"""The port's stereo matching against the JAX package on the CPU.

The inputs are those of ``test_frontend.py``'s stereo test: 120 dots at
1-6 m rendered into a rectified 640x480 pair (bf = 50), 300 ORB
features in 384 slots.  Both packages get the same ``FrameFeatures``
(the JAX package's, carried across with ``convert.features_from_numpy``).

Tolerances:
- ``masked_distance_matrix``: exact.
- ``stereo_match`` on the JAX package's pyramids: the same ok mask;
  depth and right_u within 1e-4 relative at octave 0 (level 0 holds
  whole numbers, so every SAD sum is exact) and within 1e-5 relative at
  octaves 1-7, where the SAD sums of interpolated levels run in another
  order (measured on both: at most 1.4e-6 relative, the divisions).
- ``stereo_match`` on the port's own pyramids (levels 1-7 differ from
  XLA's by <= 5e-5, ROADMAP T4): the ok mask agrees on >= 98 % of the
  valid keypoints (measured: all 300) and depths where both are ok within
  1e-4 relative (measured: 1.4e-6).
- The per-octave gather of ``sad_costs``: bit-identical to the JAX
  package's all-levels-then-select form at every octave, on levels of
  whole numbers with keypoints within ``_PAD`` of every border and right
  x up to 30 px beyond the level.
- The median cut, a SAD tie and a Hamming tie: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import render_dots

from ydorbslam_tpu.geometry import CameraIntrinsics as JaxCamera
from ydorbslam_tpu.ops import extractor as jextractor
from ydorbslam_tpu.ops import hamming as jhamming
from ydorbslam_tpu.ops import stereo as jstereo
from ydorbslam_tpu.ops.pyramid import build_pyramid as jax_pyramid

from ydorbslam_tpu_torch.convert import features_from_numpy
from ydorbslam_tpu_torch.geometry.camera import CameraIntrinsics
from ydorbslam_tpu_torch.ops import extractor, hamming, stereo
from ydorbslam_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes

torch.set_num_threads(2)

JCAM = JaxCamera.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640, height=480)
CAM = CameraIntrinsics.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640, height=480,
                              device="cpu")


def _np(feats):
    return {k: np.asarray(v) for k, v in feats._asdict().items()}


@pytest.fixture(scope="module")
def pair():
    """test_frontend.py's rectified stereo pair, the JAX package's
    features and pyramids of both images, and the JAX match."""
    rng = np.random.default_rng(42)
    n = 120
    z = rng.uniform(1.0, 6.0, n)
    u = rng.uniform(60, 580, n)
    v = rng.uniform(60, 420, n)
    inten = rng.uniform(100, 250, n)
    left = render_dots(np.stack([u, v], -1), z, intensities=inten)
    right = render_dots(np.stack([u - 50.0 / z, v], -1), z, intensities=inten)
    jfl, jfr = (jextractor.extract_orb(jnp.asarray(im), JCAM, n_features=300, capacity=384,
                                       has_distortion=False) for im in (left, right))
    jpl, jpr = jax_pyramid(jnp.asarray(left)), jax_pyramid(jnp.asarray(right))
    jout = jstereo.stereo_match(jfl, jfr, jpl, jpr, JCAM)
    return dict(
        left=left, right=right,
        fl=features_from_numpy(_np(jfl)), fr=features_from_numpy(_np(jfr)),
        pl=tuple(torch.from_numpy(np.asarray(x)) for x in jpl),
        pr=tuple(torch.from_numpy(np.asarray(x)) for x in jpr),
        jout=_np(jout),
    )


@pytest.mark.parametrize("with_pairs", [False, True])
def test_masked_distance_matrix_equals_jax(with_pairs):
    rng = np.random.default_rng(5)
    da = rng.integers(0, 2**32, (37, 8), dtype=np.uint32)
    db = da[rng.integers(0, 37, 53)] ^ (rng.integers(0, 2**32, (53, 8), dtype=np.uint32)
                                        & rng.integers(0, 2**32, (53, 8), dtype=np.uint32))
    va, vb = rng.random(37) < 0.8, rng.random(53) < 0.8
    pm = rng.random((37, 53)) < 0.5 if with_pairs else None
    want = np.asarray(jhamming.masked_distance_matrix(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb),
        None if pm is None else jnp.asarray(pm)))
    got = hamming.masked_distance_matrix(
        torch.from_numpy(da.view(np.int32)), torch.from_numpy(db.view(np.int32)),
        torch.from_numpy(va), torch.from_numpy(vb), None if pm is None else torch.from_numpy(pm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == hamming.INVALID_DIST).any() and (want < 257).any()


def test_stereo_match_on_jax_pyramids(pair):
    out = stereo.stereo_match(pair["fl"], pair["fr"], pair["pl"], pair["pr"], CAM)
    j = pair["jout"]
    ok, jok = out.depth.numpy() > 0, j["depth"] > 0
    assert jok.sum() > 40
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(out.right_u.numpy() >= 0, j["right_u"] >= 0)
    oct0 = ok & (j["octave"] == 0)
    rest = ok & (j["octave"] > 0)
    assert oct0.sum() > 10 and rest.sum() > 10
    for field in ("depth", "right_u"):
        got, want = getattr(out, field).numpy(), j[field]
        np.testing.assert_allclose(got[oct0], want[oct0], rtol=1e-4)
        np.testing.assert_allclose(got[rest], want[rest], rtol=1e-5)
        np.testing.assert_array_equal(got[~ok], want[~ok])


def test_stereo_match_on_port_pyramids(pair):
    pl = build_pyramid(torch.from_numpy(pair["left"]))
    pr = build_pyramid(torch.from_numpy(pair["right"]))
    out = stereo.stereo_match(pair["fl"], pair["fr"], pl, pr, CAM)
    j = pair["jout"]
    ok, jok = out.depth.numpy() > 0, j["depth"] > 0
    valid = j["valid"]
    assert np.mean(ok[valid] == jok[valid]) >= 0.98
    both = ok & jok
    np.testing.assert_allclose(out.depth.numpy()[both], j["depth"][both], rtol=1e-4)


def test_extraction_returns_the_pyramid_it_builds(pair):
    img = torch.from_numpy(pair["left"].astype(np.uint8))
    kw = dict(n_features=300, capacity=384, n_levels=8, scale_factor=1.2, th_high=20,
              th_low=7, has_distortion=False, subpixel=True)
    feats, pyr = extractor._extract_orb_pyramid(img, CAM, **kw)
    fresh = build_pyramid(img.to(torch.float32))
    assert len(pyr) == len(fresh) == 8
    assert all(torch.equal(a, b) for a, b in zip(pyr, fresh))
    alone = extractor.extract_orb(img, CAM, **kw)
    assert all(torch.equal(a, b) for a, b in zip(feats, alone))


@pytest.mark.parametrize("octave", range(8))
def test_sad_gather_equals_all_levels_then_select(octave):
    """``sad_costs`` reads each keypoint at its own octave from one flat
    buffer; the JAX package computes every level and selects.  On levels
    of whole numbers every SAD sum is exact, so the two agree bit for bit,
    with keypoints within ``_PAD`` of every border and right x beyond it."""
    rng = np.random.default_rng(100 + octave)
    shapes = pyramid_shapes(480, 640, 8, 1.2)
    pyr_l = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    pyr_r = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    h, w = shapes[octave]
    p = stereo._PAD
    us = np.array([0.0, 0.4, 3.0, p - 1.0, p + 0.6, w / 2, w - p, w - 3.0, w - 1.0, w - 0.6])
    vs = np.array([0.0, 2.0, p - 0.5, h / 3, h - p, h - 1.0])
    uv = np.stack(np.meshgrid(us, vs), -1).reshape(-1, 2)
    # Right x from -2.4 on: a window start left of the padded level (right
    # x below -2.5, which no right keypoint reaches: they lie >= 13 px
    # inside their level) would wrap in JAX's dynamic_slice.
    ur = np.concatenate([np.maximum(uv[:, 0] - rng.uniform(-2, 40, len(uv)), -2.4),
                         [-2.4, -1.0, w + p, w + 30.0]])
    uv = np.concatenate([uv, uv[:4]])
    n = len(uv)
    # Keypoints at the other octaves too: the select must leave them out.
    octs = np.where(np.arange(n) % 3 == 0, (octave + 1) % 8, octave).astype(np.int32)
    want = np.zeros((n, 2 * stereo.SAD_L + 1), np.float32)
    for level in range(8):
        c = np.asarray(jstereo._sad_costs_at_level(
            jnp.asarray(pyr_l[level]), jnp.asarray(pyr_r[level]),
            jnp.asarray(uv, jnp.float32), jnp.asarray(ur, jnp.float32)))
        want = np.where((octs == level)[:, None], c, want)
    got = stereo.sad_costs(
        [torch.from_numpy(x) for x in pyr_l], [torch.from_numpy(x) for x in pyr_r],
        torch.from_numpy(octs), torch.from_numpy(uv.astype(np.float32)),
        torch.from_numpy(ur.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), want)


def _toy_match(monkeypatch, costs, desc_r=None, ur_r=None):
    """``stereo_match`` on N hand-made keypoints at octave 0, each with its
    own right keypoint 20 px to the left (the same descriptor), with the
    SAD costs replaced by ``costs`` (N, 11)."""
    n = costs.shape[0]
    rng = np.random.default_rng(9)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    u = 100.0 + 40.0 * np.arange(n)
    v = np.full(n, 200.0)
    ur_r = u - 20.0 if ur_r is None else ur_r
    desc_r = desc if desc_r is None else desc_r

    def feats(uu, dd):
        m = len(uu)
        return features_from_numpy(dict(
            uv=np.stack([uu, np.full(m, 200.0)], -1), uv_raw=np.stack([uu, np.full(m, 200.0)], -1),
            response=np.ones(m), octave=np.zeros(m, np.int32), angle=np.zeros(m),
            desc=dd, right_u=-np.ones(m), depth=-np.ones(m), valid=np.ones(m, bool)))

    monkeypatch.setattr(stereo, "sad_costs", lambda *a: torch.from_numpy(costs))
    pyr = [torch.zeros(s) for s in pyramid_shapes(480, 640, 8, 1.2)]
    return stereo.stereo_match(feats(u, desc), feats(ur_r, desc_r), pyr, pyr, CAM), u, v


def _vee(best, at=5, step=10.0):
    """(11,) SAD costs with their minimum ``best`` at ``at`` and a
    symmetric parabola around it (delta = 0)."""
    return (best + step * np.abs(np.arange(11) - at)).astype(np.float32)


def test_median_cut_takes_the_upper_median(monkeypatch):
    """Four ok keypoints with best SAD 1, 2, 10 and 20: the cut is 2.1 x
    sorted[n_ok // 2] = 2.1 x 10, the upper median, so all four stay;
    the lower median (2, ``torch.median``'s) would drop the last two."""
    best = np.array([1.0, 2.0, 10.0, 20.0], np.float32)
    out, u, _ = _toy_match(monkeypatch, np.stack([_vee(b) for b in best]))
    ok = out.depth.numpy() > 0
    lower = float(torch.median(torch.from_numpy(best)))
    assert lower == 2.0 and not np.array_equal(ok, best <= 1.5 * 1.4 * lower)
    np.testing.assert_array_equal(ok, best <= 1.5 * 1.4 * np.sort(best)[len(best) // 2])
    np.testing.assert_allclose(out.depth.numpy(), 50.0 / 20.0, rtol=1e-6)


def test_sad_tie_goes_to_the_first_offset(monkeypatch):
    """Equal minima at offsets 3 and 7 (both inner, both with delta 0):
    the match takes offset 3, so right x = u - 20 - 2."""
    c = np.full(11, 50.0, np.float32)
    c[[3, 7]] = 4.0
    c[[2, 4, 6, 8]] = 14.0
    out, u, _ = _toy_match(monkeypatch, np.stack([c, c]))
    np.testing.assert_allclose(out.right_u.numpy(), u - 22.0, rtol=0, atol=1e-4)


def test_hamming_tie_goes_to_the_first_column(monkeypatch):
    """Two right keypoints on the row with the left keypoint's descriptor
    (distance 0), 30 and 20 px to its left: the first column wins."""
    rng = np.random.default_rng(9)
    desc = rng.integers(0, 2**32, (1, 8), dtype=np.uint32)
    out, u, _ = _toy_match(monkeypatch, _vee(3.0)[None], desc_r=np.concatenate([desc, desc]),
                           ur_r=np.array([70.0, 80.0]))
    np.testing.assert_allclose(out.right_u.numpy(), [70.0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.depth.numpy(), [50.0 / 30.0], rtol=1e-6)
