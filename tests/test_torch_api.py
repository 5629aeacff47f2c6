"""The port's exported helpers against the JAX package on the CPU.

Every name that ``ydorbslam_tpu.geometry`` and ``ydorbslam_tpu.ops``
export imports from the same subpackage of ``ydorbslam_tpu_torch``, and
each helper gets the same seeded numpy inputs as its JAX counterpart,
with the cases of tests/test_geometry.py, tests/test_frontend.py and
tests/test_proj_best2_kernel.py.

Tolerances:

* identical: ``in_image``, ``hamming_distance``, ``best_and_second``
  (ties included), ``ratio_test_matches`` (mutual on and off),
  ``remove_keyframe``, ``empty_features`` field by field,
  ``se3_to_sim3``;
* ``filter_matches_by_rotation`` identical on angle differences kept at
  least 1e-4 rad from a bin edge: XLA contracts to FMAs and PyTorch
  rounds each operation, so a difference on an edge may take either bin;
* 1e-5 (atol and rtol): the geometry functions, all float32, whose two
  versions round in other places;
* 1e-4: ``se3_log`` within 1e-4 rad of pi, as tests/test_geometry.py
  allows there (the axis comes from a difference of near-equal terms);
* ``gaussian_blur``: 1e-3 absolute on 0-255 images (seven taps a pass,
  summed in another order than XLA's banded matmul).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ydorbslam_tpu.geometry as jgeo
import ydorbslam_tpu.ops as jops
from ydorbslam_tpu.ops import extractor as jext
from ydorbslam_tpu.slam import retrieval as jret

import ydorbslam_tpu_torch.geometry as pgeo
import ydorbslam_tpu_torch.ops as pops
from ydorbslam_tpu_torch.convert import retrieval_index_from_numpy, retrieval_index_to_numpy
from ydorbslam_tpu_torch.ops import extractor as pext
from ydorbslam_tpu_torch.slam import map_state as pms
from ydorbslam_tpu_torch.slam import retrieval as pret

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
CAM_ARGS = (517.3, 516.5, 318.6, 255.3)
CAM_KW = dict(k1=0.26, k2=-0.95, p1=-0.0054, p2=0.0026, k3=1.16, bf=40.0, width=640, height=480)
JCAM = jgeo.CameraIntrinsics.create(*CAM_ARGS, **CAM_KW)
PCAM = pgeo.CameraIntrinsics.create(*CAM_ARGS, **CAM_KW, device="cpu")


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _exported(pkg):
    return sorted(n for n, v in vars(pkg).items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType))


@pytest.mark.parametrize("jpkg,ppkg", [(jgeo, pgeo), (jops, pops)], ids=["geometry", "ops"])
def test_every_exported_name_is_ported(jpkg, ppkg):
    names = _exported(jpkg)
    assert len(names) > 15
    missing = [n for n in names if not hasattr(ppkg, n)]
    assert not missing, f"not in {ppkg.__name__}: {missing}"
    assert callable(pret.remove_keyframe)
    assert isinstance(pgeo.CameraIntrinsics.baseline, property)


# ----------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------

def _twists(kind):
    rng = np.random.default_rng(3)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    if kind == "canonical":  # tests/test_geometry.py: |phi| < 2.8
        xi *= 0.8
        norm = np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
        xi[:, 3:] *= np.minimum(1.0, 2.8 / norm)
    elif kind == "big":
        xi *= 2.0
    elif kind == "near_identity":
        xi[:, 3:] *= np.float32(1e-6)
    elif kind == "near_pi":
        axis = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
        xi[:, 3:] = (np.pi - 1e-4) * axis
    return xi.astype(np.float32)


@pytest.mark.parametrize("kind", ["canonical", "big", "near_identity", "near_pi"])
def test_se3_log_matches_jax(kind):
    T = np.asarray(jgeo.se3_exp(jnp.asarray(_twists(kind))))
    ref = np.asarray(jgeo.se3_log(jnp.asarray(T)))
    got = pgeo.se3_log(_t(T)).numpy()
    tol = dict(atol=1e-4, rtol=1e-4) if kind == "near_pi" else TOL
    np.testing.assert_allclose(got, ref, **tol)
    # exp(log(T)) reproduces T, as tests/test_geometry.py asks of JAX.
    np.testing.assert_allclose(pgeo.se3_exp(pgeo.se3_log(_t(T))).numpy(), T, atol=2e-4)


def test_transform_points_matches_jax(rng):
    T = np.asarray(jgeo.se3_exp(jnp.asarray(rng.normal(size=(3, 6)), jnp.float32)))
    pts = rng.normal(size=(3, 10, 3)).astype(np.float32)
    ref = np.asarray(jgeo.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(pgeo.transform_points(_t(T), _t(pts)).numpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["random", "near_pi", "identity"])
def test_quaternions_match_jax(kind):
    rng = np.random.default_rng(5)
    phi = rng.normal(size=(48, 3))
    if kind == "near_pi":  # w ~ 0.05: the x, y and z pivots are the largest
        phi = (np.pi - 0.1) * phi / np.linalg.norm(phi, axis=-1, keepdims=True)
    elif kind == "identity":
        phi = np.zeros((4, 3))
    R = np.asarray(jgeo.so3_exp(jnp.asarray(phi, jnp.float32)))
    q_ref = np.asarray(jgeo.rot_to_quat(jnp.asarray(R)))
    q = pgeo.rot_to_quat(_t(R))
    np.testing.assert_allclose(q.numpy(), q_ref, **TOL)
    assert (q[:, 3] >= 0).all()
    np.testing.assert_allclose(pgeo.quat_to_rot(q).numpy(), R, **TOL)
    q_raw = rng.normal(size=(32, 4)).astype(np.float32)  # not unit length
    np.testing.assert_allclose(pgeo.quat_to_rot(_t(q_raw)).numpy(),
                               np.asarray(jgeo.quat_to_rot(jnp.asarray(q_raw))), **TOL)


def test_projection_matches_jax(rng):
    pts = np.concatenate([
        rng.uniform([-2, -2, 0.5], [2, 2, 5], (100, 3)),
        rng.uniform([-1, -1, -1], [1, 1, 1e-7], (8, 3)),  # at or behind the clamp
        [[0.0, 0.0, 2.0]],  # tests/test_geometry.py's stereo point
    ]).astype(np.float32)
    for jf, pf in ((jgeo.project, pgeo.project), (jgeo.project_stereo, pgeo.project_stereo)):
        ref = np.asarray(jf(JCAM, jnp.asarray(pts)))
        np.testing.assert_allclose(pf(PCAM, _t(pts)).numpy(), ref, **TOL)
    uvr = pgeo.project_stereo(PCAM, _t(pts[-1:]))[0]
    assert abs(float(uvr[2]) - (float(uvr[0]) - 40.0 / 2.0)) < 1e-4
    np.testing.assert_allclose(float(PCAM.baseline), float(JCAM.baseline), rtol=1e-7)


def test_in_image_matches_jax(rng):
    edges = np.array([-0.5, 0.0, 2.9999, 3.0, 3.0001, 476.0, 477.0, 479.9, 480.0, 636.9999,
                      637.0, 639.0, 640.0, 641.0], np.float32)
    uv = np.concatenate([np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2),
                         rng.uniform(-10, 650, (200, 2))]).astype(np.float32)
    for border in (0.0, 3.0):
        ref = np.asarray(jgeo.in_image(JCAM, jnp.asarray(uv), border))
        got = pgeo.in_image(PCAM, _t(uv), border).numpy()
        assert got.dtype == np.bool_ and 0 < ref.sum() < ref.size
        np.testing.assert_array_equal(got, ref)


def test_se3_to_sim3_matches_jax(rng):
    T = np.asarray(jgeo.se3_exp(jnp.asarray(rng.normal(size=(4, 6)), jnp.float32)))
    ref = np.asarray(jgeo.se3_to_sim3(jnp.asarray(T)))
    np.testing.assert_array_equal(pgeo.se3_to_sim3(_t(T)).numpy(), ref)
    s, _, _ = pgeo.split_S(pgeo.se3_to_sim3(_t(T)))
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------

def _checkerboard(h=96, w=128, sq=8):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy // sq + xx // sq) % 2) * 200.0 + 20.0).astype(np.float32)


@pytest.mark.parametrize("shape,ksize,sigma", [
    ("checker", 7, 2.0), ((480, 640), 7, 2.0), ((4, 5), 7, 2.0), ((13, 31), 7, 2.0),
    ((37, 29), 5, 1.2),
])
def test_gaussian_blur_matches_jax(shape, ksize, sigma):
    img = (_checkerboard() if shape == "checker"
           else np.random.default_rng(9).uniform(0, 255, shape).astype(np.float32))
    ref = np.asarray(jops.gaussian_blur(jnp.asarray(img), ksize=ksize, sigma=sigma))
    got = pops.gaussian_blur(_t(img), ksize=ksize, sigma=sigma)
    assert got.shape == img.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    if shape == "checker":  # tests/test_frontend.py's properties
        assert abs(float(got.mean()) - float(img.mean())) < 0.5
        assert float(got.diff(dim=1).abs().mean()) < float(np.abs(np.diff(img, axis=1)).mean())


def test_empty_features_matches_jax():
    ref = jext.empty_features(7)
    got = pext.empty_features(7, device="cpu")
    assert got._fields == ref._fields
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        expect_dtype = torch.from_numpy(_np(r).copy()).dtype
        assert g.dtype == expect_dtype, name
        np.testing.assert_array_equal(g.numpy(), _np(r), err_msg=name)


@pytest.mark.parametrize("make", [
    lambda: pext.empty_features(3),
    lambda: pret.empty_index(4, n_banks=2, bank_bits=4),
    lambda: pms.empty_map(2, 3, 4, 2),
], ids=["empty_features", "empty_index", "empty_map"])
def test_allocating_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in make())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_hamming_distance_matches_jax(rng):
    a = rng.integers(0, 2**32, (3, 5, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (5, 8), dtype=np.uint64).astype(np.uint32)
    a[0, 0] = np.uint32(0xFFFFFFFF)
    b[1] = a[1, 1]  # distance 0
    ref = np.asarray(jops.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    got = pops.hamming_distance(_t(a), _t(b))
    assert got.dtype == torch.int32 and ref.min() == 0
    np.testing.assert_array_equal(got.numpy(), ref)


def _tie_matrices():
    rng = np.random.default_rng(13)
    out = {
        "ties": rng.integers(0, 4, (64, 32)),
        "ties_narrow": rng.integers(0, 2, (40, 2)),
        "random": rng.integers(0, 257, (50, 70)),
        "frontend": np.array([[10, 50, 60], [30, 31, 90], [200, 210, 220]]),
    }
    invalid = rng.integers(0, 6, (30, 20))
    invalid[rng.random((30, 20)) < 0.5] = jops.INVALID_DIST
    invalid[0] = jops.INVALID_DIST
    out["sentinels"] = invalid
    return {k: v.astype(np.int32) for k, v in out.items()}


@pytest.mark.parametrize("kind", sorted(_tie_matrices()))
def test_best_and_second_matches_jax(kind):
    d = _tie_matrices()[kind]
    ref = jops.best_and_second(jnp.asarray(d))
    got = pops.best_and_second(_t(d))
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("kind", sorted(_tie_matrices()))
def test_ratio_test_matches_jax(kind, mutual):
    d = _tie_matrices()[kind]
    for max_dist, ratio in ((100, 0.8), (2, None), (300, 0.9)):
        ref = jops.ratio_test_matches(jnp.asarray(d), max_dist, ratio=ratio, mutual=mutual)
        got = pops.ratio_test_matches(_t(d), max_dist, ratio=ratio, mutual=mutual)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if kind == "frontend":  # tests/test_frontend.py's expectations
        idx, _ = pops.ratio_test_matches(_t(d), max_dist=100, ratio=0.8)
        assert idx.tolist() == [0, -1, -1]


def _rotation_case(kind):
    rng = np.random.default_rng(21)
    if kind == "frontend":  # tests/test_frontend.py: 90 at ~0.5 rad, 10 scattered
        n = 100
        ang_a = np.zeros(n, np.float32)
        ang_b = np.full(n, 0.5, np.float32)
        ang_b[:10] = rng.uniform(2.0, 6.0, 10)
        return np.arange(n, dtype=np.int32), ang_a, ang_b
    n, nb = 300, 200
    width = 2 * np.pi / 30
    # Differences at least 1e-4 rad from a bin edge, mostly in a few bins.
    bins = np.where(rng.random(n) < 0.7, rng.choice([3, 4, 17], n), rng.integers(0, 30, n))
    diff = (bins + rng.uniform(0.01, 0.99, n)) * width
    match = rng.integers(0, nb, n).astype(np.int32)
    match[rng.random(n) < 0.15] = -1
    ang_b = rng.uniform(0, 2 * np.pi, nb)
    ang_a = np.mod(ang_b[np.maximum(match, 0)] + diff, 2 * np.pi)
    return match, ang_a.astype(np.float32), ang_b.astype(np.float32)


@pytest.mark.parametrize("kind", ["frontend", "random"])
def test_filter_matches_by_rotation_matches_jax(kind):
    match, ang_a, ang_b = _rotation_case(kind)
    ref = np.asarray(jops.filter_matches_by_rotation(
        jnp.asarray(match), jnp.asarray(ang_a), jnp.asarray(ang_b)))
    got = pops.filter_matches_by_rotation(_t(match), _t(ang_a), _t(ang_b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < (got >= 0).sum() < (match >= 0).sum()
    if kind == "frontend":
        assert (got[10:] >= 0).all() and (got[:10] == -1).sum() >= 8


@pytest.mark.parametrize("kf_id", [2, 0, -1, 9])
def test_remove_keyframe_matches_jax(kf_id):
    rng = np.random.default_rng(17)
    K, W = 9, 64
    hist = rng.random((K, W)).astype(np.float32) * (rng.random((K, W)) < 0.3)
    fields = dict(hist=hist, presence=(hist > 0).astype(np.float32), valid=rng.random(K) < 0.8)
    ref = jret.remove_keyframe(jret.RetrievalIndex(**{k: jnp.asarray(v) for k, v in
                                                      fields.items()}), kf_id)
    got = retrieval_index_to_numpy(pret.remove_keyframe(retrieval_index_from_numpy(fields),
                                                        kf_id))
    for name in ("hist", "presence", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)), err_msg=name)
