"""K1 over all pyramid levels in one call, and the K1 and K4 wrappers, on
the CPU.

* ``ops.fast.fast_score_nms_levels`` (CPU tensors: the plain version,
  level by level) against the JAX package's ``fast_score_nms_pallas`` in
  interpret mode, as tests/test_pallas_kernels.py runs it, and against
  its XLA ``nms_and_border(fast_score_map(.))``: exact, on the 8 levels
  of a small frame and on ragged levels (1x1, 7x33, 33x7, one with
  H < 2 x border).
* A plain mirror of ``csrc/fast_nms.cu``'s block decomposition of the
  cyclic 9-arc max-min (``arc9``) against the plain version's tree:
  exact, ties included.
* ``extract_orb`` calls K1 once per frame, for all levels.
* The K1 and K4 wrappers refuse bad inputs with ``ValueError`` before
  the kernel library is loaded, and count no launch.

The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydorbslam_tpu.ops import fast as jf
from ydorbslam_tpu.ops.pallas_kernels import fast_score_nms_pallas

from ydorbslam_tpu_torch.config import camera_intrinsics
from ydorbslam_tpu_torch.ops import extractor, kernels
from ydorbslam_tpu_torch.ops import fast as tf
from ydorbslam_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(2)

BORDER = 16
RAGGED = [(1, 1), (7, 33), (33, 7), (20, 90)]  # (20, 90): H < 2 x border


@pytest.fixture(scope="module")
def levels():
    """The 8 pyramid levels of a seeded 120x160 frame, then the ragged
    levels, as numpy float32."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (120, 160)).astype(np.float32)
    pyr = [t.numpy() for t in build_pyramid(torch.from_numpy(frame), 8, 1.2)]
    return pyr + [rng.uniform(0, 255, s).astype(np.float32) for s in RAGGED]


def test_levels_match_pallas_and_xla(levels):
    before = kernels.launch_counts()
    out = tf.fast_score_nms_levels([torch.from_numpy(x) for x in levels], BORDER)
    assert kernels.launch_counts() == before  # the CPU takes the plain version
    assert len(out) == len(levels)
    for x, o in zip(levels, out):
        ref_xla = np.asarray(jf.nms_and_border(jf.fast_score_map(jnp.asarray(x)), BORDER))
        ref_pallas = np.asarray(fast_score_nms_pallas(jnp.asarray(x), BORDER))
        # Subtractions, min and max only: exact.
        assert o.shape == x.shape
        np.testing.assert_array_equal(o.numpy(), ref_xla)
        np.testing.assert_array_equal(o.numpy(), ref_pallas)
    assert (out[0] > 0).sum() > 50


@pytest.mark.parametrize("border", [0, 1, 3])
def test_levels_match_xla_at_small_borders(levels, border):
    """Borders below the NMS ring read the -1 padding of the plain
    version (the kernel's scores outside the image)."""
    out = tf.fast_score_nms_levels([torch.from_numpy(x) for x in levels], border)
    for x, o in zip(levels, out):
        ref = np.asarray(jf.nms_and_border(jf.fast_score_map(jnp.asarray(x)), border))
        np.testing.assert_array_equal(o.numpy(), ref)  # exact


def _arc9_blocks(d: torch.Tensor, kmin: bool) -> torch.Tensor:
    """Mirror of csrc/fast_nms.cu ``arc9``: over e[i] = d[i % 16], cut in
    the blocks [0, 9), [9, 18), [18, 24), red over k of op(e[k..k+8])
    from a suffix run of one block and a prefix run of the next."""
    op = torch.minimum if kmin else torch.maximum
    red = torch.maximum if kmin else torch.minimum
    sa = [None] * 9
    sa[8] = d[8]
    for k in range(7, -1, -1):
        sa[k] = op(d[k], sa[k + 1])
    best, pre = sa[0], d[9]
    for k in range(1, 9):
        if k > 1:
            pre = op(pre, d[(k + 8) % 16])
        best = red(best, op(sa[k], pre))
    sb, run = [None] * 7, op(d[0], d[1])
    for k in range(15, 8, -1):
        run = op(d[k], run)
        sb[k - 9] = run
    best, pre = red(best, sb[0]), d[2]
    for k in range(10, 16):
        if k > 10:
            pre = op(pre, d[(k + 8) % 16])
        best = red(best, op(sb[k - 9], pre))
    return best


@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_arc9_blocks_equal_the_tree(kind):
    rng = np.random.default_rng(11)
    if kind == "uniform":
        d = rng.uniform(-255, 255, (16, 20000))
    else:  # few distinct values: most arcs tie
        d = rng.integers(-2, 3, (16, 20000))
    d = torch.from_numpy(d.astype(np.float32))
    bright = torch.amax(tf._arc_min(d), dim=0)
    dark = torch.amax(tf._arc_min(-d), dim=0)
    assert torch.equal(_arc9_blocks(d, True), bright)
    assert torch.equal(-_arc9_blocks(d, False), dark)
    score = torch.clamp(torch.maximum(_arc9_blocks(d, True), -_arc9_blocks(d, False)), min=0.0)
    assert torch.equal(score, tf._fast_from_diffs(d))


def test_extract_orb_calls_k1_once_for_all_levels(monkeypatch):
    from ydorbslam_tpu_torch.config import CameraConfig, SlamConfig

    calls = []

    def spy(levels, border):
        calls.append([tuple(t.shape) for t in levels])
        return tf.fast_score_nms_levels(levels, border)

    monkeypatch.setattr(extractor, "fast_score_nms_levels", spy)
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (120, 160)).astype(np.uint8))
    cam = camera_intrinsics(SlamConfig(camera=CameraConfig(
        fx=100.0, fy=100.0, cx=80.0, cy=60.0, width=160, height=120)), "cpu")
    feats = extractor.extract_orb(img, cam, n_features=200, capacity=256, has_distortion=False)
    assert len(calls) == 1 and len(calls[0]) == 8 and calls[0][0] == (120, 160)
    assert int(feats.valid.sum()) > 0


def _k1_inputs(bad: str):
    lv = [torch.zeros((40, 50)), torch.zeros((33, 41))]
    if bad == "dtype":
        lv[1] = lv[1].double()
    elif bad == "not_2d":
        lv[0] = torch.zeros((2, 40, 50))
    elif bad == "strided":
        lv[1] = torch.zeros((41, 33)).t()
    elif bad == "two_devices":
        lv[1] = torch.zeros((33, 41), device="meta")
    elif bad == "too_many":
        lv = [torch.zeros((8, 8))] * (kernels.MAX_LEVELS + 1)
    elif bad == "none":
        lv = []
    return lv


K1_BAD = {"cpu": "expected CUDA tensors", "dtype": "2-D float32", "not_2d": "2-D float32",
          "strided": "not contiguous", "two_devices": "different devices",
          "too_many": "levels per launch", "none": "levels per launch"}
K4_BAD = {"cpu": "expected a CUDA tensor", "rows": "expected shape",
          "dtype": "expected torch.float32", "strided": "contiguous"}


def _no_library():
    raise AssertionError("the kernel library was loaded")


@pytest.mark.parametrize("bad", sorted(K1_BAD))
def test_k1_wrapper_refuses_bad_inputs(bad, monkeypatch):
    """The one-launch K1 wrapper refuses CPU levels, also with a wrong
    dtype, rank or layout, levels on two devices and more levels than
    the kernel's table holds, naming the fault, before any library load
    and without counting a launch."""
    monkeypatch.setattr(kernels, "_lib", _no_library)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match=f"^fast_score_nms: .*{K1_BAD[bad]}"):
        kernels.fast_score_nms_levels_cuda(_k1_inputs(bad), BORDER)
    if bad == "cpu":
        with pytest.raises(ValueError, match="^fast_score_nms: expected CUDA tensors"):
            kernels.fast_score_nms_cuda(torch.zeros((40, 50)), BORDER)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("bad", sorted(K4_BAD))
def test_k4_wrapper_refuses_bad_inputs(bad, monkeypatch):
    monkeypatch.setattr(kernels, "_lib", _no_library)
    before = kernels.launch_counts()
    inp = {"cpu": torch.zeros((32, 4, 40)), "rows": torch.zeros((31, 4, 40)),
           "dtype": torch.zeros((32, 4, 40), dtype=torch.float64),
           "strided": torch.zeros((32, 40, 4)).transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match=f"^lm_obs inp: .*{K4_BAD[bad]}"):
        kernels.lm_obs_cuda(inp)
    assert kernels.launch_counts() == before
