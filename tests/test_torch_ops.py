"""Parity of the port's front-end ops (ydorbslam_tpu_torch.ops) with the
JAX package on the CPU.

The same numpy inputs go through the JAX function and its port; where
the JAX function is a Pallas kernel it runs in interpret mode, as
tests/test_pallas_kernels.py runs it.  Each tolerance is stated beside
its assertion.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence

from ydorbslam_tpu.config import CameraConfig, SlamConfig, camera_intrinsics as jax_cam
from ydorbslam_tpu.ops import descriptors as jd
from ydorbslam_tpu.ops import fast as jf
from ydorbslam_tpu.ops.extractor import extract_orb as jax_extract
from ydorbslam_tpu.ops.pyramid import build_pyramid as jax_pyramid
from ydorbslam_tpu.ops.select import select_topk_cells as jax_select
from ydorbslam_tpu.ops.stereo import fill_depth_from_rgbd as jax_fill_depth

from ydorbslam_tpu_torch.config import camera_intrinsics as torch_cam
from ydorbslam_tpu_torch.convert import features_from_numpy
from ydorbslam_tpu_torch.ops import descriptors as td
from ydorbslam_tpu_torch.ops import fast as tf
from ydorbslam_tpu_torch.ops.extractor import extract_orb as torch_extract
from ydorbslam_tpu_torch.ops.pyramid import build_pyramid as torch_pyramid
from ydorbslam_tpu_torch.ops.select import select_topk_cells as torch_select
from ydorbslam_tpu_torch.ops.stereo import fill_depth_from_rgbd as torch_fill_depth

torch.set_num_threads(2)

CFG = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_feats_np(f):
    return {k: np.asarray(v) for k, v in f._asdict().items()}


@pytest.fixture(scope="module")
def frame():
    seq = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=2, n_landmarks=600)
    _, gray, depth = seq.frame(1)
    return gray.astype(np.uint8), depth


def test_pyramid_levels_match_jax(frame):
    img = frame[0].astype(np.float32)
    ref = jax_pyramid(jnp.asarray(img), 8, 1.2)
    out = torch_pyramid(_t(img), 8, 1.2)
    assert len(out) == 8
    # Level 0 is the input itself: exact.
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    for r, o in zip(ref[1:], out[1:]):
        assert o.shape == r.shape
        # Levels 1-7: two-tap lerps here vs XLA's dense f32 matmul; the
        # roundings differ by a few ulps of 255 (measured <= 5e-5).
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_fast_score_nms_plain_matches_jax_and_pallas(rng):
    from ydorbslam_tpu.ops.pallas_kernels import fast_score_nms_pallas

    img = rng.uniform(0, 255, size=(137, 201)).astype(np.float32)
    ref_xla = np.asarray(jf.nms_and_border(jf.fast_score_map(jnp.asarray(img)), 16))
    ref_pallas = np.asarray(fast_score_nms_pallas(jnp.asarray(img), 16))
    out = tf.fast_score_nms(_t(img), 16).numpy()
    # Subtractions, min and max only: exact.
    np.testing.assert_array_equal(out, ref_xla)
    np.testing.assert_array_equal(out, ref_pallas)
    assert (out > 0).sum() > 100


def test_two_threshold_and_subpixel_match_jax(rng):
    score = rng.integers(0, 40, size=(100, 130)).astype(np.float32)
    ref = np.asarray(jf.two_threshold_mask(jnp.asarray(score), 32, 20.0, 7.0))
    # Selects and compares only: exact.
    np.testing.assert_array_equal(tf.two_threshold_mask(_t(score), 32, 20.0, 7.0).numpy(), ref)

    # Bright blobs centred off the pixel grid: the score peaks at the
    # centre pixel and the parabola fits give non-zero offsets.
    yy, xx = np.mgrid[0:45, 0:45]
    c = 22 + rng.uniform(-0.45, 0.45, (64, 2, 1, 1))
    blob = np.exp(-((xx - c[:, 0]) ** 2 + (yy - c[:, 1]) ** 2) / 8.0)
    patches = np.round(20 + 200 * blob + rng.uniform(0, 3, blob.shape)).astype(np.uint8)
    ref = np.asarray(jf.fast_subpixel_offsets(jnp.asarray(patches)))
    out = tf.fast_subpixel_offsets(_t(patches)).numpy()
    # The same float32 operations in the same order: exact.
    np.testing.assert_array_equal(out, ref)
    assert (out != 0).any()


def test_select_topk_cells_tie_order(rng):
    # Integer scores in 0..3: almost every cell winner ties with others.
    score = rng.integers(0, 4, size=(61, 83)).astype(np.float32)
    for k in (5, 40, 80):
        ref = jax_select(jnp.asarray(score), k)
        out = torch_select(_t(score), k)
        # Ties must resolve in jax.lax.top_k's order: exact indices.
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_brief_pattern_and_bits_match_jax(rng):
    np.testing.assert_array_equal(td.brief_pattern(), jd.brief_pattern())
    # The gather table selects exactly the +1 / -1 entries of the JAX
    # package's one-hot selection tensor.
    D = jd._binned_diff_tensor()
    off = td.brief_offsets()
    b, s = np.meshgrid(np.arange(32), np.arange(256), indexing="ij")
    same = off[..., 0] == off[..., 1]
    np.testing.assert_array_equal(D[b, s, off[..., 0]][~same], 1.0)
    np.testing.assert_array_equal(D[b, s, off[..., 1]][~same], -1.0)
    np.testing.assert_array_equal((D != 0).sum(-1), np.where(same, 0, 2))

    K = 96
    blurred = rng.uniform(0, 255, (K, 39, 39)).astype(np.float32)
    blurred[:, ::3, ::4] = np.round(blurred[:, ::3, ::4]) + 0.5  # half-way roundings
    angles = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    ref = np.asarray(jd.brief_from_patches(jnp.asarray(blurred), jnp.asarray(angles)))
    out = td.brief_from_patches(_t(blurred), _t(angles)).numpy().view(np.uint32)
    # Identical patches and angles: identical bits.
    np.testing.assert_array_equal(out, ref)


def test_patches_orientation_blur_match_jax(rng):
    img = rng.integers(0, 256, (80, 90)).astype(np.uint8)
    uv = np.stack([rng.integers(22, 68, 50), rng.integers(22, 58, 50)], -1).astype(np.float32)
    ref = np.asarray(jd.extract_patches(jnp.asarray(img), jnp.asarray(uv), 22))
    out = td.extract_patches(_t(img), _t(uv), 22).numpy()
    np.testing.assert_array_equal(out, ref)  # a gather: exact

    ctr = ref[:, 7:38, 7:38].astype(np.float32)
    ref_a = np.asarray(jd.orientation_from_patches(jnp.asarray(ctr)))
    out_a = td.orientation_from_patches(_t(ctr)).numpy()
    # The moments are exact integers; atan2 implementations differ by an ulp.
    np.testing.assert_allclose(out_a, ref_a, rtol=0, atol=1e-6)

    ref_b = np.asarray(jd.blur_patches(jnp.asarray(ref)))
    out_b = td.blur_patches(_t(ref)).numpy()
    # Float32 sums of 49 taps in another order: a few ulps of 255.
    np.testing.assert_allclose(out_b, ref_b, rtol=0, atol=1e-4)


def test_fill_depth_matches_jax(rng):
    n = 64
    uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    uv[:, 1] *= 0.75
    feats = dict(
        uv=uv, uv_raw=uv + 0.3, response=np.ones(n, np.float32),
        octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
        desc=np.zeros((n, 8), np.uint32), right_u=-np.ones(n, np.float32),
        depth=-np.ones(n, np.float32), valid=rng.random(n) < 0.8,
    )
    depth = np.where(rng.random((480, 640)) < 0.7, rng.uniform(0.5, 8, (480, 640)), 0)
    depth = depth.astype(np.float32)
    from ydorbslam_tpu.ops.extractor import FrameFeatures as JaxFeatures

    ref = jax_fill_depth(
        JaxFeatures(**{k: jnp.asarray(v) for k, v in feats.items()}),
        jnp.asarray(depth), jax_cam(CFG),
    )
    out = torch_fill_depth(features_from_numpy(feats), _t(depth), torch_cam(CFG, "cpu"))
    # A gather and one float32 division: exact.
    np.testing.assert_array_equal(out.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_array_equal(out.right_u.numpy(), np.asarray(ref.right_u))


def test_extract_orb_matches_jax(frame):
    gray = frame[0]
    kw = dict(n_features=600, capacity=640, has_distortion=False)
    ref = _jax_feats_np(jax_extract(jnp.asarray(gray), jax_cam(CFG), **kw))
    out = torch_extract(_t(gray), torch_cam(CFG, "cpu"), **kw)
    o = {k: v.numpy() for k, v in out._asdict().items()}
    o["desc"] = o["desc"].view(np.uint32)
    for k in ("uv", "uv_raw", "response", "angle", "right_u", "depth"):
        assert o[k].shape == ref[k].shape and o[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(o["octave"], ref["octave"])
    lvl0 = ref["octave"] == 0
    assert lvl0.sum() > 100
    # Level 0 is the integer-valued input: keypoints, responses and
    # descriptors are exact there.
    for k in ("uv", "uv_raw", "response", "valid", "desc"):
        np.testing.assert_array_equal(o[k][lvl0], ref[k][lvl0], err_msg=k)
    # Angles: exact moments, atan2 within an ulp.
    np.testing.assert_allclose(o["angle"], ref["angle"], rtol=0, atol=1e-5)
    # Levels 1-7 come from interpolated levels that differ by ulps
    # (test_pyramid_levels_match_jax), which can flip a near-tie
    # selection or a half-way uint8 rounding: bound the keypoints whose
    # position or descriptor differ at 2% of the valid ones.
    valid = ref["valid"]
    differs = (o["uv"] != ref["uv"]).any(1) | (o["desc"] != ref["desc"]).any(1)
    assert differs[valid].sum() <= 0.02 * valid.sum()
    np.testing.assert_array_equal(o["valid"], ref["valid"])
