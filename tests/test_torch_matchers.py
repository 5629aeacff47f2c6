"""Parity of the port's matching (ydorbslam_tpu_torch.ops.hamming,
ydorbslam_tpu_torch.slam.matchers) with the JAX package on the CPU.

The K2 plain version is held against the Pallas kernel in interpret
mode on the problem of tests/test_proj_best2_kernel.py; the port's
searches (all through K2) against the JAX package's dense XLA
searches.  Integer results: every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydorbslam_tpu.config import CameraConfig, SlamConfig, camera_intrinsics as jax_cam
from ydorbslam_tpu.ops.extractor import FrameFeatures as JaxFeatures
from ydorbslam_tpu.ops.hamming import distance_matrix as jax_distance_matrix
from ydorbslam_tpu.slam import matchers as jm

from ydorbslam_tpu_torch.config import camera_intrinsics as torch_cam
from ydorbslam_tpu_torch.convert import features_from_numpy
from ydorbslam_tpu_torch.ops.hamming import (
    INVALID_DIST, distance_matrix, popcount32, proj_best2,
)
from ydorbslam_tpu_torch.slam import matchers as tm

torch.set_num_threads(2)

CFG = SlamConfig(camera=CameraConfig(
    fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480))


def _t(x):
    return torch.from_numpy(np.array(x))


def _desc(x):
    return _t(np.asarray(x, np.uint32).view(np.int32))


def _rand_feats(rng, n, width=640.0, height=480.0):
    """Random current-frame features as numpy (the generator of
    tests/test_proj_best2_kernel.py)."""
    uv = rng.uniform([8, 8], [width - 8, height - 8], (n, 2)).astype(np.float32)
    return dict(
        uv=uv,
        uv_raw=uv.copy(),
        response=rng.uniform(1, 100, n).astype(np.float32),
        octave=rng.integers(0, 8, n).astype(np.int32),
        angle=rng.uniform(0, 2 * np.pi, n).astype(np.float32),
        desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        right_u=np.where(rng.random(n) < 0.7,
                         uv[:, 0] - rng.uniform(1, 30, n), -1.0).astype(np.float32),
        depth=rng.uniform(0.5, 8, n).astype(np.float32),
        valid=rng.random(n) < 0.9,
    )


def _jax_feats(d):
    return JaxFeatures(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def problem():
    """Sources near current keypoints with a few flipped descriptor bits,
    so the windows and the distance gate pass non-trivially."""
    rng = np.random.default_rng(7)
    M, N = 512, 256
    curr = _rand_feats(rng, N)
    tgt = rng.integers(0, N, M)
    u = curr["uv"][tgt, 0] + rng.normal(0, 6, M)
    v = curr["uv"][tgt, 1] + rng.normal(0, 6, M)
    src_desc = curr["desc"][tgt].copy()
    src_desc ^= (rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
                 & rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
                 & rng.integers(0, 2**32, (M, 8), dtype=np.uint32))
    return dict(
        M=M, N=N, curr=curr, tgt=tgt, src_desc=src_desc,
        u=u.astype(np.float32), v=v.astype(np.float32),
        ur=(u - rng.uniform(1, 30, M)).astype(np.float32),
        rad_n=rng.uniform(4, 10, M).astype(np.float32),
        oct_lo=rng.integers(-1, 3, M).astype(np.int32),
        oct_hi=rng.integers(4, 9, M).astype(np.int32),
        valid=rng.random(M) < 0.9,
    )


def test_popcount_and_distance_matrix_match_jax(rng):
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA],
                     np.uint32)
    np.testing.assert_array_equal(
        popcount32(_desc(words)).numpy(), [0, 1, 1, 32, 31, 16])
    a = rng.integers(0, 2**32, (70, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (45, 8), dtype=np.uint32)
    a[:6, :] = words[:, None]
    b[:3] = a[:3]
    ref = np.asarray(jax_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = distance_matrix(_desc(a), _desc(b)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_resolve_unique_matches_jax(rng):
    # Distances in 0..5 (ties everywhere), most pairs not candidates, and
    # a few rows with none at all.
    d = rng.integers(0, 6, (90, 70)).astype(np.int32)
    d[rng.random(d.shape) < 0.6] = INVALID_DIST
    d[:5] = INVALID_DIST
    ref = jm.resolve_unique(jnp.asarray(d))
    out = tm.resolve_unique(_t(d))
    # Integer argmins and a per-column minimum: exact.
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (out[0].numpy() >= 0).sum() > 30


@pytest.mark.parametrize("check_ur", [False, True])
def test_proj_best2_plain_matches_pallas(problem, check_ur):
    from ydorbslam_tpu.ops.pallas_kernels import proj_best2_pallas

    p = problem
    rad_w = p["rad_n"] * 2.0
    jax_attr_a = jm._pack_src_attr(*(jnp.asarray(p[k]) for k in (
        "u", "v", "ur")), jnp.asarray(p["rad_n"]), jnp.asarray(rad_w),
        jnp.asarray(p["oct_lo"]), jnp.asarray(p["oct_hi"]), jnp.asarray(p["valid"]))
    jax_attr_b = jm._pack_cur_attr(_jax_feats(p["curr"]))
    ref = proj_best2_pallas(
        jnp.asarray(p["src_desc"]), jax_attr_a, jnp.asarray(p["curr"]["desc"]),
        jax_attr_b, check_ur=check_ur,
    )
    out = proj_best2(
        _desc(p["src_desc"]), _t(jax_attr_a), _desc(p["curr"]["desc"]),
        _t(jax_attr_b), check_ur=check_ur,
    )
    for r3, o3 in zip(ref, out):
        for r, o in zip(r3, o3):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # Non-trivial: most rows find a candidate, some with a real second.
    assert (out[1][0].numpy() >= 0).mean() > 0.5
    assert (out[1][2].numpy() < 10_000).any()


@pytest.fixture(scope="module")
def motion(problem):
    """The last frame's features and landmarks for the motion search:
    landmarks project near current keypoints, descriptors are noisy
    copies and angles agree up to noise, so the rotation histogram keeps
    most matches."""
    p = problem
    rng = np.random.default_rng(11)
    M = p["M"]
    last = _rand_feats(np.random.default_rng(13), M)
    last["desc"] = p["src_desc"]
    last["angle"] = (p["curr"]["angle"][p["tgt"]]
                     + rng.normal(0, 0.05, M)).astype(np.float32)
    z = rng.uniform(1.0, 8.0, M)
    pw = np.stack([(p["u"] - 320.0) * z / 500.0, (p["v"] - 240.0) * z / 500.0, z], -1)
    T_pred = np.eye(4, dtype=np.float32)
    T_pred[0, 3] = 0.02
    return dict(
        last=last, p_w=pw.astype(np.float32),
        lm_valid=p["valid"] & (np.arange(M) % 7 != 0),
        T_pred=T_pred, T_last=np.eye(4, dtype=np.float32),
    )


def _motion_args(p, mo, torch_side):
    if torch_side:
        return (torch_cam(CFG, "cpu"), features_from_numpy(p["curr"]),
                features_from_numpy(mo["last"]), _t(mo["p_w"]), _t(mo["lm_valid"]),
                _t(mo["T_pred"]), _t(mo["T_last"]))
    return (jax_cam(CFG), _jax_feats(p["curr"]), _jax_feats(mo["last"]),
            jnp.asarray(mo["p_w"]), jnp.asarray(mo["lm_valid"]),
            jnp.asarray(mo["T_pred"]), jnp.asarray(mo["T_last"]))


@pytest.mark.parametrize("th", [7.0, 14.0])
def test_match_motion_model_matches_jax(problem, motion, th):
    ref, ref_d = jm.match_motion_model(*_motion_args(problem, motion, False), th=th)
    out, out_d = tm.match_motion_model(*_motion_args(problem, motion, True), th=th)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_d.numpy(), np.asarray(ref_d))
    assert (out.numpy() >= 0).sum() > 30


def test_match_motion_model_two_matches_jax(problem, motion):
    ref = jm.match_motion_model_two(*_motion_args(problem, motion, False))
    out = tm.match_motion_model_two(*_motion_args(problem, motion, True))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # The narrow search is the single-radius one at th=7, the wide at 14.
    for o, th in zip(out, (7.0, 14.0)):
        one, _ = tm.match_motion_model(*_motion_args(problem, motion, True), th=th)
        np.testing.assert_array_equal(o.numpy(), one.numpy())


def test_match_dense_matches_jax(problem):
    p = problem
    rng = np.random.default_rng(3)
    angle_a = (p["curr"]["angle"][p["tgt"]] + rng.normal(0, 0.05, p["M"])).astype(np.float32)
    for use_rotation in (True, False):
        ref = jm.match_dense(
            jnp.asarray(p["src_desc"]), jnp.asarray(p["valid"]), jnp.asarray(angle_a),
            jnp.asarray(p["curr"]["desc"]), jnp.asarray(p["curr"]["valid"]),
            jnp.asarray(p["curr"]["angle"]), max_dist=50, ratio=0.7,
            use_rotation=use_rotation,
        )
        out = tm.match_dense(
            _desc(p["src_desc"]), _t(p["valid"]), _t(angle_a),
            _desc(p["curr"]["desc"]), _t(p["curr"]["valid"]), _t(p["curr"]["angle"]),
            max_dist=50, ratio=0.7, use_rotation=use_rotation,
        )
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert (out[0].numpy() >= 0).sum() > 30
