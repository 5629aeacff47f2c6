"""K5, the pose-only LM in one CUDA launch (csrc/pose_lm.cu).

On the CPU: ``optimize_pose`` takes the plain version and launches
nothing; the wrapper refuses malformed inputs before the library loads.
On the card (marked ``cuda``, skipped without one): the kernel against
the plain version in float32 and against a float64 solve on seeded
problems and edge cases, two launches bit for bit, one launch a call.
Run on the card with ``python -m pytest --noconftest -o addopts=
tests/test_torch_pose_kernel.py -q``: this file imports no JAX and needs
no conftest.
"""
import numpy as np
import pytest
import torch

from ydorbslam_tpu_torch.geometry.camera import CameraIntrinsics
from ydorbslam_tpu_torch.ops import kernels
from ydorbslam_tpu_torch.optim.pose import (
    CHI2_MONO, CHI2_STEREO, PoseObservations, _chi2, _flat_project, _weights, optimize_pose,
    optimize_pose_plain,
)
from ydorbslam_tpu_torch.testing import KITTI00, pose_problem

torch.set_num_threads(2)

# The benchmark's limit on the camera-centre gap of a pose solve to the
# same solve in float64 (slambench/limits, pose_gap_m).
POSE_GAP_M = 1.5e-5
# An inlier that flips between two solves sits at the chi2 threshold: its
# raw chi2 at the float64 pose lies within this of delta^2.
FLIP_CHI2 = 0.05
# Where they flip, the camera centre stays within this of float64's, per
# flip: one threshold observation dropped moved float64's centre by up to
# 6.8e-4 m on these problems at N = 1024 and 2048, seeds 0-5.
FLIP_GAP_M = 1e-3

CASES = [("random", n) for n in (1, 31, 1000, 1024, 2048, 4096, 10000)] + [
    (kind, 2048) for kind in ("no_valid", "mono", "stereo", "outliers", "behind")]


def _camera(device, dtype=torch.float32) -> CameraIntrinsics:
    c = CameraIntrinsics.create(KITTI00["fx"], KITTI00["fy"], KITTI00["cx"], KITTI00["cy"],
                                bf=KITTI00["bf"], width=KITTI00["width"],
                                height=KITTI00["height"], device=device)
    return c._replace(**{k: getattr(c, k).to(dtype) for k in c._fields[:10]})


def _problem(kind, n, seed, device, dtype=torch.float32):
    obs, T0, _ = pose_problem(np.random.default_rng(seed), n, kind)
    po = PoseObservations(**{k: torch.from_numpy(v).to(device) for k, v in obs.items()})
    if dtype != torch.float32:
        po = po._replace(p_w=po.p_w.to(dtype), obs_uvr=po.obs_uvr.to(dtype),
                         inv_sigma2=po.inv_sigma2.to(dtype))
    return torch.from_numpy(T0).to(device, dtype), po


def _centre(T):
    T = T.double().cpu()
    return -T[:3, :3].T @ T[:3, 3]


def test_cpu_takes_the_plain_version():
    cam = _camera("cpu")
    T0, po = _problem("random", 300, 0, "cpu")
    before = kernels.launch_counts()["pose_lm"]
    T, inlier, n_in = optimize_pose(cam, T0, po)
    assert kernels.launch_counts()["pose_lm"] == before
    T_p, inlier_p, n_p = optimize_pose_plain(cam, T0, po)
    assert torch.equal(T, T_p) and torch.equal(inlier, inlier_p) and torch.equal(n_in, n_p)
    assert T.dtype == torch.float32 and inlier.dtype == torch.bool and n_in.dtype == torch.int64


def _no_library():
    raise AssertionError("the wrapper loaded the library before refusing its inputs")


def _bad_inputs(bad):
    T0, po = _problem("random", 64, 1, "cpu")
    if bad == "cpu":
        return T0, po
    T0 = T0.to("meta")
    po = PoseObservations(*(t.to("meta") for t in po))
    if bad == "float64":
        return T0, po._replace(p_w=po.p_w.double())
    if bad == "shape":
        return T0, po._replace(obs_uvr=po.obs_uvr[:, :2].contiguous())
    if bad == "T shape":
        return T0[:3].contiguous(), po
    if bad == "non-contiguous":
        return T0, po._replace(p_w=torch.empty((3, 64), device="meta").T)
    raise ValueError(bad)


BAD = {"cpu": "expected CUDA tensors", "float64": "p_w: expected torch.float32",
       "shape": "obs_uvr: expected shape", "T shape": "T_cw_init: expected shape",
       "non-contiguous": "p_w: expected a contiguous tensor"}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_refuses_bad_inputs(bad, monkeypatch):
    # Meta tensors stand in for the card's: they carry device, dtype,
    # shape and strides without a GPU, and the refusals come before any
    # launch.
    monkeypatch.setattr(kernels, "_lib", _no_library)
    T0, po = _bad_inputs(bad)
    cam = _camera("cpu")
    if bad != "cpu":
        cam = cam._replace(**{k: getattr(cam, k).to("meta") for k in cam._fields[:10]})
    before = kernels.launch_counts()["pose_lm"]
    with pytest.raises(ValueError, match=f"^pose_lm.*{BAD[bad]}"):
        kernels.pose_lm_cuda(cam, T0, po)
    assert kernels.launch_counts()["pose_lm"] == before


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 is a CUDA kernel with no CPU build")
    return torch.device("cuda")


def _flips(cam64, T64, po64, a, b):
    """Indices where inlier masks a and b differ, each checked to sit at
    the threshold: its raw chi2 at the float64 pose within FLIP_CHI2 of
    delta^2."""
    idx = torch.nonzero(a.cpu() != b.cpu())[:, 0]
    if idx.numel():
        _, _, _, _, _, r = _flat_project(cam64, T64, po64)
        wu, wr = _weights(po64, torch.ones_like(po64.valid))
        chi2 = _chi2(r, wu, wr)[idx]
        d2 = torch.where(po64.has_stereo[idx], CHI2_STEREO, CHI2_MONO).double()
        far = (chi2 - d2).abs() > FLIP_CHI2
        assert not far.any(), f"inliers differ away from the threshold at {idx[far].tolist()}: " \
                              f"chi2 {chi2[far].tolist()}"
    return idx.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,n", CASES)
def test_kernel_matches_plain_and_float64(kind, n, seed, card):
    cam = _camera(card)
    T0, po = _problem(kind, n, seed, card)
    before = kernels.launch_counts()["pose_lm"]
    T_k, in_k, n_k = optimize_pose(cam, T0, po)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pose_lm"] == before + 1
    assert T_k.shape == (4, 4) and T_k.dtype == torch.float32 and T_k.is_cuda
    assert in_k.shape == (n,) and in_k.dtype == torch.bool and in_k.is_cuda
    assert n_k.shape == () and n_k.dtype == torch.int64 and n_k.is_cuda
    assert int(n_k) == int(in_k.sum())
    assert torch.isfinite(T_k).all()
    R = T_k[:3, :3].double().cpu()
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-6)
    assert T_k[3].tolist() == [0.0, 0.0, 0.0, 1.0]

    cam32, T32, po32 = _camera("cpu"), *_problem(kind, n, seed, "cpu")
    T_p, in_p, n_p = optimize_pose_plain(cam32, T32, po32)
    cam64, T64_0, po64 = _camera("cpu", torch.float64), *_problem(kind, n, seed, "cpu",
                                                                  torch.float64)
    T_d, in_d, n_d = optimize_pose_plain(cam64, T64_0, po64)

    flips_d = _flips(cam64, T_d, po64, in_k, in_d)
    flips_p = _flips(cam64, T_d, po64, in_k, in_p)
    assert abs(int(n_k) - int(n_d)) <= len(flips_d) <= 3, f"flips against float64 {flips_d}"
    assert abs(int(n_k) - int(n_p)) <= len(flips_p) <= 3, f"flips against plain {flips_p}"
    if kind == "no_valid":
        assert int(n_k) == 0
        assert torch.allclose(T_k.cpu(), T_p, rtol=0, atol=1e-6)
    if n == 1:
        # One observation fixes at most 3 of the pose's 6 degrees of
        # freedom: the solution is not unique and float32 and float64 part
        # along the free directions (the plain float32 version too).  The
        # kernel must still fit the observation as well as float64 does.
        wu, wr = _weights(po64, po64.valid)
        chi2_k = _chi2(_flat_project(cam64, T_k.double().cpu(), po64)[-1], wu, wr)
        chi2_d = _chi2(_flat_project(cam64, T_d, po64)[-1], wu, wr)
        assert float(chi2_k.sum()) <= float(chi2_d.sum()) + 1e-3
        return
    gap = float(torch.linalg.norm(_centre(T_k) - _centre(T_d)))
    if not flips_d:
        assert gap <= POSE_GAP_M, f"camera-centre gap to float64 {gap:.3e} m"
    else:
        assert gap <= FLIP_GAP_M * len(flips_d), \
            f"camera-centre gap to float64 {gap:.3e} m with {len(flips_d)} flips"
    if not flips_p:
        gap = float(torch.linalg.norm(_centre(T_k) - _centre(T_p)))
        assert gap <= POSE_GAP_M, f"camera-centre gap to plain float32 {gap:.3e} m"
        assert torch.allclose(T_k.cpu(), T_p, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 10000])
def test_two_launches_are_bit_identical(n, card):
    cam = _camera(card)
    T0, po = _problem("random", n, 3, card)
    before = kernels.launch_counts()["pose_lm"]
    a = optimize_pose(cam, T0, po)
    b = optimize_pose(cam, T0, po)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pose_lm"] == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_float64_on_the_card_raises(card):
    cam = _camera(card, torch.float64)
    T0, po = _problem("random", 64, 2, card, torch.float64)
    with pytest.raises(ValueError, match="^pose_lm .*expected torch.float32"):
        optimize_pose(cam, T0, po)
