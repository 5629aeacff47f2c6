# Frozen copy of ydorbslam_tpu_torch/optim/pose.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
# Changed: the solve follows the dtype of the initial pose, so it runs in float64.
"""Pose-only bundle adjustment (motion-only LM on SE3), torch.

Port of ``ydorbslam_tpu/optim/pose.py`` (the reference's
``Optimizer::optimizePose``): 4 episodes x 10 LM iterations; after each
episode every valid observation is re-classified inlier/outlier by raw
chi2 (5.991 mono / 7.815 stereo); each episode restarts from the
INITIAL pose with the refined inlier set; the Huber kernel is dropped
from episode index 3 on.

The per-observation algebra is flat (N,) tensors and the 6x6 normal
equations are one whitened-Jacobian product ``H = J J^T``, as in the
JAX package.  Accept/reject and damping stay on the device
(``torch.where``), so the whole solve makes no host synchronization;
the 6x6 damped system is solved by Cholesky (``cholesky_ex``, which
does not check errors on the host) and two triangular solves.  A
failed factorization gives a non-finite step whose cost never wins,
so the step is rejected and the damping grows.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .camera import CameraIntrinsics
from .se3 import orthonormalize_T, se3_exp
from .residuals import huber_cost, huber_scale

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObservations(NamedTuple):
    """Fixed-capacity observation set for one frame."""

    p_w: torch.Tensor  # (N,3) world landmark positions
    obs_uvr: torch.Tensor  # (N,3) (uL,vL,uR) with uR ignored when not has_stereo
    inv_sigma2: torch.Tensor  # (N,) octave information weight
    has_stereo: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool


def _flat_project(cam: CameraIntrinsics, T: torch.Tensor, obs: PoseObservations):
    """Camera-frame coordinates and (u, v, uR) residuals, as (N,) tensors."""
    pc = obs.p_w @ T[:3, :3].T + T[:3, 3]
    x, y, zr = pc[:, 0], pc[:, 1], pc[:, 2]
    z = torch.clamp(zr, min=1e-6)
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = obs.obs_uvr - torch.stack([u, v, ur], dim=-1)
    return x, y, z, zr, iz, r


def _weights(obs: PoseObservations, mask: torch.Tensor):
    wu = obs.inv_sigma2 * mask.to(obs.inv_sigma2.dtype)
    wr = wu * obs.has_stereo.to(obs.inv_sigma2.dtype)
    return wu, wr


def _chi2(r: torch.Tensor, wu: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    return r[:, 0] ** 2 * wu + r[:, 1] ** 2 * wu + r[:, 2] ** 2 * wr


def _normal_equations(cam, T, obs: PoseObservations, active, use_huber: bool, delta2):
    """One flat pass: (H (6,6), b (6,), robust cost ())."""
    x, y, z, zr, iz, r = _flat_project(cam, T, obs)
    wu, wr = _weights(obs, active & (zr > 1e-3))
    chi2 = _chi2(r, wu, wr)
    if use_huber:
        cost = torch.sum(huber_cost(chi2, delta2))
        hub = huber_scale(chi2, delta2)
        wu, wr = wu * hub, wr * hub
    else:
        cost = torch.sum(chi2)

    iz2 = iz * iz
    a = cam.fx * iz
    c3 = -cam.fx * x * iz2
    d = cam.fy * iz
    e = -cam.fy * y * iz2
    cr = c3 + cam.bf * iz2
    zero = torch.zeros_like(a)
    Ju = torch.stack([-a, zero, -c3, -c3 * y, -(a * z - c3 * x), a * y])
    Jv = torch.stack([zero, -d, -e, -(-d * z + e * y), e * x, -d * x])
    Jr = torch.stack([-a, zero, -cr, -cr * y, -(a * z - cr * x), a * y])
    sw_u = torch.sqrt(wu)
    sw_r = torch.sqrt(wr)
    J = torch.cat([Ju * sw_u, Jv * sw_u, Jr * sw_r], dim=1)  # (6, 3N)
    r_w = torch.cat([r[:, 0] * sw_u, r[:, 1] * sw_u, r[:, 2] * sw_r])  # (3N,)
    return J @ J.T, J @ r_w, cost


def _classify(cam, T, obs: PoseObservations, delta2) -> torch.Tensor:
    _, _, _, zr, _, r = _flat_project(cam, T, obs)
    wu, wr = _weights(obs, torch.ones_like(obs.valid))
    return obs.valid & (_chi2(r, wu, wr) <= delta2) & (zr > 1e-3)


def _solve_spd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def _lm_refine(cam, T0, obs, active, iters: int, use_huber: bool, delta2):
    """LM with adaptive damping and a fixed iteration count, carrying the
    normal equations of the current pose (one projection pass per
    iteration)."""
    eye = torch.eye(6, dtype=T0.dtype, device=T0.device)
    H, b, cost = _normal_equations(cam, T0, obs, active, use_huber, delta2)
    T = T0
    lam = torch.full((), 1e-3, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        damped = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye
        dx = -_solve_spd6(damped, b)
        T_new = se3_exp(dx) @ T
        H_new, b_new, cost_new = _normal_equations(
            cam, T_new, obs, active, use_huber, delta2
        )
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        lam = torch.where(
            accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 4.0, max=1e4)
        )
        cost = torch.where(accept, cost_new, cost)
    return T


def optimize_pose(
    cam: CameraIntrinsics,
    T_cw_init: torch.Tensor,
    obs: PoseObservations,
    episodes: int = 4,
    iters_per_episode: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (T_cw (4,4), inlier mask (N,), n_inliers ()), all on the
    device; the count is matches minus outliers."""
    delta2 = torch.where(
        obs.has_stereo,
        torch.full((), CHI2_STEREO, dtype=T_cw_init.dtype, device=T_cw_init.device),
        torch.full((), CHI2_MONO, dtype=T_cw_init.dtype, device=T_cw_init.device),
    )
    inlier = obs.valid
    T = T_cw_init
    for epi in range(episodes):
        T = _lm_refine(
            cam, T_cw_init, obs, inlier, iters_per_episode, epi < 3, delta2
        )
        inlier = _classify(cam, T, obs, delta2)
    return orthonormalize_T(T), inlier, torch.sum(inlier)
