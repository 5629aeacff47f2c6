# Frozen copy of ydorbslam_tpu_torch/optim/residuals.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
"""Reprojection residuals, their Jacobians and the robust kernel.

Port of ``ydorbslam_tpu/optim/residuals.py``: g2o's edge types
(EdgeSE3ProjectXYZ[OnlyPose], EdgeStereoSE3ProjectXYZ[OnlyPose]) as
closed-form functions, and g2o's Huber kernel as an IRLS weight and as a
cost.  Pose increments are left-multiplied twists, ``T <- exp(xi) @ T``
with ``xi = [rho, phi]``; a stereo observation is ``(uL, vL, uR)`` with
``uR = uL - bf/z``, and a mono row carries a weight of 0 on its third
component.  Where the JAX package vmaps one observation, these functions
broadcast over leading batch dimensions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .camera import CameraIntrinsics
from .se3 import hat


def project_point(cam: CameraIntrinsics, T_cw: torch.Tensor, p_w: torch.Tensor):
    """World points (..., 3) -> (pc (..., 3), uvr (..., 3)) under the
    poses T_cw (..., 4, 4)."""
    pc = (T_cw[..., :3, :3] @ p_w[..., None])[..., 0] + T_cw[..., :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    return pc, torch.stack([u, v, ur], dim=-1)


def residual_and_jacobians(
    cam: CameraIntrinsics, T_cw: torch.Tensor, p_w: torch.Tensor, obs_uvr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals ``r = obs - predicted`` in (uL, vL, uR) and Jacobians.

    Returns (r (..., 3), J_pose (..., 3, 6), J_point (..., 3, 3), z (...,)),
    broadcast over the leading dimensions of T_cw, p_w and obs_uvr."""
    pc, pred = project_point(cam, T_cw, p_w)
    r = obs_uvr - pred
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * iz2], dim=-1)
    d_uvr_d_pc = torch.stack([du, dv, dur], dim=-2)  # (..., 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    d_pc_d_xi = torch.cat([eye, -hat(pc)], dim=-1)  # (..., 3, 6)
    J_pose = -(d_uvr_d_pc @ d_pc_d_xi)
    J_point = -(d_uvr_d_pc @ T_cw[..., :3, :3])
    return r, J_pose, J_point, pc[..., 2]


# One pose (4, 4) against N points (N, 3) and their observations (N, 3):
# the JAX package's vmap over N is the broadcast itself.
batched_residual_and_jacobians = residual_and_jacobians


def observation_weights(has_stereo: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    """(N, 3) per-component information weights: a mono row zeroes uR."""
    w = inv_sigma2[..., None].expand(inv_sigma2.shape + (3,))
    keep = torch.stack([torch.ones_like(has_stereo), torch.ones_like(has_stereo), has_stereo],
                       dim=-1)
    return torch.where(keep, w, 0.0)


def chi2_per_obs(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Raw chi-squared ``r^T Omega r`` per observation (no robust kernel,
    g2o's edge->chi2() used for inlier classification)."""
    return torch.sum(r * r * w, dim=-1)


def huber_scale(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS weight of g2o's Huber kernel: 1 inside delta^2,
    delta/sqrt(chi2) outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))


def huber_cost(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """Robustified cost rho(chi2) (for LM accept/reject decisions)."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, chi2, 2.0 * d * s - delta2)
