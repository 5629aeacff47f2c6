"""Sim3 refinement from two-way reprojection (optimizeSim3), torch.

Port of ``ydorbslam_tpu/optim/sim3_opt.py``, the replacement of
``Optimizer::optimizeSim3`` (src/optimizer.cpp:662-801): one Sim3 with
paired forward/inverse projection residuals, ``iters1`` damped
Gauss-Newton steps, a chi2 cut at ``CHI2``, ``iters2`` more steps on the
inliers, and the inlier count.  The Jacobian of the residuals in the
left-multiplied tangent perturbation is taken from the closed-form
residual at all 14 central-difference perturbations in one float64
batch (``geometry.sim3.tangent_jacobian``); the JAX package takes it
with ``jax.jacfwd``.  Every accept/reject and damping update stays on
the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.camera import CameraIntrinsics, project
from ..geometry.sim3 import inv_S, sim3_exp, tangent_jacobian

CHI2 = 9.999  # reference threshold for sim3 edges (optimizer.cpp:751 ~ 10)


def _residuals(cam: CameraIntrinsics, S12, p1_cam, p2_cam, obs1, obs2):
    """(..., N, 4): [err1(2): p2 through S12 vs obs1, err2(2): p1 through
    S21], for similarities S12 (..., 4, 4)."""
    S21 = inv_S(S12)
    p2_in_1 = p2_cam @ S12[..., :3, :3].transpose(-1, -2) + S12[..., None, :3, 3]
    p1_in_2 = p1_cam @ S21[..., :3, :3].transpose(-1, -2) + S21[..., None, :3, 3]
    return torch.cat(
        [project(cam, p2_in_1) - obs1, project(cam, p1_in_2) - obs2], dim=-1
    )


def optimize_sim3(
    cam: CameraIntrinsics,
    S12_init: torch.Tensor,
    p1_cam: torch.Tensor,
    p2_cam: torch.Tensor,
    obs1: torch.Tensor,
    obs2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    iters1: int = 5,
    iters2: int = 10,
    fix_scale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (S12 refined, inlier mask, n_inliers), the protocol of
    optimizer.cpp:742-801.  With ``fix_scale`` the scale's tangent
    component is pinned (a zero Jacobian column, a large diagonal and a
    zeroed step)."""
    dev = S12_init.device
    pin = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(torch.float32)
    eye7 = torch.eye(7, device=dev)
    w_obs = torch.cat([inv_sigma2_1[:, None].expand(-1, 2), inv_sigma2_2[:, None].expand(-1, 2)], -1)

    def chi2_parts(S):
        r = _residuals(cam, S, p1_cam, p2_cam, obs1, obs2)
        return (torch.sum(r[:, :2] ** 2, dim=-1) * inv_sigma2_1,
                torch.sum(r[:, 2:] ** 2, dim=-1) * inv_sigma2_2)

    f64 = [x.to(torch.float64) for x in (p1_cam, p2_cam, obs1, obs2)]
    pin64 = pin.to(torch.float64)

    def gn(S, active, iters):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        w = w_obs * active[:, None]
        for _ in range(iters):
            S64 = S.to(torch.float64)
            r0 = _residuals(cam, S, p1_cam, p2_cam, obs1, obs2)
            J = tangent_jacobian(
                lambda eps: _residuals(cam, sim3_exp(eps * pin64) @ S64, *f64), (), dev
            ).reshape(-1, 4, 7)  # (N,4,7)
            H = torch.einsum("nci,nc,ncj->ij", J, w, J)
            b = torch.einsum("nci,nc,nc->i", J, w, r0)
            if fix_scale:
                H = H + 1e6 * torch.diag(1.0 - pin)
            dx = -torch.linalg.solve_ex(H + lam * eye7 + 1e-8 * eye7, b)[0] * pin
            S_new = sim3_exp(dx) @ S
            cost_old = torch.sum(w * r0 * r0)
            r_new = _residuals(cam, S_new, p1_cam, p2_cam, obs1, obs2)
            accept = torch.sum(w * r_new * r_new) < cost_old
            S = torch.where(accept, S_new, S)
            lam = torch.where(accept, lam * 0.5, lam * 10.0)
        return S

    S = gn(S12_init, valid.to(torch.float32), iters1)
    c1, c2 = chi2_parts(S)
    inlier = valid & (c1 <= CHI2) & (c2 <= CHI2)
    S = gn(S, inlier.to(torch.float32), iters2)
    c1, c2 = chi2_parts(S)
    inlier = valid & (c1 <= CHI2) & (c2 <= CHI2)
    return S, inlier, torch.sum(inlier)
