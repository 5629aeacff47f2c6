"""Absolute pose RANSAC for relocalization, torch.

Port of ``ydorbslam_tpu/optim/pnp.py``: the primary 3-point 3D-3D solver
(``ransac_pose_3d3d``, Horn alignment of depth-backprojected frame points
to map points) and the depth-free fallback (``ransac_pnp``, 6-point DLT on
normalized coordinates with SVD re-orthonormalisation), both scoring
every hypothesis by the reference's per-octave chi-square reprojection
gate (pnpSolver.hpp:100-101).  The JAX package solves its hypotheses
under ``jax.vmap``; here a hypothesis batch is one set of (B, ...)
tensors: one (B, 4, 4) ``eigh``, one (B, 12, 12) ``svd`` and one (B, N)
inlier mask.

The minimal sets are drawn as ``jax.random.choice(key, n, (B, k),
replace=True, p=probs)`` draws them (jax 0.9): inverse-CDF sampling of
uniforms, ``choice_picks``.  The uniforms come from a ``torch.Generator``
on the CPU, so a card run and a CPU run draw the same ones; a caller may
also pass the picks themselves (``picks=``), as the tests pass the JAX
package's.  When no point is eligible every pick is index 0, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import make_T
from .horn import horn_sim3

MIN_SET = 6


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # (4,4)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int64
    ok: torch.Tensor  # () bool


def choice_picks(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn with probabilities ``probs`` (N,) from uniforms ``u``
    in [0, 1): ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` on the
    left side, jax.random.choice's formula with replacement."""
    cdf = torch.cumsum(probs, dim=0)
    return torch.searchsorted(cdf, cdf[-1] * (1 - u))


def _draw(eligible: torch.Tensor, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Minimal sets (shape) of indices of ``eligible`` points, uniform
    over them, from uniforms drawn on the CPU."""
    probs = eligible.to(torch.float32)
    probs = probs / torch.clamp(probs.sum(), min=1e-6)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    if eligible.is_cuda:  # from pinned memory the upload does not stall the host
        u = u.pin_memory().to(eligible.device, non_blocking=True)
    return choice_picks(probs, u)


def _inliers(cam: CameraIntrinsics, T, p_w, uv, sigma2, valid, chi2: float):
    """(..., N) chi-square reprojection inliers of poses T (..., 4, 4)."""
    pc = p_w @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    return valid & (pc[..., 2] > 0.05) & (e2 <= chi2 * sigma2)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a (1,) index tensor, without reading it on the host."""
    return torch.index_select(x, 0, i)[0]


def _dlt_pose(p_w: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """(..., 6, 3) world points + (..., 6, 2) normalized image coords ->
    (..., 4, 4) T_cw.  Rows of A are the two cross-product constraints
    of x_n ~ [R|t] X per point; the null vector is reshaped to [R|t] and
    projected to SE(3)."""
    X = torch.cat([p_w, torch.ones_like(p_w[..., :1])], dim=-1)  # (..., 6, 4)
    zeros = torch.zeros_like(X)
    r1 = torch.cat([X, zeros, -xn[..., 0:1] * X], dim=-1)
    r2 = torch.cat([zeros, X, -xn[..., 1:2] * X], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 12, 12)
    _, _, vt = torch.linalg.svd(A)
    P = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
    # Scale so that R has unit determinant; fix the sign with point depths.
    U, s, Vt = torch.linalg.svd(P[..., :3])
    R = U @ Vt
    sd = torch.sign(torch.linalg.det(R))
    R = R * sd[..., None, None]
    scale = torch.sum(s, dim=-1) / 3.0 * sd
    t = P[..., 3] / torch.where(torch.abs(scale) > 1e-9, scale, 1e-9)[..., None]
    # Resolve the global sign: points must be in front of the camera.
    z = (p_w @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    flip = torch.sum(torch.sign(z), dim=-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # Re-orthonormalise after the possible flip (det must stay +1).
    U2, _, Vt2 = torch.linalg.svd(R)
    d = torch.linalg.det(U2 @ Vt2)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return make_T(U2 @ D @ Vt2, t)


def ransac_pose_3d3d(
    cam: CameraIntrinsics,
    p_w: torch.Tensor,  # (N,3) map points (world)
    p_cam: torch.Tensor,  # (N,3) frame points from depth backprojection
    uv: torch.Tensor,  # (N,2) frame observations
    sigma2: torch.Tensor,  # (N,) octave variance
    has_depth: torch.Tensor,  # (N,) depth measured (eligible for minimal sets)
    valid: torch.Tensor,  # (N,)
    n_hypotheses: int = 256,
    min_inliers: int = 10,
    chi2: float = 5.991,
    picks: Optional[torch.Tensor] = None,  # (B,3) minimal sets, else drawn
    generator: Optional[torch.Generator] = None,
) -> PnPResult:
    """Pose RANSAC from 3-point Horn alignments of 3D-3D pairs, scored by
    reprojection, then one Horn refit on the best hypothesis's inliers
    with depth; the refit is kept when it has at least as many inliers.
    The non-inliers of the refit are collapsed onto the weighted
    centroid, so every point enters it with weight 0 or 1."""
    if picks is None:
        picks = _draw(valid & has_depth, (n_hypotheses, 3), generator)
    T_batch = horn_sim3(p_cam[picks], p_w[picks], fix_scale=True)
    inl = _inliers(cam, T_batch, p_w, uv, sigma2, valid, chi2)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=0, keepdim=True)
    ref_mask = _pick(inl, best) & has_depth
    w = ref_mask.to(torch.float32)[:, None]
    nw = torch.clamp(torch.sum(w), min=3.0)
    c_cam = torch.sum(p_cam * w, dim=0) / nw
    c_w = torch.sum(p_w * w, dim=0) / nw
    T_fine = horn_sim3((p_cam - c_cam) * w + c_cam, (p_w - c_w) * w + c_w, fix_scale=True)
    inl_fine = _inliers(cam, T_fine, p_w, uv, sigma2, valid, chi2)
    use = torch.sum(inl_fine) >= _pick(counts, best)
    T_out = torch.where(use, T_fine, _pick(T_batch, best))
    inl_out = torch.where(use, inl_fine, _pick(inl, best))
    n_out = torch.sum(inl_out)
    return PnPResult(T_out, inl_out, n_out, n_out >= min_inliers)


def ransac_pnp(
    cam: CameraIntrinsics,
    p_w: torch.Tensor,  # (N,3)
    uv: torch.Tensor,  # (N,2) undistorted pixels
    sigma2: torch.Tensor,  # (N,) octave variance
    valid: torch.Tensor,  # (N,)
    n_hypotheses: int = 256,
    min_inliers: int = 10,
    chi2: float = 5.991,
    picks: Optional[torch.Tensor] = None,  # (B,6) minimal sets, else drawn
    generator: Optional[torch.Generator] = None,
) -> PnPResult:
    """Batched-hypothesis DLT-PnP RANSAC with the per-octave chi-square
    gate (pnpSolver parameters 0.99/10/300/4/0.5/5.991,
    tracking.cpp:657-658; the 300 sequential iterations become one
    batch)."""
    if picks is None:
        picks = _draw(valid, (n_hypotheses, MIN_SET), generator)
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    T_batch = _dlt_pose(p_w[picks], xn[picks])
    inl = _inliers(cam, T_batch, p_w, uv, sigma2, valid, chi2)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=0, keepdim=True)
    n_best = _pick(counts, best)
    return PnPResult(_pick(T_batch, best), _pick(inl, best), n_best, n_best >= min_inliers)
