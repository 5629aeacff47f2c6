"""Closed-form similarity between two point sets (Horn 1987), torch.

Port of ``horn_sim3`` of ``ydorbslam_tpu/optim/horn.py``: the reference's
``Sim3Solver`` minimal solve (src/sim3Solver.cpp:134-206), the largest
eigenvector of the 4x4 quaternion matrix.  It broadcasts over leading
batch dimensions, so a whole RANSAC hypothesis batch is one
``torch.linalg.eigh`` over (B, 4, 4) in place of the JAX package's
``jax.vmap``.  An eigenvector is defined only up to its sign; R is
quadratic in the quaternion, so either sign gives the same R.

``ransac_sim3`` is loop verification's hypothesis stage (Sim3Solver's
RANSAC, sim3Solver.cpp:134-224): B minimal sets of three pairs, B Horn
solves in one batch, the two-way reprojection inlier test at 9.210 sigma^2,
the best hypothesis by its count (the first maximum), and one refit on
its inliers that is kept when it loses none.  The minimal sets come as
``picks=`` or from uniforms of a CPU ``torch.Generator``
(``optim.pnp.choice_picks``), as in relocalization.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.camera import CameraIntrinsics, project
from ..geometry.sim3 import inv_S, make_S


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = True) -> torch.Tensor:
    """Similarity aligning point sets: p1 ~= S @ p2.

    p1, p2: (..., N, 3).  Returns (..., 4, 4) S_12 (maps frame-2 points
    into frame 1); the scale is 1 for stereo/RGB-D (bFixScale,
    loopClosing.cpp:132)."""
    c1 = p1.mean(dim=-2)
    c2 = p2.mean(dim=-2)
    return _horn_centered(c1, c2, p1 - c1[..., None, :], p2 - c2[..., None, :], fix_scale)


def _horn_centered(c1, c2, q1, q2, fix_scale: bool) -> torch.Tensor:
    """Horn's solve from centroids (..., 3) and centred (possibly
    weighted) point sets (..., N, 3)."""
    # M = sum q1_i q2_i^T; maximise trace(R M^T) through the quaternion eigenvector.
    M = q1.transpose(-1, -2) @ q2
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    _, vecs = torch.linalg.eigh(N)
    q = vecs[..., :, -1]  # eigenvector of the largest eigenvalue, (w, x, y, z)
    # The eigenvector encodes the 2->1 rotation's conjugate; negate the
    # vector part to rotate frame-2 points into frame 1.
    w, x, y, z = q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        # Horn's symmetric scale: sqrt(sum|q1|^2 / sum|q2|^2).
        s = torch.sqrt(
            torch.sum(q1 * q1, dim=(-1, -2))
            / torch.clamp(torch.sum(q2 * q2, dim=(-1, -2)), min=1e-9)
        )
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return make_S(s, R, t)


class Sim3RansacResult(NamedTuple):
    S_12: torch.Tensor  # (4,4) best similarity
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int64
    ok: torch.Tensor  # () bool


def _two_way_inliers(cam, S12, p1, p2, obs1, obs2, s2_1, s2_2, valid):
    """(..., N) two-way reprojection inliers of similarities S12 (..., 4, 4)."""
    S21 = inv_S(S12)
    p2_in_1 = p2 @ S12[..., :3, :3].transpose(-1, -2) + S12[..., None, :3, 3]
    p1_in_2 = p1 @ S21[..., :3, :3].transpose(-1, -2) + S21[..., None, :3, 3]
    e1 = torch.sum((project(cam, p2_in_1) - obs1) ** 2, dim=-1)
    e2 = torch.sum((project(cam, p1_in_2) - obs2) ** 2, dim=-1)
    return (valid & (e1 < 9.210 * s2_1) & (e2 < 9.210 * s2_2)
            & (p2_in_1[..., 2] > 0) & (p1_in_2[..., 2] > 0))


def ransac_sim3(
    cam: CameraIntrinsics,
    p1_cam: torch.Tensor,  # (N,3) matched points in camera-1 frame
    p2_cam: torch.Tensor,  # (N,3) matched points in camera-2 frame
    sigma2_1: torch.Tensor,  # (N,) octave sigma^2 in frame 1
    sigma2_2: torch.Tensor,  # (N,)
    valid: torch.Tensor,  # (N,) bool
    n_hypotheses: int = 256,
    min_inliers: int = 20,
    fix_scale: bool = True,
    picks: Optional[torch.Tensor] = None,  # (B,3) minimal sets, else drawn
    generator: Optional[torch.Generator] = None,
) -> Sim3RansacResult:
    """Batched RANSAC over 3-point Horn hypotheses with the two-way
    reprojection test; no host synchronisation."""
    from .pnp import _draw, _pick

    if picks is None:
        picks = _draw(valid, (n_hypotheses, 3), generator)
    S_batch = horn_sim3(p1_cam[picks], p2_cam[picks], fix_scale=fix_scale)  # (B,4,4)
    obs1, obs2 = project(cam, p1_cam), project(cam, p2_cam)

    def inliers(S):
        return _two_way_inliers(cam, S, p1_cam, p2_cam, obs1, obs2, sigma2_1, sigma2_2, valid)

    inl = inliers(S_batch)  # (B,N)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=0, keepdim=True)  # the first maximum
    best_S, best_inl, n_best = _pick(S_batch, best), _pick(inl, best), _pick(counts, best)
    # Refit on the best hypothesis's inliers: masked centroids, weighted
    # centred points.
    w = best_inl.to(torch.float32)[:, None]
    nw = torch.clamp(n_best.to(torch.float32), min=1.0)
    c1 = torch.sum(torch.where(best_inl[:, None], p1_cam, 0.0), dim=0) / nw
    c2 = torch.sum(torch.where(best_inl[:, None], p2_cam, 0.0), dim=0) / nw
    S_fine = _horn_centered(c1, c2, (p1_cam - c1) * w, (p2_cam - c2) * w, fix_scale)
    S_fine = torch.where(n_best >= 3, S_fine, best_S)
    inl_fine = inliers(S_fine)
    n_fine = torch.sum(inl_fine)
    use_fine = n_fine >= n_best
    n_out = torch.where(use_fine, n_fine, n_best)
    return Sim3RansacResult(
        S_12=torch.where(use_fine, S_fine, best_S),
        inliers=torch.where(use_fine, inl_fine, best_inl),
        n_inliers=n_out,
        ok=(n_out >= min_inliers) & (torch.sum(valid) >= 3),
    )
