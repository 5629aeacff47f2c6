"""Closed-form similarity between two point sets (Horn 1987), torch.

Port of ``horn_sim3`` of ``ydorbslam_tpu/optim/horn.py``: the reference's
``Sim3Solver`` minimal solve (src/sim3Solver.cpp:134-206), the largest
eigenvector of the 4x4 quaternion matrix.  It broadcasts over leading
batch dimensions, so a whole RANSAC hypothesis batch is one
``torch.linalg.eigh`` over (B, 4, 4) in place of the JAX package's
``jax.vmap``.  An eigenvector is defined only up to its sign; R is
quadratic in the quaternion, so either sign gives the same R.
``ransac_sim3`` serves loop closing and comes with it (ROADMAP slice 11).
"""
from __future__ import annotations

import torch

from ..geometry.sim3 import make_S


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = True) -> torch.Tensor:
    """Similarity aligning point sets: p1 ~= S @ p2.

    p1, p2: (..., N, 3).  Returns (..., 4, 4) S_12 (maps frame-2 points
    into frame 1); the scale is 1 for stereo/RGB-D (bFixScale,
    loopClosing.cpp:132)."""
    c1 = p1.mean(dim=-2)
    c2 = p2.mean(dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
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
