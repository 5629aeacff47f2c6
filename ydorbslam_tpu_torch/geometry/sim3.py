"""Sim(3) similarities on torch tensors.

Port of the packing and point-action part of
``ydorbslam_tpu/geometry/sim3.py``: ``make_S``, ``split_S``, ``inv_S`` and
``transform_points_S``.  A similarity ``(s, R, t)`` is one (...,4,4)
matrix ``S = [[s*R, t], [0, 1]]`` acting on points as ``p' = s R p + t``.
The tangent-space maps (``sim3_exp``, ``sim3_log``) and the SE(3)
conversions serve loop closing and come with it (ROADMAP slice 11).
"""
from __future__ import annotations

import torch

from .se3 import _EPS, make_T


def make_S(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack scale/rotation/translation into a (...,4,4) similarity matrix."""
    return make_T(s[..., None, None] * R, t)


def split_S(S: torch.Tensor):
    """(...,4,4) -> (s, R, t) with det(R)=+1."""
    sR = S[..., :3, :3]
    d = torch.linalg.det(sR)
    s = torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)  # real cube root
    R = sR / torch.clamp(s[..., None, None], min=_EPS)
    return s, R, S[..., :3, 3]


def inv_S(S: torch.Tensor) -> torch.Tensor:
    """Inverse similarity: (s,R,t)^-1 = (1/s, R^T, -1/s R^T t)."""
    s, R, t = split_S(S)
    s_inv = 1.0 / torch.clamp(s, min=_EPS)
    Rt = R.transpose(-1, -2)
    return make_S(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def transform_points_S(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a similarity to (...,N,3) points."""
    sR, t = S[..., :3, :3], S[..., :3, 3]
    return pts @ sR.transpose(-1, -2) + t[..., None, :]
