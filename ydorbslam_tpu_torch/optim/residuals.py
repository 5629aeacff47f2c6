"""Robust-kernel helpers for the pose LM.

Port of the part of ``ydorbslam_tpu/optim/residuals.py`` the tracking
slice uses: g2o's Huber kernel as an IRLS weight and as a cost.
"""
from __future__ import annotations

import torch


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
