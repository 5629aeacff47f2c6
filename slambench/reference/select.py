# Frozen copy of ydorbslam_tpu_torch/ops/select.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
"""Spatially-uniform keypoint selection from dense score maps.

Port of ``ydorbslam_tpu/ops/select.py``: one winner per fixed 8x8 cell
(first maximum in row-major order within the cell), then the global
top-k cell winners for the per-level budget.

Tie order: ``jax.lax.top_k`` puts equal values in ascending index
order, and at level 0 FAST scores are integers, so ties are common.
``torch.topk`` does not promise that order; a stable descending sort
does, so the top-k here is ``torch.sort(descending=True, stable=True)``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

CELL = 8  # selection cell in pixels


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level keypoint budgets, geometric in 1/scale_factor."""
    q = 1.0 / scale_factor
    first = n_features * (1.0 - q) / (1.0 - q**n_levels)
    ks = [int(round(first * q**l)) for l in range(n_levels - 1)]
    ks.append(max(0, n_features - sum(ks)))
    return ks


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dimension with ties in ascending index order
    (the order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_cells(
    score: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick top-k spatially-spread keypoints from a suppressed score map.

    Returns (uv (k,2) float32 level coords, response (k,), valid (k,) bool).
    """
    h, w = score.shape
    ch, cw = -(-h // CELL), -(-w // CELL)
    padded = F.pad(score, (0, cw * CELL - w, 0, ch * CELL - h))
    cells = padded.reshape(ch, CELL, cw, CELL).permute(0, 2, 1, 3).reshape(
        ch * cw, CELL * CELL
    )
    cell_best, cell_arg = torch.max(cells, dim=1)
    top_vals, top_idx = stable_topk(cell_best, k)
    cell_y = top_idx // cw
    cell_x = top_idx % cw
    arg = cell_arg[top_idx]
    u = (cell_x * CELL + arg % CELL).to(torch.float32)
    v = (cell_y * CELL + arg // CELL).to(torch.float32)
    valid = top_vals > 0.0
    return torch.stack([u, v], dim=-1), top_vals, valid
