# Frozen copy of ydorbslam_tpu_torch/ops/fast.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
# Changed: the CUDA dispatch removed: the plain version runs on every device.
"""FAST-9/16 corner scores as whole-image tensor ops, and the K1
dispatcher.

Port of ``ydorbslam_tpu/ops/fast.py``.  A dense corner *score map* per
pyramid level:

  score(p) = max over the 16 contiguous 9-arcs of min (I_i - I(p)),
  taken for the bright and the dark branch, clamped at 0

which is the largest threshold at which the segment test still passes.
3x3 non-maximum suppression keeps a pixel's score when it is >= all 8
neighbours (ties survive); pixels outside ``[border, dim - border)`` are
zeroed.  ``fast_score_nms_levels`` runs score + NMS + border for every
level of a pyramid: on CUDA tensors it launches the hand-written kernel
(``csrc/fast_nms.cu``) once for all levels, on CPU tensors it takes the
plain version below.  Every step is a subtraction, min or max, so both
agree bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the 16 FAST offsets, (dx, dy), standard order).
FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def _arc_min(x: torch.Tensor) -> torch.Tensor:
    """Min over each cyclic 9-arc of the leading (16) axis, as the
    log-depth tree of the JAX package: spans 2, 4, 8, then 9."""
    m = torch.minimum(x, torch.roll(x, -1, dims=0))
    m2 = torch.minimum(m, torch.roll(m, -2, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -4, dims=0))
    return torch.minimum(m4, torch.roll(x, -8, dims=0))


def _fast_from_diffs(d: torch.Tensor) -> torch.Tensor:
    """(16, ...) circle-minus-centre differences -> (...) FAST score."""
    bright = torch.amax(_arc_min(d), dim=0)
    dark = torch.amax(_arc_min(-d), dim=0)
    return torch.clamp(torch.maximum(bright, dark), min=0.0)


def fast_score_map(image: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 corner score (max passing threshold), float32 (H, W).
    Pixels beyond the image are edge-replicated."""
    h, w = image.shape
    padded = F.pad(image[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    circle = torch.stack(
        [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_OFFSETS]
    )
    return _fast_from_diffs(circle - image[None])


def nms_and_border(score: torch.Tensor, border: int) -> torch.Tensor:
    """3x3 non-max suppression + border mask; returns suppressed scores
    (the reference's detection region is a 16 px margin)."""
    h, w = score.shape
    neighborhood = F.pad(score, (1, 1, 1, 1), value=-1.0)
    local_max = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = neighborhood[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            local_max = torch.maximum(local_max, shifted)
    is_peak = score >= local_max
    row = torch.arange(h, device=score.device)[:, None]
    col = torch.arange(w, device=score.device)[None, :]
    in_bounds = (
        (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    )
    return torch.where(is_peak & in_bounds, score, torch.zeros_like(score))


def fast_score_nms_levels(
    levels: Sequence[torch.Tensor], border: int
) -> Tuple[torch.Tensor, ...]:
    """K1: ``nms_and_border(fast_score_map(level), border)`` for every
    level of a pyramid.

    The plain version level by level, on any device."""
    levels = tuple(levels)
    return tuple(nms_and_border(fast_score_map(t), border) for t in levels)


def fast_score_nms(image: torch.Tensor, border: int) -> torch.Tensor:
    """K1 for one image: the one-level call of ``fast_score_nms_levels``."""
    return fast_score_nms_levels((image,), border)[0]


def two_threshold_mask(
    score: torch.Tensor, cell: int = 32, th_high: float = 20.0, th_low: float = 7.0
) -> torch.Tensor:
    """The reference's per-cell threshold fallback as a select.

    Each cell keeps score >= th_high if any pixel in it reaches th_high,
    else falls back to score >= th_low.  Failing pixels are zeroed.
    """
    h, w = score.shape
    ch, cw = -(-h // cell), -(-w // cell)
    padded = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cell_max = padded.reshape(ch, cell, cw, cell).amax(dim=(1, 3))
    th = torch.where(
        cell_max >= th_high,
        torch.full_like(cell_max, th_high),
        torch.full_like(cell_max, th_low),
    )
    th_full = th.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(score >= th_full, score, torch.zeros_like(score))


def fast_subpixel_offsets(patches: torch.Tensor) -> torch.Tensor:
    """Sub-pixel corner refinement from raw keypoint patches.

    ``patches``: (K, P, P) patches centred on detected corners (P odd,
    P >= 9).  Recomputes the FAST-9 score at the central 3x3 positions
    and fits a 1-D parabola per axis through the peak; returns (K, 2)
    float32 (dx, dy) offsets in [-0.5, 0.5].  Offsets are zero where a
    4-neighbour score is zero, the fit is not concave, or the centre is
    not the 3x3 maximum (see the JAX module for why).
    """
    K, P, _ = patches.shape
    c = P // 2
    x = patches.to(torch.float32)
    ctr = x[:, c - 1 : c + 2, c - 1 : c + 2]
    planes = [
        x[:, c - 1 + dy : c + 2 + dy, c - 1 + dx : c + 2 + dx]
        for dx, dy in FAST_OFFSETS
    ]
    s = _fast_from_diffs(torch.stack(planes) - ctr[None])  # (K, 3, 3)

    def parabola(lo, cen, hi):
        denom = lo - 2.0 * cen + hi
        off = 0.5 * (lo - hi) / torch.clamp(denom, max=-1e-6)
        return torch.where(
            denom < 0.0, torch.clamp(off, -0.5, 0.5), torch.zeros_like(off)
        )

    dx = parabola(s[:, 1, 0], s[:, 1, 1], s[:, 1, 2])
    dy = parabola(s[:, 0, 1], s[:, 1, 1], s[:, 2, 1])
    ok = (
        (s[:, 1, 0] > 0.0) & (s[:, 1, 2] > 0.0)
        & (s[:, 0, 1] > 0.0) & (s[:, 2, 1] > 0.0)
        & (s[:, 1, 1] >= s[:, 1, 0]) & (s[:, 1, 1] >= s[:, 1, 2])
        & (s[:, 1, 1] >= s[:, 0, 1]) & (s[:, 1, 1] >= s[:, 2, 1])
    )
    off = torch.stack([dx, dy], dim=-1)
    return torch.where(ok[:, None], off, torch.zeros_like(off))
