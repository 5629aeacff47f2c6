"""Stereo matching and RGB-D depth association for a frame.

Port of ``ydorbslam_tpu/ops/stereo.py`` (the reference's
``Frame::computeStereoMatches`` and ``Frame::computeStereoFromRGBD``).
The RGB-D lookup is a plain gather ``depth[vi, ui]``; the TPU's one-hot
row matmul is not carried over.

``stereo_match`` keeps the JAX package's arithmetic: the masked dense
(N, N) Hamming matrix (row band, octave agreement, disparity range),
the SAD slide of center-normalized 11x11 windows, the parabola fit and
the median cut.  The JAX package evaluates the SAD strips of every
keypoint at all 8 levels and selects one; here each keypoint reads its
own octave only.  The edge-padded levels of both images lie in one flat
buffer with a per-level offset and stride, and one indexed read fetches
every keypoint's (11, 11) left patch and (11, 21) right strip, with the
row and column clamping of the JAX package's ``extract_patches``.  The
whole function has static shapes and never reads the device.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.camera import CameraIntrinsics
from .extractor import FrameFeatures
from .hamming import masked_distance_matrix
from .pyramid import scale_table

SAD_W = 5  # SAD half-window (reference w=5 -> 11x11, frame.cpp:417)
SAD_L = 5  # slide range +-5 (frame.cpp:421)
TH_HIGH = 100
_PAD = SAD_W + SAD_L + 2  # level pad for strip extraction


def fill_depth_from_rgbd(
    feats: FrameFeatures, depth_image: torch.Tensor, cam: CameraIntrinsics
) -> FrameFeatures:
    """Fill (depth, right_u) from a registered float32 depth map (metres).

    Depth is read at the RAW keypoint coords and the virtual right-image
    x is derived from the UNDISTORTED x, the reference's convention."""
    h, w = depth_image.shape
    ui = torch.clamp(torch.round(feats.uv_raw[:, 0]).to(torch.int64), 0, w - 1)
    vi = torch.clamp(torch.round(feats.uv_raw[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_image[vi, ui]
    ok = feats.valid & (d > 0.0)
    minus_one = torch.full_like(d, -1.0)
    right_u = torch.where(ok, feats.uv[:, 0] - cam.bf / torch.clamp(d, min=1e-6), minus_one)
    depth = torch.where(ok, d, minus_one)
    return feats._replace(depth=depth, right_u=right_u)


@functools.lru_cache()
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """(4, 2L) int64 on ``device``: offset, row stride (= padded width),
    padded height and padded width of each padded level in the flat
    buffer of ``_flat_levels`` (the L left levels, then the L right
    ones).  Copied to the card once, from pinned memory."""
    dims = [(h + 2 * _PAD, w + 2 * _PAD) for h, w in shapes] * 2
    sizes = [hp * wp for hp, wp in dims]
    tab = np.array([np.cumsum([0] + sizes[:-1]), [wp for _, wp in dims],
                    [hp for hp, _ in dims], [wp for _, wp in dims]], dtype=np.int64)
    t = torch.from_numpy(tab)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def _flat_levels(pyr_l: Sequence[torch.Tensor], pyr_r: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every level of both pyramids, edge-padded by ``_PAD``, flattened
    into one float32 buffer (left levels first)."""
    pads = [F.pad(lv[None, None], (_PAD,) * 4, mode="replicate").reshape(-1)
            for lv in (*pyr_l, *pyr_r)]
    return torch.cat(pads)


def _windows(table, level, u, v, half_cols):
    """(K, 2*SAD_W+1, 2*half_cols+1) flat-buffer indices of the windows
    centred at the rounded (u, v) (padded-level coords) of padded level
    ``level`` (K,): rows clamped into the level one by one, the column
    window's start clamped so the window fits, as the JAX package's
    ``extract_patches`` (row gather + ``dynamic_slice``) does."""
    dev = table.device
    off, stride, hp, wp = (table[i][level] for i in range(4))
    p = 2 * half_cols + 1
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    d = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    rows = torch.minimum(torch.clamp(vi[:, None] + d[None, :], min=0), hp[:, None] - 1)
    c0 = torch.clamp(torch.minimum(ui - half_cols, wp - p), min=0)
    cols = c0[:, None] + torch.arange(p, device=dev)[None, :]
    return (off[:, None, None] + rows[:, :, None] * stride[:, None, None]
            + cols[:, None, :])


def sad_costs(
    pyr_l: Sequence[torch.Tensor], pyr_r: Sequence[torch.Tensor],
    octave: torch.Tensor, uv_l: torch.Tensor, ur: torch.Tensor,
) -> torch.Tensor:
    """(N, 2*SAD_L+1) SAD costs of each keypoint at its own octave.

    ``uv_l`` (N, 2) is the left keypoint and ``ur`` (N,) the matched
    right x, both in the coords of level ``octave``.  Center-normalized
    11x11 windows (the reference subtracts the window center,
    frame.cpp:418-420,427-429) slid +-SAD_L around ``ur``: the JAX
    package's ``_sad_costs_at_level`` at the keypoint's octave."""
    n_levels = len(pyr_l)
    flat = _flat_levels(pyr_l, pyr_r)
    table = _level_table(tuple(tuple(lv.shape) for lv in pyr_l), flat.device)
    lvl = octave.to(torch.int64)
    strip_half = SAD_W + SAD_L
    idx = torch.cat([
        _windows(table, lvl, uv_l[:, 0] + _PAD, uv_l[:, 1] + _PAD, SAD_W),
        _windows(table, lvl + n_levels, ur + _PAD, uv_l[:, 1] + _PAD, strip_half),
    ], dim=2)
    win = flat[idx]  # (N, 11, 11 + 21): one read for patches and strips
    patches = win[:, :, : 2 * SAD_W + 1]
    patches = patches - patches[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    strips = win[:, :, 2 * SAD_W + 1 :]
    offs = []
    for off in range(2 * SAD_L + 1):
        w = strips[:, :, off : off + 2 * SAD_W + 1]
        w = w - w[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        offs.append(torch.sum(torch.abs(patches - w), dim=(1, 2)))
    return torch.stack(offs, dim=-1)


def stereo_match(
    feats_l: FrameFeatures,
    feats_r: FrameFeatures,
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    cam: CameraIntrinsics,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameFeatures:
    """Rectified stereo association: fills (depth, right_u) of the left
    frame (src/frame.cpp:362-471, as the JAX package):

      1. dense Hamming matrix masked by the row band (+-2 sigma of the
         left octave), octave agreement (+-1) and disparity in [-2, fx];
      2. best match per left keypoint (first index on a tie), <= TH_HIGH;
      3. SAD slide at the left keypoint's octave + parabola fit;
      4. the median(SAD) outlier cut at 1.5*1.4*median.
    """
    scales = scale_table(n_levels, scale_factor, feats_l.uv.device)
    ul, vl = feats_l.uv_raw[:, 0], feats_l.uv_raw[:, 1]
    ur_kp, vr_kp = feats_r.uv_raw[:, 0], feats_r.uv_raw[:, 1]
    sigma_l = scales[feats_l.octave.to(torch.int64)]

    max_d = cam.fx  # min depth = baseline -> max disparity = fx (frame.cpp:365)
    band = 2.0 * sigma_l[:, None]
    row_ok = torch.abs(vr_kp[None, :] - vl[:, None]) <= band
    oct_ok = torch.abs(feats_r.octave[None, :] - feats_l.octave[:, None]) <= 1
    disp = ul[:, None] - ur_kp[None, :]
    disp_ok = (disp >= -2.0) & (disp <= max_d)
    d = masked_distance_matrix(
        feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid,
        row_ok & oct_ok & disp_ok,
    )
    best_j = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_j[:, None])[:, 0]
    cand_ok = best_d <= TH_HIGH

    inv_s = 1.0 / sigma_l
    uv_scaled = feats_l.uv_raw * inv_s[:, None]
    ur0 = ur_kp[best_j] * inv_s
    costs = sad_costs(pyr_l, pyr_r, feats_l.octave, uv_scaled, ur0)

    inc = torch.argmin(costs, dim=1)
    inner = (inc >= 1) & (inc <= 2 * SAD_L - 1)
    incc = torch.clamp(inc, 1, 2 * SAD_L - 1)
    c0 = torch.gather(costs, 1, incc[:, None] - 1)[:, 0]
    c1 = torch.gather(costs, 1, incc[:, None])[:, 0]
    c2 = torch.gather(costs, 1, incc[:, None] + 1)[:, 0]
    denom = torch.clamp(2.0 * (c0 + c2 - 2.0 * c1), min=1e-6)
    delta = (c0 - c2) / denom
    sub_ok = inner & (torch.abs(delta) <= 1.0)

    # The windows sit at the ROUNDED level-scaled x on both sides, so the
    # rounding residual of the left x goes back into the matched right x
    # (the JAX package's frac_u: without it, every octave > 0 keypoint
    # gets a [-0.5, 0.5] px level-scale disparity bias).
    frac_u = uv_scaled[:, 0] - torch.round(uv_scaled[:, 0])
    best_ur = (
        torch.round(ur0) + (incc - SAD_L).to(torch.float32) + delta + frac_u
    ) * sigma_l
    # best_ur moves into undistorted space by the left keypoint's own
    # undistortion shift (rectified stereo shares the row map); the
    # expression keeps the JAX package's order of operations.
    disparity = feats_l.uv[:, 0] - (best_ur + (feats_l.uv[:, 0] - ul))
    disparity = torch.clamp(disparity, min=-1.0)
    # The 0.3 px disparity floor caps depth at ~3.3*fx baselines: the
    # near-zero disparities of a dense matcher would otherwise make
    # points at huge depth that destabilize float32 bundle adjustment.
    pos_ok = (disparity > 0.3) & (disparity < max_d)
    minus_one = torch.full_like(disparity, -1.0)
    depth = torch.where(pos_ok, cam.bf / torch.clamp(disparity, min=1e-6), minus_one)

    ok = feats_l.valid & cand_ok & sub_ok & pos_ok

    # Median outlier cut on the best SAD costs (frame.cpp:452-470):
    # sorted[n_ok // 2], the upper median for an even count, read with a
    # gather so the count stays on the device.
    best_cost = c1
    inf = torch.full_like(best_cost, float("inf"))
    sorted_costs, _ = torch.sort(torch.where(ok, best_cost, inf))
    n_ok = torch.sum(ok)
    mid = torch.clamp(n_ok // 2, 0, feats_l.uv.shape[0] - 1)
    median = torch.gather(sorted_costs, 0, mid.reshape(1))[0]
    median = torch.where(torch.isfinite(median), median, torch.zeros_like(median))
    ok = ok & (best_cost <= 1.5 * 1.4 * median)

    return feats_l._replace(
        depth=torch.where(ok, depth, minus_one),
        right_u=torch.where(ok, feats_l.uv[:, 0] - disparity, minus_one),
    )
