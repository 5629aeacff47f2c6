"""Projection and appearance matching on torch tensors.

Port of the tracking part of ``ydorbslam_tpu/slam/matchers.py``: the
motion-model search (``match_motion_model``, and its two-radius form
``match_motion_model_two``), the appearance-only fallback
(``match_dense``), the local-map search (``match_local_points``) and loop
closing's fusion search (``match_fuse_points``).  Every best/second search goes through the K2
dispatcher ``ops.hamming.proj_best2``: gates travel as per-row and
per-column attribute packs, the kernel (or its plain version) returns
per-row (idx, best, second), and ``_resolve_columns`` turns those into
a per-keypoint unique assignment (smallest distance wins a contested
keypoint, ties to the smaller row).  The JAX package takes this route
on the TPU; its CPU route builds the dense masked (M, N) matrix and
resolves it with ``resolve_unique``, and both give identical
assignments.

Shared constants: TH_HIGH=100, TH_LOW=50 (src/orbMatcher.cpp:7-9).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..ops.extractor import FrameFeatures
from ..ops.hamming import INVALID_DIST, proj_best2, rotation_histogram_mask
from ..ops.pyramid import scale_table

TH_HIGH = 100
TH_LOW = 50


def _pack_src_attr(u, v, ur, rad_narrow, rad_wide, oct_lo, oct_hi, valid):
    """Row-side attribute pack of ``proj_best2`` (lanes ``A_*``)."""
    f = torch.float32
    return torch.stack(
        [
            u.to(f), v.to(f), ur.to(f), rad_narrow.to(f), rad_wide.to(f),
            oct_lo.to(f), oct_hi.to(f), valid.to(f),
        ],
        dim=-1,
    )


def _pack_cur_attr(curr: FrameFeatures):
    """Column-side attribute pack (current-frame keypoints, lanes ``B_*``)."""
    f = torch.float32
    z = torch.zeros_like(curr.angle)
    return torch.stack(
        [
            curr.uv[:, 0].to(f), curr.uv[:, 1].to(f), curr.right_u.to(f),
            curr.octave.to(f), curr.valid.to(f), z, z, z,
        ],
        dim=-1,
    )


def _resolve_columns(idx, dist, row_ok, n_cols: int):
    """Per-column unique assignment from per-row best candidates.

    The smallest distance wins a contested column, ties to the smaller
    row index.  Returns (assign (N,) int32 row index or -1, dist (N,)
    int32, INVALID_DIST where unassigned)."""
    M = idx.shape[0]
    dev = idx.device
    ok = row_ok & (idx >= 0)
    big = INVALID_DIST * 16384
    rows = torch.arange(M, dtype=torch.int64, device=dev)
    key = torch.where(ok, dist.to(torch.int64) * M + rows, big)
    col = torch.where(ok, idx.to(torch.int64), n_cols)  # row n_cols is dropped
    colmin = torch.full((n_cols + 1,), big, dtype=torch.int64, device=dev)
    colmin = colmin.scatter_reduce(0, col, key, reduce="amin")[:n_cols]
    hit = colmin < big
    return (
        torch.where(hit, colmin % M, -1).to(torch.int32),
        torch.where(hit, colmin // M, INVALID_DIST).to(torch.int32),
    )


def resolve_unique(pair_dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row best -> per-column unique assignment, from a dense (M, N)
    distance matrix with INVALID_DIST where a pair is not a candidate.

    Each row keeps its lowest-distance column (the lowest column on a
    tie), then ``_resolve_columns`` applies its rule.  Returns (assign
    (N,) int32 row index or -1, dist (N,) int32)."""
    best, idx = torch.min(pair_dist, dim=1)
    return _resolve_columns(idx, best, best < INVALID_DIST, pair_dist.shape[1])


class ProjectedSources(NamedTuple):
    """Landmarks projected into the current frame, ready to match."""

    uv: torch.Tensor  # (M,2) predicted pixel coords
    ur: torch.Tensor  # (M,) predicted right-x
    depth: torch.Tensor  # (M,) camera-frame z
    dist: torch.Tensor  # (M,) distance to camera center
    valid: torch.Tensor  # (M,) bool (in front, in image)


def project_sources(
    cam: CameraIntrinsics, T_cw: torch.Tensor, p_w: torch.Tensor,
    valid: torch.Tensor, border: float = 0.0,
) -> ProjectedSources:
    """Project points (..., M, 3) through poses (..., 4, 4); a leading
    batch of poses projects a batch of point sets."""
    pc = p_w @ T_cw[..., :3, :3].transpose(-1, -2) + T_cw[..., None, :3, 3]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    ok = (
        valid
        & (z > 0.05)
        & (u >= border)
        & (u < cam.width - border)
        & (v >= border)
        & (v < cam.height - border)
    )
    dist = torch.linalg.norm(pc, dim=-1)
    return ProjectedSources(torch.stack([u, v], -1), ur, z, dist, ok)


def _finish(idx, best, max_dist, curr: FrameFeatures, src_angle, histo_bins=30):
    """Column resolution + rotation histogram of a per-row search."""
    assign, dist = _resolve_columns(idx, best, best <= max_dist, curr.valid.shape[0])
    matched = assign >= 0
    ang_src = src_angle[torch.clamp(assign, 0, src_angle.shape[0] - 1).to(torch.int64)]
    keep = rotation_histogram_mask(curr.angle, ang_src, matched, n_bins=histo_bins)
    return torch.where(keep, assign, -1), dist


def _motion_attr(cam, curr, last, last_landmarks_w, last_lm_valid, T_cw_pred,
                 T_cw_last, th_narrow, th_wide, n_levels, scale_factor):
    """Row-side pack of the motion-model search: projections of the last
    frame's landmarks, the forward/backward octave range and the
    window radius th * scale_factor^octave_last."""
    scales = scale_table(n_levels, scale_factor, curr.uv.device)
    proj = project_sources(cam, T_cw_pred, last_landmarks_w, last_lm_valid)
    T_rel = T_cw_pred @ inv_T(T_cw_last)
    tz = T_rel[2, 3]
    baseline = cam.bf / cam.fx
    forward = tz > baseline
    backward = tz < -baseline
    o = last.octave
    oct_lo = torch.where(forward, o, torch.where(backward, torch.zeros_like(o), o - 1))
    oct_hi = torch.where(
        forward, torch.full_like(o, n_levels), torch.where(backward, o, o + 1)
    )
    s = scales[last.octave.to(torch.int64)]
    return _pack_src_attr(
        proj.uv[:, 0], proj.uv[:, 1], proj.ur, th_narrow * s, th_wide * s,
        oct_lo, oct_hi, proj.valid,
    )


def match_motion_model_two(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    last: FrameFeatures,
    last_landmarks_w: torch.Tensor,
    last_lm_valid: torch.Tensor,
    T_cw_pred: torch.Tensor,
    T_cw_last: torch.Tensor,
    th_narrow: float = 7.0,
    th_wide: float = 14.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    max_dist: int = TH_HIGH,
    histo_bins: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last-frame -> current-frame projection match (motion model) at
    both window widths from ONE K2 launch.

    The reference searches with th=7 and repeats with 2*th when fewer
    than 20 matches come back (tracking.cpp:450-460); the narrow window
    is a subset of the wide one, so both come from one pass.  Octaves:
    forward motion (more than a baseline) needs current octave >= the
    last one, backward <=, otherwise within +-1; stereo right-x
    coherence is checked; the rotation histogram is applied.

    Returns (assign_narrow, assign_wide), each (N,) int32 into ``last``
    (-1 = unmatched)."""
    attr_a = _motion_attr(
        cam, curr, last, last_landmarks_w, last_lm_valid, T_cw_pred, T_cw_last,
        th_narrow, th_wide, n_levels, scale_factor,
    )
    (i_n, b_n, _), (i_w, b_w, _) = proj_best2(
        last.desc, attr_a, curr.desc, _pack_cur_attr(curr), check_ur=True
    )
    return (
        _finish(i_n, b_n, max_dist, curr, last.angle, histo_bins)[0],
        _finish(i_w, b_w, max_dist, curr, last.angle, histo_bins)[0],
    )


def match_motion_model(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    last: FrameFeatures,
    last_landmarks_w: torch.Tensor,
    last_lm_valid: torch.Tensor,
    T_cw_pred: torch.Tensor,
    T_cw_last: torch.Tensor,
    th: float = 7.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-radius motion-model search (radius th * scale^octave).
    Returns (assign (N,) into ``last`` or -1, dist (N,))."""
    attr_a = _motion_attr(
        cam, curr, last, last_landmarks_w, last_lm_valid, T_cw_pred, T_cw_last,
        th, th, n_levels, scale_factor,
    )
    (idx, best, _), _ = proj_best2(
        last.desc, attr_a, curr.desc, _pack_cur_attr(curr), check_ur=True
    )
    return _finish(idx, best, TH_HIGH, curr, last.angle)


def match_dense(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    angle_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    angle_b: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 0.7,
    use_rotation: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appearance-only matching between two descriptor sets (the
    reference's BoW searches as a dense search): TH_LOW gate,
    best/second ratio, rotation histogram.  The search is K2 with gates
    that pass every valid pair.

    Returns (assign (B,) index into a per b-keypoint or -1, dist (B,))."""
    f = torch.float32
    dev = desc_a.device
    M, B = desc_a.shape[0], desc_b.shape[0]
    za = torch.zeros((M,), dtype=f, device=dev)
    zb = torch.zeros((B,), dtype=f, device=dev)
    wide = torch.full((M,), 1e9, dtype=f, device=dev)
    attr_a = _pack_src_attr(za, za, za, wide, wide, za - 1.0, wide, valid_a)
    attr_b = torch.stack([zb, zb, zb - 1.0, zb, valid_b.to(f), zb, zb, zb], dim=-1)
    (idx, b1, b2), _ = proj_best2(desc_a, attr_a, desc_b, attr_b, check_ur=False)
    # A row with a single candidate has second = INVALID_DIST, which would
    # make the ratio test vacuous; clamp to 256, the reference's
    # bestDist2 initialization (orbMatcher.cpp:318).
    b2c = torch.clamp(b2, max=256)
    row_ok = (b1 <= max_dist) & (b1.to(f) < ratio * b2c.to(f))
    assign, dist = _resolve_columns(idx, b1, row_ok, B)
    matched = assign >= 0
    if use_rotation:
        ang_a = angle_a[torch.clamp(assign, 0, angle_a.shape[0] - 1).to(torch.int64)]
        matched = rotation_histogram_mask(angle_b, ang_a, matched)
    return torch.where(matched, assign, -1), dist


def predict_scale_level(
    dist: torch.Tensor, max_dist: torch.Tensor, n_levels: int, scale_factor: float
) -> torch.Tensor:
    """MapPoint::predictScaleLevel (src/mapPoint.cpp:251-278):
    level = ceil(log(max_dist / dist) / log(scale_factor)), clamped.
    The logarithm of the scale factor is taken in float32 and divided as
    a tensor, as in the JAX package."""
    dev = dist.device
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    log_sf = torch.log(torch.full((), scale_factor, dtype=torch.float32, device=dev))
    lvl = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def match_local_points(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    T_cw: torch.Tensor,
    mp_pos: torch.Tensor,
    mp_desc: torch.Tensor,
    mp_normal: torch.Tensor,
    mp_max_dist: torch.Tensor,
    mp_min_dist: torch.Tensor,
    mp_valid: torch.Tensor,
    th: float = 1.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ratio: float = 0.8,
    max_dist: int = TH_HIGH,
    return_visible: bool = False,
):
    """Local-map-point -> frame search (track-local-map): the frustum
    test (in image, distance band [0.8 min, 1.2 max], view cos > 0.5,
    frame.cpp:295-326) and the projection search (radius 2.5 if view cos
    > 0.998 else 4.0, times th and the predicted octave's scale; octaves
    in [pred-1, pred]; best/second ratio), orbMatcher.cpp:24-64.  One K2
    launch with ``check_ur=False``; the assignments equal those of the
    JAX package's dense CPU search (``search_by_projection``).

    Returns (assign (N,) map-point row per current keypoint or -1,
    dist (N,)), and with ``return_visible`` also the (P,) frustum mask
    (the points that count as visible, tracking.cpp:570-604)."""
    scales = scale_table(n_levels, scale_factor, mp_pos.device)
    proj = project_sources(cam, T_cw, mp_pos, mp_valid)
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    po = mp_pos - cam_center[None]
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * mp_normal, dim=-1) / torch.clamp(
        dist * torch.linalg.norm(mp_normal, dim=-1), min=1e-6
    )
    band_ok = (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
    frustum_ok = proj.valid & band_ok & (view_cos > 0.5)
    pred = predict_scale_level(dist, 1.2 * mp_max_dist, n_levels, scale_factor)
    big = torch.full_like(view_cos, 4.0)
    radius = torch.where(view_cos > 0.998, 2.5 * torch.ones_like(big), big) * scales[
        pred.to(torch.int64)
    ] * th
    attr_a = _pack_src_attr(
        proj.uv[:, 0], proj.uv[:, 1], proj.ur, radius, radius, pred - 1, pred, frustum_ok,
    )
    (idx, b1, b2), _ = proj_best2(
        mp_desc, attr_a, curr.desc, _pack_cur_attr(curr), check_ur=False
    )
    row_ok = (b1 <= max_dist) & (b1.to(torch.float32) < ratio * b2.to(torch.float32))
    res = _resolve_columns(idx, b1, row_ok, curr.valid.shape[0])
    return (*res, frustum_ok) if return_visible else res


def match_fuse_points(
    cam: CameraIntrinsics,
    target: FrameFeatures,
    T_cw: torch.Tensor,
    mp_pos: torch.Tensor,
    mp_desc: torch.Tensor,
    mp_normal: torch.Tensor,
    mp_max_dist: torch.Tensor,
    mp_min_dist: torch.Tensor,
    mp_valid: torch.Tensor,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop fusion's candidate search for one target keyframe
    (fuseBySim3, src/orbMatcher.cpp:746-807), the JAX package's
    ``_fuse_match_into_kf``: points projected with the target's
    (corrected) pose, in front and in the image, distance in the
    [0.8 min, 1.2 max] band, view cos >= 0.5, a 4 * scale^pred window,
    octaves [pred - 1, pred], best Hamming distance <= TH_LOW, no ratio
    test and no rotation check.  One K2 launch; the assignments equal
    those of the JAX package's dense ``search_by_projection``.

    Returns (assign (N,) point row per target keypoint or -1, dist (N,))."""
    scales = scale_table(n_levels, scale_factor, mp_pos.device)
    proj = project_sources(cam, T_cw, mp_pos, mp_valid)
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    po = mp_pos - cam_center[None]
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * mp_normal, dim=-1) / torch.clamp(
        dist * torch.linalg.norm(mp_normal, dim=-1), min=1e-6
    )
    band_ok = (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
    ok = proj.valid & band_ok & (view_cos >= 0.5)
    pred = predict_scale_level(dist, 1.2 * mp_max_dist, n_levels, scale_factor)
    radius = 4.0 * scales[pred.to(torch.int64)]
    attr_a = _pack_src_attr(
        proj.uv[:, 0], proj.uv[:, 1], proj.ur, radius, radius, pred - 1, pred, ok,
    )
    (idx, b1, _), _ = proj_best2(
        mp_desc, attr_a, target.desc, _pack_cur_attr(target), check_ur=False
    )
    return _resolve_columns(idx, b1, b1 <= TH_LOW, target.valid.shape[0])
