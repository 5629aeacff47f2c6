"""Device-resident pipelined tracking: one dispatch and no host wait per frame.

Port of ``ydorbslam_tpu/slam/pipeline.py``.  The whole per-frame state
machine of tracking runs on the device over a ``TrackState``: extraction
(K1; twice for a stereo pair), depth association (the RGB-D depth map,
or ``stereo_match`` for a stereo pair), the motion-model
search at both window radii (one K2 launch), the appearance fallback
against the last frame (K2), the pose LM, the local-map search (K2) and
its LM, the found/visible accumulators and the keyframe-decision
counters.  The tracking mode (INIT/OK/LOST) is device state, and every
branch of the JAX package's ``lax`` selects is a ``torch.where``: the
step has no Python ``if`` on a tensor and reads nothing back to the host,
so a frame that is not drained makes no host wait.

Each frame's packed outcome (``FrameInfo``, ``INFO_DIM`` floats), its
features, map-point ids and pose land in a ring of ``RING`` slots that
``SlamSystem`` reads a few frames late, one read of ``ring_info`` per
drain.  The host names the slot from its own frame counter
(``frame_id % RING``); ``read_ring`` returns copies, so a slot written
``RING`` frames later does not change what the host kept.

Integer sums (the found counters, ``fold_track_counters``) go through
``ops.scatter.scatter_add``: exact on every device, out-of-range rows
dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import CameraIntrinsics, backproject
from ..geometry.se3 import inv_T
from ..ops.extractor import FrameFeatures, _extract_orb_pyramid, empty_features, extract_orb
from ..ops.scatter import scatter_add
from ..ops.stereo import fill_depth_from_rgbd, stereo_match
from ..optim.pose import PoseObservations, optimize_pose
from .map_state import MapState
from .matchers import match_dense, match_local_points, match_motion_model_two

MODE_INIT = 0
MODE_OK = 1
MODE_LOST = 2

RING = 16  # on-device frame ring size (frames + packed info)


class TrackSet(NamedTuple):
    """Local tracking map (refreshed by the host after keyframes)."""

    pts: torch.Tensor  # (P,) global map-point ids, -1 where empty
    pos: torch.Tensor  # (P,3)
    desc: torch.Tensor  # (P,8) int32 views of the uint32 words
    normal: torch.Tensor  # (P,3)
    dmax: torch.Tensor  # (P,)
    dmin: torch.Tensor  # (P,)
    valid: torch.Tensor  # (P,) bool
    # 0-dim: the reference keyframe's tracked count already multiplied by
    # the reference ratio (0.4 with < 2 keyframes, else kf_ref_ratio;
    # tracking.cpp:755-760), made at the refresh.
    ref_thresh: torch.Tensor


class TrackState(NamedTuple):
    mode: torch.Tensor  # 0-dim int32
    T_cw: torch.Tensor  # (4,4)
    velocity: torch.Tensor  # (4,4)
    last: FrameFeatures
    last_lms: torch.Tensor  # (N,3)
    last_lms_valid: torch.Tensor  # (N,)
    ring_feats: FrameFeatures  # every field with a leading (RING,)
    ring_mpid: torch.Tensor  # (RING,N) int32
    ring_T: torch.Tensor  # (RING,4,4)
    ring_info: torch.Tensor  # (RING, INFO_DIM) packed per-frame outcomes
    frame_idx: torch.Tensor  # 0-dim int32
    since_reloc: torch.Tensor  # 0-dim int32: frames since the last relocalization
    # Found/visible accumulators indexed by TRACKING-SET ROW, folded into
    # the map (fold_track_counters) at each drain and before each refresh;
    # the input of the 0.25 found-ratio cull (localMapping.cpp:90-108).
    vis_acc: torch.Tensor  # (P,) int32
    found_acc: torch.Tensor  # (P,) int32


INFO_DIM = 21  # [mode, ok, n_inliers, need_kf, slot, T_cw(16)]


class FrameInfo(NamedTuple):
    """Host-side view of one packed info row."""

    mode: int
    ok: bool
    n_inliers: int
    need_kf: bool
    ring_slot: int
    T_cw: np.ndarray

    @staticmethod
    def unpack(row: np.ndarray) -> "FrameInfo":
        return FrameInfo(
            mode=int(row[0]),
            ok=bool(row[1] > 0.5),
            n_inliers=int(row[2]),
            need_kf=bool(row[3] > 0.5),
            ring_slot=int(row[4]),
            T_cw=row[5:21].reshape(4, 4).astype(np.float64),
        )


def empty_track_state(n: int, n_track_pts: int = 8192, device="cuda") -> TrackState:
    """A ``TrackState`` in MODE_INIT with ``n`` keypoint rows and
    ``n_track_pts`` tracking-set rows, on ``device`` (the card unless the
    caller asks for another)."""
    ef = empty_features(n, device)
    eye = torch.eye(4, device=device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return TrackState(
        mode=i32(MODE_INIT),
        T_cw=eye,
        velocity=eye.clone(),
        last=ef,
        last_lms=torch.zeros((n, 3), device=device),
        last_lms_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        ring_feats=FrameFeatures(*(torch.stack([a] * RING) for a in ef)),
        ring_mpid=torch.full((RING, n), -1, dtype=torch.int32, device=device),
        ring_T=eye.repeat(RING, 1, 1),
        ring_info=torch.zeros((RING, INFO_DIM), device=device),
        frame_idx=i32(0),
        since_reloc=i32(1 << 20),
        vis_acc=torch.zeros((n_track_pts,), dtype=torch.int32, device=device),
        found_acc=torch.zeros((n_track_pts,), dtype=torch.int32, device=device),
    )


def rgbd_frame_step(
    state: TrackState,
    gray: torch.Tensor,
    depth: torch.Tensor,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: torch.Tensor,
    depth_threshold: torch.Tensor,
    slot: int,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    min_motion: int = 10,
    min_local: int = 30,
    min_init: int = 500,
    min_after_reloc: int = 50,
    fps: int = 30,
    close_tracked_max: int = 100,
    close_untracked_min: int = 70,
    loc_mode: bool = False,
    depth_scale=1.0,
    subpixel: bool = True,
) -> TrackState:
    """One full RGB-D tracking step on the device; the packed outcome
    lands in ``ring_info[slot]`` (``slot`` is the host's frame counter
    modulo ``RING``).  The ring buffers of ``state`` are written in place;
    the returned state shares them.

    ``gray`` may be uint8 and ``depth`` uint16 (the sensor-native TUM
    encodings, with ``depth_scale`` = 1/DepthMapFactor, a float32 0-dim
    tensor or a float); both convert on the device, as in the JAX
    package (a multiplication by the scale)."""
    feats = extract_orb(
        gray, cam, n_features=n_features, capacity=capacity, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low, has_distortion=False,
        subpixel=subpixel,
    )
    feats = fill_depth_from_rgbd(feats, depth.to(torch.float32) * depth_scale, cam)
    return _track_core(
        state, feats, trkset, cam, inv_sigma2_tab, depth_threshold, slot, n_levels,
        scale_factor, min_motion, min_local, min_init, min_after_reloc, fps,
        close_tracked_max, close_untracked_min, loc_mode,
    )


def stereo_frame_step(
    state: TrackState,
    gray_l: torch.Tensor,
    gray_r: torch.Tensor,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: torch.Tensor,
    depth_threshold: torch.Tensor,
    slot: int,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    min_motion: int = 10,
    min_local: int = 30,
    min_init: int = 500,
    min_after_reloc: int = 50,
    fps: int = 30,
    close_tracked_max: int = 100,
    close_untracked_min: int = 70,
    loc_mode: bool = False,
    subpixel: bool = True,
) -> TrackState:
    """One full stereo tracking step on the device: the two extractions
    (K1 twice), ``stereo_match`` on the pyramids they built, and the
    shared tracking core, as ``rgbd_frame_step``.

    The pair is uint8 or float32, both the same.  The JAX package builds
    the match's pyramids again from the frames as they come, so for a
    uint8 pair its level 0 is uint8 and the SAD costs of octave-0
    keypoints wrap modulo 256; levels 1-7 are float32 either way.  The
    extraction's float32 pyramids give the same levels, and
    ``wrap_level0`` gives the same octave-0 costs."""
    if gray_l.dtype != gray_r.dtype:
        raise ValueError(f"stereo pair of two dtypes: {gray_l.dtype}, {gray_r.dtype}")
    kw = dict(n_features=n_features, capacity=capacity, n_levels=n_levels,
              scale_factor=scale_factor, th_high=th_high, th_low=th_low, has_distortion=False,
              subpixel=subpixel)
    fl, pyr_l = _extract_orb_pyramid(gray_l, cam, **kw)
    fr, pyr_r = _extract_orb_pyramid(gray_r, cam, **kw)
    feats = stereo_match(fl, fr, pyr_l, pyr_r, cam, n_levels, scale_factor,
                         wrap_level0=gray_l.dtype == torch.uint8)
    return _track_core(
        state, feats, trkset, cam, inv_sigma2_tab, depth_threshold, slot, n_levels,
        scale_factor, min_motion, min_local, min_init, min_after_reloc, fps,
        close_tracked_max, close_untracked_min, loc_mode,
    )


def _track_core(
    state: TrackState,
    feats: FrameFeatures,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: torch.Tensor,
    depth_threshold: torch.Tensor,
    slot: int,
    n_levels: int,
    scale_factor: float,
    min_motion: int,
    min_local: int,
    min_init: int,
    min_after_reloc: int,
    fps: int,
    close_tracked_max: int,
    close_untracked_min: int,
    loc_mode: bool,
) -> TrackState:
    n = feats.valid.shape[0]
    dev = feats.valid.device
    eye = torch.eye(4, device=dev)
    n_depth = torch.sum(feats.valid & (feats.depth > 0))
    octave = feats.octave.to(torch.int64)
    obs_uvr = torch.cat([feats.uv, feats.right_u[:, None]], -1)

    # ---------- initialization: > min_init depth keypoints (tracking.cpp:337)
    can_init = (state.mode == MODE_INIT) & (n_depth >= min_init)

    # ---------- motion-model tracking: both radii from one K2 launch
    T_pred = state.velocity @ state.T_cw
    assign7, assign14 = match_motion_model_two(
        cam, feats, state.last, state.last_lms, state.last_lms_valid, T_pred, state.T_cw,
        th_narrow=7.0, th_wide=14.0, n_levels=n_levels, scale_factor=scale_factor,
    )
    use_wide = torch.sum(assign7 >= 0) < 20
    assign = torch.where(use_wide, assign14, assign7)
    # ---------- fallback: appearance match against the last frame
    # (trackReferenceKeyFrame, tracking.cpp:375-406), chosen on match
    # counts before the LM so that one pose LM serves both branches.
    motion_viable = torch.sum(assign >= 0) >= 20
    fb_assign, _ = match_dense(
        state.last.desc, state.last.valid & state.last_lms_valid, state.last.angle,
        feats.desc, feats.valid, feats.angle, max_dist=50, ratio=0.7,
    )
    fb_viable = (~motion_viable) & (torch.sum(fb_assign >= 0) >= 15)
    use_assign = torch.where(motion_viable, assign, fb_assign)
    T_init = torch.where(motion_viable, T_pred, state.T_cw)
    src = torch.clamp(use_assign, 0, n - 1).to(torch.int64)
    po = PoseObservations(
        p_w=state.last_lms[src], obs_uvr=obs_uvr, inv_sigma2=inv_sigma2_tab[octave],
        has_stereo=feats.right_u >= 0,
        valid=(use_assign >= 0) & feats.valid & state.last_lms_valid[src]
        & (motion_viable | fb_viable),
    )
    T_frame, _, n_frame = optimize_pose(cam, T_init, po)
    frame_ok = (motion_viable | fb_viable) & (n_frame >= min_motion)

    # ---------- local-map tracking
    T_start = torch.where(frame_ok, T_frame, T_pred)
    lassign, _, frustum_ok = match_local_points(
        cam, feats, T_start, trkset.pos, trkset.desc, trkset.normal, trkset.dmax,
        trkset.dmin, trkset.valid, th=1.0, n_levels=n_levels, scale_factor=scale_factor,
        return_visible=True,
    )
    P = trkset.pos.shape[0]
    lsrc = torch.clamp(lassign, 0, P - 1).to(torch.int64)
    plo = PoseObservations(
        p_w=trkset.pos[lsrc], obs_uvr=obs_uvr, inv_sigma2=inv_sigma2_tab[octave],
        has_stereo=feats.right_u >= 0,
        valid=(lassign >= 0) & feats.valid & trkset.valid[lsrc],
    )
    T_loc, linlier, n_loc = optimize_pose(cam, T_start, plo)
    # Bootstrap guard: a frame dispatched before the first tracking-set
    # refresh sees an (almost) empty set and keeps its motion-only result.
    trk_populated = torch.sum(trkset.valid) >= min_local
    # The stricter gate within 1 s of a relocalization (tracking.cpp:630-636).
    min_local_eff = torch.where(state.since_reloc < fps, min_after_reloc, min_local)
    local_ok = torch.where(trk_populated, n_loc >= min_local_eff, frame_ok)
    T_loc = torch.where(trk_populated, T_loc, T_start)
    n_loc = torch.where(trk_populated, n_loc, n_frame)
    if loc_mode:
        # Localization-only visual odometry (tracking.cpp:407-441): too few
        # frozen-map inliers keep the motion-model pose instead of LOST.
        vo = frame_ok & trk_populated & (n_loc < min_local_eff)
        local_ok = local_ok | vo
        T_loc = torch.where(vo, T_frame, T_loc)
        n_loc = torch.where(vo, n_frame, n_loc)

    track_ok = frame_ok & local_ok
    matched = trk_populated & linlier & (lassign >= 0)
    mpid = torch.where(matched, trkset.pts[lsrc], -1).to(torch.int32)

    # ---------- found/visible counters (tracking.cpp:570-604)
    count_gate = trk_populated & frame_ok
    vis_rows = (frustum_ok & count_gate).to(torch.int32)
    n_acc = state.found_acc.shape[0]
    found_rows = scatter_add(
        torch.zeros_like(state.found_acc), torch.where(matched & track_ok, lassign, n_acc), 1,
    )
    vis_acc = state.vis_acc + vis_rows
    found_acc = state.found_acc + torch.clamp(found_rows, max=1)

    # ---------- keyframe decision counters (tracking.cpp:762-775)
    close = feats.valid & (feats.depth > 0) & (feats.depth <= depth_threshold)
    tracked_close = torch.sum(close & (mpid >= 0))
    untracked_close = torch.sum(close & (mpid < 0))
    need_close = (tracked_close < close_tracked_max) & (untracked_close > close_untracked_min)
    c2 = (n_loc > 15) & ((n_loc < trkset.ref_thresh) | need_close)
    need_kf = track_ok & c2

    # ---------- outcome
    T_new = torch.where(can_init, eye, torch.where(track_ok, T_loc, state.T_cw))
    ok = can_init | ((state.mode != MODE_INIT) & track_ok)
    new_mode = torch.where(
        can_init | track_ok, MODE_OK, torch.where(state.mode == MODE_INIT, MODE_INIT, MODE_LOST),
    ).to(torch.int32)
    velocity = torch.where(
        track_ok & (state.mode == MODE_OK), T_new @ inv_T(state.T_cw),
        torch.where(can_init, eye, state.velocity),
    )

    # Landmarks of the next frame's motion search: map positions where
    # matched, depth backprojection elsewhere.
    p_c = backproject(cam, feats.uv, torch.clamp(feats.depth, min=1e-3))
    p_depth = (p_c - T_new[:3, 3]) @ T_new[:3, :3]
    lms = torch.where((mpid >= 0)[:, None], trkset.pos[lsrc], p_depth)
    lms_valid = (feats.depth > 0) | (mpid >= 0)
    new_last = FrameFeatures(*(
        torch.where(ok.reshape((1,) * a.ndim), a, b) for a, b in zip(feats, state.last)
    ))

    for ring, f in zip(state.ring_feats, feats):
        ring[slot].copy_(f)
    state.ring_mpid[slot].copy_(torch.where(can_init, -1, mpid))
    state.ring_T[slot].copy_(T_new)
    head = torch.stack([
        new_mode.to(torch.float32), ok.to(torch.float32),
        torch.where(can_init, n_depth, n_loc).to(torch.float32),
        (need_kf | can_init).to(torch.float32),
        torch.full((), float(slot), device=dev),
    ])
    state.ring_info[slot].copy_(torch.cat([head, T_new.reshape(-1)]))
    return state._replace(
        mode=new_mode,
        T_cw=T_new,
        velocity=velocity,
        last=new_last,
        last_lms=torch.where(ok, lms, state.last_lms),
        last_lms_valid=torch.where(ok, lms_valid & feats.valid, state.last_lms_valid),
        frame_idx=state.frame_idx + 1,
        since_reloc=state.since_reloc + 1,
        vis_acc=vis_acc,
        found_acc=found_acc,
    )


def fold_track_counters(m: MapState, pts, valid, vis_acc, found_acc) -> MapState:
    """Add the device accumulators into ``mp_visible``/``mp_found`` by
    map-point id (the cull input, localMapping.cpp:90-108); called before
    the tracking set they are indexed by goes."""
    M = m.mp_found.shape[0]
    idx = torch.where(valid & (pts >= 0), pts, M)  # out-of-range rows drop
    return m._replace(
        mp_visible=scatter_add(m.mp_visible, idx, vis_acc),
        mp_found=scatter_add(m.mp_found, idx, found_acc),
    )


def clear_track_counters(state: TrackState) -> TrackState:
    return state._replace(
        vis_acc=torch.zeros_like(state.vis_acc), found_acc=torch.zeros_like(state.found_acc),
    )


def read_ring(state: TrackState, slot: int):
    """Copies of one ring entry (features, map-point ids, pose), for
    keyframe insertion and relocalization by the host."""
    feats = FrameFeatures(*(a[slot].clone() for a in state.ring_feats))
    return feats, state.ring_mpid[slot].clone(), state.ring_T[slot].clone()
