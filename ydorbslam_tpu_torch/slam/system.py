"""System facade: the SLAM pipeline behind the reference's API.

Port of the synchronous path of ``ydorbslam_tpu/slam/system.py``:
``SlamSystem(cfg, Sensor.RGBD, enable_mapping=..., enable_loop_closing=...,
device=...)`` routes every ``track_rgbd`` frame through
``Tracker.track_rgbd``, and ``SlamSystem(cfg, Sensor.STEREO, ...)`` every
``track_stereo`` pair through ``Tracker.track_stereo`` (two extractions
and ``ops.stereo.stereo_match``); both keep the per-frame records, and
each raises ``ValueError`` on the other sensor's call.  With mapping on
(the default), a tracked frame is also matched against the local map
(``_local_map_hook``: tracking set, ``match_local_points`` through K2,
pose LM), the keyframe decision runs, and a new keyframe is inserted
(``map_state.insert_keyframe``) and followed by the whole local-mapping
pipeline (``mapping.mapping_step``: cull, triangulation and fusion
through K3, local BA through K4, keyframe cull) before the call returns.

The host reads the device where the JAX package's synchronous path does:
the inlier count of each pose solve, each frame record's pose, the
reference-keyframe count and the frame's depth and map-point ids of the
keyframe decision, and one packed snapshot per keyframe.

Every keyframe is also added to the place-recognition index
(``slam/retrieval.py``) and removed from it when culled.  A frame that
finds tracking LOST relocalizes (``_relocalize``): retrieval candidates,
an appearance match against each through K2, 3D-3D RANSAC with a PnP
fallback (``optim/pnp.py``), the pose LM, and a projection search
through K2 that widens a near miss.  ``activate_localization_mode``
freezes the map: no keyframe is made, and when the map leaves the view
tracking goes on by visual odometry (``visual_odometry``).

With mapping and loop closing on (``enable_loop_closing=True``, the
default), each keyframe after the second then goes to the loop closer
(``slam/loop.py``): detection on every keyframe, verification one
keyframe late against the staleness guard (a host copy of
``kf_valid``/``kf_frame_id`` from the mapping snapshot), the correction
with whole-group fusion, the essential graph, and a global BA advanced
one chunk per keyframe and merged into the live map; ``shutdown()``
verifies what is pending and finishes the global BA.

``attach_viewer`` makes both tracking calls hand their frame to a
``viz.headless.PeriodicViewer``, which reads the card only on a frame it
draws.  ``update_calibration`` reloads the camera from a settings file as
the JAX package does; ``slam/serialize.py`` checkpoints and restores a
system.

The pipelined path (``enable_pipelined``, ``precompile``,
``track_rgbd_pipelined`` or ``track_stereo_pipelined``, ``flush_pipeline``)
dispatches each frame as one device step (``slam/pipeline.py``:
``rgbd_frame_step``, or ``stereo_frame_step`` with two extractions and
``stereo_match``) that makes no host wait, and decides
a batch of frames a few frames late: one read of the ring's packed
outcomes per drain, the keyframes of the batch inserted with the
per-keyframe half of mapping (``mapping_prep``), one deferred local BA
(``mapping_finish``) on the newest of them, a tracking-set refresh
around the keyframe nearest the newest pose, and one global-BA chunk of
the loop closer.  The records of a drain decompose against a host copy
of the reference keyframe's pose, taken from the packed snapshot of the
last BA (read when the host next needs it) and patched at each
insertion.  The drains take either sensor's ring features alike: a
stereo frame's ``right_u`` and depth come from ``stereo_match``.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from .. import trace
from ..config import SlamConfig, camera_intrinsics, load_config
from ..geometry.camera import backproject
from ..io.trajectory import write_tum_trajectory
from ..ops.extractor import FrameFeatures
from ..ops.pyramid import level_sigma2
from ..ops.scatter import scatter_add, scatter_max, scatter_set
from ..ops.select import stable_topk
from ..optim.pnp import ransac_pnp, ransac_pose_3d3d
from ..optim.pose import PoseObservations, optimize_pose
from .loop import LoopCloser
from .map_state import MapState, empty_map, f32, insert_keyframe
from .mapping import (
    SNAP_CULL_CAP, mapping_finish, mapping_prep, mapping_step, snapshot_layout,
)
from .matchers import match_dense, match_local_points
from .pipeline import (
    MODE_LOST, MODE_OK, RING, FrameInfo, TrackSet, clear_track_counters,
    empty_track_state, fold_track_counters, read_ring, rgbd_frame_step, stereo_frame_step,
)
from .retrieval import (
    add_keyframe, bow_histogram, detect_candidates, empty_index, remove_keyframes,
)
from .stats import RunStats
from .tracking import Tracker, TrackingState, landmark_positions


class Sensor(enum.Enum):
    """src/enumclass.hpp:13-17 (monocular unsupported, as in the reference)."""

    STEREO = 1
    RGBD = 2


def _select_tracking_set(m: MapState, ref_kf: int, cap: int = 8192, max_kf: int = 80):
    """Local tracking map: the points bound to the reference keyframe's
    covisibility neighbourhood (first order, then strong second-order
    neighbours and spanning-tree relatives; at most ``max_kf``
    keyframes, tracking.cpp:496-569), lowest point ids first, capped at
    ``cap``.  Returns (pts, pos, desc, normal, max_dist, min_dist, valid)."""
    dev = m.device
    K = m.K
    valid_i = m.kf_valid.to(torch.int32)
    w = scatter_set(m.covis[ref_kf] * valid_i, ref_kf, 1 << 20)
    K1 = min(max_kf, K)
    vals, kfs = stable_topk(w, K1)
    first_ok = vals > 0
    kfc = torch.clamp(kfs, 0, K - 1)
    in_first = scatter_max(torch.zeros((K,), dtype=torch.bool, device=dev), kfc, first_ok)
    rows = m.covis[kfc] * first_ok[:, None].to(torch.int32)
    w2 = torch.amax(torch.where(rows > 10, rows, 0), dim=0)
    par = torch.clamp(m.parent[kfc].to(torch.int64), 0, K - 1)
    par_ok = first_ok & (m.parent[kfc] >= 0)
    w2 = scatter_max(w2, torch.where(par_ok, par, K), 1)
    child_of_first = (m.parent >= 0) & in_first[torch.clamp(m.parent.to(torch.int64), 0, K - 1)]
    w2 = torch.maximum(w2, child_of_first.to(torch.int32))
    w2 = w2 * valid_i * (~in_first).to(torch.int32)
    wc = torch.where(in_first, w + (1 << 21), w2)
    vals2, kfs2 = stable_topk(wc, K1)
    sel_kf = torch.where(vals2 > 0, kfs2, -1)
    in_set = scatter_set(
        torch.zeros((K + 1,), dtype=torch.bool, device=dev),
        torch.where(sel_kf >= 0, sel_kf, K), sel_kf >= 0,
    )[:K]
    kf_sel = in_set[:, None] & (m.kf_mp >= 0)
    member = scatter_max(
        torch.zeros((m.M,), dtype=torch.bool, device=dev),
        torch.clamp(m.kf_mp.to(torch.int64), 0, m.M - 1), kf_sel,
    )
    member = member & m.mp_valid
    order = torch.where(member, torch.arange(m.M, device=dev), m.M)
    pts = torch.sort(order).values[:cap]
    pts = torch.where(pts < m.M, pts, -1)
    ptc = torch.clamp(pts, 0, m.M - 1)
    return (
        pts, m.mp_pos[ptc], m.mp_desc[ptc], m.mp_normal[ptc], m.mp_max_dist[ptc],
        m.mp_min_dist[ptc], (pts >= 0) & m.mp_valid[ptc],
    )


def _count_ref_tracked(m: MapState, ref_kf: int, min_obs: int) -> torch.Tensor:
    """KeyFrame::trackedMapPointsNum (keyFrame.cpp:221): reference-KF
    points with >= min_obs weighted observations (stereo counts double)."""
    row = m.kf_mp[ref_kf]
    ids = torch.clamp(row.to(torch.int64), 0, m.M - 1)
    live = (row >= 0) & m.mp_valid[ids]
    obs_live = m.mp_obs_kf[ids] >= 0
    n_obs = torch.sum(
        torch.where(obs_live, 1 + m.mp_obs_stereo[ids].to(torch.int64), 0), dim=-1
    )
    return torch.sum(live & (n_obs >= min_obs))


def _bump_counters(m: MapState, pts, visible, found) -> MapState:
    """MapPoint found/visible counters, read by the 0.25 found-ratio cull."""
    ptc = torch.clamp(pts.to(torch.int64), 0, m.M - 1)
    ok = pts >= 0
    return m._replace(
        mp_visible=scatter_add(m.mp_visible, ptc, (ok & visible).to(torch.int32)),
        mp_found=scatter_add(m.mp_found, ptc, (ok & found).to(torch.int32)),
    )


def _nearest_kf(m: MapState, T_cur: torch.Tensor) -> torch.Tensor:
    """0-dim index of the keyframe closest to the camera of ``T_cur`` in
    pose space (translation plus 2 m per radian of rotation), the lowest
    index on a tie.  The pipelined path centres the tracking window on it
    at each refresh: the per-drain analogue of the reference's per-frame
    local-window vote (Tracking::updateLocalKeyFrames,
    tracking.cpp:507-569), which on a revisit snaps the window back to
    the old keyframes."""
    c_cur = -T_cur[:3, :3].T @ T_cur[:3, 3]
    R = m.kf_pose[:, :3, :3]
    t = m.kf_pose[:, :3, 3]
    centers = -torch.einsum("kij,ki->kj", R, t)
    d_t = torch.linalg.norm(centers - c_cur[None], dim=-1)
    tr = torch.einsum("kij,ij->k", R, T_cur[:3, :3])
    ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    cost = torch.where(m.kf_valid, d_t + 2.0 * ang, torch.inf)
    return torch.argmin(cost)


def kf_decision_params(n_keyframes: int, kf_ref_ratio: float):
    """(min_obs, ref_ratio) of the keyframe decision for a map of
    ``n_keyframes``: the young-map relaxations of tracking.cpp:749-760."""
    if n_keyframes < 2:
        return 2, 0.4
    if n_keyframes == 2:
        return 2, kf_ref_ratio
    return 3, kf_ref_ratio


@dataclasses.dataclass
class SystemRecord:
    timestamp: float
    ref_kf: int
    T_c_ref: np.ndarray
    lost: bool


class SlamSystem:
    """End-to-end RGB-D or stereo SLAM on ``device`` (the card unless the
    caller asks for another): tracking, and with mapping on the
    synchronous local mapping after every keyframe."""

    def __init__(
        self,
        cfg: SlamConfig,
        sensor: Sensor = Sensor.RGBD,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        device="cuda",
    ):
        self.cfg = cfg
        self.sensor = sensor
        self.device = torch.device(device)
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        inv_sigma2 = 1.0 / level_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor)
        self.inv_sigma2_tab = torch.from_numpy(inv_sigma2).to(self.device)
        # The octave variances of relocalization's RANSAC gate, as the JAX
        # package computes them (float32 1 / inv_sigma2).
        self._sigma2_tab = torch.from_numpy(np.float32(1.0) / inv_sigma2).to(self.device)
        # depth threshold in meters: ThDepth baselines (tracking.cpp:62)
        self.depth_threshold = cfg.depth.th_depth * cfg.camera.bf / cfg.camera.fx
        self._depth_thr_dev = f32(self.depth_threshold, self.device)
        self._no_match = torch.full(
            (cfg.n_keypoints,), -1, dtype=torch.int32, device=self.device
        )
        self.frame_id = 0
        self.stats = RunStats()
        # Localization-only mode (ActivateLocalizationMode) and its
        # visual-odometry state (m_b_isDoingVisualOdometry); a reset keeps
        # the mode, as in the JAX package.
        self.localization_only = False
        self.visual_odometry = False
        self.viewer = None  # optional PeriodicViewer (attach_viewer)
        # Per-frame outcome trace of the pipelined path: with
        # YDORBSLAM_TRACE_FRAMES set, each drained frame appends
        # (timestamp, mode, ok, n_inliers, need_kf, inserted).
        self.frame_trace = [] if os.environ.get("YDORBSLAM_TRACE_FRAMES") else None
        # The pipelined path's state (enable_pipelined); a reset keeps it,
        # as in the JAX package.
        self._dstate = None
        self._trkset = None
        self._pending = []
        self._clear()
        self.cam = self.tracker.cam

    @property
    def _bank_kw(self):
        return dict(n_banks=self.cfg.loop.retrieval_banks,
                    bank_bits=self.cfg.loop.retrieval_bank_bits)

    def _clear(self):
        """Fresh map, retrieval index, tracker and bookkeeping
        (construction and reset)."""
        cap = self.cfg.capacity
        self.map = empty_map(
            cap.max_keyframes, self.cfg.n_keypoints, cap.max_map_points,
            cap.max_obs_per_point, device=self.device,
        )
        self.retrieval = empty_index(cap.max_keyframes, **self._bank_kw, device=self.device)
        # RANSAC draws of relocalization (the JAX package's PRNGKey(7)).
        self._reloc_gen = torch.Generator("cpu").manual_seed(7)
        self.tracker = Tracker(self.cfg, device=self.device)
        self.loop_closer = None
        if self.enable_mapping and self.enable_loop_closing:
            self.loop_closer = LoopCloser(self)
        if self.enable_mapping:
            self.tracker.local_map_hook = self._local_map_hook
            self.tracker.new_kf_hook = self._insert_keyframe
            self.tracker.reloc_hook = self._relocalize
        self.n_keyframes = 0
        self.ref_kf = 0
        self.frames_since_kf = 0
        self.records: List[SystemRecord] = []
        self._frame_mpid = None  # (N,) map-point id per current-frame keypoint
        # The host's copies of map.kf_valid and map.kf_frame_id, refreshed
        # from each mapping snapshot (the map starts empty), and of the
        # reference keyframe's pose, which the pipelined records decompose
        # against (the empty map's identity; None: read it from the map
        # when next needed).  A deferred BA's snapshot waits in
        # _pending_snap until the host next needs these (_snapshot).
        self._host_kf_valid = np.zeros(cap.max_keyframes, dtype=bool)
        self._host_kf_frame_id = np.full(cap.max_keyframes, -1, dtype=np.int64)
        self._host_ref_pose = np.eye(4)
        self._pending_snap = None

    # ------------------------------------------------------------------
    # public API (mirrors src/system.hpp)
    # ------------------------------------------------------------------
    def track_rgbd(self, timestamp, gray, depth) -> bool:
        if self.sensor != Sensor.RGBD:
            raise ValueError("sensor mismatch: track_rgbd on a non-RGB-D system")
        with trace.span("frame", self.frame_id):
            ok = self.tracker.track_rgbd(timestamp, gray, depth)
            self._record(timestamp, ok)
            if self.viewer is not None:
                self.viewer.maybe_draw(self, self.frame_id, gray)
            self.frame_id += 1
        return ok

    def track_stereo(self, timestamp, gray_l, gray_r) -> bool:
        if self.sensor != Sensor.STEREO:
            raise ValueError("sensor mismatch: track_stereo on a non-stereo system")
        with trace.span("frame", self.frame_id):
            ok = self.tracker.track_stereo(timestamp, gray_l, gray_r)
            self._record(timestamp, ok)
            if self.viewer is not None:
                self.viewer.maybe_draw(self, self.frame_id, gray_l)
            self.frame_id += 1
        return ok

    def attach_viewer(self, out_dir: str, every: int = 30, **kw):
        """In-run periodic rendering (viewer.cpp:37-121 analogue): every
        ``every`` frames an annotated frame PNG and a top-down map PNG
        under ``out_dir``."""
        from ..viz.headless import PeriodicViewer

        self.viewer = PeriodicViewer(out_dir, every=every, **kw)
        return self.viewer

    def activate_localization_mode(self):
        """Pause mapping; keep tracking (system.cpp:80-87).  Tracking
        falls back to visual odometry (motion model over depth-seeded
        last-frame landmarks) whenever the frozen map leaves the view
        (tracking.cpp:407-441)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.visual_odometry = False

    def shutdown(self):
        """Sequence end (system.cpp:176-191): drain the frames the pipelined
        path has pending, then verify any loop detection still pending and
        run any global BA in flight to its end."""
        if self._pending:
            self.flush_pipeline()
        if self.loop_closer is not None:
            self.loop_closer.flush()

    def reset(self):
        """Clear map, retrieval index and tracker state (system.cpp:96-102,
        tracking.cpp:150-180).  The counters start a new epoch; only the
        reset count carries over.  As in the JAX package, the pipelined
        path's device state, pending frames and tracking set stay as they
        were."""
        self._clear()
        resets = self.stats.resets + 1
        self.stats = RunStats()
        self.stats.resets = resets

    def update_calibration(self, yaml_path: str):
        """Runtime re-calibration from a settings file
        (Tracking::changeIntParMat, tracking.cpp:128-146): a new ``cfg``
        and camera, and the depth threshold made from them.  As in the
        JAX package, the tracker keeps its own ``cfg`` (distortion gate,
        ORB settings), its depth divisor and the octave tables."""
        self.cfg = load_config(yaml_path, base=self.cfg)
        self.cam = camera_intrinsics(self.cfg, self.device)
        self.tracker.cam = self.cam
        self.depth_threshold = self.cfg.depth.th_depth * self.cfg.camera.bf / self.cfg.camera.fx
        self._depth_thr_dev = f32(self.depth_threshold, self.device)

    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def tracked_map_points(self) -> int:
        """System::getTrackedMapPoints analogue: inliers of the last pose solve."""
        return self.tracker.n_inliers

    def tracked_keypoints(self):
        """System::getTrackedKeyPoints analogue: the last frame's keypoint
        coordinates and validity as numpy arrays (one read of the
        device), or None before the first frame."""
        f = self.tracker.last_feats
        if f is None:
            return None
        a = torch.cat([f.uv, f.valid[:, None].to(f.uv.dtype)], -1).cpu().numpy()
        return a[:, :2], a[:, 2] > 0.5

    def map_changed_index(self) -> int:
        """Big-change counter analogue (map.hpp:46-47)."""
        return self.n_keyframes

    def run_stats(self) -> dict:
        """Per-run counters merged with values from the frame records and
        one read of the map's validity masks (call at the end of a run)."""
        s = self.stats
        s.frames_total = len(self.records)
        s.frames_lost = sum(1 for r in self.records if r.lost)
        if self.loop_closer is not None:
            s.loops_closed = self.loop_closer.n_loops_closed
        d = s.as_dict()
        d["keyframes_live"] = int(self.map.kf_valid.sum())
        d["map_points_live"] = int(self.map.mp_valid.sum())
        return d

    # ------------------------------------------------------------------
    # pipelined (device-resident) tracking
    # ------------------------------------------------------------------
    def enable_pipelined(self, lag: int = 3):
        """Switch to the pipelined tracker (``slam/pipeline.py``): each
        frame is one device step with no host wait, and the host decides
        (records, keyframes, relocalization) in batches, ``lag`` frames
        late, from one read of the ring's packed outcomes."""
        self._pipe_lag = lag
        self._trkset = None
        self._dstate = empty_track_state(
            self.cfg.n_keypoints, self.cfg.capacity.tracking_points, device=self.device
        )
        self._pending = []
        self._pipe_frames_since_kf = 0
        self._inlier_peak = 0.0  # stress-gate yardstick (see _drain_batch)
        self._stress_drains = 0
        self._refresh_trkset()

    @property
    def _effective_lag(self) -> int:
        """Drain every frame until the map initializes, at a short lag while
        the first keyframes are minted from frames that predate a
        populated tracking set (their landmarks would be seeded twice),
        and at a short lag under tracking stress (``stress_lag``);
        otherwise at the full lag."""
        if self.n_keyframes == 0:
            return 1
        if self.n_keyframes < 3 and self.frame_id < 24:
            return min(3, self._pipe_lag)
        if self._stress_drains > 0:
            return min(3, self._pipe_lag)
        return self._pipe_lag

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the system's device; to the card from pinned
        memory, which does not make the host wait."""
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _step_kw(self) -> dict:
        cfg = self.cfg
        o, tc = cfg.orb, cfg.tracking
        return dict(
            n_features=o.n_features, capacity=cfg.n_keypoints, n_levels=o.n_levels,
            scale_factor=o.scale_factor, th_high=o.ini_th_fast, th_low=o.min_th_fast,
            subpixel=o.subpixel, min_motion=tc.min_matches_motion,
            min_local=tc.min_matches_local_map, min_init=tc.min_init_depth_points,
            min_after_reloc=tc.min_matches_after_reloc, fps=max(1, int(cfg.camera.fps)),
            close_tracked_max=tc.kf_close_tracked_max,
            close_untracked_min=tc.kf_close_untracked_min, loc_mode=self.localization_only,
        )

    def _refresh_trkset(self, T_latest=None):
        """Fold the found/visible accumulators into the map (they are
        indexed by the outgoing set's rows), then rebuild the tracking set
        around the keyframe nearest ``T_latest`` (the newest drained OK
        pose; one read of its index) or, without it, around ``ref_kf``."""
        cfg = self.cfg
        if self._trkset is not None and self._dstate is not None:
            self.map = fold_track_counters(
                self.map, self._trkset.pts, self._trkset.valid, self._dstate.vis_acc,
                self._dstate.found_acc,
            )
            self._dstate = clear_track_counters(self._dstate)
        if T_latest is not None and self.n_keyframes > 1:
            T = self._upload(np.asarray(T_latest, np.float32))
            with trace.wait("nearest_kf"):
                window_ref = int(_nearest_kf(self.map, T))
        else:
            window_ref = self.ref_kf
        pts, pos, desc, normal, dmax, dmin, valid = _select_tracking_set(
            self.map, window_ref, cfg.capacity.tracking_points,
            cfg.tracking.local_window_max_kf,
        )
        min_obs, ref_ratio = kf_decision_params(self.n_keyframes, cfg.tracking.kf_ref_ratio)
        ref_tracked = _count_ref_tracked(self.map, window_ref, min_obs)
        self._trkset = TrackSet(
            pts=pts, pos=pos, desc=desc, normal=normal, dmax=dmax, dmin=dmin, valid=valid,
            ref_thresh=ref_tracked.to(torch.float32) * ref_ratio,
        )
        self._inlier_peak = 0.0  # the stress yardstick restarts per window

    def track_rgbd_pipelined(self, timestamp, gray, depth) -> None:
        """Dispatch one frame; decisions drain in batches.  uint8 gray and
        uint16 depth go to the device as they are (from pinned memory)
        and convert there.  Call ``flush_pipeline()`` or ``shutdown()`` at
        the end of a sequence."""
        if self.sensor != Sensor.RGBD:
            raise ValueError("sensor mismatch: track_rgbd_pipelined on a non-RGB-D system")
        depth = np.asarray(depth)
        scale = 1.0 / self.cfg.depth.depth_map_factor if depth.dtype == np.uint16 else 1.0
        with trace.span("frame", self.frame_id):
            with trace.span("pipeline.step"):
                self._dstate = rgbd_frame_step(
                    self._dstate, self._upload(gray), self._upload(depth), self._trkset,
                    self.cam, self.inv_sigma2_tab, self._depth_thr_dev, self.frame_id % RING,
                    depth_scale=torch.full((), scale, dtype=torch.float32, device=self.device),
                    **self._step_kw(),
                )
            self._dispatched(timestamp)

    def track_stereo_pipelined(self, timestamp, gray_l, gray_r) -> None:
        """Stereo analogue of ``track_rgbd_pipelined``: a rectified pair,
        uint8 or float32 (both the same), goes to the device as it is,
        from pinned memory."""
        if self.sensor != Sensor.STEREO:
            raise ValueError("sensor mismatch: track_stereo_pipelined on a non-stereo system")
        with trace.span("frame", self.frame_id):
            with trace.span("pipeline.step"):
                self._dstate = stereo_frame_step(
                    self._dstate, self._upload(gray_l), self._upload(gray_r), self._trkset,
                    self.cam, self.inv_sigma2_tab, self._depth_thr_dev, self.frame_id % RING,
                    **self._step_kw(),
                )
            self._dispatched(timestamp)

    def _dispatched(self, timestamp):
        """After a frame's step: queue the frame, draw the viewer, and drain
        once ``_effective_lag`` frames are pending."""
        self._pending.append((timestamp, self.frame_id))
        if self.viewer is not None:
            # The map view is current; the frame's features stay on the
            # device, so no frame annotation is drawn.
            self.viewer.maybe_draw(self, self.frame_id, None)
        self.frame_id += 1
        if len(self._pending) >= self._effective_lag:
            self._drain_batch()

    def flush_pipeline(self):
        while self._pending:
            self._drain_batch()

    def _drain_batch(self):
        """Read the ring's packed outcomes once and decide every pending
        frame.  Keyframes inserted in the batch run only ``mapping_prep``;
        the local BA and keyframe culling (``mapping_finish``) run once at
        the end on the newest keyframe: the reference's ``interruptBA``
        (localMapping.cpp:54-58), where a queued keyframe stops the
        running local BA."""
        if not self._pending:
            return
        assert len(self._pending) <= RING, "pipeline lag exceeds ring size"
        # The drain's one read; it waits for the device to catch up.
        with trace.span("drain.fetch"), trace.wait("drain_ring"):
            ring = self._dstate.ring_info.cpu().numpy()
        with trace.span("drain.frames"):
            infos = self._drain_frames(ring)
        with trace.span("drain.deferred_ba"):
            if self._ba_pending:
                self._run_deferred_ba()
        # At an insertion the window moves to the keyframe nearest the
        # newest drained OK pose; between insertions it stays.
        T_latest = next((info.T_cw for info in reversed(infos) if info.ok), None)
        with trace.span("drain.trkset_refresh"):
            if self._batch_inserted:
                self._refresh_trkset(T_latest)
        with trace.span("drain.loop_tick"):
            if self.loop_closer is not None:
                # One global-BA chunk per drain (loopClosing.cpp:334's
                # transient BA thread, overlapped with tracking).
                self.loop_closer.tick()

    def _drain_frames(self, ring):
        """Decide the pending frames from the ring's packed outcomes;
        returns their ``FrameInfo``s."""
        # Fold the found/visible accumulators at every drain: the 0.25
        # found-ratio cull looks at each recent point within a few
        # keyframes, and the reference bumps the counters every frame.
        if self._trkset is not None:
            self.map = fold_track_counters(
                self.map, self._trkset.pts, self._trkset.valid, self._dstate.vis_acc,
                self._dstate.found_acc,
            )
            self._dstate = clear_track_counters(self._dstate)
        batch = self._pending
        self._pending = []
        self._batch_inserted = False
        self._ba_pending = False
        infos = [FrameInfo.unpack(ring[fid % RING]) for _, fid in batch]
        # Stress gate of the adaptive lag (_effective_lag): a lost frame, or
        # inliers below half their peak since the last refresh.
        ok_inl = [i.n_inliers for i in infos if i.ok]
        peak = self._inlier_peak
        stress = self.cfg.tracking.stress_lag and (
            any(not i.ok for i in infos)
            or (bool(ok_inl) and peak > 0 and min(ok_inl) < 0.5 * peak)
        )
        if ok_inl:
            self._inlier_peak = max(peak, max(ok_inl))
        self._stress_drains = 3 if stress else max(0, self._stress_drains - 1)
        for i, ((timestamp, _), info) in enumerate(zip(batch, infos)):
            # Relocalize at most once per batch, from the newest frame
            # (the reference relocalizes the current frame,
            # tracking.cpp:257-259).
            self._drain_one(timestamp, info, allow_reloc=(i == len(batch) - 1))
        return infos

    def _run_deferred_ba(self):
        """The drain's local BA and keyframe culling on the newest keyframe;
        its snapshot is read when the host next needs it."""
        cfg = self.cfg
        win_cap, fix_cap, pts_cap = self._ba_caps()
        self.map, self._pending_snap = mapping_finish(
            self.map, self.ref_kf, self.cam, self.inv_sigma2_tab, self._depth_thr_dev,
            iters1=cfg.optim.local_ba_iters_1, iters2=cfg.optim.local_ba_iters_2,
            win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
            obs_cap=cfg.capacity.local_ba_obs, kf_cull_redundancy=cfg.mapping.kf_cull_redundancy,
        )
        self._ba_pending = False
        self.stats.local_ba_runs += 1

    def _drain_one(self, timestamp, info: FrameInfo, allow_reloc: bool = True):
        """One drained frame: its record, the tracker's state and inliers,
        relocalization when LOST, and a keyframe when the device asked
        for one (at least 2 tracked frames after the last insertion: the
        reference drops requests while its mapping queue is full,
        tracking.cpp:787-791)."""
        ok, mode = info.ok, info.mode
        self._pipe_frames_since_kf += 1
        if ok:
            T_ref = self._ref_pose()
            self.records.append(
                SystemRecord(timestamp, self.ref_kf, info.T_cw @ np.linalg.inv(T_ref), False)
            )
        else:
            self.records.append(SystemRecord(timestamp, self.ref_kf, np.eye(4), True))
        self.tracker.n_inliers = int(info.n_inliers)
        if ok:
            self.stats.inlier_sum += self.tracker.n_inliers
            self.stats.inlier_frames += 1
        self.tracker.state = (
            TrackingState.OK if ok else (
                TrackingState.LOST if mode == MODE_LOST else TrackingState.NOT_INITIALIZED
            )
        )
        if self.frame_trace is not None:
            self.frame_trace.append(
                (timestamp, int(mode), bool(ok), int(info.n_inliers), bool(info.need_kf), False)
            )
        if mode == MODE_LOST:
            if allow_reloc:
                self._pipelined_relocalize(timestamp, info.ring_slot)
            return
        if info.need_kf and ok and not self.localization_only:
            first = self.n_keyframes == 0
            if first or self._pipe_frames_since_kf >= 2:
                feats, mpid, T = read_ring(self._dstate, info.ring_slot)
                self._insert_keyframe(
                    timestamp, feats, T, matched_mp=None if first else mpid,
                    defer_ba=True, T_host=info.T_cw,
                )
                self._pipe_frames_since_kf = 0
                self._batch_inserted = True
                if self.frame_trace is not None:
                    self.frame_trace[-1] = self.frame_trace[-1][:5] + (True,)

    def _pipelined_relocalize(self, timestamp, slot: int):
        """Relocalize a ring frame on the host (``_relocalize``); on success
        the device state restarts from the recovered pose.  As in the JAX
        package, the host's reference pose is left as it was."""
        if self.n_keyframes < 2:
            return  # nothing to relocalize against yet
        feats, _, _ = read_ring(self._dstate, slot)
        with trace.span("track.reloc"):
            if not self._relocalize(self.tracker, timestamp, feats):
                return
        T = self.tracker.T_cw
        lms, lms_valid = landmark_positions(self.cam, feats, T)
        self._dstate = self._dstate._replace(
            mode=torch.full((), MODE_OK, dtype=torch.int32, device=self.device),
            T_cw=T,
            velocity=torch.eye(4, device=self.device),
            last=feats,
            last_lms=lms,
            last_lms_valid=lms_valid,
            since_reloc=torch.full((), 0, dtype=torch.int32, device=self.device),
        )
        if self.records:
            with trace.wait("reloc_pose"):
                T_np = T.cpu().numpy()
            with trace.wait("ref_pose"):
                T_ref = self.map.kf_pose[self.ref_kf].cpu().numpy()
            self.records[-1] = SystemRecord(
                timestamp, self.ref_kf, T_np @ np.linalg.inv(T_ref), False,
            )
        self._refresh_trkset()

    def precompile(self):
        """Run every steady-state program of the pipelined path once, on
        scratch state: the sensor's frame step (a uint8 pair for stereo,
        uint8 gray and uint16 depth for RGB-D), ``read_ring``, a keyframe insertion,
        ``mapping_prep``, ``mapping_finish`` at both local-BA capacity
        buckets, the retrieval index's add and removal, the tracking-set
        selection, and with loop closing on a detection, a verification
        and a correction.  On the card this loads the kernels and the
        libraries' handles and warms the caching allocator before the
        first frame.  The live map, index, tracking state and random
        generators are not touched.  Needs ``enable_pipelined`` first;
        relocalization and the global BA still run cold on first use."""
        from .loop_impl import _correct_on_device, _detect, _verify_pack

        if self._dstate is None:
            raise RuntimeError("precompile() needs enable_pipelined() first")
        cfg = self.cfg
        cap = cfg.capacity
        o = cfg.orb
        dev = self.device
        shape = (cfg.camera.height, cfg.camera.width)
        st = empty_track_state(cfg.n_keypoints, cap.tracking_points, device=dev)
        img8 = self._upload(np.zeros(shape, np.uint8))
        if self.sensor == Sensor.STEREO:
            st = stereo_frame_step(
                st, img8, self._upload(np.zeros(shape, np.uint8)), self._trkset, self.cam,
                self.inv_sigma2_tab, self._depth_thr_dev, 0, **self._step_kw(),
            )
        else:
            st = rgbd_frame_step(
                st, img8, self._upload(np.zeros(shape, np.uint16)), self._trkset, self.cam,
                self.inv_sigma2_tab, self._depth_thr_dev, 0,
                depth_scale=torch.full((), 1.0, dtype=torch.float32, device=dev),
                **self._step_kw(),
            )
        feats, mpid, T = read_ring(st, 0)
        m = MapState(*(a.clone() for a in self.map))
        m, _ = insert_keyframe(
            m, 0, 0, 0.0, feats, T, mpid, self.cam, self._depth_thr_dev, 0,
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            min_close_seed=cfg.tracking.min_close_seed_points,
        )
        m = mapping_prep(m, 0, 3, self.cam, scale_factor=o.scale_factor, n_levels=o.n_levels,
                         **self._prep_kw)
        saved = self.n_keyframes
        try:
            for nkf in (0, cap.local_ba_window_kf):
                self.n_keyframes = nkf
                win_cap, fix_cap, pts_cap = self._ba_caps()
                m, _ = mapping_finish(
                    m, 0, self.cam, self.inv_sigma2_tab, self._depth_thr_dev,
                    iters1=cfg.optim.local_ba_iters_1, iters2=cfg.optim.local_ba_iters_2,
                    win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
                    obs_cap=cap.local_ba_obs, kf_cull_redundancy=cfg.mapping.kf_cull_redundancy,
                )
        finally:
            self.n_keyframes = saved
        idx = empty_index(cap.max_keyframes, **self._bank_kw, device=dev)
        idx = add_keyframe(idx, 0, m.kf_desc[0], m.kf_kp_valid[0], **self._bank_kw)
        remove_keyframes(idx, torch.full((SNAP_CULL_CAP,), -1, dtype=torch.int64, device=dev))
        _select_tracking_set(self.map, 0, cap.tracking_points, cfg.tracking.local_window_max_kf)
        for min_obs in (2, 3):
            _count_ref_tracked(self.map, 0, min_obs)
        _nearest_kf(self.map, torch.eye(4, device=dev))
        if self.loop_closer is not None:
            lc = cfg.loop
            C = cap.loop_candidates
            _detect(
                self.map, self.retrieval, 0, torch.zeros((C, self.map.K), dtype=torch.bool,
                                                          device=dev),
                torch.full((C,), -1, dtype=torch.int32, device=dev), C,
                lc.covisibility_consistency_th, n_banks=lc.retrieval_banks,
                bank_bits=lc.retrieval_bank_bits, min_frame_gap=lc.min_frame_gap,
            )
            _verify_pack(
                self.map, 0, 0, self.cam, th_low=cfg.matcher.th_low,
                ratio=cfg.matcher.ratio_reloc, n_hypotheses=lc.ransac_max_iters,
                min_inliers=lc.ransac_min_inliers, sim3_iters=cfg.optim.sim3_iters,
                scale_factor=o.scale_factor, n_levels=o.n_levels,
                guided_cap=cap.tracking_points,
                generator=torch.Generator("cpu").manual_seed(0),
            )
            _correct_on_device(
                self.map, 0, 0, torch.eye(4, device=dev),
                torch.full((self.map.N,), -1, dtype=torch.int32, device=dev), self.cam,
                scale_factor=o.scale_factor, n_levels=o.n_levels,
                fuse_pts_cap=cap.loop_fuse_points, fuse_group_cap=cap.loop_fuse_group,
            )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    # trajectory export (src/system.cpp:193-261)
    # ------------------------------------------------------------------
    @staticmethod
    def _kf_pose_with_tree_walk(kf: int, kf_pose, kf_valid, parent, T_c2p):
        """Walk up the spanning tree past culled keyframes, composing the
        frozen child-to-parent transforms (system.cpp:209-223)."""
        T_acc = np.eye(4)
        hops = 0
        while kf >= 0 and not kf_valid[kf] and hops < kf_pose.shape[0]:
            T_acc = T_acc @ T_c2p[kf]
            kf = int(parent[kf])
            hops += 1
        if kf < 0:
            return None
        return T_acc @ kf_pose[kf]

    def save_trajectory_tum(self, path: str):
        """Full per-frame trajectory relative to the first keyframe."""
        m = self.map
        kf_pose = m.kf_pose.cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        parent = m.parent.cpu().numpy()
        T_c2p = m.kf_T_c2p.cpu().numpy()
        first = int(np.argmax(kf_valid))
        T_first_inv = np.linalg.inv(kf_pose[first])
        ts, poses, lost = [], [], []
        for rec in self.records:
            if rec.lost or rec.ref_kf < 0:
                continue
            T_ref = self._kf_pose_with_tree_walk(rec.ref_kf, kf_pose, kf_valid, parent, T_c2p)
            if T_ref is None:
                continue
            ts.append(rec.timestamp)
            poses.append(rec.T_c_ref @ T_ref @ T_first_inv)
            lost.append(False)
        write_tum_trajectory(path, ts, poses, lost, precision=9)

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.map
        kf_valid = m.kf_valid.cpu().numpy()
        kf_pose = m.kf_pose.cpu().numpy()
        ts = m.kf_timestamp.cpu().numpy()
        order = np.argsort(m.kf_frame_id.cpu().numpy())
        sel = [k for k in order if kf_valid[k]]
        write_tum_trajectory(
            path, [float(ts[k]) for k in sel], [kf_pose[k] for k in sel], precision=7,
        )

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _record(self, timestamp, ok):
        if not self.records or self.records[-1].timestamp != timestamp:
            # tracking failed before any hook ran (or mapping is off)
            self.records.append(SystemRecord(
                timestamp, -1 if not self.n_keyframes else self.ref_kf, np.eye(4), not ok,
            ))
        self.frames_since_kf += 1
        # Auto-reset: lost right after initialization with a tiny map
        # (tracking.cpp:307-312: <= 5 keyframes).
        if not ok and self.tracker.state == TrackingState.LOST and 0 < self.n_keyframes <= 5:
            self.reset()

    def _local_map_hook(self, tracker: Tracker, timestamp, feats) -> bool:
        """Tracking::trackLocalMap (tracking.cpp:605-637), then the
        keyframe decision and, for a new keyframe, the mapping pipeline.
        In localization-only mode no keyframe is made, and a frame with
        too few map inliers keeps its motion-model pose (visual odometry)
        instead of being lost."""
        cfg = self.cfg
        T_pred = tracker.new_T
        cap = cfg.capacity.tracking_points
        with trace.span("track.local_map_select"):
            pts, pos, desc, normal, dmax, dmin, valid = _select_tracking_set(
                self.map, self.ref_kf, cap, cfg.tracking.local_window_max_kf
            )
        with trace.span("track.local_map_match"):
            assign, _ = match_local_points(
                self.cam, feats, T_pred, pos, desc, normal, dmax, dmin, valid,
                th=1.0, n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
                ratio=cfg.matcher.ratio_local_map, max_dist=cfg.matcher.th_high,
            )
        with trace.span("track.pose_local"):
            n_pts = pts.shape[0]
            ac = torch.clamp(assign.to(torch.int64), 0, n_pts - 1)
            po = PoseObservations(
                p_w=pos[ac],
                obs_uvr=torch.cat([feats.uv, feats.right_u[:, None]], -1),
                inv_sigma2=self.inv_sigma2_tab[feats.octave.to(torch.int64)],
                has_stereo=feats.right_u >= 0,
                valid=(assign >= 0) & feats.valid,
            )
            T_opt, inliers, n_in = optimize_pose(
                self.cam, T_pred, po,
                episodes=cfg.optim.pose_episodes,
                iters_per_episode=cfg.optim.pose_iters_per_episode,
            )
            with trace.wait("pose_inliers"):
                n_in = int(n_in)
        # Stricter gate within 1 s of a relocalization (tracking.cpp:630-636).
        threshold = (
            cfg.tracking.min_matches_after_reloc
            if tracker.frames_since_reloc < max(1, int(cfg.camera.fps))
            else cfg.tracking.min_matches_local_map
        )
        if n_in < threshold:
            if self.localization_only and self.n_keyframes > 0:
                # Visual odometry (tracking.cpp:407-441): the frozen map has
                # too few visible points, so the motion-model pose stands and
                # the next frame tracks off this frame's depth-seeded
                # landmarks (the tracker backprojects them when it adopts the
                # frame).  The map stays untouched.
                self.visual_odometry = True
                T_ref = self.map.kf_pose[self.ref_kf]
                T_c_ref = tracker.new_T @ torch.linalg.inv_ex(T_ref)[0]
                with trace.wait("ref_pose"):
                    T_c_ref = T_c_ref.cpu().numpy()
                self.records.append(SystemRecord(timestamp, self.ref_kf, T_c_ref, False))
                return True
            return False
        self.visual_odometry = False
        tracker.new_T = T_opt
        tracker.n_inliers = n_in
        self.stats.inlier_sum += n_in
        self.stats.inlier_frames += 1

        with trace.span("track.local_map_update"):
            # Per-keypoint map-point ids of this frame (inliers only).
            mpid = torch.where(inliers, pts[ac], -1)
            self._frame_mpid = mpid
            self.map = _bump_counters(
                self.map, torch.where(assign >= 0, pts[ac], -1),
                visible=torch.ones_like(assign, dtype=torch.bool), found=inliers,
            )
            # The motion model of the next frame uses optimised map-point
            # positions where available, depth backprojection elsewhere.
            lm_pos, lm_valid = landmark_positions(self.cam, feats, T_opt)
            mp_pos_assigned = self.map.mp_pos[torch.clamp(mpid, 0, self.map.M - 1)]
            tracker.pending_landmarks = (
                torch.where((mpid >= 0)[:, None], mp_pos_assigned, lm_pos),
                lm_valid | (mpid >= 0),
            )
            T_ref = self.map.kf_pose[self.ref_kf]
            T_c_ref = T_opt @ torch.linalg.inv_ex(T_ref)[0]
            with trace.wait("ref_pose"):
                T_c_ref = T_c_ref.cpu().numpy()
            self.records.append(SystemRecord(timestamp, self.ref_kf, T_c_ref, False))
        if not self.localization_only:
            with trace.span("track.kf_decision"):
                need_kf = self._need_new_keyframe(feats, n_in)
            if need_kf:
                self._insert_keyframe(timestamp, feats, T_opt, matched_mp=mpid)
        return True

    def _relocalize(self, tracker: Tracker, timestamp, feats) -> bool:
        """Tracking::relocalize (tracking.cpp:638-739): retrieval
        candidates, then per candidate an appearance match (K2, at least
        ``reloc_min_bow_matches``), 3D-3D RANSAC with the PnP fallback,
        the pose LM, and where that falls short of ``reloc_min_inliers``
        a projection search against the candidate's points (K2) and a
        second LM.  The first candidate that reaches
        ``reloc_min_inliers`` is accepted.  The host reads the candidate
        ids, each match count, each RANSAC's ``ok`` and each inlier
        count, as the JAX package does."""
        cfg = self.cfg
        m = self.map
        if self.n_keyframes == 0:
            return False
        self.stats.reloc_attempts += 1
        q = bow_histogram(feats.desc, feats.valid, **self._bank_kw)
        ids, _ = detect_candidates(
            self.retrieval, q, torch.zeros((m.K,), dtype=torch.bool, device=self.device),
            m.covis, -1.0, max_out=cfg.capacity.reloc_candidates,
        )
        octave = feats.octave.to(torch.int64)
        sigma2 = self._sigma2_tab[octave]
        p_cam = backproject(self.cam, feats.uv, torch.clamp(feats.depth, min=1e-3))

        def observations(p_w, valid):
            return PoseObservations(
                p_w=p_w, obs_uvr=torch.cat([feats.uv, feats.right_u[:, None]], -1),
                inv_sigma2=self.inv_sigma2_tab[octave], has_stereo=feats.right_u >= 0,
                valid=valid,
            )

        with trace.wait("reloc_candidates"):
            ids = ids.cpu().numpy()
        for cand in [int(i) for i in ids if i >= 0]:
            has_mp = m.kf_kp_valid[cand] & (m.kf_mp[cand] >= 0)
            assign, _ = match_dense(
                m.kf_desc[cand], has_mp, m.kf_angle[cand],
                feats.desc, feats.valid, feats.angle,
                max_dist=cfg.matcher.th_low, ratio=cfg.matcher.ratio_reloc,
            )  # per frame keypoint -> candidate keypoint
            with trace.wait("reloc_matches"):
                n_matches = int(torch.sum(assign >= 0))
            if n_matches < cfg.tracking.reloc_min_bow_matches:
                continue
            mp = m.kf_mp[cand][torch.clamp(assign, 0, m.N - 1).to(torch.int64)]
            mpc = torch.clamp(mp, 0, m.M - 1).to(torch.int64)
            ok = (assign >= 0) & (mp >= 0) & m.mp_valid[mpc] & feats.valid
            p_w = m.mp_pos[mpc]
            res = ransac_pose_3d3d(
                self.cam, p_w, p_cam, feats.uv, sigma2, feats.depth > 0, ok,
                n_hypotheses=cfg.capacity.ransac_batch, min_inliers=10,
                generator=self._reloc_gen,
            )
            with trace.wait("reloc_ransac"):
                found = bool(res.ok)
            if not found:
                # Depth-sparse fallback: 2D-3D DLT-PnP (the reference's EPnP
                # solver, src/pnpSolver.cpp), for a frame that matches map
                # points but measured too few depths to seed 3-point sets.
                res = ransac_pnp(
                    self.cam, p_w, feats.uv, sigma2, ok,
                    n_hypotheses=cfg.capacity.ransac_batch, min_inliers=10,
                    generator=self._reloc_gen,
                )
            with trace.wait("reloc_ransac"):
                found = bool(res.ok)
            if not found:
                continue
            T_opt, _, n_in = optimize_pose(self.cam, res.T_cw, observations(p_w, ok))
            with trace.wait("reloc_inliers"):
                n_in = int(n_in)
            if n_in < cfg.tracking.reloc_min_inliers:
                # Widen by projection against the candidate's map points and
                # re-optimize (tracking.cpp:702-732).
                kf_ids = m.kf_mp[cand]
                idc = torch.clamp(kf_ids, 0, m.M - 1).to(torch.int64)
                pos = m.mp_pos[idc]
                assign2, _ = match_local_points(
                    self.cam, feats, T_opt, pos, m.mp_desc[idc], m.mp_normal[idc],
                    m.mp_max_dist[idc], m.mp_min_dist[idc], (kf_ids >= 0) & m.mp_valid[idc],
                    th=3.0, n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
                    ratio=cfg.matcher.ratio_local_map, max_dist=cfg.matcher.th_high,
                )
                p_w2 = pos[torch.clamp(assign2, 0, m.N - 1).to(torch.int64)]
                T_opt, _, n_in = optimize_pose(
                    self.cam, T_opt, observations(p_w2, (assign2 >= 0) & feats.valid)
                )
                with trace.wait("reloc_inliers"):
                    n_in = int(n_in)
            if n_in >= cfg.tracking.reloc_min_inliers:
                tracker.new_T = T_opt
                tracker.T_cw = T_opt
                tracker.velocity = torch.eye(4, device=self.device)
                tracker.n_inliers = n_in
                self.ref_kf = cand
                self.stats.reloc_successes += 1
                return True
        return False

    def _rebase_records(self, culled, T_c2p, parent):
        """Migrate frame records off culled reference keyframes at once
        (keyframe slots are reused): T_c_ref <- T_c_ref @ T_c2p and
        ref <- parent, the writer's tree walk done eagerly.  The culled
        keyframes also leave the retrieval index (KeyFrameDatabase::erase),
        in one batched removal."""
        culled = set(culled)
        if not culled:
            return
        self.stats.keyframes_culled += len(culled)
        ids = np.full((SNAP_CULL_CAP,), -1, np.int64)
        ids[: len(culled)] = sorted(culled)[:SNAP_CULL_CAP]
        self.retrieval = remove_keyframes(self.retrieval, self._upload(ids))
        if self.ref_kf in culled:
            p = int(parent[self.ref_kf])
            if p >= 0:
                self.ref_kf = p
        for rec in self.records:
            hops = 0
            while rec.ref_kf in culled and hops < len(parent):
                rec.T_c_ref = rec.T_c_ref @ T_c2p[rec.ref_kf]
                rec.ref_kf = int(parent[rec.ref_kf])
                hops += 1
            if rec.ref_kf < 0:
                rec.lost = True

    def _consume_snapshot(self, snap_vec: torch.Tensor):
        """Read a mapping snapshot (one copy to the host) into the host
        mirrors and rebase the records of the keyframes it culled."""
        with trace.wait("snapshot"):
            v = snap_vec.cpu().numpy()
        off, _ = snapshot_layout(self.map.K)

        def seg(name):
            a, b = off[name]
            return v[a:b]

        self._host_kf_valid = seg("kf_valid") > 0.5
        self._host_kf_frame_id = seg("kf_frame_id").astype(np.int64)
        self._host_ref_pose = seg("ref_pose").reshape(4, 4).astype(np.float64)
        culled_ids = seg("culled_ids").astype(np.int64)
        if (culled_ids >= 0).any():
            c2p = seg("culled_c2p").reshape(SNAP_CULL_CAP, 4, 4).astype(np.float64)
            T_c2p = {int(k): c2p[i] for i, k in enumerate(culled_ids) if k >= 0}
            self._rebase_records(list(T_c2p), T_c2p, seg("parent").astype(np.int64))

    def _snapshot(self):
        """Bring the host mirrors up to date: consume a deferred BA's
        snapshot if one is waiting (where the JAX package's ``_snapshot()``
        does)."""
        if self._pending_snap is not None:
            vec, self._pending_snap = self._pending_snap, None
            self._consume_snapshot(vec)

    def _ref_pose(self) -> np.ndarray:
        """The host's copy of the reference keyframe's pose (float64),
        read from the map when no snapshot or insertion has set it."""
        self._snapshot()
        if self._host_ref_pose is None:
            with trace.wait("ref_pose"):
                T_ref = self.map.kf_pose[self.ref_kf].cpu().numpy()
            self._host_ref_pose = T_ref.astype(np.float64)
        return self._host_ref_pose

    def _need_new_keyframe(self, feats: FrameFeatures, n_in: int) -> bool:
        """Tracking::needNewKeyFrame (tracking.cpp:740-796): minObs/refRatio
        relaxed while the map has < 3 keyframes, the close-point rule,
        cond1a/1b/1c and cond2; cond1b's "local mapper idle" always holds
        (mapping is synchronous)."""
        cfg = self.cfg
        if self.n_keyframes == 0:
            return True
        if self.localization_only:
            return False
        min_obs, ref_ratio = kf_decision_params(self.n_keyframes, cfg.tracking.kf_ref_ratio)
        with trace.wait("ref_tracked"):
            ref_tracked = int(_count_ref_tracked(self.map, self.ref_kf, min_obs))
        with trace.wait("kf_decision"):
            depth = feats.depth.cpu().numpy()
        with trace.wait("kf_decision"):
            mpid = self._frame_mpid.cpu().numpy()
        close = (depth > 0) & (depth <= self.depth_threshold)
        tracked_close = int((close & (mpid >= 0)).sum())
        untracked_close = int((close & (mpid < 0)).sum())
        need_close = (tracked_close < cfg.tracking.kf_close_tracked_max) and (
            untracked_close > cfg.tracking.kf_close_untracked_min
        )
        c1a = self.frames_since_kf >= max(1, int(cfg.camera.fps))
        c1b = True  # minFrames=0 and mapping always idle (synchronous)
        c1c = n_in < ref_tracked * 0.25 or need_close
        c2 = n_in > 15 and (n_in < ref_tracked * ref_ratio or need_close)
        return (c1a or c1b or c1c) and c2

    def _alloc_kf_slot(self) -> Optional[int]:
        """The first free keyframe slot in the host's copy of the slot
        mask (marked taken at once), or None when every slot is live."""
        self._snapshot()
        free = np.where(~self._host_kf_valid)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        self._host_kf_valid[slot] = True
        self._host_kf_frame_id[slot] = self.frame_id
        return slot

    def _ba_caps(self):
        """Local-BA capacity bucket: a small one for the first keyframes,
        the full one afterwards (the JAX package's two sizes)."""
        cap = self.cfg.capacity
        if self.n_keyframes <= min(20, cap.local_ba_window_kf // 2):
            return (
                max(4, cap.local_ba_window_kf // 2),
                max(2, cap.local_ba_fixed_kf // 2),
                max(256, cap.local_ba_max_points // 2),
            )
        return cap.local_ba_window_kf, cap.local_ba_fixed_kf, cap.local_ba_max_points

    @property
    def _prep_kw(self) -> dict:
        mc = self.cfg.mapping
        return dict(
            n_neighbors=mc.triangulation_neighbors, cull_found_ratio=mc.cull_found_ratio,
            cull_min_obs=mc.cull_min_obs, tri_ratio=self.cfg.matcher.ratio_triangulation,
        )

    def _insert_keyframe(self, timestamp, feats, T_cw, matched_mp=None, force=False,
                         defer_ba=False, T_host=None):
        """Insert a keyframe and run local mapping on it.  ``defer_ba`` (the
        pipelined path) runs only ``mapping_prep`` and leaves the local BA
        to the drain; ``T_host``, the keyframe's pose already on the host,
        becomes the host's reference pose without a read."""
        cfg = self.cfg
        with trace.span("track.kf_insert"):
            slot = self._alloc_kf_slot()
            if slot is None:
                # Every keyframe slot is live and culling freed none: the
                # keyframe is skipped, loudly.
                self.stats.keyframes_dropped_capacity += 1
                if self.stats.keyframes_dropped_capacity == 1:
                    warnings.warn(
                        f"keyframe capacity exhausted (max_keyframes="
                        f"{cfg.capacity.max_keyframes}); new keyframes are being "
                        "dropped: raise CapacityConfig.max_keyframes for this "
                        "sequence length",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                return
            if matched_mp is None:
                matched_mp = self._no_match
            # Map initialization seeds a point for every keypoint with depth
            # (tracking.cpp:343); later keyframes seed only close points.
            depth_limit = f32(1e9, self.device) if self.n_keyframes == 0 else self._depth_thr_dev
            self.map, _ = insert_keyframe(
                self.map, slot, self.frame_id, timestamp, feats, T_cw, matched_mp,
                self.cam, depth_limit, self.n_keyframes,
                scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                min_close_seed=cfg.tracking.min_close_seed_points,
            )
            self.n_keyframes += 1
            self.ref_kf = slot
            self.frames_since_kf = 0
            self.stats.keyframes_inserted += 1
            trace.count("keyframes")
            # Index the keyframe for place recognition (KeyFrameDatabase::add).
            self.retrieval = add_keyframe(
                self.retrieval, slot, self.map.kf_desc[slot], self.map.kf_kp_valid[slot],
                **self._bank_kw,
            )
        host_pose = None if T_host is None else np.asarray(T_host, np.float64)
        if self.n_keyframes <= 2:
            self._host_ref_pose = host_pose
        elif defer_ba:
            self.map = mapping_prep(
                self.map, slot, self.n_keyframes, self.cam, scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels, **self._prep_kw,
            )
            self._ba_pending = True
            # The batch's later records decompose against the new keyframe.
            if host_pose is not None:
                self._host_ref_pose = host_pose
        else:
            win_cap, fix_cap, pts_cap = self._ba_caps()
            self.stats.local_ba_runs += 1
            self.map, snap_vec = mapping_step(
                self.map, slot, self.n_keyframes, self.cam, self.inv_sigma2_tab,
                self._depth_thr_dev,
                scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                iters1=cfg.optim.local_ba_iters_1, iters2=cfg.optim.local_ba_iters_2,
                win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
                obs_cap=cfg.capacity.local_ba_obs,
                kf_cull_redundancy=cfg.mapping.kf_cull_redundancy, **self._prep_kw,
            )
            self._consume_snapshot(snap_vec)
        if self.loop_closer is not None and self.n_keyframes > 2:
            with trace.span("loop.process"):
                self.loop_closer.process(slot)
