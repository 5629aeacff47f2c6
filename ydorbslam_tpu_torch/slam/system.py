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

Not ported yet: the pipelined path (ROADMAP slice 14), checkpoints,
``update_calibration``, ``tracked_keypoints``, ``map_changed_index`` and
the viewer.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..config import SlamConfig
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
from .mapping import SNAP_CULL_CAP, mapping_step, snapshot_layout
from .matchers import match_dense, match_local_points
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
        # from each mapping snapshot (the map starts empty).
        self._host_kf_valid = np.zeros(cap.max_keyframes, dtype=bool)
        self._host_kf_frame_id = np.full(cap.max_keyframes, -1, dtype=np.int64)

    # ------------------------------------------------------------------
    # public API (mirrors src/system.hpp)
    # ------------------------------------------------------------------
    def track_rgbd(self, timestamp, gray, depth) -> bool:
        if self.sensor != Sensor.RGBD:
            raise ValueError("sensor mismatch: track_rgbd on a non-RGB-D system")
        ok = self.tracker.track_rgbd(timestamp, gray, depth)
        self._record(timestamp, ok)
        self.frame_id += 1
        return ok

    def track_stereo(self, timestamp, gray_l, gray_r) -> bool:
        if self.sensor != Sensor.STEREO:
            raise ValueError("sensor mismatch: track_stereo on a non-stereo system")
        ok = self.tracker.track_stereo(timestamp, gray_l, gray_r)
        self._record(timestamp, ok)
        self.frame_id += 1
        return ok

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
        """Sequence end (system.cpp:176-191): verify any loop detection
        still pending and run any global BA in flight to its end."""
        if self.loop_closer is not None:
            self.loop_closer.flush()

    def reset(self):
        """Clear map, retrieval index and tracker state (system.cpp:96-102,
        tracking.cpp:150-180).  The counters start a new epoch; only the
        reset count carries over."""
        self._clear()
        resets = self.stats.resets + 1
        self.stats = RunStats()
        self.stats.resets = resets

    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def tracked_map_points(self) -> int:
        """System::getTrackedMapPoints analogue: inliers of the last pose solve."""
        return self.tracker.n_inliers

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
        pts, pos, desc, normal, dmax, dmin, valid = _select_tracking_set(
            self.map, self.ref_kf, cap, cfg.tracking.local_window_max_kf
        )
        assign, _ = match_local_points(
            self.cam, feats, T_pred, pos, desc, normal, dmax, dmin, valid,
            th=1.0, n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
            ratio=cfg.matcher.ratio_local_map, max_dist=cfg.matcher.th_high,
        )
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
                T_c_ref = (tracker.new_T @ torch.linalg.inv_ex(T_ref)[0]).cpu().numpy()
                self.records.append(SystemRecord(timestamp, self.ref_kf, T_c_ref, False))
                return True
            return False
        self.visual_odometry = False
        tracker.new_T = T_opt
        tracker.n_inliers = n_in
        self.stats.inlier_sum += n_in
        self.stats.inlier_frames += 1

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
        T_c_ref = (T_opt @ torch.linalg.inv_ex(T_ref)[0]).cpu().numpy()
        self.records.append(SystemRecord(timestamp, self.ref_kf, T_c_ref, False))
        if not self.localization_only and self._need_new_keyframe(feats, n_in):
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

        for cand in [int(i) for i in ids.cpu().numpy() if i >= 0]:
            has_mp = m.kf_kp_valid[cand] & (m.kf_mp[cand] >= 0)
            assign, _ = match_dense(
                m.kf_desc[cand], has_mp, m.kf_angle[cand],
                feats.desc, feats.valid, feats.angle,
                max_dist=cfg.matcher.th_low, ratio=cfg.matcher.ratio_reloc,
            )  # per frame keypoint -> candidate keypoint
            if int(torch.sum(assign >= 0)) < cfg.tracking.reloc_min_bow_matches:
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
            if not bool(res.ok):
                # Depth-sparse fallback: 2D-3D DLT-PnP (the reference's EPnP
                # solver, src/pnpSolver.cpp), for a frame that matches map
                # points but measured too few depths to seed 3-point sets.
                res = ransac_pnp(
                    self.cam, p_w, feats.uv, sigma2, ok,
                    n_hypotheses=cfg.capacity.ransac_batch, min_inliers=10,
                    generator=self._reloc_gen,
                )
            if not bool(res.ok):
                continue
            T_opt, _, n_in = optimize_pose(self.cam, res.T_cw, observations(p_w, ok))
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
        self.retrieval = remove_keyframes(self.retrieval, torch.from_numpy(ids).to(self.device))
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
        """Read mapping_step's packed snapshot (one copy to the host) and
        rebase the records of the keyframes it culled."""
        v = snap_vec.cpu().numpy()
        off, _ = snapshot_layout(self.map.K)

        def seg(name):
            a, b = off[name]
            return v[a:b]

        self._host_kf_valid = seg("kf_valid") > 0.5
        self._host_kf_frame_id = seg("kf_frame_id").astype(np.int64)
        culled_ids = seg("culled_ids").astype(np.int64)
        if (culled_ids >= 0).any():
            c2p = seg("culled_c2p").reshape(SNAP_CULL_CAP, 4, 4).astype(np.float64)
            T_c2p = {int(k): c2p[i] for i, k in enumerate(culled_ids) if k >= 0}
            self._rebase_records(list(T_c2p), T_c2p, seg("parent").astype(np.int64))

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
        ref_tracked = int(_count_ref_tracked(self.map, self.ref_kf, min_obs))
        depth = feats.depth.cpu().numpy()
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

    def _insert_keyframe(self, timestamp, feats, T_cw, matched_mp=None, force=False):
        cfg = self.cfg
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
        # Index the keyframe for place recognition (KeyFrameDatabase::add).
        self.retrieval = add_keyframe(
            self.retrieval, slot, self.map.kf_desc[slot], self.map.kf_kp_valid[slot],
            **self._bank_kw,
        )
        if self.n_keyframes > 2:
            win_cap, fix_cap, pts_cap = self._ba_caps()
            mc = cfg.mapping
            self.stats.local_ba_runs += 1
            self.map, snap_vec = mapping_step(
                self.map, slot, self.n_keyframes, self.cam, self.inv_sigma2_tab,
                self._depth_thr_dev,
                scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                iters1=cfg.optim.local_ba_iters_1, iters2=cfg.optim.local_ba_iters_2,
                win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
                obs_cap=cfg.capacity.local_ba_obs,
                n_neighbors=mc.triangulation_neighbors,
                cull_found_ratio=mc.cull_found_ratio, cull_min_obs=mc.cull_min_obs,
                tri_ratio=cfg.matcher.ratio_triangulation,
                kf_cull_redundancy=mc.kf_cull_redundancy,
            )
            self._consume_snapshot(snap_vec)
        if self.loop_closer is not None and self.n_keyframes > 2:
            self.loop_closer.process(slot)
