"""Per-frame tracking: the front-end state machine, on torch tensors.

Port of ``ydorbslam_tpu/slam/tracking.py``: NOT_INITIALIZED -> OK ->
LOST, depth-seeded initialization, motion-model tracking with the
7/14 px retry, the appearance-only fallback and trajectory bookkeeping.
Local-map tracking, keyframe creation and relocalization plug in through
the hooks that ``slam.system.SlamSystem`` installs when mapping is on
(``local_map_hook``, ``new_kf_hook``, ``reloc_hook``), as in the JAX
package.

The control flow lives on the host in plain Python; every compute step
(extraction, matching, pose LM) runs on the tracker's device.  The host
reads the device only where the control flow needs a number, as the
JAX package does: the depth-point count at initialization, the match
counts of the retry and the fallback, the inlier count of each pose
solve, and the pose of each frame record.

The motion-model search makes ONE K2 launch per frame: both window
radii come from ``match_motion_model_two``, and the retry logic (the
narrow window first, the wide one when the narrow one gives fewer than
20 matches or too few inliers) runs on its two results.  The
assignments equal those of two single-radius searches.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np
import torch

from ..config import SlamConfig, camera_intrinsics
from ..geometry.camera import backproject
from ..ops.extractor import FrameFeatures, _extract_orb_pyramid, extract_orb
from ..ops.pyramid import level_sigma2
from ..ops.stereo import fill_depth_from_rgbd, stereo_match
from ..optim.pose import PoseObservations, optimize_pose
from .matchers import match_dense, match_motion_model_two


class TrackingState(enum.Enum):
    """Mirror of the reference TrackingState (src/enumclass.hpp:5-11)."""

    NO_IMAGE_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class FrameRecord:
    """Per-frame trajectory bookkeeping (tracking.hpp:59-62 lists): the
    absolute pose at track time.  The pose relative to the reference
    keyframe is ``slam.system.SystemRecord``'s."""

    timestamp: float
    T_cw: np.ndarray  # absolute pose at track time (4,4)
    lost: bool


def landmark_positions(cam, feats: FrameFeatures, T_cw: torch.Tensor):
    """Backproject a frame's depth measurements to world points."""
    p_c = backproject(cam, feats.uv, torch.clamp(feats.depth, min=1e-3))
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    p_w = (p_c - t) @ R  # R^T (p - t)
    return p_w, feats.valid & (feats.depth > 0)


def _pose_obs_from_assign(
    assign, curr: FrameFeatures, src_p_w, src_valid, inv_sigma2_tab
) -> PoseObservations:
    """Build fixed-capacity PoseObservations from a match assignment."""
    ok = (assign >= 0) & curr.valid
    m = torch.clamp(assign, 0, src_p_w.shape[0] - 1).to(torch.int64)
    ok = ok & src_valid[m]
    obs = torch.cat([curr.uv, curr.right_u[:, None]], dim=-1)
    return PoseObservations(
        p_w=src_p_w[m],
        obs_uvr=obs,
        inv_sigma2=inv_sigma2_tab[curr.octave.to(torch.int64)],
        has_stereo=curr.right_u >= 0,
        valid=ok,
    )


class Tracker:
    """Frame-to-frame RGB-D or stereo tracker: motion-model projection matching
    against the last frame's landmarks + pose-only LM, with the
    appearance-only fallback; local-map tracking and keyframe creation
    plug in through the hooks.  All state lives on ``device``, the card
    unless the caller asks for another."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = camera_intrinsics(cfg, self.device)
        self.state = TrackingState.NO_IMAGE_YET
        self.inv_sigma2_tab = torch.from_numpy(
            1.0 / level_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor)
        ).to(self.device)
        # The uint16 depth divisor, made once (a fill, not a copy from the
        # host): a tensor divisor keeps a true float32 division on every
        # device (CUDA turns division by a Python scalar into a
        # multiplication by its reciprocal).
        self.depth_factor = torch.full(
            (), cfg.depth.depth_map_factor, dtype=torch.float32, device=self.device
        )
        self.T_cw = torch.eye(4, device=self.device)
        self.velocity = torch.eye(4, device=self.device)
        self.new_T = self.T_cw
        self.last_feats: Optional[FrameFeatures] = None
        self.last_lms = None
        self.last_lms_valid = None
        self.records: List[FrameRecord] = []
        self.n_inliers = 0
        self.local_map_hook = None  # set by SlamSystem when mapping runs
        self.new_kf_hook = None
        self.reloc_hook = None
        self.pending_landmarks = None  # (p_w, valid) supplied by the hook
        # Frames since the last successful relocalization: within 1 s
        # (= fps frames) the local-map gate tightens (tracking.cpp:630-636).
        self.frames_since_reloc = 1 << 20

    # -- per-sensor frame ingestion ------------------------------------
    def _extract_kw(self) -> dict:
        o = self.cfg.orb
        c = self.cfg.camera
        return dict(
            n_features=o.n_features, capacity=self.cfg.n_keypoints,
            n_levels=o.n_levels, scale_factor=o.scale_factor,
            th_high=o.ini_th_fast, th_low=o.min_th_fast,
            subpixel=o.subpixel,
            has_distortion=any(abs(k) > 0 for k in (c.k1, c.k2, c.p1, c.p2, c.k3)),
        )

    def _image(self, gray: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(gray)).to(self.device)

    def _extract(self, gray: np.ndarray) -> FrameFeatures:
        return extract_orb(self._image(gray), self.cam, **self._extract_kw())

    def track_rgbd(self, timestamp: float, gray: np.ndarray, depth: np.ndarray):
        """System::trackRGBD -> Tracking::grabImageRGBD: uint8 gray and a
        depth map (uint16 TUM encoding, or float32 metres)."""
        feats = self._extract(gray)
        depth = np.asarray(depth)
        d = torch.as_tensor(depth).to(self.device).to(torch.float32)
        if depth.dtype == np.uint16:  # sensor-native TUM encoding
            d = d / self.depth_factor
        feats = fill_depth_from_rgbd(feats, d, self.cam)
        return self._track(timestamp, feats)

    def track_stereo(self, timestamp: float, gray_l: np.ndarray, gray_r: np.ndarray):
        """System::trackStereo: a rectified uint8 pair, extracted one image
        after the other (K1 twice), then ``stereo_match`` on the
        pyramids the extraction built (src/frame.cpp:60-105)."""
        kw = self._extract_kw()
        fl, pl = _extract_orb_pyramid(self._image(gray_l), self.cam, **kw)
        fr, pr = _extract_orb_pyramid(self._image(gray_r), self.cam, **kw)
        fl = stereo_match(fl, fr, pl, pr, self.cam, kw["n_levels"], kw["scale_factor"])
        return self._track(timestamp, fl)

    # -- core ----------------------------------------------------------
    def _initialize(self, timestamp: float, feats: FrameFeatures) -> bool:
        """Depth map init: needs enough keypoints with depth
        (config tracking.min_init_depth_points)."""
        n_depth = int(torch.sum(feats.valid & (feats.depth > 0)))
        if n_depth < self.cfg.tracking.min_init_depth_points:
            return False
        self.T_cw = torch.eye(4, device=self.device)
        self._adopt_frame(feats)
        self.state = TrackingState.OK
        if self.new_kf_hook is not None:
            self.new_kf_hook(timestamp, feats, self.T_cw, force=True)
        return True

    def _adopt_frame(self, feats: FrameFeatures):
        self.last_feats = feats
        if self.pending_landmarks is not None:
            # The local-map hook supplies map-point positions where the
            # frame was matched to the map (better than raw depth).
            self.last_lms, self.last_lms_valid = self.pending_landmarks
            self.pending_landmarks = None
        else:
            self.last_lms, self.last_lms_valid = landmark_positions(
                self.cam, feats, self.T_cw
            )

    def _track(self, timestamp: float, feats: FrameFeatures):
        lost = False
        if self.state in (TrackingState.NO_IMAGE_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if not self._initialize(timestamp, feats):
                lost = True
        else:
            self.frames_since_reloc += 1
            if self.state == TrackingState.LOST and self.reloc_hook is not None:
                # LOST -> relocalization only (tracking.cpp:257-259).
                ok = self.reloc_hook(self, timestamp, feats)
                if ok:
                    self.frames_since_reloc = 0
            else:
                T_pred = self.velocity @ self.T_cw
                ok = self._track_motion(feats, T_pred)
                if not ok:
                    # The reference falls back to reference-KF BoW
                    # tracking; the dense equivalent matches
                    # appearance-only against the last frame.
                    ok = self._track_appearance(feats)
            if ok and self.local_map_hook is not None:
                ok = self.local_map_hook(self, timestamp, feats)
            if ok:
                T_last = self.T_cw
                # velocity = T_curr @ inv(T_last) (tracking.cpp:273-281)
                self.velocity = self.new_T @ torch.linalg.inv_ex(T_last)[0]
                self.T_cw = self.new_T
                self._adopt_frame(feats)
                self.state = TrackingState.OK
            else:
                self.state = TrackingState.LOST
                lost = True

        self.records.append(
            FrameRecord(timestamp=timestamp, T_cw=self.T_cw.cpu().numpy(), lost=lost)
        )
        return not lost

    def _optimize_with_assign(self, feats, assign, T_init):
        po = _pose_obs_from_assign(
            assign, feats, self.last_lms, self.last_lms_valid, self.inv_sigma2_tab
        )
        T, _, n_in = optimize_pose(
            self.cam, T_init, po,
            episodes=self.cfg.optim.pose_episodes,
            iters_per_episode=self.cfg.optim.pose_iters_per_episode,
        )
        return T, int(n_in)

    def _track_motion(self, feats, T_pred) -> bool:
        o = self.cfg.orb
        assigns = match_motion_model_two(
            self.cam, feats, self.last_feats, self.last_lms,
            self.last_lms_valid, T_pred, self.T_cw,
            th_narrow=7.0, th_wide=14.0,
            n_levels=o.n_levels, scale_factor=o.scale_factor,
        )
        for assign in assigns:  # widened retry (tracking.cpp:456-461)
            n_matches = int(torch.sum(assign >= 0))
            if n_matches >= 20:
                T, n_in = self._optimize_with_assign(feats, assign, T_pred)
                if n_in >= self.cfg.tracking.min_matches_motion:
                    self.new_T = T
                    self.n_inliers = n_in
                    return True
        return False

    def _track_appearance(self, feats) -> bool:
        """Fallback: appearance-only dense match vs the last frame + LM
        from the LAST pose (the reference's trackReferenceKeyFrame
        analogue)."""
        assign, _ = match_dense(
            self.last_feats.desc, self.last_feats.valid & self.last_lms_valid,
            self.last_feats.angle,
            feats.desc, feats.valid, feats.angle,
            max_dist=self.cfg.matcher.th_low, ratio=self.cfg.matcher.ratio_ref_kf,
        )
        if int(torch.sum(assign >= 0)) < 15:
            return False
        T, n_in = self._optimize_with_assign(feats, assign, self.T_cw)
        if n_in >= self.cfg.tracking.min_matches_motion:
            self.new_T = T
            self.n_inliers = n_in
            return True
        return False

    # -- output --------------------------------------------------------
    def trajectory(self):
        """-> (timestamps, poses T_cw list, lost flags)."""
        return (
            [r.timestamp for r in self.records],
            [r.T_cw for r in self.records],
            [r.lost for r in self.records],
        )
