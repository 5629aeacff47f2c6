"""System facade: the SLAM pipeline behind the reference's API.

Port of the mapping-off configuration of ``ydorbslam_tpu/slam/system.py``:
``SlamSystem(cfg, Sensor.RGBD, enable_mapping=False,
enable_loop_closing=False, device=...)`` routes every ``track_rgbd``
frame through ``Tracker.track_rgbd`` and keeps the per-frame records.
Local mapping (map state, triangulation, fusion, local BA) and loop
closing belong to later slices of the port; asking for mapping raises
``NotImplementedError`` rather than running without it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np

from ..config import SlamConfig
from .tracking import Tracker, TrackingState


class Sensor(enum.Enum):
    """src/enumclass.hpp:13-17 (monocular unsupported, as in the reference)."""

    STEREO = 1
    RGBD = 2


@dataclasses.dataclass
class SystemRecord:
    timestamp: float
    ref_kf: int
    T_c_ref: np.ndarray
    lost: bool


class SlamSystem:
    """End-to-end tracking on ``device`` (mapping and loop closing off)."""

    def __init__(
        self,
        cfg: SlamConfig,
        sensor: Sensor = Sensor.RGBD,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        device="cpu",
    ):
        if enable_mapping:
            # Loop closing runs only on top of mapping (as in the JAX
            # package), so with mapping off it has nothing to do.
            raise NotImplementedError(
                "local mapping is not ported yet (ROADMAP.md Queue 1, "
                "slices 6-8); pass enable_mapping=False"
            )
        self.cfg = cfg
        self.sensor = sensor
        self.tracker = Tracker(cfg, device=device)
        self.cam = self.tracker.cam
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        self.frame_id = 0
        self.records: List[SystemRecord] = []

    def track_rgbd(self, timestamp, gray, depth) -> bool:
        if self.sensor != Sensor.RGBD:
            raise ValueError("sensor mismatch: track_rgbd on a non-RGB-D system")
        ok = self.tracker.track_rgbd(timestamp, gray, depth)
        self._record(timestamp, ok)
        self.frame_id += 1
        return ok

    def track_stereo(self, timestamp, gray_l, gray_r) -> bool:
        return self.tracker.track_stereo(timestamp, gray_l, gray_r)

    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def tracked_map_points(self) -> int:
        """System::getTrackedMapPoints analogue: inliers of the last pose solve."""
        return self.tracker.n_inliers

    def _record(self, timestamp, ok):
        """One record per timestamp.  With mapping off there is no
        reference keyframe: ``ref_kf`` is -1 and ``T_c_ref`` the
        identity."""
        if not self.records or self.records[-1].timestamp != timestamp:
            self.records.append(SystemRecord(timestamp, -1, np.eye(4), not ok))
