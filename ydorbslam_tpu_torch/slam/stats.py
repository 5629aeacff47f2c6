"""Per-run counters of the SLAM system.

Port of ``RunStats`` (``ydorbslam_tpu/slam/stats.py``): a plain host-side
counter bag.  Every increment happens at a host decision point that
already exists, so it adds no device traffic.  ``SlamSystem.run_stats()``
merges these counters with values derived from the frame records and one
read of the map's validity masks.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunStats:
    frames_total: int = 0
    frames_lost: int = 0
    inlier_sum: int = 0  # local-map inliers accumulated over ok frames
    inlier_frames: int = 0
    keyframes_inserted: int = 0
    keyframes_culled: int = 0
    keyframes_dropped_capacity: int = 0  # max_keyframes exhausted
    local_ba_runs: int = 0
    reloc_attempts: int = 0
    reloc_successes: int = 0
    loop_candidates: int = 0
    loops_closed: int = 0
    global_ba_runs: int = 0
    resets: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_inliers"] = (
            self.inlier_sum / self.inlier_frames if self.inlier_frames else 0.0
        )
        d["track_rate"] = (
            1.0 - self.frames_lost / self.frames_total if self.frames_total else 0.0
        )
        return d
