"""Per-run counters of the SLAM system.

Port of ``RunStats`` (``ydorbslam_tpu/slam/stats.py``): a plain host-side
counter bag.  Every increment happens at a host decision point that
already exists, so it adds no device traffic.  ``SlamSystem.run_stats()``
merges these counters with values derived from the frame records and one
read of the map's validity masks; ``format_stats`` prints them for the
runners.
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
    loop_candidates: int = 0  # candidate sets dispatched to verification
    loops_closed: int = 0
    global_ba_runs: int = 0
    resets: int = 0
    # (query frame id, matched frame id, |t| of the Sim3 correction) per
    # accepted loop.
    loop_events: list = dataclasses.field(default_factory=list)
    # Verification-gate failures by stage (bow / ransac / sim3 / guided).
    loop_verify_fails: dict = dataclasses.field(default_factory=dict)
    # New cross-loop essential-graph edges (loopConnections,
    # loopClosing.cpp:311-325) per accepted loop.
    loop_conn_edges: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_inliers"] = (
            self.inlier_sum / self.inlier_frames if self.inlier_frames else 0.0
        )
        d["track_rate"] = (
            1.0 - self.frames_lost / self.frames_total if self.frames_total else 0.0
        )
        return d


def format_stats(d: dict) -> str:
    """One human block for app epilogues (analog of the reference test
    driver's summary prints, test/src/test.cpp:98-110)."""
    lines = [
        f"frames        {d['frames_total']}  "
        f"(lost {d['frames_lost']}, track rate {d['track_rate']:.3f})",
        f"mean inliers  {d['mean_inliers']:.1f}",
        f"keyframes     +{d['keyframes_inserted']} / -{d['keyframes_culled']} culled"
        f"  (live {d.get('keyframes_live', '?')})"
        + (
            f"  [{d['keyframes_dropped_capacity']} DROPPED: capacity]"
            if d.get("keyframes_dropped_capacity") else ""
        ),
        f"map points    live {d.get('map_points_live', '?')}",
        f"local BA      {d['local_ba_runs']} runs",
        f"reloc         {d['reloc_successes']}/{d['reloc_attempts']} succeeded",
        f"loops         {d['loops_closed']} closed"
        f" ({d['loop_candidates']} candidate sets verified),"
        f" global BA {d['global_ba_runs']}",
        f"resets        {d['resets']}",
    ]
    conn = d.get("loop_conn_edges", [])
    for i, (q, m, t) in enumerate(d.get("loop_events", [])):
        edges = f", {conn[i]} cross-loop edges" if i < len(conn) else ""
        lines.append(f"  loop: frame {q} -> frame {m}  |t| = {t:.3f} m{edges}")
    if d.get("loop_verify_fails"):
        lines.append(f"  loop verify fails: {d['loop_verify_fails']}")
    return "\n".join(lines)
