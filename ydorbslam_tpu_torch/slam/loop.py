"""Loop closing: detection, Sim3 estimation, correction, global BA.

Port of ``ydorbslam_tpu/slam/loop.py``: the replacement of the reference
``LoopClosing`` thread (src/loopClosing.cpp) and ``KeyFrameDatabase``
(src/keyFrameDatabase.cpp), run synchronously after each keyframe's
local mapping.  The work is in ``slam/loop_impl.py``.
"""
from __future__ import annotations


class LoopCloser:
    """Consumes newly inserted keyframes; runs detection and correction.

    The gates are the reference's: ``min_kfs_between_loops`` keyframes
    between loops (loopClosing.cpp:43), covisibility consistency over
    consecutive detections (:90), >= 20 Sim3 inliers (:171), >= 40 total
    matches after the guided search (:214)."""

    def __init__(self, system):
        from .loop_impl import LoopCloserImpl

        self.system = system
        self.last_loop_kf_count = 0
        self.consistent_groups = []  # (masks (C, K), counts (C,)) once a detection ran
        self.n_loops_closed = 0
        self._impl = LoopCloserImpl(system, self)

    def process(self, kf_id: int) -> bool:
        return self._impl.process(kf_id)

    def tick(self) -> None:
        """Advance any global BA in flight by one chunk."""
        self._impl.tick()

    def flush(self) -> bool:
        """Verify a detection still pending at sequence end and run any
        global BA in flight to its end."""
        return self._impl.flush()
