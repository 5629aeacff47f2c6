"""The port's own spans and counters (``ydorbslam_tpu_torch/trace.py``), on the CPU.

A short stereo run of the synchronous path (``small_cfg``'s capacities,
640x480 pairs of the synthetic dot world; keyframes from the second
frame on) goes once with tracing off and once on: the outputs are bit
for bit the same, nothing is recorded off, and on, every frame has one
root ``frame`` span whose children nest inside it with its frame id.  A
counting stub on the tensor's host reads checks that each ``wait.<site>``
span holds exactly one read and that no read happens outside them.  A
short pipelined run carries the drain's five spans and the device step's.
The runner's ``--trace-spans`` prints the span table.  The readers of
``slambench/program_spans.py`` give known answers on hand-built
recordings, and None on an empty one.
"""
import collections
import os
import time

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence, project_np, render_dots

from slambench import program_spans
from ydorbslam_tpu_torch import trace
from ydorbslam_tpu_torch.apps import run_kitti_stereo
from ydorbslam_tpu_torch.config import (
    CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from ydorbslam_tpu_torch.slam.stats import format_spans
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.testing import write_kitti_sequence

torch.set_num_threads(2)

N_FRAMES = 5
READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")
MAPPING_CHILDREN = {
    "mapping.prep": ["mapping.cull_points", "mapping.triangulate", "mapping.refresh",
                     "mapping.fuse", "mapping.refresh"],
    "mapping.ba": ["mapping.ba_build", "mapping.ba_solve", "mapping.ba_apply"],
}
DRAIN = ["drain.fetch", "drain.frames", "drain.deferred_ba", "drain.trkset_refresh",
         "drain.loop_tick"]


def small_cfg():
    """``tests/test_slam_system.small_cfg`` in the port's config classes."""
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
                            height=480, fps=30.0),
        orb=OrbConfig(n_features=512),
        depth=DepthConfig(th_depth=100.0),
        tracking=TrackingConfig(kf_close_tracked_max=10_000, kf_close_untracked_min=3,
                                min_matches_local_map=20, min_init_depth_points=100),
        capacity=CapacityConfig(max_keypoints=512, max_keyframes=24, max_map_points=4096,
                                max_obs_per_point=12, local_ba_window_kf=12,
                                local_ba_fixed_kf=6, local_ba_max_points=2048,
                                tracking_points=2048),
    )


def stereo_frames(n):
    """(timestamp, left, right) uint8 pairs with a 0.1 m baseline, and the poses."""
    seq = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=12, n_landmarks=500)
    frames = []
    for i in range(n):
        T = seq.poses[i]
        T_r = T.copy()
        T_r[0, 3] -= 0.1
        (uv, z), (uv_r, z_r) = (project_np(seq.K, P, seq.landmarks) for P in (T, T_r))
        frames.append((i / 30.0, render_dots(uv, z, 640, 480).astype(np.uint8),
                       render_dots(uv_r, z_r, 640, 480).astype(np.uint8)))
    return frames, seq.poses[:n]


class ReadStub:
    """Counts the tensor's host reads (and ``.to(device)`` copies) with the
    host time of each, while installed."""

    def __init__(self):
        self.reads, self.copies = [], []
        self.saved = {n: getattr(torch.Tensor, n) for n in READS + ("to",)}

    def __enter__(self):
        def read(name):
            orig = self.saved[name]

            def f(t, *a, **k):
                self.reads.append((time.perf_counter_ns(), name))
                return orig(t, *a, **k)
            return f

        to = self.saved["to"]

        def copy(t, *a, **k):
            if a and isinstance(a[0], (torch.device, str)) or "device" in k:
                self.copies.append((time.perf_counter_ns(), "to"))
            return to(t, *a, **k)

        for n in READS:
            setattr(torch.Tensor, n, read(n))
        torch.Tensor.to = copy
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def _sync_run(frames, traced):
    system = SlamSystem(small_cfg(), Sensor.STEREO, enable_loop_closing=False, device="cpu")
    stub = ReadStub()
    if traced:
        trace.enable()
    try:
        with stub:
            for f in frames:
                system.track_stereo(*f)
    finally:
        recorded = trace.take()
    return system, recorded, stub


@pytest.fixture(scope="module")
def runs():
    frames, _ = stereo_frames(N_FRAMES)
    off, off_rec, _ = _sync_run(frames, traced=False)
    on, (spans, counts), stub = _sync_run(frames, traced=True)
    return dict(off=off, off_rec=off_rec, on=on, spans=spans, counts=counts, stub=stub)


def test_tracing_leaves_the_run_bit_equal(runs):
    off, on = runs["off"], runs["on"]
    assert len(off.tracker.records) == len(on.tracker.records) == N_FRAMES
    for a, b in zip(off.tracker.records, on.tracker.records):
        assert (a.timestamp, a.lost) == (b.timestamp, b.lost)
        np.testing.assert_array_equal(a.T_cw, b.T_cw)
    assert len(off.records) == len(on.records) == N_FRAMES
    for a, b in zip(off.records, on.records):
        assert (a.timestamp, a.ref_kf, a.lost) == (b.timestamp, b.ref_kf, b.lost)
        np.testing.assert_array_equal(a.T_c_ref, b.T_c_ref)
    assert off.run_stats() == on.run_stats()
    assert on.stats.local_ba_runs >= 2 and not any(r.lost for r in on.records)
    for a, b in zip(off.map, on.map):
        assert torch.equal(a, b)


def test_nothing_is_recorded_with_tracing_off(runs):
    assert runs["off_rec"] == ([], {})
    assert not trace.enabled()
    assert trace.span("frame", 3) is trace.span("mapping.ba") is trace.wait("snapshot")
    trace.count("keyframes")
    assert trace.take() == ([], {})


def test_frames_have_one_root_and_nested_children(runs):
    spans, counts = runs["spans"], runs["counts"]
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["frame"] * N_FRAMES
    assert [s.frame for s in roots] == list(range(N_FRAMES))
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1 and s.frame == p.frame, (s, p)
    assert counts == {"keyframes": runs["on"].stats.keyframes_inserted}
    kids = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(s.name)
    mapped = [i for i, s in enumerate(spans) if s.name == "mapping.prep"]
    assert len(mapped) == runs["on"].stats.local_ba_runs
    for i, s in enumerate(spans):
        if s.name in MAPPING_CHILDREN:
            assert kids[i] == MAPPING_CHILDREN[s.name], (s.name, kids[i])
            assert spans[s.parent].name == "frame"
    for fid in range(N_FRAMES):
        names = [s.name for s in spans if s.frame == fid]
        assert names.count("track.extract") == 2 and names.count("track.stereo") == 1
        assert names.count("wait.upload_image") == 2 and names.count("wait.record_pose") == 1
        if fid and fid in {s.frame for s in spans if s.name == "mapping.prep"}:
            for name in ("track.motion", "track.pose_motion", "track.local_map_match",
                         "track.pose_local", "track.kf_decision", "track.kf_insert",
                         "mapping.ba", "mapping.cull_kf", "wait.snapshot"):
                assert name in names, (fid, name)


def test_each_wait_span_holds_one_read_and_no_read_is_outside(runs):
    spans, stub = runs["spans"], runs["stub"]
    waits = [s for s in spans if s.name.startswith("wait.")]
    frames = [s for s in spans if s.name == "frame"]
    inside = collections.Counter()
    per_site = collections.Counter()
    outside = []
    for t, name in stub.reads + stub.copies:
        hit = [w for w in waits if w.t0 <= t <= w.t1]
        if hit:
            inside[id(hit[0])] += 1
            per_site[hit[0].name] += 1
        elif name != "to" and any(f.t0 <= t <= f.t1 for f in frames):
            outside.append(name)
    assert outside == []
    assert all(inside[id(w)] == 1 for w in waits), [w.name for w in waits if inside[id(w)] != 1]
    assert per_site == collections.Counter(w.name for w in waits)
    assert {"wait.upload_image", "wait.motion_matches", "wait.pose_inliers", "wait.record_pose",
            "wait.ref_pose", "wait.ref_tracked", "wait.kf_decision",
            "wait.snapshot"} <= set(per_site)


def test_pipelined_run_carries_the_drain_and_step_spans():
    frames, _ = stereo_frames(6)
    system = SlamSystem(small_cfg(), Sensor.STEREO, enable_loop_closing=False, device="cpu")
    system.enable_pipelined(lag=2)
    trace.enable()
    try:
        for f in frames:
            system.track_stereo_pipelined(*f)
        system.flush_pipeline()
    finally:
        spans, counts = trace.take()
    assert [s.frame for s in spans if s.name == "frame"] == list(range(6))
    steps = [s for s in spans if s.name == "pipeline.step"]
    assert len(steps) == 6 and all(spans[s.parent].name == "frame" for s in steps)
    drains = [s.name for s in spans if s.name.startswith("drain.")]
    assert len(drains) >= 5 * 2 and drains == DRAIN * (len(drains) // 5)
    fetch = [i for i, s in enumerate(spans) if s.name == "drain.fetch"]
    assert all(spans[i + 1].name == "wait.drain_ring" and spans[i + 1].parent == i
               for i in fetch)
    assert counts["keyframes"] == system.stats.keyframes_inserted >= 2
    assert any(s.name == "mapping.prep" for s in spans)
    assert not trace.enabled()


def _kitti_dir(root, n):
    """A KITTI directory of ``stereo_frames`` with their own camera."""
    frames, poses = stereo_frames(n)
    write_kitti_sequence(root, frames, poses)
    P0 = "500 0 320 0 0 500 240 0 0 0 1 0"
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P0: {P0}\nP1: {P0.replace('500 0 320 0', '500 0 320 -50', 1)}\n")


def test_kitti_runner_prints_the_span_table(tmp_path, capsys):
    root = str(tmp_path / "seq")
    _kitti_dir(root, 3)
    system = run_kitti_stereo.main([root, "--no-loop", "--device", "cpu", "--trace-spans",
                                    "--out-trajectory", str(tmp_path / "traj.txt")])
    out = capsys.readouterr().out
    stats, table = out.split("--- run stats ---")[1].split("--- spans ---")
    assert "frames        3  (lost 0" in stats
    rows = {line.split()[0]: line.split()[1:] for line in table.strip().splitlines()[1:]}
    assert rows["frame"][0] == "3" and rows["track.extract"][0] == "6"
    assert rows["wait.upload_image"][0] == "6" and rows["wait.record_pose"][0] == "3"
    assert float(rows["frame"][1]) > float(rows["track.extract"][1]) > 0
    assert rows["count"] == ["keyframes", str(system.stats.keyframes_inserted)]
    assert not trace.enabled()


# -- the readers of a recording, on hand-built spans ----------------------

def S(name, parent, frame, t0, t1):
    return trace.Span(name, parent, frame, t0, t1)


MS = 1_000_000
HAND = [
    S("frame", -1, 0, 0, 100 * MS),                    # 0
    S("track.extract", 0, 0, 0, 10 * MS),              # 1
    S("wait.upload_image", 1, 0, 0, 1 * MS),           # 2
    S("track.extract", 0, 0, 10 * MS, 22 * MS),        # 3
    S("track.pose_motion", 0, 0, 22 * MS, 30 * MS),    # 4
    S("wait.pose_inliers", 4, 0, 29 * MS, 30 * MS),    # 5
    S("track.pose_local", 0, 0, 30 * MS, 35 * MS),     # 6
    S("mapping.prep", 0, 0, 40 * MS, 60 * MS),         # 7
    S("mapping.ba", 0, 0, 60 * MS, 90 * MS),           # 8
    S("frame", -1, 1, 100 * MS, 150 * MS),             # 9
    S("track.extract", 9, 1, 100 * MS, 130 * MS),      # 10
    S("wait.record_pose", 9, 1, 140 * MS, 142 * MS),   # 11
    S("frame", -1, 2, 150 * MS, 170 * MS),             # 12
    S("track.extract", 12, 2, 150 * MS, 156 * MS),     # 13
    S("track.pose_motion", 12, 2, 156 * MS, 160 * MS),  # 14
    S("mapping.prep", 12, 2, 160 * MS, 164 * MS),      # 15
    S("mapping.ba", 12, 2, 164 * MS, 170 * MS),        # 16
]


@pytest.mark.parametrize("name, want", [
    ("extract_ms_p50", 22.0),           # per frame 22, 30, 6
    ("pose_ms_p50", 4.0),               # per frame 13, 0, 4
    ("map_prep_ms_p50", 12.0),          # spans 20, 4
    ("local_ba_ms_p50", 18.0),          # spans 30, 6
    ("host_wait_ms_per_frame", 4 / 3),  # 1 + 1 + 2 over 3 frames
    ("keyframes_per_frame", 2 / 3),
])
def test_program_span_readers_on_a_hand_built_recording(name, want):
    read = program_spans.READINGS[name]
    assert read(HAND, {"keyframes": 2}) == pytest.approx(want)
    assert read([], {}) is None
    if name not in ("host_wait_ms_per_frame", "keyframes_per_frame"):
        assert read([s for s in HAND if s.name == "frame"], {}) is None


def test_self_time_and_idle_by_innermost_span():
    own = program_spans.self_ms(HAND)
    assert own[0] == pytest.approx(100 - 10 - 12 - 8 - 5 - 20 - 30)
    assert own[1] == pytest.approx(9) and own[4] == pytest.approx(7)
    assert program_spans.self_ms_by_name(HAND)["track.extract"] == pytest.approx(9 + 12 + 30 + 6)
    # Device gaps, on a device clock 5 ms ahead of the host's.
    gaps = [(5 * MS, 2 * MS), (33 * MS, 10 * MS), (165 * MS, 10 * MS), (185 * MS, 1 * MS)]
    idle = program_spans.idle_by_span(HAND, gaps, 5 * MS)
    assert idle == pytest.approx({"wait.upload_image": 0.001, "track.extract": 0.001,
                                  "track.pose_motion": 0.001, "wait.pose_inliers": 0.001,
                                  "track.pose_local": 0.005, "frame": 0.003,
                                  "mapping.prep": 0.004, "mapping.ba": 0.006, None: 0.001})


def test_format_spans_lists_each_name():
    text = format_spans(HAND, {"keyframes": 2})
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines()[1:]}
    assert rows["track.extract"] == ["4", "58.000", "11.000"]
    assert rows["frame"] == ["3", "170.000", "50.000"]
    assert rows["count"] == ["keyframes", "2"]
