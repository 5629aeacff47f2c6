#!/usr/bin/env python3
"""The JAX package's loop-on figures on the revisit workload, on a CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_revisit_reference.py [--frames N] [--features F]

Runs ``ydorbslam_tpu``'s synchronous RGB-D ``SlamSystem`` (mapping and loop
closing on, default ``LoopConfig``) over ``bench.make_revisit_frames()``
(a 100-frame drifted orbit and a 40-frame tail, 640x480) with the
capacities of ``chip_smoke._config()`` (160 keyframes, 16384 map points,
1000 features), then ``shutdown()``.  It prints one JSON line: loop events
(query frame, matched frame, |t|), the first frame after which a loop had
closed, lost frames, keyframes, the TUM-file ATE, the worst camera-centre
error before the closure and the best after it, the cross-loop edge
counts and the verification failures.  These are the figures that
``chip_smoke.py`` phase 13 holds the port to.  One device: the sharded
detection and global BA of a multi-device host are not used.
"""
import argparse
import json
import os
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=140)
    ap.add_argument("--features", type=int, default=1000)
    args = ap.parse_args()

    import bench
    from synthetic import OrbitDriftSequence
    from ydorbslam_tpu.config import (
        CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from ydorbslam_tpu.io.trajectory import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu.slam.system import Sensor, SlamSystem

    frames = bench.make_revisit_frames()[: args.frames]
    seq = OrbitDriftSequence(np.random.default_rng(7), n_frames=100, n_landmarks=1500,
                             drift_rate=0.008)
    cfg = SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                            width=640, height=480),
        orb=OrbConfig(n_features=args.features),
        depth=DepthConfig(depth_map_factor=5000.0),
        capacity=CapacityConfig(max_keyframes=160, max_map_points=16384),
    )
    system = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True)
    errs, oks, loop_frame = [], [], None
    t0 = time.perf_counter()
    for i, (t, g, d) in enumerate(frames):
        oks.append(bool(system.track_rgbd(t, g, d)))
        T = np.asarray(system.tracker.T_cw, np.float64)
        errs.append(float(np.linalg.norm(-T[:3, :3].T @ T[:3, 3] - seq.gt_center_est_frame(i))))
        if loop_frame is None and system.loop_closer.n_loops_closed:
            loop_frame = i
    system.shutdown()
    secs = time.perf_counter() - t0
    gt = np.stack([-seq.pose(i)[:3, :3].T @ seq.pose(i)[:3, 3] for i in range(len(frames))])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    rows = [int(round(t * 30.0)) for t in ts]
    stats = system.run_stats()
    out = dict(
        frames=len(frames), features=args.features, seconds=round(secs, 1),
        lost=int(sum(not o for o in oks)), tracked=int(sum(oks)),
        loops_closed=stats["loops_closed"], loop_events=stats["loop_events"],
        loop_frame=loop_frame, loop_conn_edges=stats["loop_conn_edges"],
        loop_verify_fails={k: v for k, v in stats["loop_verify_fails"].items()
                           if k != "bow_diag"},
        loop_candidates=stats["loop_candidates"], global_ba_runs=stats["global_ba_runs"],
        keyframes_inserted=stats["keyframes_inserted"],
        keyframes_live=stats["keyframes_live"], map_points_live=stats["map_points_live"],
        tum_rows=len(ts), ate_tum=ate_rmse(pos, gt[rows]),
        pre_err=(max(errs[100 - 8:loop_frame + 1]) if loop_frame is not None else None),
        post_err=(min(errs[loop_frame + 1:]) if loop_frame is not None
                  and loop_frame + 1 < len(errs) else None),
        max_err=max(errs), centre_errs=[round(e, 6) for e in errs],
    )
    print(json.dumps(out))


if __name__ == "__main__":
    with jax.default_device(jax.devices("cpu")[0]):
        main()
