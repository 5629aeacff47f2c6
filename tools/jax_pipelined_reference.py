#!/usr/bin/env python3
"""The JAX package's pipelined RGB-D figures, on a CPU.

    python3 tools/jax_pipelined_reference.py [--frames N] [--part bench|tum|both]

Two runs of the JAX package's pipelined path (``enable_pipelined`` and
``precompile``), the figures that ``chip_smoke.py`` phases 17 and 18 hold
the port to:

* ``bench``: bench.py's own configuration and call sequence on a CPU:
  ``bench.make_system(enable_loop_closing=False)`` (lag 16, the
  capacities of ``chip_smoke._config()``), then ``bench.run`` over
  ``bench.make_frames()`` (20 warm-up frames, ``flush_pipeline``, the
  other 100 frames, ``shutdown``).  It prints the lost frames, keyframes
  inserted and live, local BAs, the TUM-file ATE against the ground truth
  (each row matched to its frame by time, as ``chip_smoke.py`` phase 8
  does) and the frame trace (``YDORBSLAM_TRACE_FRAMES``: mode, ok,
  inliers, need_kf, inserted per frame).
* ``tum``: ``bench.make_frames()`` written as a TUM directory
  (``ydorbslam_tpu_torch.testing.write_tum_sequence``) and the JAX
  package's own runner on it with ``--pipelined`` (lag 16, its default),
  mapping and loop closing on, at ``load_config``'s capacities:

      python apps/run_tum_rgbd.py settings.yaml DIR assoc.txt --groundtruth gt.txt --pipelined

Each part prints one JSON line.  Only the frames, the sequence writer and
the trajectory reader come from the port's package (its numpy-only
``testing`` and ``io``); none of the port's SLAM code runs.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["YDORBSLAM_TRACE_FRAMES"] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402


def bench_part(n_frames: int) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench
    from synthetic import oscillating_trajectory

    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory

    frames = bench.make_frames(n_frames)
    gt = oscillating_trajectory(len(frames))
    gt_centres = np.stack([-p[:3, :3].T @ p[:3, 3] for p in gt])
    t0 = time.perf_counter()
    system = bench.make_system(enable_loop_closing=False)
    precompile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fps, bstats = bench.run(system, frames)
    run_s = time.perf_counter() - t0
    stats = system.run_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    frame_of = {t: i for i, (t, _, _) in enumerate(frames)}
    rows = [frame_of[min(frame_of, key=lambda x: abs(x - t))] for t in ts]
    lost = [i for i, r in enumerate(system.records) if r.lost]
    return dict(
        part="bench", frames=len(frames), lag=system._pipe_lag,
        lost=len(lost), lost_frames=lost, tracked=len(system.records) - len(lost),
        records=len(system.records), keyframes_inserted=stats["keyframes_inserted"],
        keyframes_culled=stats["keyframes_culled"], keyframes_live=stats["keyframes_live"],
        local_ba_runs=stats["local_ba_runs"], map_points_live=stats["map_points_live"],
        tum_rows=len(ts), ate_tum=float(ate_rmse(pos, gt_centres[rows])),
        precompile_s=round(precompile_s, 1), run_s=round(run_s, 1), cpu_fps=fps,
        bench_stats=bstats,
        trace=[[int(m), int(ok), int(n), int(need), int(ins)]
               for _, m, ok, n, need, ins in system.frame_trace],
    )


def tum_part(n_frames: int) -> dict:
    import bench
    from jax_tum_reference import stats_from_output
    from synthetic import oscillating_trajectory

    from ydorbslam_tpu_torch.io.trajectory import ate_against_groundtruth
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_tum_sequence

    frames = bench.make_frames(n_frames)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        yaml, assoc, gt = write_tum_sequence(seq, frames, oscillating_trajectory(len(frames)),
                                             TUM_RGBD_SETTINGS)
        traj = os.path.join(seq, "CameraTrajectory.txt")
        kf_traj = os.path.join(seq, "KeyFrameTrajectory.txt")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("YDORBSLAM_TRACE_FRAMES", None)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "apps", "run_tum_rgbd.py"), yaml, seq, assoc,
             "--groundtruth", gt, "--out-trajectory", traj, "--out-kf-trajectory", kf_traj,
             "--pipelined"],
            env=env, capture_output=True, text=True, check=True,
        )
        secs = time.perf_counter() - t0
        print(res.stdout, flush=True)
        return dict(stats_from_output(res.stdout), part="tum", lag=16,
                    ate_tum=ate_against_groundtruth(traj, gt)[0], seconds=round(secs, 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--part", choices=("bench", "tum", "both"), default="both")
    args = ap.parse_args()
    if args.part in ("tum", "both"):
        print(json.dumps(tum_part(args.frames)), flush=True)
    if args.part in ("bench", "both"):
        print(json.dumps(bench_part(args.frames)), flush=True)


if __name__ == "__main__":
    main()
