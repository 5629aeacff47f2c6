#!/usr/bin/env python3
"""The JAX package's pipelined stereo figures, on a CPU.

    python3 tools/jax_pipelined_stereo_reference.py [--frames N] [--float32]
    python3 tools/jax_pipelined_stereo_reference.py --runner DIR [--frames N]

Without ``--runner``: the JAX package's ``SlamSystem(kitti00_config,
Sensor.STEREO, enable_mapping=True, enable_loop_closing=False)`` with
``enable_pipelined(lag=16)`` and ``precompile()`` tracks
``ydorbslam_tpu_torch.testing.make_stereo_frames(N)`` (60 by default)
through ``track_stereo_pipelined``, fed as the uint8 pairs the function
returns (``--float32``: cast to float32 first, which the step does not
wrap at pyramid level 0), then ``shutdown()``.  It prints one JSON line:
the lost pattern, the per-frame packed outcomes (mode, ok, inliers,
need_kf, inserted; ``YDORBSLAM_TRACE_FRAMES``), the frames of each drain
and the keyframes it inserted, keyframes, deferred local BAs, the
TUM-file ATE against the ground truth (each row matched to its frame by
time) and the seconds of ``precompile()`` and of the run.

With ``--runner DIR``: the same frames written to DIR
(``testing.write_kitti_sequence``, unless DIR already holds them) and the
JAX package's own runner on it,

    python apps/run_kitti_stereo.py DIR --pipelined --poses DIR/poses.txt

(lag 16, its default; ``SlamConfig()`` with the calibration of
``calib.txt``, loop closing on).  It prints the runner's output and one
JSON line: its run stats, the ATE at full precision from the written
trajectory and ``poses.txt`` with the runner's own pairing
(``io.trajectory.ate_against_kitti_poses``), and the seconds.

These are the figures ``chip_smoke.py`` phases 19 and 20 hold the port
to.  Only the frames, the sequence writer and the trajectory readers come
from the port's package (its numpy-only ``testing`` and ``io``); none of
the port's SLAM code runs.
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402

LAG = 16


def run_part(n_frames: int, float32: bool) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ydorbslam_tpu import config as jconfig
    from ydorbslam_tpu.slam.system import Sensor, SlamSystem

    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.testing import kitti00_config, make_stereo_frames

    frames, poses = make_stereo_frames(n_frames)
    if float32:
        frames = [(t, le.astype(np.float32), r.astype(np.float32)) for t, le, r in frames]
    cfg = kitti00_config(jconfig)
    system = SlamSystem(cfg, Sensor.STEREO, enable_mapping=True, enable_loop_closing=False)
    drains = []
    orig = system._drain_batch

    def drain():
        """Each drain's frames and the keyframes it inserted."""
        batch = [fid for _, fid in system._pending]
        before = system.n_keyframes
        orig()
        if batch:
            drains.append([batch[0], batch[-1], system.n_keyframes - before])

    system._drain_batch = drain
    system.enable_pipelined(lag=LAG)
    t0 = time.perf_counter()
    system.precompile()
    precompile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in frames:
        system.track_stereo_pipelined(*f)
    system.shutdown()
    run_s = time.perf_counter() - t0
    stats = system.run_stats()
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    rows = [int(round(t * cfg.camera.fps)) for t in ts]
    lost = [int(r.lost) for r in system.records]
    return dict(
        part="run", feed="float32" if float32 else "uint8", frames=len(frames), lag=LAG,
        lost=sum(lost), lost_pattern=lost, keyframes_inserted=stats["keyframes_inserted"],
        keyframes_culled=stats["keyframes_culled"], keyframes_live=stats["keyframes_live"],
        local_ba_runs=stats["local_ba_runs"], map_points_live=stats["map_points_live"],
        reloc_successes=stats["reloc_successes"], tum_rows=len(ts),
        ate_tum=float(ate_rmse(pos, gt[rows])), precompile_s=round(precompile_s, 1),
        run_s=round(run_s, 1), drains=drains,
        trace=[[int(m), int(ok), int(n), int(need), int(ins)]
               for _, m, ok, n, need, ins in system.frame_trace],
    )


def runner_part(n_frames: int, root: str) -> dict:
    from jax_tum_reference import stats_from_output

    from ydorbslam_tpu_torch.io.trajectory import ate_against_kitti_poses
    from ydorbslam_tpu_torch.testing import make_stereo_frames, write_kitti_sequence

    poses_path = os.path.join(root, "poses.txt")
    if not os.path.exists(poses_path):
        frames, poses = make_stereo_frames(n_frames)
        write_kitti_sequence(root, frames, poses)
    with open(os.path.join(root, "times.txt")) as f:
        n = len(f.read().split())
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "CameraTrajectory.txt")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("YDORBSLAM_TRACE_FRAMES", None)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "apps", "run_kitti_stereo.py"), root,
             "--pipelined", "--poses", poses_path, "--out-trajectory", traj],
            env=env, capture_output=True, text=True, check=True, cwd=tmp,
        )
        secs = time.perf_counter() - t0
        print(res.stdout, flush=True)
        ate, pairs = ate_against_kitti_poses(traj, poses_path, n)
    return dict(stats_from_output(res.stdout), part="runner", lag=LAG, ate=ate,
                ate_pairs=pairs, seconds=round(secs, 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--float32", action="store_true",
                    help="feed float32 pairs (no level-0 wrap) instead of uint8")
    ap.add_argument("--runner", default=None, metavar="DIR",
                    help="run the JAX package's KITTI runner with --pipelined on DIR")
    args = ap.parse_args()
    if args.runner:
        print(json.dumps(runner_part(args.frames, args.runner)), flush=True)
    else:
        print(json.dumps(run_part(args.frames, args.float32)), flush=True)


if __name__ == "__main__":
    main()
