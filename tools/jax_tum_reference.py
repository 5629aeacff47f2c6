#!/usr/bin/env python3
"""The JAX package's figures on the TUM-runner workload, on a CPU.

    python3 tools/jax_tum_reference.py [--frames N] [--out DIR]

Writes ``bench.make_frames()`` (120 synthetic 640x480 RGB-D frames) to
disk as a TUM sequence directory with
``ydorbslam_tpu_torch.testing.write_tum_sequence`` (the settings file
``TUM_RGBD_SETTINGS``: the rendering camera and TUM1.yaml's ORB and
depth settings; every capacity at ``load_config``'s default), then runs
the JAX package's own runner on it on the CPU, as a user would:

    python apps/run_tum_rgbd.py settings.yaml DIR assoc.txt --groundtruth groundtruth.txt

with loop closing and mapping on (the runner's defaults).  It prints the
runner's output, then one JSON line: frames, tracked and lost frames,
keyframes inserted and live, live map points, local BAs, loops closed,
the ATE of the written trajectory against the ground truth (unrounded;
the runner prints four decimals), the runner's run time, and frame 0's
keypoints and how many of them get a depth (the initialization gate
needs ``min_init_depth_points``, 500).  These are
the figures that ``chip_smoke.py`` phase 15 holds the port's runner to.
Only the frames, the sequence writer and the trajectory reader come
from the port's package (its numpy-only ``testing`` and ``io``); none
of the port's SLAM code runs.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def stats_from_output(out: str) -> dict:
    """The run-stats block of a runner's output (``format_stats``) as numbers."""
    m = re.search(r"frames\s+(\d+)\s+\(lost (\d+)", out)
    kf = re.search(r"keyframes\s+\+(\d+) / -(\d+) culled\s+\(live (\d+)\)", out)
    return dict(
        frames=int(m.group(1)), lost=int(m.group(2)),
        tracked=int(m.group(1)) - int(m.group(2)),
        keyframes_inserted=int(kf.group(1)), keyframes_culled=int(kf.group(2)),
        keyframes_live=int(kf.group(3)),
        map_points_live=int(re.search(r"map points\s+live (\d+)", out).group(1)),
        local_ba_runs=int(re.search(r"local BA\s+(\d+) runs", out).group(1)),
        loops_closed=int(re.search(r"loops\s+(\d+) closed", out).group(1)),
    )


def frame0_depths(yaml: str, frame) -> tuple:
    """Frame 0's valid keypoints and those with a depth, as the JAX
    package's tracker extracts them under the settings file."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from ydorbslam_tpu.config import load_config
    from ydorbslam_tpu.ops.stereo import fill_depth_from_rgbd
    from ydorbslam_tpu.slam.tracking import Tracker

    cfg = load_config(yaml)
    tr = Tracker(cfg)
    _, gray, depth = frame
    depth = depth.astype(np.float32) / cfg.depth.depth_map_factor  # as Tracker.track_rgbd
    f = fill_depth_from_rgbd(tr._extract(gray), jnp.asarray(depth), tr.cam)
    valid = np.asarray(f.valid)
    return int(valid.sum()), int((valid & (np.asarray(f.depth) > 0)).sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default=None, help="keep the sequence directory here")
    args = ap.parse_args()

    import bench

    from ydorbslam_tpu_torch.io.trajectory import ate_against_groundtruth
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_tum_sequence

    frames = bench.make_frames(args.frames)
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    with tempfile.TemporaryDirectory() as tmp:
        seq = args.out or os.path.join(tmp, "seq")
        yaml, assoc, gt = write_tum_sequence(seq, frames, oscillating_trajectory(len(frames)),
                                             TUM_RGBD_SETTINGS)
        traj = os.path.join(seq, "CameraTrajectory.txt")
        kf_traj = os.path.join(seq, "KeyFrameTrajectory.txt")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "apps", "run_tum_rgbd.py"), yaml, seq, assoc,
             "--groundtruth", gt, "--out-trajectory", traj, "--out-kf-trajectory", kf_traj],
            env=env, capture_output=True, text=True, check=True,
        )
        secs = time.perf_counter() - t0
        print(res.stdout, flush=True)
        kp0, depth0 = frame0_depths(yaml, frames[0])
        print(json.dumps(dict(stats_from_output(res.stdout),
                              ate_tum=ate_against_groundtruth(traj, gt)[0],
                              seconds=round(secs, 1), keypoints_frame0=kp0,
                              depths_frame0=depth0)))


if __name__ == "__main__":
    main()
