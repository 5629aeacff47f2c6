#!/usr/bin/env python3
"""The JAX package's figures on the stereo workload, on a CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_stereo_reference.py [--frames N]

Runs ``ydorbslam_tpu``'s synchronous stereo ``SlamSystem`` (mapping on,
loop closing off) over ``ydorbslam_tpu_torch.testing.make_stereo_frames``
(rectified 1241x376 pairs at the KITTI-00 camera, seed 0) with the
settings of ``testing.kitti00_config``: 2000 features (2048 keypoint
slots), ThDepth 35, 10 fps, ``min_init_depth_points`` 500, 160 keyframe
slots, every other capacity at its default.  It prints one JSON line:
the keypoints and stereo depths of frame 0 (its own extraction and
``stereo_match``), the lost pattern, keyframes, local BAs, live map
points, the TUM-file ATE against ground truth and the run time.  These
are the figures that ``chip_smoke.py`` phase 14 holds the port to.
Only the frames and the settings come from the port's ``testing``
module; nothing of the port runs.
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

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args()

    import jax.numpy as jnp

    from ydorbslam_tpu import config as jconfig
    from ydorbslam_tpu.io.trajectory import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu.ops.pyramid import build_pyramid
    from ydorbslam_tpu.ops.stereo import stereo_match
    from ydorbslam_tpu.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import kitti00_config, make_stereo_frames

    frames, poses = make_stereo_frames(args.frames)
    cfg = kitti00_config(jconfig)
    system = SlamSystem(cfg, Sensor.STEREO, enable_mapping=True, enable_loop_closing=False)
    o = cfg.orb
    tr = system.tracker
    _, left, right = frames[0]
    f0 = stereo_match(
        tr._extract(left), tr._extract(right),
        build_pyramid(jnp.asarray(left, jnp.float32), o.n_levels, o.scale_factor),
        build_pyramid(jnp.asarray(right, jnp.float32), o.n_levels, o.scale_factor),
        tr.cam, o.n_levels, o.scale_factor,
    )
    oks = []
    t0 = time.perf_counter()
    for t, left, right in frames:
        oks.append(bool(system.track_stereo(t, left, right)))
    secs = time.perf_counter() - t0
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    rows = [int(round(t * cfg.camera.fps)) for t in ts]
    stats = system.run_stats()
    print(json.dumps(dict(
        frames=len(frames), seconds=round(secs, 1),
        keypoints_frame0=int(np.sum(np.asarray(f0.valid))),
        stereo_depths_frame0=int(np.sum(np.asarray(f0.valid & (f0.depth > 0)))),
        lost=int(sum(not ok for ok in oks)), tracked=int(sum(oks)),
        lost_pattern=[int(not ok) for ok in oks],
        keyframes_inserted=stats["keyframes_inserted"], keyframes_live=stats["keyframes_live"],
        map_points_live=stats["map_points_live"], local_ba_runs=stats["local_ba_runs"],
        tum_rows=len(ts), ate_tum=ate_rmse(pos, gt[rows]),
    )))


if __name__ == "__main__":
    with jax.default_device(jax.devices("cpu")[0]):
        main()
