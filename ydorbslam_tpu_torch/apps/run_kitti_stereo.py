"""KITTI odometry stereo runner for the PyTorch port.

    python -m ydorbslam_tpu_torch.apps.run_kitti_stereo SEQUENCE_DIR
        [--config CFG.yaml] [--poses POSES.txt] [--max-frames N]
        [--no-loop] [--out-trajectory PATH] [--viewer-dir DIR]
        [--viewer-every N] [--device cuda|cpu]

The counterpart of ``apps/run_kitti_stereo.py``: it reads a KITTI
sequence directory (``image_0``/``image_1`` PNGs, ``times.txt``,
``calib.txt``), tracks every rectified pair through
``SlamSystem(cfg, Sensor.STEREO, ...)`` and prints the median and mean
tracking time, the run stats and, given ground-truth poses, the ATE of
the written TUM trajectory.  ``--viewer-dir`` writes a frame and a map
PNG every ``--viewer-every`` frames.  It runs on the card
(``--device cuda``, the default) and fails when there is none;
``--device cpu`` runs the plain versions of the kernels.  Not ported:
``--pipelined``/``--lag`` and the multi-host join (the
``YDORBSLAM_COORDINATOR`` / ``YDORBSLAM_AUTO_DISTRIBUTED`` environment);
each stops the runner with an error.
"""
import argparse
import dataclasses
import os

import numpy as np

from ._common import add_port_arguments, check_arguments, print_stats, track_frames


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ydorbslam_tpu_torch.apps.run_kitti_stereo")
    ap.add_argument("sequence_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--poses", default=None, help="KITTI ground-truth poses.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--out-trajectory", default="CameraTrajectory.txt")
    ap.add_argument("--pipelined", action="store_true", help="not ported")
    ap.add_argument("--lag", type=int, default=None, help="not ported")
    add_port_arguments(ap)
    args = ap.parse_args(argv)
    given = [f"--{k}" for k in ("pipelined", "lag") if getattr(args, k) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not ported to the PyTorch package")
    check_arguments(ap, args)

    from ..config import SlamConfig, load_config
    from ..io import KittiStereoDataset, ate_rmse, kitti_intrinsics, read_tum_trajectory
    from ..slam.system import Sensor, SlamSystem

    ds = KittiStereoDataset(args.sequence_dir)
    fx, fy, cx, cy, bf = kitti_intrinsics(os.path.join(args.sequence_dir, "calib.txt"))
    _, left0, _ = ds[0]
    h, w = left0.shape
    cfg = load_config(args.config) if args.config else SlamConfig()
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(
            cfg.camera, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,  # KITTI is rectified
            width=w, height=h, fps=10.0,
        ),
    )
    n = len(ds) if not args.max_frames else min(args.max_frames, len(ds))
    system = SlamSystem(cfg, Sensor.STEREO, enable_loop_closing=not args.no_loop,
                        device=args.device)
    track_frames(system, args, n, ds.__getitem__, system.track_stereo, 100, inliers=False)
    system.save_trajectory_tum(args.out_trajectory)
    print_stats(system)

    if args.poses:
        P = np.loadtxt(args.poses).reshape(-1, 3, 4)  # T_w_cam rows
        _, p_est, _ = read_tum_trajectory(args.out_trajectory)
        gt_pos = P[: len(ds), :, 3]
        k = min(len(p_est), len(gt_pos))
        if k >= 3:
            print(f"ATE RMSE: {ate_rmse(p_est[:k], gt_pos[:k]):.3f} m")
    return system


if __name__ == "__main__":
    main()
