"""KITTI odometry stereo runner for the PyTorch port.

    python -m ydorbslam_tpu_torch.apps.run_kitti_stereo SEQUENCE_DIR
        [--config CFG.yaml] [--poses POSES.txt] [--max-frames N]
        [--no-loop] [--out-trajectory PATH] [--device cuda|cpu]

The counterpart of ``apps/run_kitti_stereo.py``: it reads a KITTI
sequence directory (``image_0``/``image_1`` PNGs, ``times.txt``,
``calib.txt``), tracks every rectified pair through
``SlamSystem(cfg, Sensor.STEREO, ...)`` and prints the median and mean
tracking time, the run stats and, given ground-truth poses, the ATE of
the written TUM trajectory.  It runs on the card (``--device cuda``, the
default) and fails when there is none; ``--device cpu`` runs the plain
versions of the kernels.  Not ported: ``--pipelined``/``--lag``, the
viewer (``--viewer-dir``/``--viewer-every``) and the multi-host join
(the ``YDORBSLAM_COORDINATOR`` / ``YDORBSLAM_AUTO_DISTRIBUTED``
environment); each stops the runner with an error.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

NOT_PORTED = ("pipelined", "lag", "viewer_dir", "viewer_every")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ydorbslam_tpu_torch.apps.run_kitti_stereo")
    ap.add_argument("sequence_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--poses", default=None, help="KITTI ground-truth poses.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--out-trajectory", default="CameraTrajectory.txt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pipelined", action="store_true", help="not ported")
    ap.add_argument("--lag", type=int, default=None, help="not ported")
    ap.add_argument("--viewer-dir", default=None, help="not ported")
    ap.add_argument("--viewer-every", type=int, default=None, help="not ported")
    args = ap.parse_args(argv)

    given = [f"--{k.replace('_', '-')}" for k in NOT_PORTED
             if getattr(args, k) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not ported to the PyTorch package")
    if os.environ.get("YDORBSLAM_COORDINATOR") or \
            os.environ.get("YDORBSLAM_AUTO_DISTRIBUTED") == "1":
        ap.error("the multi-host join is not ported to the PyTorch package")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device found (pass --device cpu to run on the CPU)")

    from ..config import SlamConfig, load_config
    from ..io import KittiStereoDataset, ate_rmse, kitti_intrinsics, read_tum_trajectory
    from ..slam.stats import format_stats
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
    cuda = system.device.type == "cuda"
    times = []
    for i in range(n):
        t, left, right = ds[i]
        t0 = time.perf_counter()
        system.track_stereo(t, left, right)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(
                f"frame {i}/{n} state={system.tracking_state().name} "
                f"kfs={system.n_keyframes}"
            )
    system.shutdown()
    stimes = sorted(times[3:]) or times
    print(f"median tracking time: {stimes[len(stimes) // 2]:.4f}")
    print(f"mean tracking time: {sum(stimes) / len(stimes):.4f}")
    system.save_trajectory_tum(args.out_trajectory)

    print("--- run stats ---")
    print(format_stats(system.run_stats()))

    if args.poses:
        P = np.loadtxt(args.poses).reshape(-1, 3, 4)  # T_w_cam rows
        _, p_est, _ = read_tum_trajectory(args.out_trajectory)
        gt_pos = P[: len(ds), :, 3]
        k = min(len(p_est), len(gt_pos))
        if k >= 3:
            print(f"ATE RMSE: {ate_rmse(p_est[:k], gt_pos[:k]):.3f} m")


if __name__ == "__main__":
    main()
