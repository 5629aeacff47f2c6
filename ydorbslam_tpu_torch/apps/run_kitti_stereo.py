"""KITTI odometry stereo runner for the PyTorch port.

    python -m ydorbslam_tpu_torch.apps.run_kitti_stereo SEQUENCE_DIR
        [--config CFG.yaml] [--poses POSES.txt] [--max-frames N]
        [--no-loop] [--pipelined [--lag N]] [--out-trajectory PATH]
        [--viewer-dir DIR] [--viewer-every N] [--device cuda|cpu] [--trace-spans]

The counterpart of ``apps/run_kitti_stereo.py``: it reads a KITTI
sequence directory (``image_0``/``image_1`` PNGs, ``times.txt``,
``calib.txt``), tracks every rectified pair through
``SlamSystem(cfg, Sensor.STEREO, ...)`` and prints the median and mean
tracking time, the run stats and, given ground-truth poses, the ATE of
the written TUM trajectory.  ``--pipelined`` tracks through the
pipelined path instead: it calls ``enable_pipelined(lag)`` (``--lag``,
default 16; without ``--pipelined`` it is accepted and unused, as in the
JAX runner) and ``precompile()``, dispatches every pair with
``track_stereo_pipelined`` and times each dispatch.  ``--viewer-dir``
writes a frame and a map PNG every ``--viewer-every`` frames.
``--trace-spans`` records the program's spans (``trace``) over the frames
and prints them by name after the run stats.  It runs on
the card (``--device cuda``, the default) and fails when there is none;
``--device cpu`` runs the plain versions of the kernels.  In a
multi-process environment (``YDORBSLAM_COORDINATOR`` /
``YDORBSLAM_NUM_PROCESSES`` / ``YDORBSLAM_PROCESS_ID``, or
``YDORBSLAM_AUTO_DISTRIBUTED=1`` under ``torchrun``) it joins first and
prints ``distributed: {...}``; only rank 0 writes the trajectory and the
PNGs.  ``main`` returns the shut-down system.
"""
import argparse
import dataclasses
import os

from ._common import add_port_arguments, check_arguments, join, print_stats, track_frames


def parse_arguments(argv=None):
    """The runner's arguments, checked (``_common.check_arguments``)."""
    ap = argparse.ArgumentParser(prog="python -m ydorbslam_tpu_torch.apps.run_kitti_stereo")
    ap.add_argument("sequence_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--poses", default=None, help="KITTI ground-truth poses.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--out-trajectory", default="CameraTrajectory.txt")
    ap.add_argument("--pipelined", action="store_true",
                    help="dispatch pairs ahead through the device pipeline and "
                         "decide them in batches, --lag frames late")
    ap.add_argument("--lag", type=int, default=16)
    add_port_arguments(ap)
    args = ap.parse_args(argv)
    check_arguments(ap, args)
    return args


def main(argv=None):
    args = parse_arguments(argv)
    writer = join(args)
    from ..config import SlamConfig, load_config
    from ..io import KittiStereoDataset, kitti_intrinsics
    from ..io.trajectory import ate_against_kitti_poses
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
    if args.pipelined:
        system.enable_pipelined(lag=args.lag)
        system.precompile()
    track = system.track_stereo_pipelined if args.pipelined else system.track_stereo
    recorded = track_frames(system, args, n, ds.__getitem__, track, 100, inliers=False,
                 wait=not args.pipelined)
    if writer:
        system.save_trajectory_tum(args.out_trajectory)
    print_stats(system, recorded)

    if args.poses and writer:
        ate, _ = ate_against_kitti_poses(args.out_trajectory, args.poses, len(ds))
        if ate is not None:
            print(f"ATE RMSE: {ate:.3f} m")
    return system


if __name__ == "__main__":
    main()
