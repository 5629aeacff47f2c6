"""TUM RGB-D sequence runner for the PyTorch port: the contract of the
reference's test program (test/src/test.cpp).

    python -m ydorbslam_tpu_torch.apps.run_tum_rgbd CONFIG.yaml SEQUENCE_DIR ASSOC.txt
        [--groundtruth GT.txt] [--no-loop] [--no-mapping] [--max-frames N]
        [--out-trajectory PATH] [--out-kf-trajectory PATH] [--viz MAP.png]
        [--viewer-dir DIR] [--viewer-every N] [--device cuda|cpu]
        [--pipelined [--lag N]] [--trace-spans]

The counterpart of ``apps/run_tum_rgbd.py``, with its arguments and
output: it parses the association file, builds the system from the
settings file (every capacity at ``load_config``'s default), tracks
every frame through ``SlamSystem(cfg, Sensor.RGBD, ...)`` with mapping
and loop closing on unless ``--no-mapping``/``--no-loop``, prints the
median and mean tracking time (test.cpp:98-106), writes
CameraTrajectory.txt and KeyFrameTrajectory.txt (test.cpp:109-110) and
prints the run stats, a top-down map PNG (``--viz``) and, given a
groundtruth.txt, the ATE of the written trajectory.  ``--viewer-dir``
writes a frame and a map PNG every ``--viewer-every`` frames.
``--trace-spans`` records the program's spans (``trace``) over the frames
and prints them by name after the run stats.
``--pipelined`` tracks through the pipelined path instead: it calls
``enable_pipelined(lag)`` (``--lag``, default 16) and ``precompile()``,
dispatches every frame with ``track_rgbd_pipelined`` and times each
dispatch, as the JAX runner does; with ``YDORBSLAM_TRACE_FRAMES`` set it
prints the per-frame trace after the run stats.  It runs on the card
(``--device cuda``, the default) and fails when there is none;
``--device cpu`` runs the plain versions of the kernels.  In a
multi-process environment (``YDORBSLAM_COORDINATOR`` /
``YDORBSLAM_NUM_PROCESSES`` / ``YDORBSLAM_PROCESS_ID``, or
``YDORBSLAM_AUTO_DISTRIBUTED=1`` under ``torchrun``) it joins first and
prints ``distributed: {...}``; every rank tracks the sequence, loop
closing shards its scoring and global BA over the ranks, and only rank 0
writes the trajectories and the PNGs.  ``main`` returns the shut-down
system.
"""
import argparse

from ._common import add_port_arguments, check_arguments, join, print_stats, track_frames


def parse_arguments(argv=None):
    """The runner's arguments, checked (``_common.check_arguments``)."""
    ap = argparse.ArgumentParser(prog="python -m ydorbslam_tpu_torch.apps.run_tum_rgbd")
    ap.add_argument("config")
    ap.add_argument("sequence_dir")
    ap.add_argument("assoc")
    ap.add_argument("--groundtruth", default=None)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-mapping", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-trajectory", default="CameraTrajectory.txt")
    ap.add_argument("--out-kf-trajectory", default="KeyFrameTrajectory.txt")
    ap.add_argument("--viz", default=None, help="write a map/trajectory PNG")
    ap.add_argument("--pipelined", action="store_true",
                    help="dispatch frames ahead through the device pipeline and "
                         "decide them in batches, --lag frames late")
    ap.add_argument("--lag", type=int, default=16)
    add_port_arguments(ap)
    args = ap.parse_args(argv)
    check_arguments(ap, args)
    return args


def main(argv=None):
    args = parse_arguments(argv)
    writer = join(args)
    from ..config import load_config
    from ..io import TumRgbdDataset
    from ..io.trajectory import ate_against_groundtruth
    from ..slam.system import Sensor, SlamSystem

    cfg = load_config(args.config)
    ds = TumRgbdDataset(args.sequence_dir, args.assoc, cfg.depth.depth_map_factor,
                        is_rgb=cfg.camera.is_rgb)
    n = len(ds) if not args.max_frames else min(args.max_frames, len(ds))
    print(f"sequence: {n} frames; starting SLAM")
    system = SlamSystem(cfg, Sensor.RGBD, enable_mapping=not args.no_mapping,
                        enable_loop_closing=not args.no_loop, device=args.device)
    if args.pipelined:
        system.enable_pipelined(lag=args.lag)
        system.precompile()
    track = system.track_rgbd_pipelined if args.pipelined else system.track_rgbd
    recorded = track_frames(system, args, n, ds.__getitem__, track, 50, wait=not args.pipelined)
    if writer:
        system.save_trajectory_tum(args.out_trajectory)
        system.save_keyframe_trajectory_tum(args.out_kf_trajectory)
        print(f"trajectories saved: {args.out_trajectory}, {args.out_kf_trajectory}")
    print_stats(system, recorded)
    if system.frame_trace is not None:
        print("--- frame trace (i mode ok inl [need] [INS]) ---")
        for i, (_ts, mode, ok, inl, need, ins) in enumerate(system.frame_trace):
            flags = ("" if not need else " need") + ("" if not ins else " INS")
            print(f"{i:4d} m{mode} {'ok' if ok else 'LOST':4s} {inl:4d}{flags}")

    if args.viz and writer:
        from ..viz.headless import render_map_topdown

        render_map_topdown(system.map, args.viz)
        print(f"map rendering saved: {args.viz}")

    if args.groundtruth and writer:
        err, n_poses = ate_against_groundtruth(args.out_trajectory, args.groundtruth)
        if err is not None:
            print(f"ATE RMSE: {err:.4f} m over {n_poses} poses")
        else:
            print("ATE: too few associations with groundtruth")
    return system


if __name__ == "__main__":
    main()
