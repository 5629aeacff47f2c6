"""What the port's sequence runners share: the arguments that choose the
device and the viewer, the refusal of a missing card and of an
incomplete multi-process environment, the multi-process join, and the
timed frame loop with its report."""
import time

import torch

from .. import trace
from ..parallel import multihost


def add_port_arguments(ap) -> None:
    ap.add_argument("--viewer-dir", default=None,
                    help="periodic in-run rendering (frame and map PNGs)")
    ap.add_argument("--viewer-every", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace-spans", action="store_true",
                    help="record the program's spans over the frames and print them "
                         "by name after the run stats")


def check_arguments(ap, args) -> None:
    """Stop with an error on a CUDA device that is not there (no CPU
    fallback) and on a multi-process environment that asks to join
    without saying how (``multihost.environment_error``)."""
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device found (pass --device cpu to run on the CPU)")
    err = multihost.environment_error()
    if err:
        ap.error(err)


def join(args) -> bool:
    """Join the multi-process run that the environment asks for
    (``YDORBSLAM_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``, or
    ``YDORBSLAM_AUTO_DISTRIBUTED=1`` under ``torchrun``; NCCL on the card,
    gloo on the CPU) and print the JAX runner's ``distributed:`` line.
    Returns whether this process writes the run's files: rank 0 does, as
    every rank tracks the same frames to the same result."""
    if multihost.initialize_distributed(args.device):
        print(f"distributed: {multihost.process_info()}")
    return multihost.is_writer()


def track_frames(system, args, n: int, frame, track, progress_every: int,
                 inliers: bool = True, wait: bool = True):
    """Attach the viewer if asked, then track frames ``frame(0..n-1)``
    with ``track``, each timed to its end on the device (with ``wait``;
    without it, as for the pipelined path, to the end of its dispatch);
    print a progress line every ``progress_every`` frames (with the
    inlier count if ``inliers``), and once the system is shut down the
    median and mean tracking time after the third frame
    (test.cpp:98-106).  With ``--trace-spans`` the frames and the shut-down
    run under ``trace``, and the recording (``trace.take()``'s spans and
    counters) is returned; otherwise None."""
    if args.viewer_dir and multihost.is_writer():
        system.attach_viewer(args.viewer_dir, every=args.viewer_every)
    cuda = wait and system.device.type == "cuda"
    if args.trace_spans:
        trace.enable()
    times = []
    try:
        for i in range(n):
            f = frame(i)
            t0 = time.perf_counter()
            track(*f)
            if cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i % progress_every == 0:
                inl = f"inliers={system.tracked_map_points()} " if inliers else ""
                print(f"frame {i}/{n} state={system.tracking_state().name} {inl}"
                      f"kfs={system.n_keyframes}")
        system.shutdown()
    finally:
        recorded = trace.take() if args.trace_spans else None
    stimes = sorted(times[3:]) or times
    print(f"median tracking time: {stimes[len(stimes) // 2]:.4f}")
    print(f"mean tracking time: {sum(stimes) / len(stimes):.4f}")
    return recorded


def print_stats(system, recorded=None) -> None:
    """The run stats, and the spans of a ``track_frames`` recording."""
    from ..slam.stats import format_spans, format_stats

    print("--- run stats ---")
    print(format_stats(system.run_stats()))
    if recorded is not None:
        print("--- spans ---")
        print(format_spans(*recorded))
