#!/usr/bin/env python3
"""Where the port's frame time goes on the GPU.

    python3 tools/profile_torch_port.py

Run from the repository root on a CUDA machine.  Tracks all 120
``bench.make_frames()`` frames with the port on its main path (mapping
on, loop closing off, the ``chip_smoke.py`` configuration), timing each
frame on the host clock around a synchronized ``track_rgbd`` and each
``mapping_step`` between synchronisations.  Frames 70-79, where the
camera reaches new ground and most frames insert a keyframe, run under
``torch.profiler`` (CPU + CUDA) and are left out of the frame-time
statistics.  Prints:

  * frame-time percentiles over frames 20-119 without the profiler,
    and the mean of each quarter of the frame wall time and of the
    process's CPU time, to show drift and whether the process was
    working or waiting for a core;
  * the card's SM clock, power draw and temperature before and after;
  * device time per frame (the sum of kernel self times), the busy
    share against the unprofiled median, and kernel launches per frame;
  * the frame time split into ``mapping_step`` and the rest, over the
    unprofiled frames;
  * the device time per launch of the four CUDA kernels (K1-K4);
  * the top operators by device time and by call count.
"""
import os
import subprocess
import sys
import time

PROFILED = range(70, 80)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.chdir(root)
    sys.path.insert(0, root)
    import bench
    from chip_smoke import _config
    from ydorbslam_tpu_torch.slam import system as system_mod
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    frames = bench.make_frames()
    system = SlamSystem(_config(), Sensor.RGBD, enable_mapping=True,
                        enable_loop_closing=False, device="cuda")
    step = system_mod.mapping_step
    step_ms = {}

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms[i] = (time.perf_counter() - t0) * 1e3
        return out

    system_mod.mapping_step = timed_step
    secs, cpu = {}, {}
    smi_before = _smi()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i, f in enumerate(frames):
        if i == PROFILED.start:
            prof.start()
        t0, c0 = time.perf_counter(), time.process_time()
        system.track_rgbd(*f)
        torch.cuda.synchronize()
        secs[i] = time.perf_counter() - t0
        cpu[i] = time.process_time() - c0
        if i == PROFILED.stop - 1:
            prof.stop()
    system_mod.mapping_step = step
    smi_after = _smi()
    lost = sum(system.tracker.trajectory()[2])
    kept = [i for i in range(20, len(frames)) if i not in PROFILED]
    timed = np.array([secs[i] for i in kept]) * 1e3
    p10, p50, p90 = np.percentile(timed, [10, 50, 90])
    quarters = [float(q.mean()) for q in np.array_split(timed, 4)]
    cpu_quarters = [float(q.mean()) for q in np.array_split(np.array([cpu[i] for i in kept]) * 1e3, 4)]
    ka = prof.key_averages()
    n = len(PROFILED)
    device_ms = sum(
        e.self_device_time_total for e in ka if str(e.device_type).endswith("CUDA")
    ) / n / 1e3
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel") / n
    kf_frames = [i for i in kept if i in step_ms]
    other = [secs[i] * 1e3 for i in kept if i not in step_ms]
    print(f"{torch.cuda.get_device_name(0)}: lost {lost}; frames 20-119 without the "
          f"profiler: p10 {p10:.3f} / p50 {p50:.3f} / p90 {p90:.3f} ms, quarter means "
          f"{[round(q, 3) for q in quarters]} ms; process CPU time quarter means "
          f"{[round(q, 3) for q in cpu_quarters]} ms")
    print(f"frames 20-119 without the profiler: {len(kf_frames)} with a mapping_step "
          f"(median frame {np.median([secs[i] * 1e3 for i in kf_frames]) if kf_frames else 0:.3f}"
          f" ms, of it mapping_step {np.median([step_ms[i] for i in kf_frames]) if kf_frames else 0:.3f}"
          f" ms), {len(other)} without (median {np.median(other):.3f} ms); mapping_step "
          f"{len(step_ms)} calls in the run, {sum(step_ms.values()):.1f} ms in all; "
          f"profiled window: {sum(1 for i in PROFILED if i in step_ms)} mapping_step calls")
    print(f"nvidia-smi clocks.sm, clocks.max.sm, power.draw, temperature: "
          f"before [{smi_before}], after [{smi_after}]")
    print(f"profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device {device_ms:.3f} "
          f"ms/frame, busy share vs p50 {device_ms / p50:.4f}, "
          f"{launches:.0f} kernel launches/frame")
    for name in ("fast_nms_levels_kernel", "proj_best2_kernel", "pair_best2_kernel",
                 "lm_obs_kernel"):
        hits = [e for e in ka if name in e.key]
        count = sum(e.count for e in hits)
        total = sum(e.self_device_time_total for e in hits)
        per = f"{total / count:.3f} us/launch" if count else "not seen by the profiler"
        print(f"  {name}: {count} launches, {per}")
    print(ka.table(sort_by="self_device_time_total", row_limit=20, max_name_column_width=50))
    print(ka.table(sort_by="count", row_limit=20, max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
