#!/usr/bin/env python3
"""Does ``mapping_step`` cost more at the default capacities?

    python3 tools/mapping_capacity_pairs.py [--pairs N]

Run from the repository root on a CUDA machine.  Tracks all 120
``bench.make_frames()`` frames with the port, mapping and loop closing
on, under the TUM runner's settings (``testing.TUM_RGBD_SETTINGS``
through ``config.load_config``, as ``chip_smoke.py`` phase 15 runs them),
at two capacities that differ in nothing else:

  * "default": 512 keyframe and 65,536 map-point slots, ``load_config``'s
    defaults, what a user of the runner gets;
  * "bench": 160 keyframe and 16,384 map-point slots, the capacities of
    ``chip_smoke.py`` phases 8 and 13.

One warm-up run at "bench" is left out.  Then N pairs (default 5) run in
the order bench, default, default, bench, bench, default, ... so that
each pair is two neighbouring runs and drift in the host's speed falls
on both capacities alike.  Each ``mapping_step`` is timed on the host
clock between two synchronisations, with the process's CPU time beside
it.  Prints, per run, the keyframes, local BAs, lost frames, frames/s and
the median (min-max) ``mapping_step`` ms and CPU ms; per pair, the ratio
default / bench of the medians and the median of the call-by-call ratios
(where both runs made the same number of calls); last, the ratios over
all pairs and the card's name and power limit.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

BENCH_CAPACITY = dict(max_keyframes=160, max_map_points=16384)


def _run(cfg, frames, torch, system_mod, SlamSystem, Sensor):
    """Track ``frames`` at ``cfg``: (per-call mapping_step ms, per-call CPU
    ms, run stats, lost frames, frames/s)."""
    step = system_mod.mapping_step
    wall, cpu = [], []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        cpu.append((time.process_time() - c0) * 1e3)
        return out

    system = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                        device="cuda")
    system_mod.mapping_step = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            system.track_rgbd(*f)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        system.shutdown()
    finally:
        system_mod.mapping_step = step
    lost = sum(system.tracker.trajectory()[2])
    return wall, cpu, system.run_stats(), lost, len(frames) / secs


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/mapping_capacity_pairs.py runs on a GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import bench
    from ydorbslam_tpu_torch.config import load_config
    from ydorbslam_tpu_torch.slam import system as system_mod
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_settings

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        yaml = os.path.join(tmp, "settings.yaml")
        write_settings(yaml, TUM_RGBD_SETTINGS)
        default = load_config(yaml)
    cfgs = {"default": default,
            "bench": dataclasses.replace(
                default, capacity=dataclasses.replace(default.capacity, **BENCH_CAPACITY))}
    frames = bench.make_frames()
    deps = (torch, system_mod, SlamSystem, Sensor)

    def one(label):
        cap = cfgs[label].capacity
        wall, cpu, stats, lost, fps = _run(cfgs[label], frames, *deps)
        print(f"{label} (K={cap.max_keyframes}, M={cap.max_map_points}): lost {lost}, keyframes "
              f"{stats['keyframes_inserted']}, local BAs {stats['local_ba_runs']}, loops "
              f"{stats['loops_closed']}, {fps:.3f} frames/s; mapping_step {len(wall)} calls, "
              f"median {np.median(wall):.3f} ms ({min(wall):.3f}-{max(wall):.3f}), CPU median "
              f"{np.median(cpu):.3f} ms", flush=True)
        return np.asarray(wall), np.asarray(cpu)

    print("warm-up run, left out:", flush=True)
    one("bench")
    med_ratios, call_ratios, cpu_ratios = [], [], []
    for i in range(args.pairs):
        order = ("bench", "default") if i % 2 == 0 else ("default", "bench")
        got = {label: one(label) for label in order}
        (wd, cd), (wb, cb) = got["default"], got["bench"]
        med_ratios.append(float(np.median(wd) / np.median(wb)))
        cpu_ratios.append(float(np.median(cd) / np.median(cb)))
        per_call = float(np.median(wd / wb)) if len(wd) == len(wb) else float("nan")
        call_ratios.append(per_call)
        print(f"pair {i} ({order[0]} first): default / bench mapping_step median "
              f"{med_ratios[-1]:.4f}, call by call median {per_call:.4f}, CPU median "
              f"{cpu_ratios[-1]:.4f}", flush=True)
    print(f"over {args.pairs} pairs: default / bench mapping_step median ratio per pair "
          f"{[round(r, 4) for r in med_ratios]} (median {np.median(med_ratios):.4f}), call "
          f"by call {[round(r, 4) for r in call_ratios]}, CPU "
          f"{[round(r, 4) for r in cpu_ratios]} | {torch.cuda.get_device_name(0)} | {smi}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
