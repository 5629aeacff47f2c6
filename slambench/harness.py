"""The benchmark of ``ydorbslam_tpu_torch`` on one or more H100s.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the deployment's camera, extractor, thresholds, capacities and scene) and
a traffic mix (``traffic/<name>.json``: the entry point, the warm frames,
the pipeline's lag, loop closing).  A run builds the kernel library
(cached in the checkout), makes one period of the sensor stream from the
seed (``scene.py``), builds the system, warms it on the first frames,
tracks frames for ``--seconds``, and then decides ``correct`` from the
samples ``capture.py`` kept.  With ``--trace 1`` the window runs under
``tracer.py``'s instruments and the line carries the cell's per-layer
metrics, each read by its own file under ``metrics/``.  The last line of
standard output is the result as one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ydorbslam_tpu")
PROGRAM = "ydorbslam_tpu_torch"
PROGRAM_MODULES = ("slam.tracking", "slam.pipeline", "slam.system", "slam.matchers",
                   "slam.triangulate", "optim.schur", "ops.kernels")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start_wall() -> float:
    """The wall-clock time this process started (Linux), for ``setup_s``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str):
    """(cell, configuration, mix, per-layer metric entries) of ``workload``,
    each found by its name."""
    bm = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    per_layer = [m for m in bm["per_layer"] if workload in m.get("workloads", [workload])]
    return cell, cfg, mix, per_layer


def slam_config(cfg: dict):
    """The port's ``SlamConfig`` from a configuration file: each section
    of ``SlamConfig`` that the file names, its keys over the defaults."""
    C = importlib.import_module(f"{PROGRAM}.config")
    base = C.SlamConfig()
    parts = {f.name: dataclasses.replace(getattr(base, f.name), **cfg[f.name])
             for f in dataclasses.fields(base) if f.name in cfg}
    return dataclasses.replace(base, **parts)


def percentile(xs, q):
    """The q-th percentile of ``xs`` by linear interpolation (numpy's default)."""
    s = sorted(xs)
    if not s:
        return None
    pos = (len(s) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload, seed, seconds, trace, *, device="cuda", tf32=False, spec=None,
             t_proc=None, window_frames=None):
    """One run of a cell; returns the result object.  ``spec`` overrides
    the cell, configuration and mix found by name, and ``window_frames``
    makes the window a number of frames instead of ``seconds`` (the tests
    pass small ones, on the CPU); ``tf32`` runs the program with TF32
    matmuls (the control)."""
    import torch

    from . import capture, scene, tracer as tracer_mod

    t_proc = time.time() if t_proc is None else t_proc
    cell, cfg, mix, per_layer = spec if spec is not None else cell_spec(workload)
    chips = int(cell.get("chips", 1))
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise SystemExit(f"{workload} needs {chips} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    parts = {"import": time.time() - t_proc}

    t = time.time()
    mods = {m: importlib.import_module(f"{PROGRAM}.{m}") for m in PROGRAM_MODULES}
    system_mod = mods["slam.system"]
    if on_card:
        from ydorbslam_tpu_torch import _build

        built = _build.build()
        log(f"kernel library: {built['path']} ({built['seconds']:.1f} s)")
        mods["ops.kernels"]._lib()
    parts["library"] = time.time() - t

    t = time.time()
    stream = scene.make_stream(cfg, seed)
    parts["frames"] = time.time() - t

    t = time.time()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    slam_cfg = slam_config(cfg)
    sensor = system_mod.Sensor.RGBD if stream.sensor == "rgbd" else system_mod.Sensor.STEREO
    system = system_mod.SlamSystem(slam_cfg, sensor, enable_mapping=True,
                                   enable_loop_closing=bool(mix["loop_closing"]), device=device)
    pipelined = mix["entry"] == "pipelined"
    parts["system"] = time.time() - t
    if pipelined:
        t = time.time()
        system.enable_pipelined(lag=int(mix["lag"]))
        if mix.get("precompile", False):
            system.precompile()
        parts["precompile"] = time.time() - t
    track = getattr(system, f"track_{stream.sensor}" + ("_pipelined" if pipelined else ""))

    def sync():
        if on_card:
            tracer_mod.quiet_sync()

    t = time.time()
    warm = int(mix["warm_frames"])
    for k in range(warm):
        track(*stream.frame(k))
    if pipelined:
        system.flush_pipeline()
    sync()
    parts["warm"] = time.time() - t

    cap = capture.Capture(seed, warm)
    cap.install(mods)
    tr = None
    # The pipelined entry dispatches ahead: its spans and frames are timed
    # on the host alone, so that tracing does not serialise the pipeline.
    timed_on_card = on_card and not pipelined
    if trace:
        tr = tracer_mod.Tracer(synchronised=timed_on_card)
        tr.install(mods, system_mod.SlamSystem, mods["slam.tracking"].Tracker,
                   stereo=not pipelined)
    frame_spans, prof = [], None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        sync()
        h_mark = time.perf_counter_ns()
        torch.zeros(1, device=device).add_(1)
        sync()
        tr.start_wait_count()

    cap.active = True
    setup_s = time.time() - t_proc
    t0 = time.perf_counter()
    k = warm
    while (k - warm < window_frames if window_frames is not None
           else time.perf_counter() - t0 < seconds):
        cap.frame = k
        if trace:
            n_drain = len(tr.spans["drain"])
            if timed_on_card:
                sync()
            f0 = time.perf_counter_ns()
            track(*stream.frame(k))
            if timed_on_card:
                sync()
            frame_spans.append((f0, time.perf_counter_ns(), len(tr.spans["drain"]) > n_drain))
        else:
            track(*stream.frame(k))
        k += 1
    if pipelined:
        cap.frame = -1
        system.flush_pipeline()
    sync()
    window_s = time.perf_counter() - t0
    cap.active = False
    n_window = k - warm

    waits = None
    if prof is not None:
        waits = tr.stop_wait_count()
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    cap.uninstall()
    if tr is not None:
        tr.uninstall()

    lost_all = [r.lost for r in system.records]
    lost_window = sum(1 for r in system.records[warm:] if r.lost)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trajectory.txt")
        system.save_trajectory_tum(path)
        traj = capture.trajectory_numbers(path, stream, sum(lost_all))
    log(f"window: {n_window} frames in {window_s:.3f} s; keyframes {system.n_keyframes}; "
        f"lost {sum(lost_all)} of {len(lost_all)} (frames "
        f"{[i for i, lost in enumerate(lost_all) if lost][:40]}); stats {system.run_stats()}")
    capacity = slam_cfg.n_keypoints

    metrics, breakdown, dev = {}, None, {}
    if trace:
        ctx = types.SimpleNamespace(
            entry=mix["entry"], sensor=stream.sensor, frames=n_window, window_s=window_s,
            spans=dict(tr.spans), frame_spans=frame_spans, waits=waits, percentile=percentile)
        if prof is not None:
            events = tracer_mod.device_events(prof)
            busy_ns, gaps = tracer_mod.busy_and_gaps(events)
            ctx.events = events
            ctx.busy_s = busy_ns / 1e9
            ctx.least = tr.least_seconds()
            breakdown = _breakdown(events, gaps, tr.spans, frame_spans, h_mark)
            dev = {"busy_s": ctx.busy_s, "window_s": window_s}
        for m in per_layer:
            v = load_metric(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        del prof
    else:
        metrics["frames_per_s"] = {"value": n_window / window_s, "unit": "frames/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    del system, track
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.time()
    diagnostics = {}
    numbers = capture.compare(cap.kept, stream, cfg, capacity, device, diagnostics)
    kept = {k_: len(v) for k_, v in cap.kept.items()}
    log(f"reference: {time.time() - t:.1f} s over the kept samples {kept}")
    numbers["lost_frames"] = sum(lost_all)
    limits = _limits(workload)
    checks, correct = {}, True
    # A number the run did not produce is not correct either: its hook
    # found nothing, so nothing vouches for that part of the path.
    for name in list(numbers) + [n for n in limits if n not in numbers]:
        value, lim = numbers.get(name), limits.get(name)
        checks[name] = {"value": value, "limit": lim}
        if lim is None or value is None or not (value <= lim):
            correct = False

    result = {"correct": correct, "attempted": n_window, "failed": lost_window,
              "metrics": metrics, "device": dict(
                  platform="gpu" if on_card else "cpu",
                  kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                  count=chips, memory_peak_bytes=int(memory_peak), **dev)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["set_up"] = parts
    result["trajectory"] = traj
    result["diagnostics"] = diagnostics
    result["checks"] = checks
    return result


def _limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return load_json(path)["limits"] if path.exists() else {}


def _breakdown(events, gaps, spans, frame_spans, h_mark):
    """The device's ten longest operations by name, and its ten longest
    idle gaps, each named by the innermost span the host was in."""
    by_name = {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # The marker launched right after the profiler started is the first
    # operation of the trace: it ties the card's clock to the host's.
    first = min((s for _, s, _ in events), default=0)
    offset = first - h_mark
    named = [(n, s, e) for n, lst in spans.items() for s, e in lst]
    named += [("frame", s, e) for s, e, _ in frame_spans]

    def label(t_dev):
        t = t_dev - offset
        inside = [(e - s, n) for n, s, e in named if s <= t <= e]
        return min(inside)[1] if inside else "harness"

    longest = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
            "idle_gaps": [[label(s + g / 2), g / 1e9] for s, g in longest]}


def main(argv=None, t_proc=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_proc=t_proc)
    bad = forbidden_modules()
    if bad:
        log(f"refused: JAX or the JAX package is loaded: {bad}")
        return 3
    log(f"set-up parts (s): {json.dumps(result['set_up'])}")
    log(f"trajectory (not compared): {json.dumps(result['trajectory'])}")
    log(f"diagnostics (not compared): {json.dumps(result['diagnostics'])}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
