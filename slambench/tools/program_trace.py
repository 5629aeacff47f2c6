"""One run of a cell with the program's own spans recorded over the window
(``ydorbslam_tpu_torch.trace``), read with ``slambench/program_spans.py``.

    python3 slambench/tools/program_trace.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> [--program <0|1>]

The run is ``harness.run_cell``'s as it stands; with ``--program 1`` the
program's recorder is on over the window: ``trace.enable()`` where the
harness opens its samples' window and ``trace.take()`` where it closes
it.  The last line but one of standard output is the run's result, as
``run.py`` prints it.  Untraced, that is all: runs with ``--program 0``
and ``--program 1`` on the same seeds give the recorder's cost in
``frames_per_s``.  Traced (``--trace 1``, on the card), the last line is
one JSON object with:

- ``readings``: ``program_spans.READINGS`` on the recording;
- ``waits_per_frame`` (``wait.*`` spans) beside the harness's
  ``host_syncs_per_frame``, the waits by site, and the sync-debug
  warnings by ``file:line`` that fell outside every ``wait.*`` span;
- ``frame_self``: the median ``frame`` span and its median self time;
- ``spans``: per name the count, total ms, median ms, median of the
  per-frame sums and total self ms;
- ``idle_by_span``: the device's idle seconds by the innermost program
  span the host was in (``None`` outside every span: the harness);
- ``keyframes``: the ``keyframes`` counter and the run's frames.
"""
import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))

from slambench import capture, harness, program_spans, tracer  # noqa: E402


class Probe:
    """The hooks around ``run_cell``: the program's recorder over the
    window, the sync-debug warnings with their sites and host times, and
    the device's idle gaps with the clock offset the harness found."""

    def __init__(self, program: bool):
        self.program = program
        self.spans, self.counts = [], {}
        self.warned = []  # (host ns, "file:line")
        self.gaps, self.offset = None, None
        self._undo = []

    def _patch(self, obj, attr, value):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def install(self):
        from ydorbslam_tpu_torch import trace

        probe = self

        class Windowed(capture.Capture):
            @property
            def active(self):
                return self._active

            @active.setter
            def active(self, on):
                if probe.program and on and not trace.enabled():
                    trace.enable()
                elif probe.program and not on and trace.enabled():
                    probe.spans, probe.counts = trace.take()
                self._active = on

        start = tracer.Tracer.start_wait_count

        def start_wait_count(tr):
            start(tr)
            show = warnings._showwarnmsg_impl  # the harness's record list

            def record(msg):
                if tracer.SYNC_WARNING in str(msg.message):
                    site = f"{os.path.relpath(msg.filename, ROOT)}:{msg.lineno}"
                    probe.warned.append((time.perf_counter_ns(), site))
                show(msg)
            warnings._showwarnmsg_impl = record

        breakdown = harness._breakdown

        def kept_breakdown(events, gaps, spans, frame_spans, h_mark):
            probe.gaps = gaps
            probe.offset = min((s for _, s, _ in events), default=h_mark) - h_mark
            return breakdown(events, gaps, spans, frame_spans, h_mark)

        self._patch(capture, "Capture", Windowed)
        self._patch(tracer.Tracer, "start_wait_count", start_wait_count)
        self._patch(harness, "_breakdown", kept_breakdown)

    def uninstall(self):
        for obj, attr, value in reversed(self._undo):
            setattr(obj, attr, value)
        self._undo.clear()


def summary(probe: Probe, result: dict) -> dict:
    """The traced run's readings of the program's recording."""
    spans, counts = probe.spans, probe.counts
    frames = program_spans.frame_ids(spans)
    n = len(frames) or 1
    waits = [s for s in spans if s.name.startswith(program_spans.WAIT)]
    starts, labels = program_spans.innermost_timeline(spans)
    outside = collections.Counter()
    for t, site in probe.warned:
        k = bisect.bisect_right(starts, t) - 1
        label = labels[k] if k >= 0 else None
        if not (label or "").startswith(program_spans.WAIT):
            outside[f"{site} in {label}"] += 1
    own = program_spans.self_ms(spans)
    own_by_name = program_spans.self_ms_by_name(spans)
    by_name = collections.defaultdict(list)
    for s in spans:
        if s.t1 is not None:
            by_name[s.name].append((s.t1 - s.t0) / 1e6)
    table = {}
    for name, ds in sorted(by_name.items()):
        per_frame = program_spans.per_frame_ms(spans, (name,)) or [0.0]
        table[name] = dict(count=len(ds), total_ms=sum(ds), p50_ms=statistics.median(ds),
                           per_frame_p50_ms=statistics.median(per_frame),
                           self_ms=own_by_name[name])
    frame_ms = [(s.t1 - s.t0) / 1e6 for s in spans if s.name == "frame" and s.t1 is not None]
    frame_own = [o for s, o in zip(spans, own) if s.name == "frame" and s.t1 is not None]
    idle = None
    if probe.gaps is not None:
        idle = program_spans.idle_by_span(spans, probe.gaps, probe.offset)
        idle = {str(k): v for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}
    syncs = result["metrics"].get("host_syncs_per_frame", {}).get("value")
    return dict(
        readings={k: f(spans, counts) for k, f in program_spans.READINGS.items()},
        frames=len(frames), attempted=result["attempted"],
        waits_per_frame=len(waits) / n, host_syncs_per_frame=syncs,
        waits_by_site=dict(collections.Counter(s.name for s in waits)),
        warned=len(probe.warned), warned_outside_waits=dict(outside),
        frame_self=dict(frame_ms_p50=statistics.median(frame_ms) if frame_ms else None,
                        self_ms_p50=statistics.median(frame_own) if frame_own else None),
        keyframes=dict(counter=counts.get("keyframes", 0), frames=len(frames)),
        spans=table, idle_by_span=idle)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    t_proc = harness.process_start_wall()
    probe = Probe(bool(args.program))
    probe.install()
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_proc=t_proc)
    finally:
        probe.uninstall()
    print(json.dumps(result), flush=True)
    if args.trace:
        print(json.dumps({"program": summary(probe, result)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
