"""The traced run's instruments, all wrapped around the program from the
benchmark's own files: spans around the calls into each layer (each
boundary synchronised with the card where the entry waits for each
frame; on the host's clock alone where it dispatches ahead), the host's
waits on the card
(CUDA's sync debug mode), the device's operations (torch.profiler), and
the work of every K1-K4 launch, from which ``roofline.py`` gives its
least time."""
from __future__ import annotations

import collections
import time
import warnings

import torch

from . import roofline
from .reference.hamming import pair_gates, proj_gates

SYNC_WARNING = "called a synchronizing CUDA operation"


def quiet_sync():
    """Synchronise without the wait counting as the program's."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)


class Tracer:
    def __init__(self, synchronised: bool = True):
        self.synchronised = synchronised
        self.spans = collections.defaultdict(list)  # name -> [(t0_ns, t1_ns)]
        self.work = collections.defaultdict(list)  # kernel id -> [pending work record]
        self._undo = []
        self._seen = None
        self._catch = None

    # -- spans -----------------------------------------------------------
    def span(self, obj, attr: str, name: str):
        orig = getattr(obj, attr)
        spans = self.spans[name]
        sync = quiet_sync if self.synchronised else (lambda: None)

        def f(*a, **kw):
            sync()
            t0 = time.perf_counter_ns()
            try:
                return orig(*a, **kw)
            finally:
                sync()
                spans.append((t0, time.perf_counter_ns()))

        setattr(obj, attr, f)
        self._undo.append((obj, attr, orig))

    def _record(self, kernels, attr: str, make):
        orig = getattr(kernels, attr)
        setattr(kernels, attr, make(orig))
        self._undo.append((kernels, attr, orig))

    def install(self, modules, system_cls, tracker_cls, stereo: bool = True):
        """Spans of the layers and the kernels' work records; ``stereo``:
        spans of ``stereo_match`` too (a span inside the pipelined device
        step would time the host's dispatch of it alone)."""
        for n in ("track_rgbd", "track_stereo"):
            self.span(tracker_cls, n, "track")
        self.span(system_cls, "_drain_batch", "drain")
        self.span(modules["slam.system"], "mapping_step", "mapping")
        if stereo:
            self.span(modules["slam.tracking"], "stereo_match", "stereo_match")
        work = self.work

        def k1(orig):
            def f(levels, border):
                levels = tuple(levels)
                work["K1"].append(("k1", tuple(tuple(t.shape) for t in levels), border))
                return orig(levels, border)
            return f

        def k2(orig):
            def f(desc_a, attr_a, desc_b, attr_b, check_ur=False):
                out = orig(desc_a, attr_a, desc_b, attr_b, check_ur)
                nin = sum(t.numel() * t.element_size() for t in (desc_a, attr_a, desc_b, attr_b))
                work["K2"].append(("k2", attr_a.clone(), attr_b.clone(), bool(check_ur), nin,
                                   6 * desc_a.shape[0] * 4))
                return out
            return f

        def k3(orig):
            def f(desc_a, attr_a, desc_b, attr_b, mode="proj"):
                out = orig(desc_a, attr_a, desc_b, attr_b, mode)
                nin = sum(t.numel() * t.element_size() for t in (desc_a, attr_a, desc_b, attr_b))
                B, M = desc_a.shape[0], desc_a.shape[1]
                work["K3"].append(("k3", attr_a.clone(), attr_b.clone(), mode, nin, 3 * B * M * 4))
                return out
            return f

        def k4(orig):
            def f(inp):
                out = orig(inp)
                work["K4"].append(("k4", inp.shape[1] * inp.shape[2], (inp[20] > 0.5).sum(),
                                   inp.shape[2]))
                return out
            return f

        kern = modules["ops.kernels"]
        self._record(kern, "fast_score_nms_levels_cuda", k1)
        self._record(kern, "proj_best2_cuda", k2)
        self._record(kern, "pair_best2_cuda", k3)
        self._record(kern, "lm_obs_cuda", k4)

    def uninstall(self):
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()

    # -- host waits ------------------------------------------------------
    def start_wait_count(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def stop_wait_count(self) -> int:
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(None, None, None)
        return sum(1 for w in self._seen if SYNC_WARNING in str(w.message))

    # -- the least time of each launch -------------------------------------
    def least_seconds(self) -> dict:
        """Kernel id -> list of least seconds, one per recorded launch."""
        out = {}
        for kid, recs in self.work.items():
            secs = []
            for rec in recs:
                if rec[0] == "k1":
                    secs.append(roofline.k1(rec[1], rec[2])[0])
                elif rec[0] == "k2":
                    gn, gw = proj_gates(rec[1], rec[2], rec[3])
                    gated = int((gn | gw).sum())
                    secs.append(roofline.k2(rec[4], rec[5], gated,
                                            int(gn.sum()) + int(gw.sum()))[0])
                elif rec[0] == "k3":
                    secs.append(roofline.k3(rec[4], rec[5], int(pair_gates(rec[1], rec[2],
                                                                          rec[3]).sum()))[0])
                else:
                    secs.append(roofline.k4(rec[1], int(rec[2]), rec[3])[0])
            out[kid] = secs
        return out


def device_events(prof):
    """[(name, start_ns, duration_ns)] of every operation the card ran
    in the profiled window (kernels, copies, fills)."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            if not str(e.device_type()).endswith("CUDA"):
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), int(start), int(dur)))
        return out
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            out.append((e.name, int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000)))
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_and_gaps(events):
    """(busy ns: the union of the operations' intervals, the gaps between
    them as (start_ns, length_ns))."""
    iv = sorted((s, s + d) for _, s, d in events)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps
