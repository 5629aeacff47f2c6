"""The program's own spans and counters, recorded in memory.

    from ydorbslam_tpu_torch import trace

    trace.enable()
    ...                                 # track frames
    spans, counts = trace.take()        # and tracing is off again

Off by default.  ``enable()`` starts an empty recording and ``take()``
ends it and returns what it holds: one ``Span`` per ``with
trace.span(name):`` block that ran, and the counters ``count()`` added
to.  A span records its name, the index of the span it ran inside (-1
for none), the frame it belongs to and its start and end on
``time.perf_counter_ns()``, the clock of the host side of a
``torch.profiler`` trace's marker.  The facade opens each frame's root
span with ``span("frame", frame_id)``; every span opened inside it
carries that frame id, and spans outside any frame carry -1.

``wait(site)`` is the span ``wait.<site>`` around a deliberate read of
the device by the host (or an upload that makes the host wait): the
time the host stood still for the device, counted by site.  A span's
self time (its length less its children's) is dispatch and Python.

No span synchronises with the device, and nothing here changes what the
program computes.  With tracing off, ``span`` and ``wait`` return one
shared context that does nothing.  The recorder serves one thread.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    parent: int  # index in the same recording, -1 at the top
    frame: int  # the root span's frame id, -1 outside any frame
    t0: int  # time.perf_counter_ns()
    t1: Optional[int]  # None when the span was still open at take()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    __slots__ = ("rows", "stack", "frame", "counts")

    def __init__(self):
        self.rows: List[list] = []
        self.stack: List[int] = []
        self.frame = -1
        self.counts: Dict[str, int] = collections.Counter()


class _Span:
    __slots__ = ("rec", "name", "frame", "row", "prev")

    def __init__(self, rec: _Recorder, name: str, frame: Optional[int]):
        self.rec, self.name, self.frame = rec, name, frame

    def __enter__(self):
        rec = self.rec
        if self.frame is not None:
            self.prev, rec.frame = rec.frame, int(self.frame)
        stack = rec.stack
        self.row = [self.name, stack[-1] if stack else -1, rec.frame, 0, None]
        stack.append(len(rec.rows))
        rec.rows.append(self.row)
        self.row[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.row[4] = time.perf_counter_ns()
        rec = self.rec
        rec.stack.pop()
        if self.frame is not None:
            rec.frame = self.prev
        return False


_rec: Optional[_Recorder] = None


def enable() -> None:
    """Start recording, from empty."""
    global _rec
    _rec = _Recorder()


def enabled() -> bool:
    return _rec is not None


def take() -> Tuple[List[Span], Dict[str, int]]:
    """End the recording; return its spans, in the order they opened, and
    its counters.  Empty when tracing was off."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        return [], {}
    return [Span(*row) for row in rec.rows], dict(rec.counts)


def span(name: str, frame: Optional[int] = None):
    """A context that records a span ``name``; ``frame`` makes it the
    root of that frame id's spans."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name, frame)


def wait(site: str):
    """The span ``wait.<site>`` around a read of the device by the host."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, "wait." + site, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _rec
    if rec is not None:
        rec.counts[name] += n


def durations(spans: List[Span]) -> Dict[str, List[int]]:
    """Each name's closed span lengths (ns), in the order they opened."""
    out: Dict[str, List[int]] = collections.defaultdict(list)
    for s in spans:
        if s.t1 is not None:
            out[s.name].append(s.t1 - s.t0)
    return dict(out)
