"""Readers of a recording of the program's own spans (``ydorbslam_tpu_torch.trace``:
``trace.take()`` after a window), for a traced run.

A recording is ``(spans, counts)``: each span has ``name``, ``parent``
(its index in the list, -1 at the top), ``frame`` (the root ``frame``
span's frame id, -1 outside any frame), ``t0`` and ``t1`` (ns on
``time.perf_counter_ns()``, the host clock of the profiler marker).
Nothing here imports the program.  Every reader returns None when the
recording is empty (a program without these spans), so a metric built
on it reads nothing there instead of failing.

The readings, one per per-layer quantity:

- ``extract_ms_p50``: median over the window's frames of each frame's
  summed ``track.extract`` spans (both images of a stereo pair);
- ``pose_ms_p50``: the same of ``track.pose_motion`` and ``track.pose_local``;
- ``map_prep_ms_p50``: median ``mapping.prep`` span (cull, triangulation
  and fusion through K3, the refreshes);
- ``local_ba_ms_p50``: median ``mapping.ba`` span (window, build,
  ``bundle_adjust`` through K4, apply);
- ``host_wait_ms_per_frame``: all ``wait.*`` span time over the frames;
- ``keyframes_per_frame``: the ``keyframes`` counter over the frames.
"""
from __future__ import annotations

import bisect
import collections
import statistics

WAIT = "wait."


def frame_ids(spans) -> list:
    """The frame ids of the recording's root ``frame`` spans."""
    return [s.frame for s in spans if s.name == "frame" and s.parent == -1]


def _ms(s) -> float:
    return (s.t1 - s.t0) / 1e6


def per_frame_ms(spans, names) -> list:
    """For each root frame, the summed ms of its spans named in ``names``
    (0 where it has none); None when no span has such a name."""
    names = set(names)
    if not any(s.name in names for s in spans):
        return None
    sums = dict.fromkeys(frame_ids(spans), 0.0)
    for s in spans:
        if s.name in names and s.t1 is not None and s.frame in sums:
            sums[s.frame] += _ms(s)
    return list(sums.values())


def _median(xs):
    return statistics.median(xs) if xs else None


def _frames_median(spans, names):
    return _median(per_frame_ms(spans, names) or [])


def _span_median(spans, name):
    return _median([_ms(s) for s in spans if s.name == name and s.t1 is not None])


def extract_ms_p50(spans, counts=None):
    return _frames_median(spans, ("track.extract",))


def pose_ms_p50(spans, counts=None):
    return _frames_median(spans, ("track.pose_motion", "track.pose_local"))


def map_prep_ms_p50(spans, counts=None):
    return _span_median(spans, "mapping.prep")


def local_ba_ms_p50(spans, counts=None):
    return _span_median(spans, "mapping.ba")


def host_wait_ms_per_frame(spans, counts=None):
    n = len(frame_ids(spans))
    if not n:
        return None
    return sum(_ms(s) for s in spans if s.name.startswith(WAIT) and s.t1 is not None) / n


def keyframes_per_frame(spans, counts):
    n = len(frame_ids(spans))
    if not n:
        return None
    return counts.get("keyframes", 0) / n


READINGS = {f.__name__: f for f in (extract_ms_p50, pose_ms_p50, map_prep_ms_p50,
                                     local_ba_ms_p50, host_wait_ms_per_frame,
                                     keyframes_per_frame)}


def self_ms(spans) -> list:
    """Each span's self time (ms): its length less its children's."""
    own = [_ms(s) if s.t1 is not None else 0.0 for s in spans]
    for s in spans:
        if s.parent >= 0 and s.t1 is not None:
            own[s.parent] -= _ms(s)
    return own


def self_ms_by_name(spans) -> dict:
    """name -> summed self time (ms) over the recording."""
    out = collections.defaultdict(float)
    for s, own in zip(spans, self_ms(spans)):
        out[s.name] += own
    return dict(out)


def innermost_timeline(spans):
    """(starts, labels): the host clock cut at every span boundary, each
    piece labelled with the innermost span open over it (None where no
    span is).  Spans nest, so one sweep over their boundaries gives it."""
    events = []
    for i, s in enumerate(spans):
        if s.t1 is not None:
            events.append((s.t0, 1, i))
            events.append((s.t1, 0, i))
    # At one instant, close before open; among opens, outer (earlier index) first.
    events.sort(key=lambda e: (e[0], e[1], e[2] if e[1] else -e[2]))
    starts, labels, stack = [], [], []
    for t, opening, i in events:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        labels.append(spans[stack[-1]].name if stack else None)
    return starts, labels


def idle_by_span(spans, gaps, offset_ns) -> dict:
    """The device's idle time (s) by the innermost program span the host
    was in: ``gaps`` are (start, length) ns on the device clock, and
    ``offset_ns`` is the device clock less the host clock.  Each gap is
    cut where the host's innermost span changes; time outside every
    span goes to ``None``."""
    starts, labels = innermost_timeline(spans)
    out = collections.defaultdict(int)
    for g0, glen in gaps:
        a, b = g0 - offset_ns, g0 - offset_ns + glen
        k = bisect.bisect_right(starts, a) - 1
        while a < b:
            label = labels[k] if k >= 0 else None
            end = starts[k + 1] if k + 1 < len(starts) else b
            cut = min(b, end)
            out[label] += cut - a
            a, k = cut, k + 1
    return {k: v / 1e9 for k, v in out.items()}
