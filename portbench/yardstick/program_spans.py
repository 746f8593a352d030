"""The card's idle time put down to the program's own spans.

The program records a span around each phase of its entry points
(``depgan_tpu_torch.utils.profiling.span``: ``predict``, ``predict.forward``,
``uresnet.step`` and its parts, ``superstep`` and its parts) while a
profile runs, on any thread, on ``time.time_ns()``, the clock of the
profiler's events. Here they meet the device's busy intervals of a traced
window (``trace.Trace``). A program that keeps no spans (no
``profiling.spans``) reads as one that recorded none, so each reader
returns None there.
"""

from __future__ import annotations

from portbench.yardstick.trace import _union


def _records() -> list:
    from depgan_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def _open(trace, names) -> list[list[int]]:
    """The instants of the window in which a span named in ``names`` is
    open, on any thread: their union, clipped to the window."""
    return _union([(max(r.start_ns, trace.t0), min(r.end_ns, trace.t1)) for r in _records()
                   if r.name in names and r.end_ns > trace.t0 and r.start_ns < trace.t1])


def _complement(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """[lo, hi] less the sorted, disjoint ``intervals``."""
    out, prev = [], lo
    for s, e in intervals:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        out.append((prev, hi))
    return out


def _intersect(a, b) -> list[tuple[int, int]]:
    """Two sorted, disjoint interval lists intersected."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_inside(trace, names, outside=()) -> float:
    """Device-idle seconds of the traced window (the complement of
    ``trace.busy`` in [t0, t1]) at the instants where a program span named
    in ``names`` is open and none named in ``outside`` is, on any thread.
    An instant inside two spans counts once."""
    idle = _complement(trace.busy, trace.t0, trace.t1)
    inside = _intersect(_open(trace, names),
                        _complement(_open(trace, outside), trace.t0, trace.t1))
    return sum(hi - lo for lo, hi in _intersect(inside, idle)) / 1e9


def count(trace, name: str) -> int:
    """How many program spans named ``name`` end inside the window."""
    return sum(1 for r in _records() if r.name == name and trace.t0 <= r.end_ns <= trace.t1)


def idle_ms_per(trace, per: str, names, outside=()) -> float | None:
    """``idle_inside`` in milliseconds per span named ``per``; None where no
    such span ended in the window."""
    n = count(trace, per)
    return 1e3 * idle_inside(trace, names, outside) / n if n else None
