"""Step and kernel timing, and the program's spans.

``StepTimer`` is the counterpart of ``depgan_tpu/utils/profiling.py`` (:20):
rolling per-step wall times and steps per second, logged as the ``perf/*``
scalars. Host clock: a step ends where the caller fetches its result.
``cuda_graph_ms`` times launches on the card in a CUDA graph.

``span(name)`` marks a phase of the program (``predict``, ``uresnet.step``,
``superstep`` and their parts) while a ``torch.profiler`` profile runs, and
does nothing otherwise. ``spans()`` returns what was recorded.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import NamedTuple

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import record_function


class StepTimer:
    def __init__(self, window: int = 50):
        self._last = time.perf_counter()
        self._durations: deque[float] = deque(maxlen=window)

    def step(self) -> float:
        """Mark a step boundary; returns the last step's duration."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._durations.append(dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self._durations:
            return 0.0
        return len(self._durations) / sum(self._durations)

    def log_to(self, logger, step: int) -> None:
        logger.log_scalar("perf/step_seconds", self._durations[-1] if self._durations else 0.0, step)
        logger.log_scalar("perf/steps_per_sec", self.steps_per_sec, step)


def cuda_graph_ms(fn, iters: int, replays: int = 2) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph after a warm-up call, the graph replayed ``replays`` times between
    CUDA events, the fastest replay over ``iters``. The graph runs the
    launches back to back, so a launch shorter than the host's dispatch (a
    wrapper's checks, ctypes, the allocation) times the kernel and not the
    host. The wrappers count their launches while the graph is captured,
    not when it is replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    graph.reset()
    return best


class SpanRecord(NamedTuple):
    """One closed span. Times are ``time.time_ns()``, the clock the
    profiler stamps its events with, so a span lines up with the device's
    timeline. ``parent`` is None for a root; every span under one root
    carries its ``id`` as ``root``."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int


# The records kept: the newest SPAN_BUFFER, enough for minutes of any entry
# point's spans (a serving request records n_repeat + 1, a step 3, a
# superstep 5).
SPAN_BUFFER = 1 << 16
_records: deque[SpanRecord] = deque(maxlen=SPAN_BUFFER)
_lock = threading.Lock()
_ids = itertools.count(1)
_stack = threading.local()  # .open: the (id, root) of this thread's open spans
_OFF = nullcontext()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        open_ = getattr(_stack, "open", None)
        if open_ is None:
            open_ = _stack.open = []
        self.id = next(_ids)
        self.parent, self.root = open_[-1] if open_ else (None, self.id)
        open_.append((self.id, self.root))
        self.start = time.time_ns()
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _stack.open.pop()
        record = SpanRecord(self.name, self.id, self.parent, self.root, threading.get_ident(),
                            self.start, end)
        with _lock:
            _records.append(record)
        return False


def span(name: str):
    """A context manager around one phase of the program. While a
    ``torch.profiler`` profile runs (on any thread: the profiler's flag is
    process-wide), it enters ``record_function(name)`` and records a
    ``SpanRecord`` on exit; otherwise it is one shared no-op, which reads no
    clock."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> list[SpanRecord]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_records)


def clear_spans() -> None:
    with _lock:
        _records.clear()
