"""Step and kernel timing.

``StepTimer`` is the counterpart of ``depgan_tpu/utils/profiling.py`` (:20):
rolling per-step wall times and steps per second, logged as the ``perf/*``
scalars. Host clock: a step ends where the caller fetches its result.
``cuda_graph_ms`` times launches on the card in a CUDA graph.
"""

from __future__ import annotations

import time
from collections import deque

import torch


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
