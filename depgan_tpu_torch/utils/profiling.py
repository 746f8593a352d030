"""Step timing.

Counterpart of ``StepTimer`` in ``depgan_tpu/utils/profiling.py`` (:20):
rolling per-step wall times and steps per second, logged as the ``perf/*``
scalars. Host clock: a step ends where the caller fetches its result.
"""

from __future__ import annotations

import time
from collections import deque


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
