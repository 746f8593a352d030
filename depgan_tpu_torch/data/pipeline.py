"""Epoch batching and the threaded subject prefetch.

Counterparts of ``EpochShuffler`` and ``prefetch`` in
``depgan_tpu/data/pipeline.py`` (:47-88), which the port cannot import (that
module imports jax). ``EpochShuffler`` stays numpy, so for one seed the
port's trainer walks the JAX trainer's exact batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np


class EpochShuffler:
    """Host-side index permutation per epoch (reference :783-787), emitting
    batch index arrays for the gather on the device."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.n_batches = n // batch_size

    def epoch(self) -> np.ndarray:
        """Returns (n_batches, batch_size) int32 indices."""
        perm = self.rng.permutation(self.n)
        usable = self.n_batches * self.batch_size
        return perm[:usable].reshape(self.n_batches, self.batch_size).astype(np.int32)


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Background-thread prefetch for host-side pipelines (subject loading
    at test time): the next subject's NIfTI decode runs while the device
    serves this one. An exception of ``iterable`` is raised in the consumer
    after the items before it."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
