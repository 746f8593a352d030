"""Epoch batching.

Counterpart of ``EpochShuffler`` in ``depgan_tpu/data/pipeline.py`` (:47-61),
which the port cannot import (that module imports jax). It stays numpy, so
for one seed the port's trainer walks the JAX trainer's exact batches.
"""

from __future__ import annotations

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
