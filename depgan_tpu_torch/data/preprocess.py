"""Label coding.

Counterpart of ``one_hot`` in ``depgan_tpu/data/preprocess.py`` (:93-99): a
numpy copy, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def one_hot(label: np.ndarray, n_class: int) -> np.ndarray:
    """Label map (..., 1) -> one-hot (..., 1, C) int16
    (`convert_to_1hot`, DEP-UResNet-wNoises-training-4fold.py:209-223)."""
    label_flat = label.flatten().astype(int)
    out = np.zeros((label_flat.size, n_class), dtype="int16")
    out[np.arange(label_flat.size), label_flat] = 1
    return out.reshape(label.shape + (n_class,))
