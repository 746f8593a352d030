"""Intensity normalisation, masking, channel assembly, one-hot codec.

Counterpart of ``depgan_tpu/data/preprocess.py``: a numpy copy, so the port
imports nothing of the JAX package. Reference locations:

- min-max normaliser: `map_image_to_intensity_range`
  (`...twoCritics_training_4fold.py:131-149`)
- z-score normaliser: inline (`DEP-UResNet-wNoises-training-4fold.py:511-512`)
- ICV / stroke-lesion masking: inline (`...twoCritics_training_4fold.py:685-716`)
- channel assembly: inline (reference :718-722; DEP-GAN_testing_4fold.py:603-613)
- one-hot codec: `convert_to_1hot` / `convert_from_1hot`
  (`DEP-UResNet-wNoises-training-4fold.py:209-223`,
  `DEP-UResNet_testing_4fold.py:150-185`)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "map_to_intensity_range",
    "zscore_normalise",
    "apply_brain_mask",
    "apply_lesion_mask",
    "clamp_negative",
    "assemble_channels",
    "one_hot",
    "from_one_hot",
]


def map_to_intensity_range(
    image: np.ndarray, min_o: float, max_o: float, percentiles: float = 0
) -> np.ndarray:
    """Percentile-robust rescale to [min_o, max_o] (reference :131-149)."""
    if image.dtype in (np.uint8, np.uint16, np.uint32):
        assert min_o >= 0, f"uint input but negative min_o: {min_o}"
    if image.dtype == np.uint8:
        assert max_o <= 255, f"uint8 input but max_o > 255: {max_o}"

    min_i = np.percentile(image, 0 + percentiles)
    max_i = np.percentile(image, 100 - percentiles)
    out = (image - min_i) / (max_i - min_i) * (max_o - min_o) + min_o
    return np.clip(out, min_o, max_o)


def zscore_normalise(image: np.ndarray) -> np.ndarray:
    """Zero-mean / unit-variance over the whole array, NaNs zeroed
    (reference `DEP-UResNet-wNoises-training-4fold.py:511-512`).

    Degenerate (constant / all-masked) volumes have zero std; the reference
    silently produces NaNs that `nan_to_num` zeroes. Guard explicitly: the
    result is all-zeros either way, but without the divide-by-zero
    RuntimeWarning."""
    std = np.std(image)
    if std == 0:
        return np.zeros_like(image, dtype=np.result_type(image, np.float32))
    out = (image - np.mean(image)) / std
    return np.nan_to_num(out)


def apply_brain_mask(image: np.ndarray, icv_mask: np.ndarray) -> np.ndarray:
    """Zero out non-brain tissue: elementwise multiply by the ICV mask
    (reference :685-687)."""
    return np.multiply(image, icv_mask)


def apply_lesion_mask(image: np.ndarray, sl_mask: np.ndarray) -> np.ndarray:
    """Exclude stroke-lesion voxels: multiply by (1 - SL mask)
    (reference :689-702)."""
    return np.multiply(image, 1 - sl_mask)


def clamp_negative(image: np.ndarray) -> np.ndarray:
    """IM/PM values below 0 are set to 0 (reference :715-716)."""
    out = np.asarray(image).copy()
    out[out < 0] = 0
    return out


def assemble_channels(primary: np.ndarray, flair: np.ndarray | None, n_channels: int) -> np.ndarray:
    """Build the generator input: map only (nicg=1) or concat(map, FLAIR)
    along the channel axis (nicg=2) — reference :718-722."""
    if n_channels == 1:
        return primary
    if n_channels == 2:
        if flair is None:
            raise ValueError("n_channels=2 requires a FLAIR volume")
        return np.concatenate((primary, flair), axis=-1)
    raise ValueError(f"unsupported n_channels={n_channels}")


def one_hot(label: np.ndarray, n_class: int) -> np.ndarray:
    """Label map (..., 1) -> one-hot (..., 1, C) int16
    (`convert_to_1hot`, DEP-UResNet-wNoises-training-4fold.py:209-223)."""
    label_flat = label.flatten().astype(int)
    out = np.zeros((label_flat.size, n_class), dtype="int16")
    out[np.arange(label_flat.size), label_flat] = 1
    return out.reshape(label.shape + (n_class,))


def from_one_hot(label: np.ndarray, to_float: bool = False) -> np.ndarray:
    """One-hot / probability map (N, H, W, C) -> label map (N, H, W)
    (`convert_from_1hot`, DEP-UResNet_testing_4fold.py:166-185).

    ``to_float=True`` returns the winning class's probability instead of its
    index, matching the reference's branch.
    """
    n, h, w, c = label.shape
    flat = label.reshape((n * h * w, c))
    if to_float:
        idx = np.argmax(flat, axis=1)
        out = flat[np.arange(flat.shape[0]), idx].astype("float32")
    else:
        out = np.argmax(flat, axis=1).astype("uint8")
    return np.squeeze(out.reshape((n, h, w)))
