"""Evaluation metrics: volumetrics, change-map coding, 6-way Dice.

Counterpart of ``depgan_tpu/eval/metrics.py``: a numpy copy, so the port
imports nothing of the JAX package.

Faithful re-implementation of the reference's per-subject metric blocks
(`DEP-GAN_testing_4fold.py:633-811`, `DEP-UResNet_testing_4fold.py:573-704`),
producing the same 18-column CSV row. Host-side numpy on subject volumes
(they are tiny: ~42x256x256), so nothing here needs a device.

The masked-Dice definition matches the reference bit-for-bit: for category k,

    dice_k = (2 * |fake==k AND real==k| + s) / (s + |real==k| + |fake==k|)

with smooth s = 1e-7 (reference :743-797).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SMOOTH = 1e-7

# Change-map codes (reference :722-741 / README).
SHRINK, GROW, STABLE = 1, 2, 3


def category_dice(fake: np.ndarray, real: np.ndarray, k: int) -> float:
    """Dice for voxels labelled k in two integer label maps."""
    inter = np.count_nonzero((real == k) & (fake == k))
    return (2.0 * inter + SMOOTH) / (
        SMOOTH + np.count_nonzero(real == k) + np.count_nonzero(fake == k)
    )


def binary_dice(fake: np.ndarray, real: np.ndarray) -> float:
    """Dice of two boolean masks (used for whole/changing/stable WMH)."""
    inter = np.count_nonzero(fake & real)
    return (2.0 * inter + SMOOTH) / (
        SMOOTH + np.count_nonzero(real) + np.count_nonzero(fake)
    )


def code_change_map(y2_fake: np.ndarray, y1: np.ndarray, threshold: float) -> np.ndarray:
    """Threshold-code the predicted follow-up vs baseline maps into
    {0: none, 1: shrink, 2: grow, 3: stay} (reference :711-741)."""
    out = np.zeros(y2_fake.shape, dtype=np.float32)
    fake_wmh = y2_fake >= threshold
    base_wmh = y1 >= threshold
    out[(~fake_wmh) & base_wmh] = SHRINK
    out[fake_wmh & (~base_wmh)] = GROW
    out[fake_wmh & base_wmh] = STABLE
    return out


def dice_suite(change_fake: np.ndarray, change_real: np.ndarray) -> dict[str, float]:
    """The six Dice metrics + two averages (reference :743-811)."""
    d1 = category_dice(change_fake, change_real, SHRINK)
    d2 = category_dice(change_fake, change_real, GROW)
    d3 = category_dice(change_fake, change_real, STABLE)
    d4 = binary_dice(change_fake > 0, change_real > 0)
    changing_fake = (change_fake == SHRINK) | (change_fake == GROW)
    changing_real = (change_real == SHRINK) | (change_real == GROW)
    d5 = binary_dice(changing_fake, changing_real)
    d6 = binary_dice(change_fake == STABLE, change_real == STABLE)
    return {
        "dice_1_shrink": d1,
        "dice_2_grow": d2,
        "dice_3_stable": d3,
        "dice_4_wmh": d4,
        "dice_5_changing": d5,
        "dice_6_stableonly": d6,
        "avg_all_dice": (d1 + d2 + d3) / 3.0,
        "avg_dice_56": (d5 + d6) / 2.0,
    }


def volume_ml(mask: np.ndarray, pixdim: np.ndarray) -> float:
    """Nonzero-voxel volume in millilitres (reference :640-641):
    count_nonzero * prod(pixdim) / 1000."""
    return float(np.count_nonzero(mask) * np.prod(pixdim) / 1000.0)


@dataclass
class VolumetricResult:
    vol_1tp_ml: float
    vol_2tp_ml: float
    vol_pred_ml: float
    err_vol: float
    mse_vol: float
    true_pred: int
    prog: int
    true_prog: int
    regg: int
    true_regg: int


def volumetric_metrics(
    vol_1tp_ml: float, vol_2tp_ml: float, vol_pred_ml: float
) -> VolumetricResult:
    """Volume error + progression/regression direction accuracy flags
    (reference :688-709)."""
    err_vol = vol_pred_ml - vol_2tp_ml
    mse_vol = float((vol_2tp_ml - vol_pred_ml) ** 2)
    true_pred = prog = true_prog = regg = true_regg = 0
    if (vol_2tp_ml - vol_1tp_ml) >= 0:  # WMH progressing
        prog = 1
        if vol_pred_ml - vol_1tp_ml >= 0:
            true_pred = true_prog = 1
    else:  # WMH regressing
        regg = 1
        if vol_pred_ml - vol_1tp_ml < 0:
            true_pred = true_regg = 1
    return VolumetricResult(
        vol_1tp_ml, vol_2tp_ml, vol_pred_ml, err_vol, mse_vol,
        true_pred, prog, true_prog, regg, true_regg,
    )


CSV_COLUMNS = (
    "true_pred", "prog", "true_prog", "regg", "true_regg",
    "vol_1tp_ml", "vol_2tp_ml", "vol_pred_ml", "mse_vol", "err_vol",
    "dice_5_changing", "dice_6_stableonly", "avg_dice_56",
    "dice_1_shrink", "dice_2_grow", "dice_3_stable", "dice_4_wmh",
    "avg_all_dice",
)  # 18-column row layout, reference :806-807


def csv_row(vol: VolumetricResult, dices: dict[str, float]) -> list[float]:
    """Assemble the reference's 18-column evaluation row (reference :806-807)."""
    return [
        vol.true_pred, vol.prog, vol.true_prog, vol.regg, vol.true_regg,
        vol.vol_1tp_ml, vol.vol_2tp_ml, vol.vol_pred_ml, vol.mse_vol, vol.err_vol,
        dices["dice_5_changing"], dices["dice_6_stableonly"], dices["avg_dice_56"],
        dices["dice_1_shrink"], dices["dice_2_grow"], dices["dice_3_stable"],
        dices["dice_4_wmh"], dices["avg_all_dice"],
    ]
