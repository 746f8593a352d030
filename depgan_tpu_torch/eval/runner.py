"""4-fold evaluation drivers: DEP-GAN and DEP-UResNet testing.

Counterpart of ``depgan_tpu/eval/runner.py`` (:69-147), the reference's
``DEP-GAN_testing_4fold.py:363-842`` and ``DEP-UResNet_testing_4fold.py:
390-726``: per fold, take the generator's weights, stream the test subjects
through the stochastic-ensemble predictor, compute the volumetric and Dice
metrics, write the NIfTI maps and the cumulative CSV.

Subject loading (NIfTI decode and masking, on the host) overlaps the
device's ensemble through ``prefetch``. ``weights_for_fold(fold)`` returns
the generator's Flax-layout variable tree (numpy arrays, as
``models.init_generator`` writes and ``io.h5_import`` fills): the port's
``EnsemblePredictor`` builds its own module from it, on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..config import DataConfig, EvalConfig, ModelConfig
from ..data import dataset
from ..data.pipeline import prefetch
from ..data.preprocess import from_one_hot
from . import metrics as M
from .predict import EnsemblePredictor, reconstruct_follow_up
from .writers import CsvRecap, write_gan_outputs, write_uresnet_outputs


@dataclass
class SubjectResult:
    name: str
    fold: int
    vol: M.VolumetricResult
    dices: dict[str, float]


def evaluate_gan_subject(
    subject: dataset.GanTestSubject,
    dem_pred: np.ndarray,
    threshold: float,
) -> tuple[M.VolumetricResult, dict[str, float], np.ndarray, np.ndarray]:
    """Metrics for one subject given the mean predicted DEM (Z, H, W).

    Returns (volumetrics, dices, y2_fake, change_code) — the latter two are
    the saved output maps (reference :633-811).
    """
    vol_1tp = M.volume_ml(subject.icv_sl_mask_1tp * subject.wmh_1tp, subject.pixdim)
    vol_2tp = M.volume_ml(subject.icv_sl_mask_2tp * subject.wmh_2tp, subject.pixdim)

    y2_fake = reconstruct_follow_up(subject.prob_1tp, dem_pred)
    # Predicted WMH volume uses strict > (reference :679), unlike the
    # >= used for change coding (reference :723-738) — kept faithful.
    wmh_pred = (y2_fake > threshold) * subject.icv_sl_mask_2tp
    vol_pred = M.volume_ml(wmh_pred, subject.pixdim)

    vol = M.volumetric_metrics(vol_1tp, vol_2tp, vol_pred)
    # Print-only IM/PM-derived WMH volumes (reference :655-671: computed
    # and printed per subject but never written to the CSV — reproduced
    # for console parity; the reference thresholds these with >=, unlike
    # the strict > above).
    vol_1tp_ml_im = M.volume_ml(subject.prob_1tp >= threshold, subject.pixdim)
    vol_2tp_ml_im = M.volume_ml(subject.prob_2tp >= threshold, subject.pixdim)
    print(f"VOL (vol_1tp_ml_im): {vol_1tp_ml_im}", flush=True)
    print(f"VOL (vol_2tp_ml_im): {vol_2tp_ml_im}", flush=True)
    change_fake = M.code_change_map(y2_fake, subject.prob_1tp, threshold)
    dices = M.dice_suite(change_fake, subject.code_2tp)
    return vol, dices, y2_fake, change_fake


def run_gan_testing(
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    weights_for_fold,
    folds=(1, 2, 3, 4),
    out_dir: str | Path | None = None,
    device="cuda",
) -> list[SubjectResult]:
    """``weights_for_fold(fold) -> variables`` gives the generator per fold
    (reference :378-384)."""
    out_dir = Path(out_dir or eval_cfg.output_dir)
    recap = CsvRecap(out_dir / "RECAP_evaluation_for_allData.csv", M.CSV_COLUMNS)
    results: list[SubjectResult] = []
    threshold = eval_cfg.wmh_threshold

    for fold in folds:
        predictor = EnsemblePredictor(model_cfg, weights_for_fold(fold), eval_cfg.n_repeat,
                                      seed=eval_cfg.seed + fold, fast=eval_cfg.fast,
                                      device=device)
        for subject in prefetch(dataset.iter_gan_test_subjects(data_cfg, fold)):
            dem = predictor.predict(subject.gen_input, subject.icv_sl_mask_2tp)
            dem = np.squeeze(dem, axis=-1)
            vol, dices, y2_fake, change_fake = evaluate_gan_subject(subject, dem, threshold)
            write_gan_outputs(out_dir, subject.name, subject.affine, subject.pixdim,
                              y2_fake, dem, change_fake)
            recap.append(M.csv_row(vol, dices))
            results.append(SubjectResult(subject.name, fold, vol, dices))
    return results


def evaluate_uresnet_subject(
    subject: dataset.UResNetTestSubject,
    prob_pred: np.ndarray,
) -> tuple[M.VolumetricResult, dict[str, float], np.ndarray]:
    """Metrics given the averaged class-probability maps (Z, H, W, C)
    (reference `DEP-UResNet_testing_4fold.py:566-704`)."""
    labels = from_one_hot(prob_pred)
    vol_1tp = M.volume_ml(subject.icv_sl_mask_1tp * subject.wmh_1tp, subject.pixdim)
    vol_2tp = M.volume_ml(subject.icv_sl_mask_2tp * subject.wmh_2tp, subject.pixdim)
    vol_pred = M.volume_ml(labels > 0, subject.pixdim)
    vol = M.volumetric_metrics(vol_1tp, vol_2tp, vol_pred)
    dices = M.dice_suite(labels, subject.code_2tp)
    return vol, dices, labels


def run_uresnet_testing(
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    weights_for_fold,
    folds=(1, 2, 3, 4),
    out_dir: str | Path | None = None,
    device="cuda",
) -> list[SubjectResult]:
    out_dir = Path(out_dir or eval_cfg.output_dir)
    recap = CsvRecap(out_dir / "vol_dsc_all.csv", M.CSV_COLUMNS)
    results: list[SubjectResult] = []

    for fold in folds:
        predictor = EnsemblePredictor(model_cfg, weights_for_fold(fold), eval_cfg.n_repeat,
                                      seed=eval_cfg.seed + fold, fast=eval_cfg.fast,
                                      device=device)
        for subject in prefetch(dataset.iter_uresnet_test_subjects(data_cfg, fold)):
            probs = predictor.predict(subject.flair, subject.icv_sl_mask_2tp)
            vol, dices, labels = evaluate_uresnet_subject(subject, probs)
            write_uresnet_outputs(out_dir, subject.name, subject.affine, subject.pixdim,
                                  labels, probs)
            recap.append(M.csv_row(vol, dices))
            results.append(SubjectResult(subject.name, fold, vol, dices))
    return results
