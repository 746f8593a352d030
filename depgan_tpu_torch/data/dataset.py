"""Per-subject preprocessing pipelines -> in-RAM fold arrays.

Counterpart of ``depgan_tpu/data/dataset.py``: a numpy copy, so the port
imports nothing of the JAX package; ``train_val_split`` is sklearn's split
in numpy.

Re-implements, as functions, the fold-loop data assembly the reference inlines
per script:

- GAN training fold: `...twoCritics_training_4fold.py:662-737`
- UResNet training fold: `DEP-UResNet-wNoises-training-4fold.py:475-526`
- GAN test subject: `DEP-GAN_testing_4fold.py:484-613`
- UResNet test subject: `DEP-UResNet_testing_4fold.py:478-541`

All arrays are NHWC float32, slices stacked over subjects, exactly like the
reference's big in-RAM concatenation (reference :727-734) — a fold is ~5k
256x256 slices, small enough to live wholly in device memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..config import DataConfig
from . import nifti, preprocess as pp
from .manifest import (
    GAN_TEST_MODALITIES,
    GAN_TRAIN_MODALITIES,
    URESNET_TEST_MODALITIES,
    URESNET_TRAIN_MODALITIES,
    ManifestBundle,
    SubjectRecord,
)


def _load_slices(path: str) -> np.ndarray:
    return nifti.volume_to_slices(nifti.load_auto(path).image)


def load_gan_training_fold(cfg: DataConfig, fold: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (x_1tp, y_2tp): generator inputs and real follow-up maps.

    Pipeline per subject (reference :662-737): load map/FLAIR/ICV volumes,
    ICV-mask, optionally SL-mask, min-max FLAIR to [0,1], clamp negative map
    values, assemble channels, stack slices.
    """
    bundle = ManifestBundle(
        cfg.manifest_dir, fold, GAN_TRAIN_MODALITIES, primary="wmh_prob_1tp"
    )
    xs, ys = [], []
    for rec in bundle.subjects():
        prob_1tp = _load_slices(rec.path("wmh_prob_1tp"))
        prob_2tp = _load_slices(rec.path("wmh_prob_2tp"))
        flair_1tp = _load_slices(rec.path("flair_1tp"))
        icv_1tp = _load_slices(rec.path("icv_1tp"))
        icv_2tp = _load_slices(rec.path("icv_2tp"))

        prob_1tp = pp.apply_brain_mask(prob_1tp, icv_1tp)
        flair_1tp = pp.apply_brain_mask(flair_1tp, icv_1tp)
        prob_2tp = pp.apply_brain_mask(prob_2tp, icv_2tp)

        if rec.exists("sl_cleaned_1tp"):
            sl_1tp = _load_slices(rec.path("sl_cleaned_1tp"))
            prob_1tp = pp.apply_lesion_mask(prob_1tp, sl_1tp)
            flair_1tp = pp.apply_lesion_mask(flair_1tp, sl_1tp)
        if rec.exists("sl_cleaned_2tp"):
            sl_2tp = _load_slices(rec.path("sl_cleaned_2tp"))
            prob_2tp = pp.apply_lesion_mask(prob_2tp, sl_2tp)

        flair_1tp = pp.map_to_intensity_range(flair_1tp, 0, 1, cfg.norm_percentile)
        prob_1tp = pp.clamp_negative(prob_1tp)
        prob_2tp = pp.clamp_negative(prob_2tp)

        xs.append(pp.assemble_channels(prob_1tp, flair_1tp, cfg.n_input_channels))
        ys.append(prob_2tp)

    if not xs:
        raise FileNotFoundError(f"no subjects found for fold {fold} in {cfg.manifest_dir}")
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def load_uresnet_training_fold(cfg: DataConfig, fold: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (flair, coded labels): z-scored FLAIR + masked change labels
    (reference `DEP-UResNet-wNoises-training-4fold.py:475-526`)."""
    bundle = ManifestBundle(
        cfg.manifest_dir, fold, URESNET_TRAIN_MODALITIES, primary="flair_1tp"
    )
    xs, ys = [], []
    for rec in bundle.subjects():
        flair = _load_slices(rec.path("flair_1tp"))
        labels = _load_slices(rec.path("wmh_subtracted_coded_2tp_1tp"))
        icv = _load_slices(rec.path("icv_1tp"))

        flair = pp.apply_brain_mask(flair, icv)
        labels = pp.apply_brain_mask(labels, icv)
        if rec.exists("sl_cleaned_1tp"):
            sl = _load_slices(rec.path("sl_cleaned_1tp"))
            flair = pp.apply_lesion_mask(flair, sl)
            labels = pp.apply_lesion_mask(labels, sl)

        xs.append(pp.zscore_normalise(flair))
        ys.append(labels)

    if not xs:
        raise FileNotFoundError(f"no subjects found for fold {fold} in {cfg.manifest_dir}")
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def train_val_split(
    x: np.ndarray, y: np.ndarray, val_fraction: float = 0.02, seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The reference's split (reference :742,
    ``train_test_split(test_size=0.02, random_state=42)``) in numpy, for
    the card's machine has no sklearn: sklearn's ``ShuffleSplit`` draws one
    ``RandomState(seed).permutation(n)``, whose first ceil(fraction * n)
    indices are the validation slices and the rest the training slices."""
    n = x.shape[0]
    n_val = math.ceil(val_fraction * n)
    perm = np.random.RandomState(seed).permutation(n)
    val, train = perm[:n_val], perm[n_val:]
    return x[train], x[val], y[train], y[val]


@dataclass
class GanTestSubject:
    """Everything the GAN evaluation engine needs for one subject
    (assembled per `DEP-GAN_testing_4fold.py:484-613`)."""

    name: str
    gen_input: np.ndarray  # (Z, H, W, nicg) — channel 0 is the map used as y1
    prob_1tp: np.ndarray  # (Z, H, W) masked PM/IM at 1tp (the map modality)
    prob_2tp: np.ndarray  # (Z, H, W) masked PM at 2tp
    wmh_1tp: np.ndarray  # (Z, H, W) manual WMH mask at 1tp
    wmh_2tp: np.ndarray  # (Z, H, W)
    code_2tp: np.ndarray  # (Z, H, W) coded change labels (0..3)
    icv_sl_mask_1tp: np.ndarray  # (Z, H, W) ICV AND NOT SL
    icv_sl_mask_2tp: np.ndarray  # (Z, H, W)
    affine: np.ndarray
    pixdim: np.ndarray
    n_slices: int


def load_gan_test_subject(rec: SubjectRecord, cfg: DataConfig) -> GanTestSubject:
    flair_vol = nifti.load(rec.path("flair_1tp"))
    flair = np.squeeze(_load_slices(rec.path("flair_1tp")))
    im_1tp = np.squeeze(_load_slices(rec.path("iam_1tp")))
    prob_1tp = np.squeeze(_load_slices(rec.path("wmh_prob_v2_1tp")))
    prob_2tp = np.squeeze(_load_slices(rec.path("wmh_prob_v2_2tp")))
    icv_1tp = np.squeeze(_load_slices(rec.path("icv_1tp")))
    icv_2tp = np.squeeze(_load_slices(rec.path("icv_2tp")))
    wmh_1tp = np.squeeze(_load_slices(rec.path("wmh_1tp")))
    wmh_2tp = np.squeeze(_load_slices(rec.path("wmh_2tp")))
    code_2tp = np.squeeze(_load_slices(rec.path("wmh_subtracted_coded_2tp_1tp")))

    flair = pp.apply_brain_mask(flair, icv_1tp)
    im_1tp = pp.apply_brain_mask(im_1tp, icv_1tp)
    prob_1tp = pp.apply_brain_mask(prob_1tp, icv_1tp)
    prob_2tp = pp.apply_brain_mask(prob_2tp, icv_2tp)
    wmh_1tp = pp.apply_brain_mask(wmh_1tp, icv_1tp)
    wmh_2tp = pp.apply_brain_mask(wmh_2tp, icv_2tp)
    code_2tp = pp.apply_brain_mask(code_2tp, icv_2tp)

    icv_sl_1tp = icv_1tp
    if rec.exists("sl_cleaned_1tp"):
        sl_1tp = np.squeeze(_load_slices(rec.path("sl_cleaned_1tp")))
        flair = pp.apply_lesion_mask(flair, sl_1tp)
        im_1tp = pp.apply_lesion_mask(im_1tp, sl_1tp)
        prob_1tp = pp.apply_lesion_mask(prob_1tp, sl_1tp)
        wmh_1tp = pp.apply_lesion_mask(wmh_1tp, sl_1tp)
        icv_sl_1tp = pp.apply_lesion_mask(icv_1tp, sl_1tp)
    icv_sl_2tp = icv_2tp
    if rec.exists("sl_cleaned_2tp"):
        sl_2tp = np.squeeze(_load_slices(rec.path("sl_cleaned_2tp")))
        wmh_2tp = pp.apply_lesion_mask(wmh_2tp, sl_2tp)
        prob_2tp = pp.apply_lesion_mask(prob_2tp, sl_2tp)
        icv_sl_2tp = pp.apply_lesion_mask(icv_2tp, sl_2tp)

    flair = pp.map_to_intensity_range(flair, 0, 1, cfg.norm_percentile)
    im_1tp = pp.clamp_negative(im_1tp)
    prob_1tp = pp.clamp_negative(prob_1tp)
    prob_2tp = pp.clamp_negative(prob_2tp)

    primary = prob_1tp if cfg.use_probability_map else im_1tp
    gen_input = pp.assemble_channels(
        primary[..., None], flair[..., None], cfg.n_input_channels
    )

    return GanTestSubject(
        name=rec.name,
        gen_input=gen_input.astype(np.float32),
        prob_1tp=primary,
        prob_2tp=prob_2tp,
        wmh_1tp=wmh_1tp,
        wmh_2tp=wmh_2tp,
        code_2tp=code_2tp,
        icv_sl_mask_1tp=icv_sl_1tp,
        icv_sl_mask_2tp=icv_sl_2tp,
        affine=flair_vol.affine,
        pixdim=flair_vol.pixdim,
        n_slices=gen_input.shape[0],
    )


@dataclass
class UResNetTestSubject:
    """Inputs for DEP-UResNet evaluation
    (`DEP-UResNet_testing_4fold.py:478-541`)."""

    name: str
    flair: np.ndarray  # (Z, H, W, 1) z-scored
    wmh_1tp: np.ndarray
    wmh_2tp: np.ndarray
    code_2tp: np.ndarray
    icv_sl_mask_1tp: np.ndarray
    icv_sl_mask_2tp: np.ndarray
    affine: np.ndarray
    pixdim: np.ndarray
    n_slices: int


def load_uresnet_test_subject(rec: SubjectRecord, cfg: DataConfig) -> UResNetTestSubject:
    flair_vol = nifti.load(rec.path("flair_1tp"))
    flair = _load_slices(rec.path("flair_1tp"))
    icv_1tp = _load_slices(rec.path("icv_1tp"))
    icv_2tp = _load_slices(rec.path("icv_2tp"))
    wmh_1tp = _load_slices(rec.path("wmh_1tp"))
    wmh_2tp = _load_slices(rec.path("wmh_2tp"))
    code_2tp = _load_slices(rec.path("wmh_subtracted_coded_2tp_1tp"))

    flair = pp.apply_brain_mask(flair, icv_1tp)
    wmh_1tp = pp.apply_brain_mask(wmh_1tp, icv_1tp)
    wmh_2tp = pp.apply_brain_mask(wmh_2tp, icv_2tp)
    code_2tp = pp.apply_brain_mask(code_2tp, icv_2tp)

    icv_sl_1tp = np.squeeze(icv_1tp)
    if rec.exists("sl_cleaned_1tp"):
        sl_1tp = _load_slices(rec.path("sl_cleaned_1tp"))
        flair = pp.apply_lesion_mask(flair, sl_1tp)
        wmh_1tp = pp.apply_lesion_mask(wmh_1tp, sl_1tp)
        icv_sl_1tp = np.squeeze(pp.apply_lesion_mask(icv_1tp, sl_1tp))
    icv_sl_2tp = np.squeeze(icv_2tp)
    if rec.exists("sl_cleaned_2tp"):
        sl_2tp = _load_slices(rec.path("sl_cleaned_2tp"))
        wmh_2tp = pp.apply_lesion_mask(wmh_2tp, sl_2tp)
        icv_sl_2tp = np.squeeze(pp.apply_lesion_mask(icv_2tp, sl_2tp))

    flair = pp.zscore_normalise(flair)

    return UResNetTestSubject(
        name=rec.name,
        flair=flair.astype(np.float32),
        wmh_1tp=np.squeeze(wmh_1tp),
        wmh_2tp=np.squeeze(wmh_2tp),
        code_2tp=np.squeeze(code_2tp),
        icv_sl_mask_1tp=icv_sl_1tp,
        icv_sl_mask_2tp=icv_sl_2tp,
        affine=flair_vol.affine,
        pixdim=flair_vol.pixdim,
        n_slices=flair.shape[0],
    )


def iter_gan_test_subjects(cfg: DataConfig, fold: int):
    bundle = ManifestBundle(
        cfg.manifest_dir, fold, GAN_TEST_MODALITIES, primary="flair_1tp",
        name_modality="name",
    )
    for rec in bundle.subjects():
        yield load_gan_test_subject(rec, cfg)


def iter_uresnet_test_subjects(cfg: DataConfig, fold: int):
    bundle = ManifestBundle(
        cfg.manifest_dir, fold, URESNET_TEST_MODALITIES, primary="flair_1tp",
        name_modality="name",
    )
    for rec in bundle.subjects():
        yield load_uresnet_test_subject(rec, cfg)
