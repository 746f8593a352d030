"""Manifest (.txt file-list) reading.

Counterpart of ``depgan_tpu/data/manifest.py``: a numpy copy, so the port
imports nothing of the JAX package.

The reference reads one ``<modality>_fold<k>.txt`` per modality, one absolute
NIfTI path per line, index-aligned across modality files, and silently skips
subjects whose primary file is missing via an ``os.path.isfile`` guard
(`...twoCritics_training_4fold.py:613-666`, `DEP-GAN_testing_4fold.py:396-485`).
That exact format and skip-if-missing semantics are preserved here, as a real
module instead of per-script copy-paste.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Mapping, Sequence


def read_manifest(path: str | Path) -> list[str]:
    """Read one path (or name) per line, stripping trailing newlines.

    Matches the reference's ``open()`` + ``strip('\\n')`` loops; blank lines
    are preserved as empty strings to keep index alignment intact.
    """
    with open(path, "r") as f:
        return [line.rstrip("\n") for line in f]


def manifest_path(manifest_dir: str | Path, modality: str, fold: int) -> Path:
    return Path(manifest_dir) / f"{modality}_fold{fold}.txt"


@dataclass(frozen=True)
class SubjectRecord:
    """One subject's index-aligned file paths (one per modality) + name."""

    index: int
    name: str
    paths: Mapping[str, str]

    def path(self, modality: str) -> str:
        return self.paths[modality]

    def exists(self, modality: str) -> bool:
        """Whether the modality's file exists (optional-modality guard,
        reference `...twoCritics_training_4fold.py:689,697`)."""
        p = self.paths.get(modality, "")
        return bool(p) and os.path.isfile(p)


class ManifestBundle:
    """Index-aligned modality manifests for one fold.

    ``primary`` names the modality whose existence gates subject inclusion
    (the reference iterates `data_list_prob_1tp` for GAN training and
    `data_list_flair_1tp` at test time, skipping missing files).
    """

    def __init__(
        self,
        manifest_dir: str | Path,
        fold: int,
        modalities: Sequence[str],
        primary: str,
        name_modality: str | None = None,
    ):
        self.manifest_dir = Path(manifest_dir)
        self.fold = fold
        self.primary = primary
        self.lists: dict[str, list[str]] = {
            m: read_manifest(manifest_path(manifest_dir, m, fold)) for m in modalities
        }
        self.names: list[str] | None = None
        if name_modality is not None:
            self.names = read_manifest(manifest_path(manifest_dir, name_modality, fold))

        n = len(self.lists[primary])
        for m, lst in self.lists.items():
            if len(lst) < n:
                # Tolerate short manifests by padding with empty entries, but
                # keep primary-driven iteration intact.
                self.lists[m] = lst + [""] * (n - len(lst))

    def __len__(self) -> int:
        return len(self.lists[self.primary])

    def subjects(self, skip_missing: bool = True) -> Iterator[SubjectRecord]:
        """Yield subjects whose primary file exists (skip-if-missing)."""
        for i, primary_path in enumerate(self.lists[self.primary]):
            if skip_missing and not os.path.isfile(primary_path):
                continue
            name = self.names[i] if self.names is not None else f"subject_{i:04d}"
            yield SubjectRecord(
                index=i,
                name=name,
                paths={m: lst[i] for m, lst in self.lists.items()},
            )


# Modality sets used by each reference workload.
GAN_TRAIN_MODALITIES = (
    "flair_1tp",
    "wmh_prob_1tp",
    "wmh_prob_2tp",
    "icv_1tp",
    "icv_2tp",
    "sl_cleaned_1tp",
    "sl_cleaned_2tp",
)  # reference :613-660

GAN_TEST_MODALITIES = (
    "flair_1tp",
    "wmh_prob_v2_1tp",
    "wmh_prob_v2_2tp",
    "iam_1tp",
    "icv_1tp",
    "icv_2tp",
    "wmh_1tp",
    "wmh_2tp",
    "wmh_subtracted_coded_2tp_1tp",
    "sl_cleaned_1tp",
    "sl_cleaned_2tp",
)  # DEP-GAN_testing_4fold.py:397-479

URESNET_TRAIN_MODALITIES = (
    "flair_1tp",
    "wmh_subtracted_coded_2tp_1tp",
    "icv_1tp",
    "sl_cleaned_1tp",
)  # DEP-UResNet-wNoises-training-4fold.py:447-473

URESNET_TEST_MODALITIES = (
    "flair_1tp",
    "icv_1tp",
    "icv_2tp",
    "wmh_1tp",
    "wmh_2tp",
    "wmh_subtracted_coded_2tp_1tp",
    "sl_cleaned_1tp",
    "sl_cleaned_2tp",
)  # DEP-UResNet_testing_4fold.py:415-477
