"""Output writers: per-subject NIfTI maps + cumulative CSV recap.

Counterpart of ``depgan_tpu/eval/writers.py``: a numpy copy, so the port
imports nothing of the JAX package.

Reproduces the reference's output surface:

- GAN (`DEP-GAN_testing_4fold.py:813-842`): ``<name>_2tp_prob_fake.nii.gz``,
  ``<name>_network_output.nii.gz``, ``<name>_2tp_code_fake.nii.gz`` and a
  cumulative ``RECAP_evaluation_for_allData.csv`` rewritten after every
  subject.
- UResNet (`DEP-UResNet_testing_4fold.py:706-726`): per-subject directory
  with ``<name>_cls_map.nii.gz`` + per-class ``<name>_prb_map_c{c}.nii.gz``
  and cumulative ``vol_dsc_all.csv``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data import nifti


class CsvRecap:
    """Cumulative evaluation CSV, rewritten after each subject
    (reference :838-842 — crash-safe progressive output)."""

    def __init__(self, path: str | Path, header: tuple[str, ...] | None = None):
        self.path = Path(path)
        self.rows: list[list[float]] = []
        self.header = header
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, row: list[float]) -> None:
        self.rows.append(list(row))
        self.flush()

    def flush(self) -> None:
        arr = np.array(self.rows, dtype=np.float64)
        kwargs = {}
        if self.header:
            kwargs = {"header": ",".join(self.header), "comments": ""}
        with open(self.path, "w") as f:
            np.savetxt(f, arr, delimiter=",", **kwargs)

    def summary(self) -> dict[str, float] | None:
        if not self.rows or not self.header:
            return None
        arr = np.array(self.rows, dtype=np.float64)
        return {name: float(v) for name, v in zip(self.header, arr.mean(axis=0))}


def save_map(slices: np.ndarray, affine: np.ndarray, path: str | Path,
             dtype: str = "float32", pixdim=None) -> None:
    """Slice stack -> on-disk NIfTI orientation -> save (reference :816-832)."""
    vol = nifti.slices_to_volume(slices).astype(dtype)
    nifti.save(vol, affine, path, pixdim=pixdim)


def write_gan_outputs(out_dir: str | Path, name: str, affine, pixdim,
                      y2_fake, dem_pred, change_code) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_map(y2_fake, affine, out_dir / f"{name}_2tp_prob_fake.nii.gz", pixdim=pixdim)
    save_map(dem_pred, affine, out_dir / f"{name}_network_output.nii.gz", pixdim=pixdim)
    save_map(change_code, affine, out_dir / f"{name}_2tp_code_fake.nii.gz", pixdim=pixdim)


def write_uresnet_outputs(out_dir: str | Path, name: str, affine, pixdim,
                          cls_map, prob_maps) -> None:
    """cls_map (Z, H, W) int; prob_maps (Z, H, W, C) float."""
    sub_dir = Path(out_dir) / name
    sub_dir.mkdir(parents=True, exist_ok=True)
    save_map(cls_map, affine, sub_dir / f"{name}_cls_map.nii.gz", dtype="int8",
             pixdim=pixdim)
    for c in range(prob_maps.shape[-1]):
        save_map(prob_maps[..., c], affine, sub_dir / f"{name}_prb_map_c{c}.nii.gz",
                 pixdim=pixdim)
