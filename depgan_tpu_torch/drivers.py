"""Workload drivers: the weights loader of the testing path.

Counterpart of ``generator_loader`` in ``depgan_tpu/drivers.py``
(:288-333), the reference's build + ``load_weights`` step
(``DEP-GAN_testing_4fold.py:380-384``). The port reads Keras ``.h5`` files;
it does not read orbax checkpoint directories, and its training drivers are
not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from .config import ModelConfig
from .io import h5_import
from .models import init_generator


def generator_loader(model_cfg: ModelConfig, weights_pattern: str):
    """``weights_for_fold`` factory for ``eval.runner``: the generator's
    Flax-layout variable tree with ``weights_pattern.format(fold=k)`` (a
    Keras ``.h5``) imported into it. Needs ``h5py``."""

    def weights_for_fold(fold: int) -> dict:
        path = Path(weights_pattern.format(fold=fold))
        if path.is_file() and path.suffix == ".h5":
            return h5_import.import_keras_h5(str(path), init_generator(model_cfg, seed=0))
        if path.is_dir():
            raise ValueError(f"{path} is a checkpoint directory: the port reads Keras .h5 "
                             f"weights only (export the generator to .h5 first, e.g. with "
                             f"depgan_tpu.io.checkpoint.export_generator_h5)")
        if not path.exists():
            raise FileNotFoundError(f"no weights for fold {fold}: {path} "
                                    f"(from pattern '{weights_pattern}')")
        raise ValueError(f"unsupported weights file: {path}")

    return weights_for_fold
