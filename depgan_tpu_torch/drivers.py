"""Workload drivers: the single-device training drivers and the weights
loader of the testing path.

Counterparts of ``depgan_tpu/drivers.py``:

- ``run_gan_training`` (:34-95) == DEP-GAN_PROB_IM_twoCritics_training_4fold.py
- ``run_uresnet_training`` (:181-224) == DEP-UResNet-wNoises-training-4fold.py
- ``generator_loader`` (:288-333), the reference's build + ``load_weights``
  step (``DEP-GAN_testing_4fold.py:380-384``), for ``eval/runner.py``.

Folds run one after another (reference ``for fold in [1,2,3,4]``,
`...twoCritics_training_4fold.py:506`); the JAX package's fold-parallel
drivers need more than one device and are not ported. The drivers write
the generator's Keras ``.h5`` at every checkpoint, which needs h5py: they
check that it imports before the first step, unless the caller passes its
own ``export_h5``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .config import DataConfig, GanTrainConfig, ModelConfig, UResNetTrainConfig, save_config
from .data import dataset
from .data.dataset import train_val_split
from .io import h5_import
from .io.checkpoint import (CheckpointManager, export_generator_h5, export_uresnet_h5,
                            load_generator_variables)
from .io.flax_bridge import flatten_tree, unflatten_tree
from .models import init_generator
from .train.gan_trainer import GanTrainer
from .train.state import Counters
from .train.uresnet_trainer import UResNetTrainer
from .utils.logging import Logger, LossHistory, NullLogger


def require_h5py() -> None:
    """Raises ImportError naming h5py where it does not import: the
    drivers' ``.h5`` export needs it, and a run must not die at its first
    checkpoint."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError("the training drivers write Keras .h5 weights at each checkpoint, "
                          "which needs h5py; install h5py, or pass export_h5") from e


def run_gan_training(model_cfg: ModelConfig, train_cfg: GanTrainConfig, data_cfg: DataConfig,
                     run_name: str = "depgan", folds=(1, 2, 3, 4), log_dir: str = "logdir",
                     model_dir: str = "models", use_tensorboard: bool = True,
                     resume: bool = True, device="cuda", export_h5=None) -> dict:
    """Train the two-critic WGAN-GP on each fold (reference :506-894).

    Per fold: the NIfTI training fold (``dataset.load_gan_training_fold``),
    split by ``train_val_split``; a fresh state from ``train_cfg.seed +
    fold``, or with ``resume`` the latest checkpoint of
    ``<model_dir>/<run_name>_fold<k>`` (the full state, Adam and the
    counters); the first validation images; ``GanTrainer.fit_fold``, with a
    checkpoint and ``netG_<run_name>_fold<k>.h5`` every
    ``checkpoint_every`` generator iterations and at the end. Counters
    persist across folds unless ``reset_counters_per_fold`` (reference
    :47-49). ``export_h5(state, path)`` writes the ``.h5``
    (``export_generator_h5`` by default, which needs h5py). Returns the
    states by fold."""
    if export_h5 is None:
        require_h5py()
        export_h5 = export_generator_h5
    trainer = GanTrainer(model_cfg, train_cfg, data_cfg, device)
    counters = Counters()
    Path(model_dir).mkdir(parents=True, exist_ok=True)
    states = {}

    for fold in folds:
        if train_cfg.reset_counters_per_fold:
            counters = Counters()
        logger = (Logger(Path(log_dir) / f"{run_name}_fold{fold}") if use_tensorboard
                  else NullLogger())
        x, y = dataset.load_gan_training_fold(data_cfg, fold)
        x_tr, x_val, y_tr, y_val = train_val_split(x, y, data_cfg.val_fraction,
                                                   data_cfg.split_seed)
        state = trainer.init_state(train_cfg.seed + fold)
        ckpt = CheckpointManager(Path(model_dir) / f"{run_name}_fold{fold}")
        if resume and ckpt.latest_step() is not None:
            state, counters, _ = ckpt.restore(state)
            print(f"resumed fold {fold} at gen_iteration {counters.gen_iterations}")
        # Initial validation images (reference :772-773, [:50]).
        k_img = train_cfg.n_val_images
        logger.log_images("val_img_Y1_IM", x_val[:k_img, ..., 0], counters.gen_iterations)
        logger.log_images("val_img_Y2_IM", y_val[:k_img], counters.gen_iterations)

        h5_path = Path(model_dir) / f"netG_{run_name}_fold{fold}.h5"

        def checkpoint_fn(s, c, ckpt=ckpt, h5_path=h5_path):
            ckpt.save(c.gen_iterations, s, c)
            export_h5(s, h5_path)

        state, counters = trainer.fit_fold(state, counters, x_tr, y_tr, x_val, y_val,
                                           logger=logger, checkpoint_fn=checkpoint_fn, fold=fold)
        ckpt.save(counters.gen_iterations, state, counters)
        export_h5(state, h5_path)
        ckpt.close()
        logger.close()
        states[fold] = state
    return states


def run_uresnet_training(model_cfg: ModelConfig, train_cfg: UResNetTrainConfig,
                         data_cfg: DataConfig, run_name: str = "depuresnet", folds=(1, 2, 3, 4),
                         log_dir: str = "logs", model_dir: str = "models", device="cuda",
                         export_h5=None) -> dict:
    """The supervised 4-class trainer per fold
    (DEP-UResNet-wNoises-training-4fold.py:434-626): ``model_<name>.json``
    (the model config), ``UResNetTrainer.fit`` over the split training
    fold, the ``loss_<name>.txt`` and ``val_loss_<name>.txt`` histories
    under ``log_dir``, and a checkpoint and ``trained_<name>.h5`` every
    ``checkpoint_every`` epochs (``export_h5``, by default
    ``export_uresnet_h5``, which needs h5py). Returns the states by fold."""
    if export_h5 is None:
        require_h5py()
        export_h5 = export_uresnet_h5
    trainer = UResNetTrainer(model_cfg, train_cfg, device)
    Path(model_dir).mkdir(parents=True, exist_ok=True)
    states = {}
    for fold in folds:
        name = f"{run_name}_fold{fold}"
        # The architecture beside the weights (the reference writes
        # model.to_json() per epoch, DEP-UResNet-wNoises-training-4fold.py:623-625).
        save_config(model_cfg, Path(model_dir) / f"model_{name}.json")
        x, y = dataset.load_uresnet_training_fold(data_cfg, fold)
        x_tr, x_val, y_tr, y_val = train_val_split(x, y, data_cfg.val_fraction,
                                                   data_cfg.split_seed)
        state = trainer.init_state(train_cfg.seed + fold)
        ckpt = CheckpointManager(Path(model_dir) / name)
        h5_path = Path(model_dir) / f"trained_{name}.h5"

        def checkpoint_fn(s, epoch, ckpt=ckpt, h5_path=h5_path):
            ckpt.save(epoch, s)
            export_h5(s, h5_path)

        state = trainer.fit(state, x_tr, y_tr, x_val, y_val,
                            loss_history=LossHistory(Path(log_dir) / f"loss_{name}.txt"),
                            val_loss_history=LossHistory(Path(log_dir) / f"val_loss_{name}.txt"),
                            checkpoint_fn=checkpoint_fn)
        ckpt.close()
        states[fold] = state
    return states


def generator_loader(model_cfg: ModelConfig, weights_pattern: str):
    """``weights_for_fold`` factory for ``eval.runner``: the generator's
    Flax-layout variable tree from ``weights_pattern.format(fold=k)``, a
    Keras ``.h5`` (needs h5py) or a GAN training checkpoint directory of
    the port (``run_gan_training``'s ``<run>_fold<k>``: the latest step,
    each leaf's shape checked against the built generator's)."""

    def weights_for_fold(fold: int) -> dict:
        path = Path(weights_pattern.format(fold=fold))
        variables = init_generator(model_cfg, seed=0)
        if path.is_file() and path.suffix == ".h5":
            return h5_import.import_keras_h5(str(path), variables)
        if path.is_dir():
            if CheckpointManager(path).latest_step() is None:
                raise ValueError(f"{path} is not a checkpoint directory of the port (no step "
                                 f"directory with a state.pt): an orbax directory of the JAX "
                                 f"package is not read; export its generator to .h5 first, "
                                 f"e.g. with depgan_tpu.io.checkpoint.export_generator_h5")
            loaded = load_generator_variables(path)
            out = {}
            for coll in ("params", "batch_stats"):
                t_flat, l_flat = flatten_tree(variables[coll]), flatten_tree(loaded[coll])
                missing = set(t_flat) - set(l_flat)
                if missing:
                    raise ValueError(f"checkpoint {path} lacks {coll} entries: "
                                     f"{sorted(k.replace('.', '/') for k in missing)[:5]}")
                for k, t in t_flat.items():
                    if np.shape(l_flat[k]) != np.shape(t):
                        raise ValueError(f"checkpoint {path}: {coll}/{k.replace('.', '/')} has "
                                         f"shape {np.shape(l_flat[k])}, the generator "
                                         f"{np.shape(t)}")
                out[coll] = unflatten_tree({k: np.asarray(l_flat[k], np.float32)
                                            for k in t_flat})
            return out
        if not path.exists():
            raise FileNotFoundError(f"no weights for fold {fold}: {path} "
                                    f"(from pattern '{weights_pattern}')")
        raise ValueError(f"unsupported weights file: {path}")

    return weights_for_fold
