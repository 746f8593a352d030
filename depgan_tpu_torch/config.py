"""Configuration of the port.

``depgan_tpu/config.py``'s ``DataConfig`` and ``EvalConfig`` in full, its
``GanTrainConfig`` and ``UResNetTrainConfig`` but ``dispatch_chunk``, the
fields of its ``ModelConfig`` that the port reads, with the same names,
types and defaults (tests hold them equal), and ``to_dict``,
``save_config`` and ``load_config``. ``MeshConfig`` is left out: the port
trains on one device. The port keeps its own copy so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

# WMH thresholds: probability maps use 0.5, irregularity maps 0.178
# (reference: DEP-GAN_PROB_IM_twoCritics_training_4fold.py:26-29).
PM_THRESHOLD = 0.5
IM_THRESHOLD = 0.178

# Values of the wmh_subtracted_coded label maps
# (reference: README.md and DEP-UResNet-wNoises-training-4fold.py:454-459).
N_CHANGE_CLASSES = 4  # 0=background, 1=shrink, 2=grow, 3=stable


def _threshold_for(use_probability_map: bool) -> float:
    return PM_THRESHOLD if use_probability_map else IM_THRESHOLD


@dataclass(frozen=True)
class ModelConfig:
    """Generator / critic architecture knobs (reference :34-45)."""

    image_size: int = 256
    noise_size: int = 32
    first_fm: int = 32  # feature maps of the first U-Net level
    n_input_channels: int = 1
    n_out: int = 1  # 1 (tanh DEM head) for GAN, 4 (softmax) for UResNet
    # Where training (``GenUNet2D.forward(train=True)``) applies dropout:
    # 'gan' at every site (reference :399-485), 'uresnet' only after the
    # first decoder conv (DEP-UResNet-wNoises-training-4fold.py:388), 'none'
    # nowhere. Serving and the frozen-BN GAN graphs apply none.
    dropout_mode: str = "gan"
    dropout_rate: float = 0.25
    # Compute dtype of the trunk. Params are always float32.
    compute_dtype: str = "float32"
    # Train through the fused s2d path (ops/fast_gen.FusedGenerator and
    # ops/fast_critic.FusedCritic, the hand-written kernels) instead of the
    # plain modules.
    use_pallas: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data manifests + preprocessing knobs.

    The manifest format is preserved verbatim from the reference: one
    modality per ``<modality>_fold<k>.txt`` file under ``manifest_dir``, one
    absolute NIfTI path per line, index-aligned across modalities, with
    missing files silently skipped (reference
    ``...twoCritics_training_4fold.py:613-666``).
    """

    manifest_dir: str = "train_data_server_fold"
    folds: tuple[int, ...] = (1, 2, 3, 4)
    image_size: int = 256
    # Number of generator input channels: 1 = map only, 2 = concat(map, FLAIR)
    # (reference :22, :718-722).
    n_input_channels: int = 1
    # True: probability maps (threshold 0.5); False: irregularity maps (0.178).
    use_probability_map: bool = True
    # Percentile used by the robust min-max normaliser (reference :704).
    norm_percentile: float = 0.0
    # Fraction of slices held out for validation (reference :742).
    val_fraction: float = 0.02
    split_seed: int = 42

    @property
    def wmh_threshold(self) -> float:
        return _threshold_for(self.use_probability_map)


@dataclass(frozen=True)
class GanTrainConfig:
    """Two-critic WGAN-GP training (reference :34-50, :506-894). The JAX
    package's ``dispatch_chunk`` is left out: a TPU dispatch knob that
    leaves the trajectory unchanged (``fit_fold`` runs one superstep a
    loop turn, JAX's ``dispatch_chunk=1``)."""

    batch_size: int = 16
    n_epochs: int = 200  # 'niter', reference :38
    d_iters: int = 5  # critic steps per generator step, reference :36
    warmup_d_iters: int = 100  # reference :792-797
    warmup_until: int = 25  # gen_iterations below which warm-up applies
    warmup_every: int = 500  # gen_iterations % warmup_every == 0 re-warms
    gp_weight: float = 10.0  # 'delta', reference :37
    lr_d: float = 1e-4
    lr_g: float = 1e-4
    adam_b1: float = 0.0
    adam_b2: float = 0.9
    k_noise: int = 10  # best-of-k noise probe, reference :868
    # L1(DEM) / volume-MSE / Dice-loss weights (reference :574-592).
    l1_weight: float = 100.0
    vol_weight: float = 100.0
    dice_weight: float = 1.0
    # 'hard' (reference-faithful, zero-gradient >= threshold) or 'soft'
    # (sigmoid((x - t) / tau)) for the volume and Dice terms.
    threshold_mode: str = "hard"
    soft_threshold_tau: float = 0.02
    # Reference quirk: the iteration counters are module-global and never
    # reset between folds (reference :47-49, :506), so folds 2-4 skip warm-up.
    reset_counters_per_fold: bool = False
    # 'frozen' (Keras learning-phase 0: moving statistics, no dropout; the
    # fused path) or 'batch' (the generator's step uses batch statistics,
    # updates them and applies dropout; the plain modules, with K8 at the
    # FiLM sites under use_pallas).
    bn_mode: str = "frozen"
    validate_every: int = 10  # gen iterations (reference :842)
    image_log_every: int = 500  # reference :858
    n_val_images: int = 50  # validation images per dump (reference :862 [:50])
    # The reference saves netG every generator iteration (reference :892);
    # checkpoint_every=1 reproduces that.
    checkpoint_every: int = 100
    # Supersteps between metric fetches: each superstep's scalars are packed
    # into one device vector, and the buffered vectors come to the host in
    # one transfer every this-many supersteps, before each validation and
    # at the end of the fit. The logged values and steps do not depend on it.
    metric_flush_every: int = 25
    seed: int = 0


@dataclass(frozen=True)
class UResNetTrainConfig:
    """Supervised trainer (DEP-UResNet-wNoises-training-4fold.py:17-27). The
    JAX package's ``dispatch_chunk`` is left out: a TPU dispatch knob that
    leaves the trajectory unchanged."""

    batch_size: int = 16  # 'nb_samples'
    n_epochs: int = 200
    lr: float = 1e-4
    n_classes: int = N_CHANGE_CLASSES
    shuffle_each_epoch: bool = True
    checkpoint_every: int = 1  # epochs (reference saves every epoch, :620-625)
    seed: int = 0


@dataclass(frozen=True)
class EvalConfig:
    """Inference + evaluation (DEP-GAN_testing_4fold.py:12-37,616-628)."""

    n_repeat: int = 10  # stochastic ensemble size
    use_probability_map: bool = True
    n_input_channels: int = 1
    output_dir: str = "outputs"
    seed: int = 0
    # Serve through FastGenerator (folded BN, the s2d kernels, a bfloat16
    # trunk) instead of the plain module.
    fast: bool = False

    @property
    def wmh_threshold(self) -> float:
        return _threshold_for(self.use_probability_map)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2))


def load_config(cls, path: str | Path):
    return cls(**json.loads(Path(path).read_text()))
