"""DEP-UResNet supervised trainer.

Counterpart of ``depgan_tpu/train/uresnet_trainer.py``, the reference's
per-epoch ``model.fit`` loop (`DEP-UResNet-wNoises-training-4fold.py:596-626`):

- categorical cross-entropy on the 4-class softmax output, Adam(1e-4)
  (reference :427);
- fresh Gaussian noise for the whole training set each epoch, fixed noise
  for validation (reference :592, :601);
- shuffle per epoch, batch 16 (reference :602-606);
- loss-history appends and per-epoch checkpoints through the caller's
  hooks (reference :608-625).

The generator is the plain ``GenUNet2D`` in training mode (batch-statistics
BatchNorm, dropout at ``cfg.dropout_mode``), its FiLM sites through K8
(``ops/film.py``) with ``cfg.use_pallas``, parameters from the state through
``torch.func.functional_call``.

Differences from the JAX trainer, none of them in the result: it runs
eagerly, one batch per step (no ``lax.scan`` chunks, no mesh), and updates
the state in place; the noises and dropout masks come from one
``torch.Generator`` seeded from ``train_cfg.seed``, which cannot give
``jax.random``'s numbers, so a test passes them in; the validation's last
chunk is the remainder rather than a padded, masked chunk.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from ..config import ModelConfig, UResNetTrainConfig
from ..data.pipeline import EpochShuffler
from ..data.preprocess import one_hot
from ..io.flax_bridge import uresnet_train_state_from_trees, zeros_like_tree
from ..models.blocks import Dropout
from ..models.generator import GenUNet2D, init_generator
from ..utils.profiling import StepTimer, span
from .state import UResNetTrainState

KERAS_EPS = 1e-7  # Keras clips softmax outputs before the log


def _keras_clip(probs: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(p, 1e-7, 1)`` with its gradient: minimum and maximum
    split the gradient at a bound in half, as JAX's do; ``torch.clamp``
    would pass it whole (a softmax saturated to exactly 1.0 hits this)."""
    return torch.minimum(torch.maximum(probs, probs.new_tensor(KERAS_EPS)), probs.new_tensor(1.0))


def _pixel_ce(probs: torch.Tensor, labels_1hot: torch.Tensor) -> torch.Tensor:
    """-sum(y * log clip(p)) over the classes."""
    return -torch.sum(labels_1hot * torch.log(_keras_clip(probs)), dim=-1)


def categorical_crossentropy(probs: torch.Tensor, labels_1hot: torch.Tensor) -> torch.Tensor:
    """Keras 'categorical_crossentropy' on probability outputs: clip to
    [eps, 1], -sum(y * log p) over classes, mean elsewhere."""
    return torch.mean(_pixel_ce(probs, labels_1hot))


def _one_hot_float(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Label maps (..., 1) -> float32 one-hot (..., n_classes)."""
    return (one_hot(labels.astype(int), n_classes).astype(np.float32)
            .reshape(labels.shape[:-1] + (n_classes,)))


class UResNetTrainer:
    """The supervised trainer of the softmax generator on ``device``."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: UResNetTrainConfig, device="cuda"):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.model = GenUNet2D(model_cfg, device="meta")  # tensors come from the state

    def init_state(self, seed: int = 0) -> UResNetTrainState:
        """Fresh generator variables from ``seed`` (the numpy initializer in
        the Flax layout), Adam moments zero."""
        variables = init_generator(self.model_cfg, seed=seed)
        zeros = zeros_like_tree(variables["params"])
        return uresnet_train_state_from_trees(
            variables["params"], variables["batch_stats"], {"count": 0, "mu": zeros, "nu": zeros},
            self.train_cfg.lr, self.device)

    def step(self, state: UResNetTrainState, x_all, y_all, noise_all, idx,
             dropout: dict | None = None, generator: torch.Generator | None = None):
        """One batch update (``update`` / ``step_core``, :91-121): gather the
        batch and its noise rows by ``idx``, the training forward, the CCE,
        its gradients, Adam, the new BatchNorm statistics. The dropout masks
        come from ``dropout`` (keep masks by layer name) where given, else
        from ``generator``. Updates ``state`` in place; returns it and the
        loss (a scalar on the device).

        Spans: ``uresnet.step`` around the whole, ``uresnet.forward`` (the
        forward and the CCE) and ``uresnet.backward`` (the gradients) in it.
        The backward's kernels launch from autograd's thread; its span
        brackets them in time."""
        with span("uresnet.step"):
            idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=self.device)
            x, y, noise = x_all[idx], y_all[idx], noise_all[idx]
            drop = Dropout(self.model_cfg.dropout_rate, dropout, generator)
            with span("uresnet.forward"):
                out = functional_call(self.model, {**state.params, **state.batch_stats},
                                      (x, noise), {"train": True, "dropout": drop})
                loss = categorical_crossentropy(out, y)
            params = list(state.params.values())
            with span("uresnet.backward"):
                for p, g in zip(params, torch.autograd.grad(loss, params)):
                    p.grad = g
            state.opt.step()
            state.batch_stats = self.model.updated_batch_stats()
            return state, loss.detach()

    @torch.no_grad()
    def val_loss(self, state: UResNetTrainState, x, noise, y) -> torch.Tensor:
        """Validation CCE over the whole set (``_val_step``, :168-209): the
        clipped CE summed over chunks of ``batch_size`` slices through the
        inference forward, divided by the true element count."""
        tensors = {**state.params, **state.batch_stats}
        chunk = max(1, int(self.train_cfg.batch_size))
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in range(0, x.shape[0], chunk):
            out = functional_call(self.model, tensors, (x[s:s + chunk], noise[s:s + chunk]))
            total = total + _pixel_ce(out, y[s:s + chunk]).sum()
        return total / (x.shape[0] * int(np.prod(y.shape[1:-1])))

    def fit(self, state: UResNetTrainState, x_train: np.ndarray, y_train_labels: np.ndarray,
            x_val: np.ndarray, y_val_labels: np.ndarray, n_epochs: int | None = None,
            logger=None, loss_history=None, val_loss_history=None, checkpoint_fn=None,
            rng_seed: int | None = None) -> UResNetTrainState:
        """The epoch loop (:213-313) over numpy slices (N, H, W, C_in) and
        label maps (N, H, W, 1). Per epoch: ``loss`` and ``val_loss`` (and
        the ``perf/*`` scalars) to ``logger.log_scalar``, the two losses
        appended to the histories, ``checkpoint_fn(state, epoch)`` every
        ``checkpoint_every`` epochs."""
        cfg = self.train_cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        seed = rng_seed if rng_seed is not None else cfg.seed
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def put(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        x_all, y_all = put(x_train), put(_one_hot_float(y_train_labels, cfg.n_classes))
        xv, yv = put(x_val), put(_one_hot_float(y_val_labels, cfg.n_classes))
        noise_shape = (self.model_cfg.noise_size, 1)
        # Fixed validation noise (reference :592).
        fixed_noise = torch.randn((x_val.shape[0], *noise_shape), generator=gen,
                                  device=self.device)

        shuffler = EpochShuffler(x_train.shape[0], cfg.batch_size, seed)
        t0 = time.time()
        timer = StepTimer()
        for epoch in range(n_epochs):
            idx_epoch = shuffler.epoch() if cfg.shuffle_each_epoch else (
                np.arange(shuffler.n_batches * cfg.batch_size)
                .reshape(shuffler.n_batches, cfg.batch_size).astype(np.int32))
            # Fresh noise for the whole train set each epoch (reference :601).
            epoch_noise = torch.randn((x_train.shape[0], *noise_shape), generator=gen,
                                      device=self.device)
            losses = []
            for idx in idx_epoch:
                state, loss = self.step(state, x_all, y_all, epoch_noise, idx, generator=gen)
                losses.append(loss)
            train_loss = float(torch.stack(losses).mean())
            val_loss = float(self.val_loss(state, xv, fixed_noise, yv))
            state.epoch += 1

            timer.step()
            if logger is not None:
                logger.log_scalar("loss", train_loss, epoch)
                logger.log_scalar("val_loss", val_loss, epoch)
                timer.log_to(logger, epoch)
            if loss_history is not None:
                loss_history.append(train_loss)
            if val_loss_history is not None:
                val_loss_history.append(val_loss)
            if checkpoint_fn is not None and (epoch + 1) % cfg.checkpoint_every == 0:
                checkpoint_fn(state, epoch)
            print(f"EPOCH {epoch + 1}/{n_epochs} loss={train_loss:.5f} "
                  f"val_loss={val_loss:.5f} ({time.time() - t0:.1f}s)")
        return state
