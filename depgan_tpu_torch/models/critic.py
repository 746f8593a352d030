"""Dis_C2D_FCN1 — the WGAN-GP critic, as an ``nn.Module``.

Counterpart of ``depgan_tpu/models/critic.py``
(`...twoCritics_training_4fold.py:316-345`): fully convolutional, no
BatchNorm (the gradient penalty is per example), plain ReLU:

conv5x5(16)x2 -> pool -> conv5x5(32)x2 -> pool -> conv3x3(64)x2 -> pool ->
conv3x3(128)x2 -> pool -> conv3x3(256)x3 -> conv1x1(1) -> flatten ->
dense(1) scalar score.

Submodule and parameter names are the Flax tree's, so ``io/flax_bridge.py``
loads a Flax critic tree by key walk, and ``init_critic`` writes such a tree
in numpy without JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from .blocks import Conv, Dense, max_pool_2x2
from .generator import _glorot_uniform, _he_normal, _put

# (suffix, features, kernel size) of each ConvRelu block, in order; None is
# a 2x2 max-pool.
LAYERS = (("dis_0a", 16, 5), ("dis_0b", 16, 5), None, ("dis_1a", 32, 5), ("dis_1b", 32, 5),
          None, ("dis_2", 64, 3), ("dis_3", 64, 3), None, ("dis_4", 128, 3),
          ("dis_5", 128, 3), None, ("dis_6", 256, 3), ("dis_7", 256, 3), ("dis_8", 256, 3))


class ConvRelu(nn.Module):
    """conv2d_relu: Conv -> ReLU, the Flax tree nesting ``conv2d_<suffix>``."""

    def __init__(self, in_ch: int, features: int, kernel: int, suffix: str, device=None):
        super().__init__()
        self.conv_name = f"conv2d_{suffix}"
        self.add_module(self.conv_name, Conv(in_ch, features, kernel, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.get_submodule(self.conv_name)(x))


class DisC2DFCN1(nn.Module):
    """Critic: (B, H, W, 1) -> (B, 1) float32 Wasserstein score; the trunk
    computes in ``cfg.compute_dtype``, parameters stay float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        in_ch = 1
        for layer in LAYERS:
            if layer is not None:
                suffix, features, kernel = layer
                self.add_module(f"block_{suffix}", ConvRelu(in_ch, features, kernel, suffix,
                                                            device))
                in_ch = features
        self.dis_9 = Conv(in_ch, 1, 1, device)
        self.dis_dense = Dense((cfg.image_size // 16) ** 2, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(getattr(torch, self.cfg.compute_dtype))
        for layer in LAYERS:
            h = max_pool_2x2(h) if layer is None else self.get_submodule(f"block_{layer[0]}")(h)
        h = self.dis_9(h)
        return self.dis_dense(h.reshape(h.shape[0], -1)).float()


def init_critic(cfg: ModelConfig, seed: int = 0) -> dict:
    """Fresh critic parameters as a numpy tree in the Flax layout.

    Returns ``{"params": ...}`` with exactly the keys and shapes of
    ``depgan_tpu.models.critic.init_critic``: glorot-uniform conv kernels,
    he-normal ``dis_9`` and ``dis_dense`` kernels, zero biases. The values
    come from ``seed``, not from JAX's random streams.
    """
    rng = np.random.default_rng(seed)
    variables: dict = {"params": {}}
    for name, p in DisC2DFCN1(cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".bias"):
            value = np.zeros(shape, np.float32)
        elif name.startswith(("dis_9.", "dis_dense.")):
            value = _he_normal(rng, shape)
        else:
            value = _glorot_uniform(rng, shape)
        _put(variables["params"], name, value)
    return variables
