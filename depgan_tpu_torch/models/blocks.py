"""Layer building blocks as ``nn.Module``s, with Keras semantics.

Counterpart of ``depgan_tpu/models/blocks.py``. Each module stores its
parameters in the Keras/Flax layout under the Flax leaf names, so a Flax
variable tree maps onto the module by a plain key walk
(``io/flax_bridge.py``):

- ``Conv``: HWIO ``kernel`` (kh, kw, in, out) and ``bias``; SAME padding.
- ``Dense``: ``kernel`` (in, out) and ``bias``.
- ``Deconv2x2``: Keras Conv2DTranspose(k=2, s=2) ``kernel`` (kh, kw, out, in).
- ``BatchNorm``: ``scale``/``bias`` parameters, ``mean``/``var`` buffers,
  epsilon 1e-3, momentum 0.99 (Keras).

Tensors are channels-last (NHWC), as in the JAX package. With ``train``
false (serving, and the GAN graphs at Keras learning-phase 0) BatchNorm
reads its running statistics. With ``train`` true (the UResNet trainer and
the batch-BN generator step) it normalizes with the batch's statistics and
leaves the updated running statistics in ``BatchNorm.running``, as Flax's
``mutable=["batch_stats"]`` returns them; its buffers are not touched.
``Dropout`` is the training dropout of the generator's named layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

KERAS_BN_MOMENTUM = 0.99
KERAS_BN_EPS = 1e-3


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """SAME 2-D convolution of an NHWC tensor with an HWIO kernel (odd
    size). NHWC -> an NCHW view with channels-last strides: no copy, and
    the result permutes back to NHWC as a view too."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """SAME 2-D convolution on NHWC tensors with an HWIO kernel."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, in_ch, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.kernel.to(x.dtype), self.bias.to(x.dtype))


class Dense(nn.Module):
    """Keras Dense on the last axis: ``x @ kernel + bias``."""

    def __init__(self, in_features: int, units: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, units, device=device))
        self.bias = nn.Parameter(torch.zeros(units, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


def batch_statistics(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last, in at least
    float32, the variance as max(E[x^2] - E[x]^2, 0): Flax 0.12's
    ``_compute_stats`` with ``use_fast_variance`` and
    ``force_float32_reductions`` (``F.batch_norm``'s running variance is the
    unbiased one)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(x.ndim - 1))
    mean = xf.mean(axes)
    var = xf.square().mean(axes) - mean.square()
    return mean, torch.maximum(var, var.new_zeros(()))


class BatchNorm(nn.Module):
    """Keras BatchNormalization over the last axis."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.running: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.var + KERAS_BN_EPS) * self.scale
            return (x - self.mean.to(x.dtype)) * mul.to(x.dtype) + self.bias.to(x.dtype)
        mean, var = batch_statistics(x)
        self.running = tuple(
            (KERAS_BN_MOMENTUM * old + (1.0 - KERAS_BN_MOMENTUM) * new.detach()).to(old.dtype)
            for old, new in ((self.mean, mean), (self.var, var)))
        mul = torch.rsqrt(var + KERAS_BN_EPS) * self.scale
        return ((x.to(mean.dtype) - mean) * mul + self.bias).to(x.dtype)


class Dropout:
    """Flax ``nn.Dropout`` in training for the generator's named layers:
    ``where(keep, x / (1 - rate), 0)``. A layer's keep mask comes from
    ``masks`` by layer name where present, else it is drawn from
    ``generator`` (kept with probability 1 - rate) and recorded in
    ``masks``, so another forward can reuse the masks of this one."""

    def __init__(self, rate: float, masks: dict | None = None,
                 generator: torch.Generator | None = None):
        self.rate = rate
        self.masks = {} if masks is None else masks
        self.generator = generator

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        keep = self.masks.get(name)
        if keep is None:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.rate
            self.masks[name] = keep
        if keep.shape != x.shape:
            raise ValueError(f"dropout mask {name}: shape {tuple(keep.shape)}, "
                             f"layer output {tuple(x.shape)}")
        return torch.where(keep, x / (1.0 - self.rate), x.new_zeros(()))


class Deconv2x2(nn.Module):
    """Keras Conv2DTranspose(k=2, s=2, 'valid') as a per-pixel matmul.

    out[b, 2i+di, 2j+dj, o] = sum_c x[b, i, j, c] * W[di, dj, o, c] + b[o]
    """

    def __init__(self, in_ch: int, features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(2, 2, features, in_ch, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        o = self.kernel.shape[2]
        w2 = self.kernel.permute(3, 0, 1, 2).reshape(c, 4 * o).to(x.dtype)
        y = (x @ w2).reshape(b, h, w, 2, 2, o)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)
        return y + self.bias.to(x.dtype)


class ConvBN(nn.Module):
    """conv2d_bn: Conv -> BN, no activation."""

    def __init__(self, in_ch: int, features: int, kernel: int, suffix: str,
                 device=None):
        super().__init__()
        self.conv_name, self.bn_name = f"conv2d_{suffix}", f"bn_{suffix}"
        self.add_module(self.conv_name, Conv(in_ch, features, kernel, device))
        self.add_module(self.bn_name, BatchNorm(features, device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.get_submodule(self.bn_name)(self.get_submodule(self.conv_name)(x), train)


class ConvBNRelu(ConvBN):
    """conv2d_bn_relu: Conv -> BN -> ReLU."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(super().forward(x, train))


class DenseBN(nn.Module):
    """dense_bn: Dense(he_normal) -> BN."""

    def __init__(self, in_features: int, units: int, suffix: str, device=None):
        super().__init__()
        self.dense_name, self.bn_name = f"dense_{suffix}", f"dense_bn_{suffix}"
        self.add_module(self.dense_name, Dense(in_features, units, device))
        self.add_module(self.bn_name, BatchNorm(units, device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.get_submodule(self.bn_name)(self.get_submodule(self.dense_name)(x), train)


class DenseBNRelu(nn.Module):
    """dense_bn_relu: the Flax tree nests its DenseBN as ``block_<suffix>``."""

    def __init__(self, in_features: int, units: int, suffix: str, device=None):
        super().__init__()
        self.block_name = f"block_{suffix}"
        self.add_module(self.block_name, DenseBN(in_features, units, suffix, device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.get_submodule(self.block_name)(x, train))


class DeconvBNRelu(nn.Module):
    """deconv2d_bn_relu: Deconv2x2 -> BN -> ReLU."""

    def __init__(self, in_ch: int, features: int, suffix: str, device=None):
        super().__init__()
        self.deconv_name, self.bn_name = f"deconv2d_{suffix}", f"bn_{suffix}"
        self.add_module(self.deconv_name, Deconv2x2(in_ch, features, device))
        self.add_module(self.bn_name, BatchNorm(features, device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.get_submodule(self.deconv_name)(x)
        return torch.relu(self.get_submodule(self.bn_name)(y, train))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPooling2D(pool_size=(2, 2)) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
