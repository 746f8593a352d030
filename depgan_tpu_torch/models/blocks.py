"""Layer building blocks as ``nn.Module``s, with Keras semantics.

Counterpart of ``depgan_tpu/models/blocks.py``. Each module stores its
parameters in the Keras/Flax layout under the Flax leaf names, so a Flax
variable tree maps onto the module by a plain key walk
(``io/flax_bridge.py``):

- ``Conv``: HWIO ``kernel`` (kh, kw, in, out) and ``bias``; SAME padding.
- ``Dense``: ``kernel`` (in, out) and ``bias``.
- ``Deconv2x2``: Keras Conv2DTranspose(k=2, s=2) ``kernel`` (kh, kw, out, in).
- ``BatchNorm``: ``scale``/``bias`` parameters, ``mean``/``var`` buffers,
  epsilon 1e-3 (Keras; Keras' momentum 0.99 is torch's ``momentum=0.01``).

Tensors are channels-last (NHWC), as in the JAX package. These modules are
the forward of serving and of the GAN graphs, which train with frozen
BatchNorm (Keras learning-phase 0): BatchNorm reads its running statistics
and Dropout is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


class BatchNorm(nn.Module):
    """Keras BatchNormalization over the last axis, frozen statistics."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + KERAS_BN_EPS) * self.scale
        return (x - self.mean.to(x.dtype)) * mul.to(x.dtype) + self.bias.to(x.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.get_submodule(self.bn_name)(self.get_submodule(self.conv_name)(x))


class ConvBNRelu(ConvBN):
    """conv2d_bn_relu: Conv -> BN -> ReLU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(super().forward(x))


class DenseBN(nn.Module):
    """dense_bn: Dense(he_normal) -> BN."""

    def __init__(self, in_features: int, units: int, suffix: str, device=None):
        super().__init__()
        self.dense_name, self.bn_name = f"dense_{suffix}", f"dense_bn_{suffix}"
        self.add_module(self.dense_name, Dense(in_features, units, device))
        self.add_module(self.bn_name, BatchNorm(units, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.get_submodule(self.bn_name)(self.get_submodule(self.dense_name)(x))


class DenseBNRelu(nn.Module):
    """dense_bn_relu: the Flax tree nests its DenseBN as ``block_<suffix>``."""

    def __init__(self, in_features: int, units: int, suffix: str, device=None):
        super().__init__()
        self.block_name = f"block_{suffix}"
        self.add_module(self.block_name, DenseBN(in_features, units, suffix, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.get_submodule(self.block_name)(x))


class DeconvBNRelu(nn.Module):
    """deconv2d_bn_relu: Deconv2x2 -> BN -> ReLU."""

    def __init__(self, in_ch: int, features: int, suffix: str, device=None):
        super().__init__()
        self.deconv_name, self.bn_name = f"deconv2d_{suffix}", f"bn_{suffix}"
        self.add_module(self.deconv_name, Deconv2x2(in_ch, features, device))
        self.add_module(self.bn_name, BatchNorm(features, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.get_submodule(self.deconv_name)(x)
        return torch.relu(self.get_submodule(self.bn_name)(y))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPooling2D(pool_size=(2, 2)) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
