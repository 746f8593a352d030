"""Gen_UNet2D as an ``nn.Module`` — the plain inference path and the oracle
of the fast generator.

Counterpart of ``depgan_tpu/models/generator.py``: a 3-level FiLM U-Net
(n, 2n, 3n feature maps, bottleneck 4n) with a FiLM site at every level and
a 1x1 head, tanh (``n_out == 1``, the DEM in [-1, 1]) or softmax. Submodule
and parameter names are the Flax tree's, so ``io/flax_bridge.py`` loads a
Flax variable tree by key walk, and ``init_generator`` writes such a tree
in numpy without JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from .blocks import Conv, ConvBNRelu, Dense, DeconvBNRelu, max_pool_2x2
from .film import FilmSite, NoiseEncoder

# (site, conv_in, conv_out, channel multiple) in forward order; the decoder
# entries also name their upsampling deconv (reference :397-491).
ENCODER = (("m1", "gen_0", "gen_1", 1), ("m2", "gen_2", "gen_3", 2),
           ("m3", "gen_4", "gen_5", 3))
MIDDLE = ("p4", "gen_8", "gen_9", 4)
DECODER = (("p3", "gen_10", "gen_11", 3, "de_gen_9"),
           ("p2", "gen_14", "gen_15", 2, "de_gen_11"),
           ("p1", "gen_16", "gen_17", 1, "de_gen_15"))


class GenUNet2D(nn.Module):
    """U-Net generator with auxiliary-noise FiLM modulation: the forward of
    the serving path and of the GAN graphs (frozen BatchNorm, no dropout).

    ``forward(x, z)`` with x (B, H, W, C_in) and z (B, noise_size, 1) returns
    (B, H, W, n_out) float32. The trunk runs in ``cfg.compute_dtype``;
    parameters stay float32.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        n = cfg.first_fm
        self.noise_encoder = NoiseEncoder(cfg.noise_size, n, device)

        def level(in_ch, site, cin, cout, mult):
            f = n * mult
            self.add_module(f"block_{cin}", ConvBNRelu(in_ch, f, 3, cin, device))
            self.add_module(f"film_{site}", FilmSite(f, site, device))
            self.add_module(f"block_{cout}", ConvBNRelu(f, f, 3, cout, device))

        in_ch = cfg.n_input_channels
        for site, cin, cout, mult in ENCODER + (MIDDLE,):
            level(in_ch, site, cin, cout, mult)
            in_ch = n * mult
        for site, cin, cout, mult, deconv in DECODER:
            # The deconv keeps the width of the level below; the skip
            # concat adds this level's encoder width.
            self.add_module(f"block_{deconv}", DeconvBNRelu(in_ch, in_ch, deconv, device))
            level(in_ch + n * mult, site, cin, cout, mult)
            in_ch = n * mult
        self.gen_segmentation = Conv(n, cfg.n_out, 1, device)

    def _level(self, x, mods, site, cin, cout):
        h = self.get_submodule(f"block_{cin}")(x)
        h = self.get_submodule(f"film_{site}")(h, *mods[site])
        return self.get_submodule(f"block_{cout}")(h)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.compute_dtype)
        x = x.to(dtype)
        mods = self.noise_encoder(z.to(dtype))
        skips = {}
        h = x
        for site, cin, cout, _ in ENCODER:
            skips[site] = self._level(h, mods, site, cin, cout)
            h = max_pool_2x2(skips[site])
        h = self._level(h, mods, *MIDDLE[:3])
        for (site, cin, cout, _, deconv), skip in zip(DECODER, ("m3", "m2", "m1")):
            up = self.get_submodule(f"block_{deconv}")(h)
            h = self._level(torch.cat([up, skips[skip]], dim=-1), mods, site, cin, cout)
        logits = self.gen_segmentation(h).float()
        if self.cfg.n_out == 1:
            return torch.tanh(logits)
        return torch.softmax(logits, dim=-1)


def _glorot_uniform(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax ``glorot_uniform``: fan_in = prod(shape[:-1]), fan_out =
    prod(shape[:-2]) * shape[-1]."""
    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = receptive * shape[-2], receptive * shape[-1]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def _he_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax ``he_normal``: a normal truncated at two standard deviations,
    rescaled to variance 2 / fan_in, fan_in = prod(shape[:-1])."""
    z = rng.standard_normal(shape)
    while (bad := np.abs(z) > 2.0).any():
        z[bad] = rng.standard_normal(int(bad.sum()))
    fan_in = int(np.prod(shape[:-1]))
    # 0.8796... is the standard deviation of a unit normal truncated at +-2.
    return (z * np.sqrt(2.0 / fan_in) / 0.87962566103423978).astype(np.float32)


def _put(tree: dict, dotted: str, value) -> None:
    """Sets ``tree[a][b]...[leaf] = value`` for the name 'a.b...leaf'."""
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def init_generator(cfg: ModelConfig, seed: int = 0) -> dict:
    """Fresh generator variables as a numpy tree in the Flax layout.

    Returns ``{"params": ..., "batch_stats": ...}`` with exactly the keys and
    shapes of ``depgan_tpu.models.init_generator``: glorot-uniform conv and
    deconv kernels, he-normal dense kernels, zero biases, BatchNorm scale 1,
    bias 0, mean 0, var 1. The values come from ``seed``, not from JAX's
    random streams.
    """
    rng = np.random.default_rng(seed)
    module = GenUNet2D(cfg, device="meta")
    owners = dict(module.named_modules())
    variables: dict = {"params": {}, "batch_stats": {}}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        owner_name, leaf = name.rsplit(".", 1)
        if leaf == "kernel" and isinstance(owners[owner_name], Dense):
            value = _he_normal(rng, shape)
        elif leaf == "kernel":  # Conv or Deconv2x2
            value = _glorot_uniform(rng, shape)
        elif leaf == "scale":
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        _put(variables["params"], name, value)
    for name, buf in module.named_buffers():
        fill = 1.0 if name.endswith(".var") else 0.0
        _put(variables["batch_stats"], name, np.full(tuple(buf.shape), fill, np.float32))
    return variables
