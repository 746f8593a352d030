"""Gen_UNet2D as an ``nn.Module``: the plain inference path, the oracle of
the fast generator, and the training forward of the UResNet trainer and the
batch-BN GAN generator step.

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
from .blocks import BatchNorm, Conv, ConvBNRelu, Dense, DeconvBNRelu, Dropout, max_pool_2x2
from .film import SITES, FilmSite, NoiseEncoder

# (site, conv_in, conv_out, channel multiple) in forward order; the decoder
# entries also name their upsampling deconv (reference :397-491).
ENCODER = (("m1", "gen_0", "gen_1", 1), ("m2", "gen_2", "gen_3", 2),
           ("m3", "gen_4", "gen_5", 3))
MIDDLE = ("p4", "gen_8", "gen_9", 4)
DECODER = (("p3", "gen_10", "gen_11", 3, "de_gen_9"),
           ("p2", "gen_14", "gen_15", 2, "de_gen_11"),
           ("p1", "gen_16", "gen_17", 1, "de_gen_15"))
# Each site's training dropout layers (reference :399-485): 'a' on its
# conv_in's output, 'b' on its FiLM conv's output before the modulation;
# and the site's image side as a divisor of the input's.
DROPOUT = {"m1": ("do_gen_a3", "do_gen_b3"), "m2": ("do_gen_a2", "do_gen_b2"),
           "m3": ("do_gen_a1", "do_gen_b1"), "p4": ("do_gen_0a", "do_gen_0b"),
           "p3": ("do_gen_1a", "do_gen_1b"), "p2": ("do_gen_2a", "do_gen_2b"),
           "p1": ("do_gen_3a", "do_gen_3b")}
SIDE_DIVISOR = {"m1": 1, "m2": 2, "m3": 4, "p4": 8, "p3": 4, "p2": 2, "p1": 1}


def dropout_layer(cfg: ModelConfig, name: str) -> str | None:
    """The layer name under which dropout ``name`` acts in training, or None
    where ``cfg.dropout_mode`` places none: every layer for 'gan'; for
    'uresnet' only 'do_gen_1a', which the reference names 'do_gen_1'."""
    if cfg.dropout_mode == "gan":
        return name
    if cfg.dropout_mode == "uresnet" and name == "do_gen_1a":
        return "do_gen_1"
    return None


def dropout_shapes(cfg: ModelConfig, batch: int) -> dict[str, tuple[int, ...]]:
    """The keep mask's shape of every dropout layer active in training."""
    shapes = {}
    for site, mult in SITES.items():
        side = cfg.image_size // SIDE_DIVISOR[site]
        for name in DROPOUT[site]:
            layer = dropout_layer(cfg, name)
            if layer is not None:
                shapes[layer] = (batch, side, side, cfg.first_fm * mult)
    return shapes


def dropout_masks(cfg: ModelConfig, batch: int, generator: torch.Generator | None = None,
                  device=None) -> dict[str, torch.Tensor]:
    """Keep masks of one training forward, drawn from ``generator``."""
    return {name: torch.rand(shape, generator=generator, device=device) < 1.0 - cfg.dropout_rate
            for name, shape in dropout_shapes(cfg, batch).items()}


class GenUNet2D(nn.Module):
    """U-Net generator with auxiliary-noise FiLM modulation.

    ``forward(x, z)`` with x (B, H, W, C_in) and z (B, noise_size, 1) returns
    (B, H, W, n_out) float32: frozen BatchNorm, no dropout (serving and the
    GAN graphs). ``forward(x, z, train=True, dropout=...)`` is Flax's
    ``train=True``: batch statistics, whose updated running statistics
    ``updated_batch_stats`` returns afterwards, and dropout where
    ``cfg.dropout_mode`` places it. The trunk runs in ``cfg.compute_dtype``;
    parameters stay float32. With ``cfg.use_pallas`` the FiLM sites run K8.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        n = cfg.first_fm
        self.noise_encoder = NoiseEncoder(cfg.noise_size, n, device)

        def level(in_ch, site, cin, cout, mult):
            f = n * mult
            self.add_module(f"block_{cin}", ConvBNRelu(in_ch, f, 3, cin, device))
            self.add_module(f"film_{site}", FilmSite(f, site, cfg.use_pallas, device))
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

    def _level(self, x, mods, site, cin, cout, train, drop):
        """conv_bn_relu -> [dropout a] -> FiLM site [dropout b] ->
        conv_bn_relu (reference :398-409)."""
        h = self.get_submodule(f"block_{cin}")(x, train)
        name_a, name_b = DROPOUT[site]
        if (drop_a := drop(name_a)) is not None:
            h = drop_a(h)
        h = self.get_submodule(f"film_{site}")(h, *mods[site], train, drop(name_b))
        return self.get_submodule(f"block_{cout}")(h, train)

    def forward(self, x: torch.Tensor, z: torch.Tensor, train: bool = False,
                dropout: Dropout | None = None) -> torch.Tensor:
        """``dropout`` gives the keep masks of a training forward (by layer
        name, or drawn from its generator); a training forward with a
        ``dropout_mode`` other than 'none' needs it."""
        if train and dropout is None and dropout_shapes(self.cfg, 1):
            raise ValueError(f"a training forward with dropout_mode "
                             f"{self.cfg.dropout_mode!r} needs dropout masks or a generator")

        def drop(name):
            layer = dropout_layer(self.cfg, name) if train else None
            return None if layer is None else (lambda h: dropout(layer, h))

        if train:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.running = None
        dtype = getattr(torch, self.cfg.compute_dtype)
        x = x.to(dtype)
        mods = self.noise_encoder(z.to(dtype), train)
        skips = {}
        h = x
        for site, cin, cout, _ in ENCODER:
            skips[site] = self._level(h, mods, site, cin, cout, train, drop)
            h = max_pool_2x2(skips[site])
        h = self._level(h, mods, *MIDDLE[:3], train, drop)
        for (site, cin, cout, _, deconv), skip in zip(DECODER, ("m3", "m2", "m1")):
            up = self.get_submodule(f"block_{deconv}")(h, train)
            h = self._level(torch.cat([up, skips[skip]], dim=-1), mods, site, cin, cout,
                            train, drop)
        logits = self.gen_segmentation(h).float()
        if self.cfg.n_out == 1:
            return torch.tanh(logits)
        return torch.softmax(logits, dim=-1)

    def updated_batch_stats(self) -> dict[str, torch.Tensor]:
        """The running statistics after the last training forward, keyed
        like the buffers (``block_gen_0.bn_gen_0.mean``): what Flax returns
        as ``batch_stats`` under ``mutable``. The buffers stay as they were."""
        stats = {}
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                if m.running is None:
                    raise RuntimeError(f"{name}: no training forward has run")
                stats[f"{name}.mean"], stats[f"{name}.var"] = m.running
        return stats


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
