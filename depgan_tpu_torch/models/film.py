"""Auxiliary-noise encoder and FiLM site modulation.

Counterpart of ``depgan_tpu/models/film.py``. The noise z (B, noise_size, 1)
passes two Dense+BN+ReLU layers along its last axis, is flattened, and one
Dense+BN pair per site gives that site's multiplicative (gamma) and additive
(beta) vector. A site modulates its trunk as
``trunk + relu(conv_bn(trunk) * gamma + beta)``, gamma and beta broadcast
over H and W; with ``use_pallas`` through K8 (``ops/film.py``), as the JAX
site calls ``film_pallas.film_residual``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.film import film_residual
from .blocks import ConvBN, DenseBN, DenseBNRelu

# Modulation sites in reference declaration order -> channel multiple of
# first_fm. Dict order is the order of the encoder's parameters.
SITES = {
    "m1": 1,
    "m2": 2,
    "m3": 3,
    "p4": 4,  # bottleneck; its dense layers are named 'noise_2_*' bare
    "p3": 3,
    "p2": 2,
    "p1": 1,
}


def site_suffix(kind: str, site: str) -> str:
    """Reference layer name of a site's dense: 'noise_2_<kind>_<site>', but
    bare 'noise_2_<kind>' for the bottleneck site p4."""
    return f"noise_2_{kind}" if site == "p4" else f"noise_2_{kind}_{site}"


class NoiseEncoder(nn.Module):
    """z (B, noise_size, 1) -> {site: (gamma (B, C), beta (B, C))}."""

    def __init__(self, noise_size: int, first_fm: int, device=None):
        super().__init__()
        self.noise_1_add_f0 = DenseBNRelu(1, first_fm, "noise_1_add_f0", device)
        self.noise_1_add_f1 = DenseBNRelu(first_fm, first_fm, "noise_1_add_f1", device)
        flat = noise_size * first_fm
        for site, mult in SITES.items():
            for kind in ("mul", "add"):
                name = site_suffix(kind, site)
                self.add_module(name, DenseBN(flat, first_fm * mult, name, device))

    def forward(self, z: torch.Tensor,
                train: bool = False) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """In training the first two BatchNorms normalize over the batch
        and the noise axis, the sites' over the batch."""
        h = self.noise_1_add_f1(self.noise_1_add_f0(z, train), train)
        h = h.reshape(h.shape[0], -1)
        return {
            site: (self.get_submodule(site_suffix("mul", site))(h, train),
                   self.get_submodule(site_suffix("add", site))(h, train))
            for site in SITES
        }


def film_modulate(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """relu(x * gamma + beta) with (B, C) -> (B, 1, 1, C) broadcast."""
    return torch.relu(x * gamma[:, None, None, :] + beta[:, None, None, :])


class FilmSite(nn.Module):
    """One modulation site: conv_bn -> [dropout] -> FiLM -> residual add,
    ``trunk + relu(conv_bn(trunk) * gamma + beta)``; the last two through
    K8 with ``use_pallas``."""

    def __init__(self, features: int, site: str, use_pallas: bool = False, device=None):
        super().__init__()
        self.use_pallas = use_pallas
        self.block_name = f"block_gen_noise_{site}"
        self.add_module(self.block_name,
                        ConvBN(features, features, 3, f"gen_noise_{site}", device))

    def forward(self, trunk, gamma, beta, train: bool = False, dropout=None):
        """``dropout`` (optional) maps the conv_bn output, before the FiLM."""
        h = self.get_submodule(self.block_name)(trunk, train)
        if dropout is not None:
            h = dropout(h)
        if self.use_pallas:
            # conv2d_same returns a permuted view: K8 takes contiguous NHWC.
            return film_residual(h.contiguous(), gamma, beta, trunk.contiguous())
        return trunk + film_modulate(h, gamma, beta)
