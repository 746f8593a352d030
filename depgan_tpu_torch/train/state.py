"""Training state of the two-critic WGAN-GP and of the UResNet trainer.

Counterpart of ``depgan_tpu/train/state.py``. The JAX state is an immutable
pytree that each superstep returns anew; here the state holds leaf tensors
and ``torch.optim.Adam`` instances that the superstep updates in place, so
no second copy of the parameters or moments exists.

Parameters are flat dicts of float32 leaf tensors keyed by the dotted Flax
path, which is also the parameter name of the port's modules
(``block_gen_0.conv2d_gen_0.kernel``), so the same dict feeds
``torch.func.functional_call`` and, unflattened, ``FusedGenerator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class GanTrainState:
    """G, both critics, and the Adam state of each."""

    g_params: dict[str, torch.Tensor]
    g_stats: dict[str, torch.Tensor]  # BatchNorm moving statistics
    g_opt: torch.optim.Adam
    dy2_params: dict[str, torch.Tensor]
    dy2_opt: torch.optim.Adam
    ddem_params: dict[str, torch.Tensor]
    ddem_opt: torch.optim.Adam


@dataclass
class UResNetTrainState:
    """The generator, its BatchNorm moving statistics, Adam, and the count
    of epochs done."""

    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt: torch.optim.Adam
    epoch: int = 0


@dataclass
class Counters:
    """The reference's module-global iteration counters (reference :47-49),
    host-side: they drive the warm-up schedule."""

    gen_iterations: int = 0
    crit_iterations: int = 0
    crit_dem_iterations: int = 0


def make_adam(params: dict[str, torch.Tensor], lr: float, b1: float, b2: float,
              count: int = 0, mu: dict | None = None, nu: dict | None = None):
    """``torch.optim.Adam(lr, betas=(b1, b2), eps=1e-8)`` over ``params``:
    the update of ``optax.adam`` (eps added after bias correction, no
    eps_root). ``count``, ``mu`` and ``nu`` carry over optax's step count
    and moments, keyed like ``params``."""
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(b1, b2), eps=1e-8)
    for name, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.zeros_like(p) if mu is None else mu[name].to(p).clone(),
            "exp_avg_sq": torch.zeros_like(p) if nu is None else nu[name].to(p).clone(),
        }
    return opt


def adam_moments(opt: torch.optim.Adam, params: dict[str, torch.Tensor]):
    """(count, mu, nu) of ``opt``, the moments keyed like ``params``."""
    first = opt.state[next(iter(params.values()))]
    return (int(first["step"]),
            {k: opt.state[p]["exp_avg"] for k, p in params.items()},
            {k: opt.state[p]["exp_avg_sq"] for k, p in params.items()})
