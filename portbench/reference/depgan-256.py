"""Plain reference of DEP-GAN (configuration ``depgan-256``): the ensemble
that serves a subject and the two-critic WGAN-GP superstep that trains it.

Written from the published training and testing scripts
(febrianrachmadi/dep-gan-im): ``DEP-GAN_testing_4fold.py:616-628`` (10
stochastic forwards, each masked, averaged) and
``DEP-GAN_PROB_IM_twoCritics_training_4fold.py:523-598, 792-877`` (D steps
of each critic with the gradient penalty, the best-of-k noise probe, the
generator's step on the last batch; Adam, b1 0, b2 0.9). It imports nothing
of the program; ``nets.py`` holds the networks.
"""

from __future__ import annotations

import torch

from portbench.reference import nets


@torch.no_grad()
def serve_ensemble(params, stats, cfg, x, mask, noises, precision: str = "float32"):
    """Masked mean of ``len(noises)`` generator forwards: x (Z, H, W, C),
    mask (Z, H, W), noises (R, Z, noise_size, 1) -> (Z, H, W, n_out)."""
    prec = nets.Precision(precision)
    with prec.products():
        total = torch.zeros(x.shape[:3] + (cfg["n_out"],), device=x.device)
        for z in noises:
            total += nets.generator(params, stats, cfg, x, z, prec)[0] * mask[..., None]
    return total / noises.shape[0]


def draws(cfg, train, d: int, gen: torch.Generator, device) -> dict:
    """One superstep's random draws, in the order the trainer takes them:
    both critic loops' noises and penalty epsilons, then the probe's k
    noises."""
    b, nz = train["batch_size"], cfg["noise_size"]
    out = {}
    for name, shape, fn in (("noises_y2", (d, b, nz, 1), torch.randn),
                            ("eps_y2", (d, b, 1, 1, 1), torch.rand),
                            ("noises_dem", (d, b, nz, 1), torch.randn),
                            ("eps_dem", (d, b, 1, 1, 1), torch.rand),
                            ("probe", (train["k_noise"], b, nz, 1), torch.randn)):
        out[name] = fn(shape, generator=gen, device=device)
    return out


def generator_loss(train, dem, y1, y2, critic_y2, critic_dem):
    """-D_y2(y1 + dem) - D_dem(dem) + 100 L1 + 100 (volume gap)^2 + Dice
    loss, the WMH masks thresholded with a hard >= (reference :573-592)."""
    t = train["wmh_threshold"]
    y2_fake = y1 + dem
    loss_cy2 = critic_y2(y2_fake).mean()
    loss_cdem = critic_dem(dem).mean()
    l1 = (dem - (y2 - y1)).abs().mean() * train["l1_weight"]
    m_real, m_fake = (y2 >= t).float(), (y2_fake >= t).float()
    dice = (2 * (m_real * m_fake).sum() + 1e-7) / (m_real.sum() + m_fake.sum() + 1e-7)
    vol = (m_real.sum() / 1000 - m_fake.sum() / 1000).square() * train["vol_weight"]
    return -loss_cy2 - loss_cdem + l1 + vol + (1 - dice) * train["dice_weight"]


class GanReference:
    """The generator, both critics and their Adam states, trained from the
    benchmark's initial weights one superstep at a time."""

    def __init__(self, cfg, train, g, g_stats, dy2, ddem, precision: str = "float32",
                 half_batch: bool = False):
        self.cfg, self.train, self.prec = cfg, train, nets.Precision(precision)
        wide = self.prec.wide
        self.g = wide({k: v.detach().clone().requires_grad_() for k, v in g.items()})
        self.stats = wide({k: v.detach().clone() for k, v in g_stats.items()})
        self.critics = {w: wide({k: v.detach().clone().requires_grad_() for k, v in p.items()})
                        for w, p in (("y2", dy2), ("dem", ddem))}
        b1, b2 = train["adam_b1"], train["adam_b2"]
        self.g_opt = nets.Adam(self.g, train["lr_g"], b1, b2)
        self.c_opts = {w: nets.Adam(p, train["lr_d"], b1, b2) for w, p in self.critics.items()}
        self.rows = train["batch_size"] // 2 if half_batch else train["batch_size"]

    def gen(self, x, z):
        return nets.generator(self.g, self.stats, self.cfg, x, z, self.prec)[0]

    def critic_fn(self, which, detach=False):
        params = self.critics[which]
        if detach:
            params = {k: v.detach() for k, v in params.items()}
        return lambda img: nets.critic(params, self.cfg, img, self.prec)

    def superstep(self, xb, yb, dr: dict, n_valid: int) -> dict:
        """One superstep on the (D, B) batches ``xb``, ``yb``; returns its
        losses: each critic row's real and fake score, and errG."""
        r = self.rows
        xb, yb = xb[:, :r], yb[:, :r]
        losses = {}
        with self.prec.products():
            for which in ("y2", "dem"):
                params, crit = self.critics[which], self.critic_fn(which)
                noises, eps = dr[f"noises_{which}"][:, :r], dr[f"eps_{which}"][:, :r]
                for j in range(n_valid):
                    x, y2 = xb[j], yb[j]
                    y1 = x[..., :1]
                    with torch.no_grad():
                        dem = self.gen(x, noises[j])
                    real, fake = (y2, y1 + dem) if which == "y2" else (y2 - y1, dem)
                    loss_real, loss_fake = crit(real).mean(), crit(fake).mean()
                    mixed = (eps[j] * real + (1 - eps[j]) * fake).detach().requires_grad_()
                    (grad,) = torch.autograd.grad(crit(mixed).sum(), mixed, create_graph=True)
                    gp = (grad.square().sum((1, 2, 3)).sqrt() - 1).square().mean()
                    loss = loss_fake - loss_real + self.train["gp_weight"] * gp
                    grads = torch.autograd.grad(loss, list(params.values()))
                    self.c_opts[which].step(params, dict(zip(params, grads)))
                    losses[f"crit_{which}_real_{j}"] = float(loss_real.detach())
                    losses[f"crit_{which}_fake_{j}"] = float(loss_fake.detach())

            x, y2 = xb[n_valid - 1], yb[n_valid - 1]
            y1 = x[..., :1]
            cy2, cdem = self.critic_fn("y2", True), self.critic_fn("dem", True)
            probes = dr["probe"][:, :r]
            with torch.no_grad():
                probe = torch.stack([generator_loss(self.train, self.gen(x, z), y1, y2, cy2, cdem)
                                     for z in probes])
            best = int(torch.argmin(probe))
            loss = generator_loss(self.train, self.gen(x, probes[best]), y1, y2, cy2, cdem)
            grads = torch.autograd.grad(loss, list(self.g.values()))
            self.g_opt.step(self.g, dict(zip(self.g, grads)))
        losses["errG"] = float(loss.detach())
        losses["best"] = best
        return losses

    def first_moments(self) -> dict:
        """Adam's first moments of every network, keyed 'g.<leaf>',
        'dy2.<leaf>', 'ddem.<leaf>'."""
        out = {f"g.{k}": v for k, v in self.g_opt.m.items()}
        for which, name in (("y2", "dy2"), ("dem", "ddem")):
            out.update({f"{name}.{k}": v for k, v in self.c_opts[which].m.items()})
        return out

    def parameters(self) -> dict:
        out = {f"g.{k}": v.detach() for k, v in self.g.items()}
        for which, name in (("y2", "dy2"), ("dem", "ddem")):
            out.update({f"{name}.{k}": v.detach() for k, v in self.critics[which].items()})
        return out
