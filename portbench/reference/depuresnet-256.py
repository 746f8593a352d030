"""Plain reference of DEP-UResNet (configuration ``depuresnet-256``): the
supervised step.

Written from ``DEP-UResNet-wNoises-training-4fold.py`` (febrianrachmadi/
dep-gan-im): the generator of ``nets.py`` with a 4-class softmax head in
training mode (batch-statistics BatchNorm, dropout 0.25 after p3's first
conv only, :388), Keras' categorical cross-entropy on the clipped
probabilities, Adam(1e-4) (:427). It imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import nets


class UResNetReference:
    def __init__(self, cfg, g, g_stats, precision: str = "float32", half_batch: bool = False):
        self.cfg, self.prec = cfg, nets.Precision(precision)
        t = cfg["train"]
        self.params = self.prec.wide({k: v.detach().clone().requires_grad_()
                                      for k, v in g.items()})
        self.stats = self.prec.wide({k: v.detach().clone() for k, v in g_stats.items()})
        self.opt = nets.Adam(self.params, t["lr"], t["adam_b1"], t["adam_b2"])
        self.half = half_batch

    def dropout_masks(self, batch: int, gen: torch.Generator, device) -> dict:
        """Keep masks of one training forward, drawn as the trainer draws
        them: one uniform a dropout layer, kept below 1 - rate."""
        cfg, n, side = self.cfg, self.cfg["first_fm"], self.cfg["image_size"]
        masks = {}
        for site, (a, b) in nets.DROPOUT.items():
            div = {"m1": 1, "m2": 2, "m3": 4, "p4": 8, "p3": 4, "p2": 2, "p1": 1}[site]
            for name in (a, b):
                layer = nets.dropout_layer(cfg["dropout_mode"], name)
                if layer is not None:
                    shape = (batch, side // div, side // div, n * nets.MULT[site])
                    masks[layer] = torch.rand(shape, generator=gen, device=device) \
                        < 1.0 - cfg["dropout_rate"]
        return masks

    def step(self, x, y, noise, gen: torch.Generator) -> float:
        """One batch update; returns its loss."""
        masks = self.dropout_masks(x.shape[0], gen, x.device)
        if self.half:
            r = x.shape[0] // 2
            x, y, noise = x[:r], y[:r], noise[:r]
            masks = {k: v[:r] for k, v in masks.items()}
        with self.prec.products():
            probs, updated = nets.generator(self.params, self.stats, self.cfg, x, noise,
                                            self.prec, train=True, masks=masks)
            loss = -(y * torch.log(probs.clamp(1e-7, 1.0))).sum(-1).mean()
            grads = torch.autograd.grad(loss, list(self.params.values()))
        self.opt.step(self.params, dict(zip(self.params, grads)))
        self.stats.update(updated)
        return float(loss.detach())
