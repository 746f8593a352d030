"""DEP-GAN two-critic WGAN-GP trainer: the superstep.

Counterpart of ``depgan_tpu/train/gan_trainer.py`` (reference
`...twoCritics_training_4fold.py:506-894`), its sequential superstep
(:313-531):

- one gather of the superstep's (D, B) batches from the fold's data on the
  device;
- the critic-Y2 loop, then the critic-DEM loop, D Adam steps each, with
  the generator frozen (its weights folded once per superstep);
- the best-of-k noise probe without gradients;
- the generator's Adam step on the last valid batch with the probe's best
  noise.

Each of the four phases is a ``torch.profiler`` range
(``superstep.critic_y2``, ``.critic_dem``, ``.probe``, ``.generator_step``),
so a profile of a superstep splits its device time by phase.

With ``bn_mode='frozen'`` (Keras learning-phase 0), ``model_cfg.use_pallas``
selects the fused path (``FusedGenerator`` and ``FusedCritic`` through the
hand-written kernels, the critic's input gradient hand-chained) or the
plain one (``GenUNet2D`` and ``DisC2DFCN1`` through
``torch.func.functional_call``, the input gradient by double backward).
``bn_mode='batch'`` runs the plain modules, as JAX does
(``gan_trainer.py:266``), ``GenUNet2D``'s FiLM sites through K8 under
``use_pallas``: the critic loops and the probe see the generator in
inference mode, and the generator's step runs it in training mode (batch
statistics, dropout at ``dropout_mode``) and keeps the new statistics
(:492-521).

Differences from the JAX superstep, none of them in the result: it runs
eagerly and updates the state in place; epoch-tail rows (beyond
``n_valid``) are skipped instead of computed and discarded, so their
metrics are NaN; every random draw can be passed in (``draws``), so a test
can feed the JAX draws.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function

from ..config import DataConfig, GanTrainConfig, ModelConfig
from ..io.flax_bridge import gan_train_state_from_trees, unflatten_tree, zeros_like_tree
from ..models.blocks import Dropout
from ..models.critic import DisC2DFCN1, init_critic
from ..models.generator import GenUNet2D, dropout_masks, init_generator
from ..ops.fast_critic import FusedCritic
from ..ops.fast_gen import FusedGenerator
from .state import GanTrainState
from .wgan_gp import critic_step_loss, generator_loss

GEN_KEYS = ("errG", "errG_CY2", "errG_DEM", "errG_MSE", "errG_VOL", "errG_WMH")


class GanTrainer:
    """The superstep of the two-critic WGAN-GP on ``device``."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: GanTrainConfig,
                 data_cfg: DataConfig | None = None, device="cuda"):
        if train_cfg.bn_mode not in ("frozen", "batch"):
            raise ValueError(f"bn_mode must be 'frozen' or 'batch', got {train_cfg.bn_mode!r}")
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.threshold = (data_cfg or DataConfig()).wmh_threshold
        self.device = torch.device(device)
        self.batch_bn = train_cfg.bn_mode == "batch"
        self.use_fused = model_cfg.use_pallas and not self.batch_bn
        dtype = getattr(torch, model_cfg.compute_dtype)
        if self.use_fused:
            # The generator's width gate runs here: a site no kernel takes
            # warns (on a CUDA device) and runs its plain torch version.
            self.fused = FusedGenerator(model_cfg, dtype, self.device)
            self.fused_critic = FusedCritic(model_cfg, dtype)
        else:
            # Parameters come from the state through functional_call.
            self.gen = GenUNet2D(model_cfg, device="meta")
            self.critic = DisC2DFCN1(model_cfg, device="meta")

    # ------------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> GanTrainState:
        """Fresh generator and critics from ``seed`` (numpy initializers in
        the Flax layout), Adam moments zero."""
        g = init_generator(self.model_cfg, seed=seed)
        trees = {"g_params": g["params"], "g_stats": g["batch_stats"]}
        for i, name in enumerate(("dy2", "ddem")):
            trees[f"{name}_params"] = init_critic(self.model_cfg, seed=seed + 1 + i)["params"]
        for name in ("g", "dy2", "ddem"):
            zeros = zeros_like_tree(trees[f"{name}_params"])
            trees[f"{name}_opt"] = {"count": 0, "mu": zeros, "nu": zeros}
        c = self.cfg
        return gan_train_state_from_trees(trees, c.lr_g, c.lr_d, c.adam_b1, c.adam_b2,
                                          self.device)

    def _d_iters_for_gi(self, gi: int) -> int:
        c = self.cfg
        if gi < c.warmup_until or gi % c.warmup_every == 0:
            return c.warmup_d_iters
        return c.d_iters

    def draw(self, d: int, batch: int, generator: torch.Generator | None = None) -> dict:
        """The superstep's random draws: per-iteration noises and GP
        epsilons of both critic loops, the probe's k noises and, with batch
        BatchNorm, the generator step's dropout keep masks by layer name."""
        nz, dev = self.model_cfg.noise_size, self.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        draws = {"noises_y2": normal(d, batch, nz, 1), "eps_y2": uniform(d, batch, 1, 1, 1),
                 "noises_dem": normal(d, batch, nz, 1), "eps_dem": uniform(d, batch, 1, 1, 1),
                 "probe_noises": normal(self.cfg.k_noise, batch, nz, 1)}
        if self.batch_bn:
            draws["dropout"] = dropout_masks(self.model_cfg, batch, generator, dev)
        return draws

    # -------------------------------------------------------------- networks

    def _gen_forward(self, state: GanTrainState):
        """G as the GAN graphs see it (Keras learning-phase 0: moving
        statistics, no dropout). The fused path folds the parameters here,
        so call it once per use under the grad mode the use needs."""
        if self.use_fused:
            W = self.fused.build_weights({"params": unflatten_tree(state.g_params),
                                          "batch_stats": unflatten_tree(state.g_stats)})
            return lambda x, z: self.fused.forward(W, x, z)
        tensors = {**state.g_params, **state.g_stats}
        return lambda x, z: functional_call(self.gen, tensors, (x, z))

    def _critic_fns(self, params: dict):
        """(score, input gradient or None) for live critic parameters."""
        if self.use_fused:
            fc = self.fused_critic
            return (lambda img: fc.forward(params, img),
                    lambda m: fc.score_and_input_grad(params, m)[1])
        return (lambda img: functional_call(self.critic, params, (img,))), None

    # -------------------------------------------------------------- superstep

    def _critic_loop(self, which, params, opt, xb, yb, noises, eps, n_valid, gen_fwd):
        """The first ``n_valid`` Adam steps of one critic (reference
        :802-829); returns the (D,) real and fake scores."""
        real_l = torch.full((xb.shape[0],), float("nan"), device=self.device)
        fake_l = real_l.clone()
        plist = list(params.values())
        critic_fn, input_grad_fn = self._critic_fns(params)
        for j in range(n_valid):
            x, y2 = xb[j], yb[j]
            y1 = x[..., :1]
            with torch.no_grad():
                dem = gen_fwd(x, noises[j])
            real, fake = (y2, y1 + dem) if which == "y2" else (y2 - y1, dem)
            loss, (loss_real, loss_fake) = critic_step_loss(
                critic_fn, real, fake, eps[j], self.cfg.gp_weight, input_grad_fn)
            for p, g in zip(plist, torch.autograd.grad(loss, plist)):
                p.grad = g
            opt.step()
            real_l[j], fake_l[j] = loss_real.detach(), loss_fake.detach()
        return real_l, fake_l

    def superstep(self, state: GanTrainState, x_all, y_all, idx_block, n_valid: int,
                  generator: torch.Generator | None = None, draws: dict | None = None):
        """One superstep on the (D, B) index block, of which the first
        ``n_valid`` rows are real batches. ``x_all`` (N, H, W, C_in) and
        ``y_all`` (N, H, W, 1) are the fold's slices on the device. The
        draws come from ``generator`` unless passed in (``draw``'s keys).
        Updates ``state`` in place; returns it and the metrics."""
        d, batch = idx_block.shape
        if not 1 <= n_valid <= d:
            raise ValueError(f"n_valid must be in [1, {d}], got {n_valid}")
        if draws is None:
            draws = self.draw(d, batch, generator)
        idx = torch.as_tensor(np.asarray(idx_block), dtype=torch.long, device=self.device)
        xb, yb = x_all[idx], y_all[idx]  # one gather for the superstep

        with torch.no_grad():
            gen_fwd = self._gen_forward(state)
        with record_function("superstep.critic_y2"):
            y2_real, y2_fake = self._critic_loop("y2", state.dy2_params, state.dy2_opt, xb, yb,
                                                 draws["noises_y2"], draws["eps_y2"], n_valid,
                                                 gen_fwd)
        with record_function("superstep.critic_dem"):
            dem_real, dem_fake = self._critic_loop("dem", state.ddem_params, state.ddem_opt,
                                                   xb, yb, draws["noises_dem"],
                                                   draws["eps_dem"], n_valid, gen_fwd)

        # ---- generator step on the last consumed batch (reference :873) ----
        x, y2 = xb[n_valid - 1], yb[n_valid - 1]
        y1 = x[..., :1]
        # The critics are constants here: detached, so their kernels'
        # backward computes no weight cotangents.
        crit_y2_fn = self._critic_fns({k: v.detach() for k, v in state.dy2_params.items()})[0]
        crit_dem_fn = self._critic_fns({k: v.detach() for k, v in state.ddem_params.items()})[0]

        def loss_of(dem):
            return generator_loss(self.cfg, self.threshold, dem, y1, y2, crit_y2_fn,
                                  crit_dem_fn)

        # Best-of-k probe, no update (reference :868-877).
        probes = draws["probe_noises"]
        with torch.no_grad(), record_function("superstep.probe"):
            probe_losses = torch.stack([loss_of(gen_fwd(x, z))[0] for z in probes])
        best = torch.argmin(probe_losses)

        with record_function("superstep.generator_step"):
            if self.batch_bn:
                drop = Dropout(self.model_cfg.dropout_rate, draws.get("dropout"), generator)
                dem = functional_call(self.gen, {**state.g_params, **state.g_stats},
                                      (x, probes[best]), {"train": True, "dropout": drop})
            else:
                dem = self._gen_forward(state)(x, probes[best])
            loss, aux = loss_of(dem)
            plist = list(state.g_params.values())
            for p, g in zip(plist, torch.autograd.grad(loss, plist)):
                p.grad = g
            state.g_opt.step()
            if self.batch_bn:
                state.g_stats = self.gen.updated_batch_stats()

        metrics = {"crit_y2_real": y2_real, "crit_y2_fake": y2_fake,
                   "crit_dem_real": dem_real, "crit_dem_fake": dem_fake,
                   "gen": {k: aux[k].detach() for k in GEN_KEYS}, "best_noise_idx": best}
        return state, metrics
