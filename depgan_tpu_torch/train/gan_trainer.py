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

The superstep is a ``profiling.span`` (``superstep``), and so is each of
its four phases (``superstep.critic_y2``, ``.critic_dem``, ``.probe``,
``.generator_step``): under ``torch.profiler`` each is a range of the
profile, so a profile of a superstep splits its device time by phase, and
a span record on the host's clock, so the card's idle time can be put down
to the phase that was running.

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

``fit_fold`` is JAX's epoch loop (:650-850) with ``dispatch_chunk=1``, one
superstep a loop turn: the warm-up schedule from the ``Counters``, the
epoch-tail supersteps, the counters in JAX's order, the metrics packed
into one device vector a superstep and fetched in one transfer every
``metric_flush_every`` supersteps (``MetricBuffer``), validation
(``val_step``: the plain generator in inference mode, K8 at its FiLM sites
under ``use_pallas``, and the plain Y2 critic), images, checkpoints and
the graph of the first superstep.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import functional_call

from ..config import DataConfig, GanTrainConfig, ModelConfig
from ..data.pipeline import EpochShuffler
from ..io.flax_bridge import gan_train_state_from_trees, unflatten_tree, zeros_like_tree
from ..models.blocks import Dropout
from ..models.critic import DisC2DFCN1, init_critic
from ..models.generator import GenUNet2D, dropout_masks, init_generator
from ..ops.fast_critic import FusedCritic
from ..ops.fast_gen import FusedGenerator
from ..utils.profiling import StepTimer, span
from .state import Counters, GanTrainState
from .wgan_gp import critic_step_loss, generator_loss

GEN_TAGS = (("errG_losses", "errG"), ("errG_CY2_losses", "errG_CY2"),
            ("errG_DEM_losses", "errG_DEM"), ("errG_MSE_losses", "errG_MSE"),
            ("errG_VOL_losses", "errG_VOL"), ("errG_WMH_losses", "errG_WMH"))
GEN_KEYS = tuple(k for _, k in GEN_TAGS)
CRIT_KEYS = ("crit_y2_real", "crit_y2_fake", "crit_dem_real", "crit_dem_fake")


def pack_superstep_metrics(metrics: dict) -> torch.Tensor:
    """One superstep's scalar metrics as ONE float32 device vector: the
    four (D,) critic rows, then the six generator losses (:62-78). The
    fit buffers these and fetches them together (``MetricBuffer``), so the
    host does not wait on the device at every superstep."""
    rows = [metrics[k].float().reshape(-1) for k in CRIT_KEYS]
    return torch.cat(rows + [torch.stack([metrics["gen"][k].float() for k in GEN_KEYS])])


def unpack_superstep_metrics(flat, d: int) -> dict:
    """Inverse of ``pack_superstep_metrics`` on a host vector (:81-89)."""
    flat = np.asarray(flat)
    rows = flat[: 4 * d].reshape(4, d)
    gen = dict(zip(GEN_KEYS, flat[4 * d: 4 * d + len(GEN_KEYS)]))
    return {**dict(zip(CRIT_KEYS, rows)), "gen": gen}


def log_superstep_metrics(log, metrics: dict, counters: Counters, n_valid: int) -> dict:
    """The reference's full scalar tag set for one superstep (reference
    :811-886, JAX :92-119): the per-critic-iteration errCrit_* streams of
    the ``n_valid`` real rows, the per-generator-iteration errDC_*
    snapshots and the six generator loss terms. Returns the generator
    losses as floats."""
    y2r, y2f, dr, df = (np.asarray(metrics[k])[:n_valid] for k in CRIT_KEYS)
    for j in range(n_valid):
        log("errCrit_aaLosses", y2r[j] - y2f[j], counters.crit_iterations + j)
        log("errCrit_aReal_losses", y2r[j], counters.crit_iterations + j)
        log("errCrit_aFake_losses", y2f[j], counters.crit_iterations + j)
        log("errCrit_DEM_aaLosses", dr[j] - df[j], counters.crit_dem_iterations + j)
        log("errCrit_DEM_aReal_losses", dr[j], counters.crit_dem_iterations + j)
        log("errCrit_DEM_aFake_losses", df[j], counters.crit_dem_iterations + j)
    gi = counters.gen_iterations
    log("errDC_aaLosses", y2r[-1] - y2f[-1], gi)
    log("errDC_aReal_losses", y2r[-1], gi)
    log("errDC_aFake_losses", y2f[-1], gi)
    log("errDC_DEM_aaLosses", dr[-1] - df[-1], gi)
    log("errDC_DEM_aReal_losses", dr[-1], gi)
    log("errDC_DEM_aFake_losses", df[-1], gi)
    gen_aux = {k: float(v) for k, v in metrics["gen"].items()}
    for tag, key in GEN_TAGS:
        log(tag, gen_aux[key], gi)
    return gen_aux


class MetricBuffer:
    """Deferred metric fetch (JAX ``fit_fold``'s ``pending`` and ``flush``,
    :703-730): each superstep adds its packed device vector with its D,
    n_valid and counters; ``flush`` concatenates the buffered vectors on
    the device, brings them to the host in ONE transfer, and logs them in
    order. The logged values and steps are those of a flush per superstep."""

    def __init__(self, log):
        self.log = log
        self.pending: list[tuple[torch.Tensor, int, int, Counters]] = []
        self.last_logged: tuple[dict, dict] | None = None  # (metrics, generator losses)

    def __len__(self) -> int:
        return len(self.pending)

    def append(self, vec: torch.Tensor, d: int, n_valid: int, counters: Counters) -> None:
        self.pending.append((vec, d, n_valid, counters))

    def flush(self) -> tuple[dict, dict] | None:
        """Logs the buffered supersteps; returns the last one's host
        metrics and generator losses (the last flushed, if none is
        buffered)."""
        if not self.pending:
            return self.last_logged
        flat = torch.cat([vec for vec, *_ in self.pending]).cpu().numpy()
        off = 0
        for vec, d, n_valid, counters in self.pending:
            m = unpack_superstep_metrics(flat[off:off + vec.numel()], d)
            self.last_logged = (m, log_superstep_metrics(self.log, m, counters, n_valid))
            off += vec.numel()
        self.pending = []
        return self.last_logged


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
        # The plain modules: the plain path's networks, and validation's on
        # every path. Parameters come from the state through functional_call.
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
        Updates ``state`` in place; returns it and the metrics.

        cuDNN runs its deterministic algorithms here (no autotuning), so
        that the same state and draws give the same superstep bit for bit,
        as JAX's does, and a run resumed from a checkpoint repeats the
        uninterrupted one. With cuDNN's default choice two runs from one
        state differ after one superstep (chip_smoke.py phase 11 prints by
        how much), Adam turning rounding-level differences of a gradient
        into steps of up to ~lr."""
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=cudnn.allow_tf32), span("superstep"):
            return self._superstep(state, x_all, y_all, idx_block, n_valid, generator, draws)

    def _superstep(self, state, x_all, y_all, idx_block, n_valid, generator, draws):
        d, batch = idx_block.shape
        if not 1 <= n_valid <= d:
            raise ValueError(f"n_valid must be in [1, {d}], got {n_valid}")
        if draws is None:
            draws = self.draw(d, batch, generator)
        idx = torch.as_tensor(np.asarray(idx_block), dtype=torch.long, device=self.device)
        xb, yb = x_all[idx], y_all[idx]  # one gather for the superstep

        with torch.no_grad():
            gen_fwd = self._gen_forward(state)
        with span("superstep.critic_y2"):
            y2_real, y2_fake = self._critic_loop("y2", state.dy2_params, state.dy2_opt, xb, yb,
                                                 draws["noises_y2"], draws["eps_y2"], n_valid,
                                                 gen_fwd)
        with span("superstep.critic_dem"):
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
        with torch.no_grad(), span("superstep.probe"):
            probe_losses = torch.stack([loss_of(gen_fwd(x, z))[0] for z in probes])
        best = torch.argmin(probe_losses)

        with span("superstep.generator_step"):
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

    # ------------------------------------------------------------ validation

    @torch.no_grad()
    def val_step(self, state: GanTrainState, x_val, y2_val, fixed_noise):
        """Validation critic scores and the generated DEM (reference
        :845-847, JAX :535-562): the plain generator in inference mode
        (K8 at its FiLM sites under ``use_pallas``) and the plain Y2
        critic, over the whole validation set in one call. Returns the
        three mean scores (device scalars) and the DEM, which the image
        stream reuses.

        Faithful quirk: ``val_D_real_generated_loss`` scores the critic on
        the raw DEM, not the follow-up y1 + DEM
        (``netD_y2.predict(netG.predict([x_val, fixed_noise]))``, reference
        :847), though the Y2 critic trains on follow-up images."""
        def critic(img):
            return functional_call(self.critic, state.dy2_params, (img,))

        y1 = x_val[..., :1]
        d_fake = critic(y1).mean()
        d_real = critic(y2_val).mean()
        dem = functional_call(self.gen, {**state.g_params, **state.g_stats}, (x_val, fixed_noise))
        d_gen = critic(dem).mean()
        return d_fake, d_real, d_gen, dem

    # ------------------------------------------------------------------- fit

    def fit_fold(self, state: GanTrainState, counters: Counters, x_train: np.ndarray,
                 y_train: np.ndarray, x_val: np.ndarray, y_val: np.ndarray,
                 n_epochs: int | None = None, logger=None, checkpoint_fn=None, fold: int = 1,
                 seed: int | None = None, fixed_noise=None, draws_fn=None):
        """Train one fold for ``n_epochs`` (``cfg.n_epochs`` if None) from
        ``state`` and ``counters`` (JAX :650-850); returns the state and the
        counters.

        Each loop turn runs one superstep of D critic steps (the warm-up
        schedule's D for the current generator iteration) over the next D
        batches of the epoch's shuffle (``EpochShuffler`` seeded
        ``cfg.seed + fold``), fewer at the epoch's tail. Then, in JAX's
        order: the critic counters advance by the real rows; the metrics
        are buffered, and flushed every ``metric_flush_every`` supersteps;
        every ``validate_every`` generator iterations a flush, ``val_step``,
        its three scores, the ``perf/*`` scalars and the ``TRN FOLD`` line,
        and every ``image_log_every`` the DEM and fake follow-up images;
        the generator counter advances, and ``checkpoint_fn(state,
        counters)`` runs every ``checkpoint_every``. The first superstep
        runs under ``logger.log_graph``. A last flush ends the fit.

        The random draws — the fixed validation noise, then each
        superstep's ``draw`` — come from one ``torch.Generator`` seeded
        ``seed`` (``cfg.seed + fold`` if None). A test can pass
        ``fixed_noise`` and ``draws_fn(i, d, batch)``, the draws of the
        i-th superstep of this fit, instead."""
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        gen = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else cfg.seed + fold)

        def put(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32, device=self.device)

        x_all, y_all, xv, yv = put(x_train), put(y_train), put(x_val), put(y_val)
        if fixed_noise is None:
            fixed_noise = torch.randn((x_val.shape[0], self.model_cfg.noise_size, 1),
                                      generator=gen, device=self.device)
        else:
            fixed_noise = put(fixed_noise)
        shuffler = EpochShuffler(x_train.shape[0], cfg.batch_size, cfg.seed + fold)
        t0 = time.time()
        log = logger.log_scalar if logger is not None else (lambda *a: None)
        timer = StepTimer()
        buffer = MetricBuffer(log)
        n_run = 0  # supersteps of this fit

        for epoch in range(n_epochs):
            idx_epoch = shuffler.epoch()
            n_batches = idx_epoch.shape[0]
            i = 0
            while i < n_batches:
                d = self._d_iters_for_gi(counters.gen_iterations)
                n_valid = min(d, n_batches - i)
                block = np.zeros((d, cfg.batch_size), np.int32)
                block[:n_valid] = idx_epoch[i:i + n_valid]
                i += n_valid
                draws = (draws_fn(n_run, d, cfg.batch_size) if draws_fn is not None
                         else self.draw(d, cfg.batch_size, gen))

                def run(s, block=block, n_valid=n_valid, draws=draws):
                    return self.superstep(s, x_all, y_all, block, n_valid, draws=draws)

                if logger is not None and n_run == 0:
                    # TensorBoard graph tab (reference log_graph :174-175,
                    # :510): the operators of the superstep about to run.
                    state, metrics = logger.log_graph(run, (state,))
                else:
                    state, metrics = run(state)
                n_run += 1

                buffer.append(pack_superstep_metrics(metrics), d, n_valid, counters)
                counters = dataclasses.replace(
                    counters, crit_iterations=counters.crit_iterations + n_valid,
                    crit_dem_iterations=counters.crit_dem_iterations + n_valid)
                gi = counters.gen_iterations
                timer.step()
                if len(buffer) >= cfg.metric_flush_every:
                    buffer.flush()

                # --- validation (reference :842-855) ---
                if gi % cfg.validate_every == 0:
                    m_last, gen_aux = buffer.flush()
                    d_fake, d_real, d_gen, val_dem = self.val_step(state, xv, yv, fixed_noise)
                    vals = torch.stack([d_fake, d_real, d_gen]).cpu().numpy()  # one transfer
                    log("val_D_fake_loss", float(vals[0]), gi)
                    log("val_D_real_loss", float(vals[1]), gi)
                    log("val_D_real_generated_loss", float(vals[2]), gi)
                    if logger is not None:
                        timer.log_to(logger, gi)
                    err_d = float(m_last["crit_y2_real"][n_valid - 1]
                                  - m_last["crit_y2_fake"][n_valid - 1])
                    print(f"TRN FOLD {fold} [{epoch}/{n_epochs}][{i}/{n_batches}]"
                          f"[{gi}] errD {err_d:+.4f} "
                          f"errG {gen_aux['errG']:+.4f} ({time.time() - t0:.1f}s)")
                    # Validation images (reference :858-865): the DEM and the
                    # fake follow-up of the first n_val_images slices.
                    if logger is not None and gi % cfg.image_log_every == 0:
                        k_img = cfg.n_val_images
                        dem = val_dem[:k_img]
                        fake = xv[:k_img, ..., :1] + dem
                        logger.log_images(f"attributed_img_step{gi}", dem.cpu().numpy(), gi)
                        logger.log_images(f"fake_img_step{gi}", fake.cpu().numpy(), gi)

                counters = dataclasses.replace(counters, gen_iterations=gi + 1)
                if checkpoint_fn is not None and (gi + 1) % cfg.checkpoint_every == 0:
                    checkpoint_fn(state, counters)

        buffer.flush()
        return state, counters
