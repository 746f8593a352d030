"""The port's ``GanTrainer.fit_fold`` against the JAX package's: the same
(tag, step) stream in the same order, the values, the images, the final
parameters, the checkpoint calls and the counters, from the same state with
the same draws; the metric packing and logging against JAX's functions; the
validation step against JAX's ``_val_step``; a buffered flush against a
flush per superstep.

The fit runs at image 32, first_fm 8, float32, batch 2 over 20 training
slices (10 batches) and 3 validation slices, d_iters 2 after a warm-up
superstep of 3: supersteps of 3, 2, 2, 2 and an epoch-tail one of 1 real
row, validation every 2 generator iterations (3 validations), a flush
every 3 supersteps, a checkpoint every 2. The JAX side is ``fit_fold``
with ``use_pallas=False`` (the plain Flax graphs, which
``tests/test_fused_grad.py`` pins to the fused path) and
``dispatch_chunk=1``, its draws rebuilt from its key chain
(``gan_trainer.py:666, 681-684, 769``, then the six-way split of
``:316``). The state has randomized BatchNorm statistics and Adam moments
that are not zero, as in ``test_torch_gan_trainer.py``, so that Adam's
steps are smooth in the gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu import config as jax_config
from depgan_tpu.train import gan_trainer as jax_gan_trainer
from depgan_tpu.train.state import Counters as JaxCounters
from depgan_tpu.train.state import GanTrainState as JaxGanTrainState
from depgan_tpu_torch.config import DataConfig, GanTrainConfig, ModelConfig
from depgan_tpu_torch.io.flax_bridge import flatten_tree, gan_train_state_from_trees
from depgan_tpu_torch.models import init_critic, init_generator
from depgan_tpu_torch.train import gan_trainer
from depgan_tpu_torch.train.gan_trainer import GanTrainer
from depgan_tpu_torch.train.state import Counters
from depgan_tpu_torch.utils import tb_writer
from depgan_tpu_torch.utils.logging import Logger
from test_torch_gan_trainer import _adam_state
from test_torch_models import _map

N_TRAIN, N_VAL, BATCH, K_NOISE, SEED, FOLD = 20, 3, 2, 2, 7, 1
START = dict(gen_iterations=0, crit_iterations=4, crit_dem_iterations=9)
TRAIN = dict(batch_size=BATCH, n_epochs=1, d_iters=2, warmup_d_iters=3, warmup_until=1,
             k_noise=K_NOISE, validate_every=2, image_log_every=2, n_val_images=2,
             checkpoint_every=2, metric_flush_every=3)
# Float32 on both sides. The values: relative 1e-4, absolute 1e-4 (the
# critic scores sit near 1e-2; the largest difference read 9.2e-5 on an
# errG of ~139 and 2.7e-5 on an errG_CY2 of -0.033). The parameters, as
# chip_smoke.py's SUPERSTEP_LIMITS hold one superstep against float64: each
# network's updates within 5e-2 relative L2, no parameter more than 2 lr
# off. The plain path reads 6.8e-3 and 0.36 lr in the Y2 critic, where
# float32 is ill-conditioned (tied 2x2 pool windows, PERF.md section 6);
# the fused path's parameters lie within 1.5e-8 (1.5e-4 lr) of JAX's.
VALUE_RTOL, VALUE_ATOL, UPDATES_REL_L2, MAX_ABS_LR = 1e-4, 1e-4, 5e-2, 2.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: under pytest-xdist,
    torch's threads contend with the other workers' for the cores, which
    slowed these fits ~50x; alone they run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Capture:
    """The JAX side's logger: the scalar stream and the images."""

    def __init__(self):
        self.scalars, self.images = [], []

    def log_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def log_images(self, tag, images, step):
        self.images.append((tag, step, np.asarray(images)))

    def log_graph(self, *a, **k):
        pass


class CaptureLogger(Logger):
    """The port's logger, recording what it writes to its event file."""

    def __init__(self, log_dir):
        super().__init__(log_dir)
        self.scalars, self.images = [], []

    def log_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))
        super().log_scalar(tag, value, step)

    def log_images(self, tag, images, step, denorm=(0, 255)):
        self.images.append((tag, step, np.asarray(images)))
        super().log_images(tag, images, step, denorm)


def key_chain_draws(seed, noise_size):
    """JAX ``fit_fold``'s draws from its key chain: the fixed validation
    noise, and ``draws_fn(i, d, batch)`` giving the i-th superstep's."""
    key = jax.random.key(seed)
    key, vk = jax.random.split(key)
    fixed = np.asarray(jax.random.normal(vk, (N_VAL, noise_size, 1)))
    chain = {"key": key, "i": 0}

    def draws_fn(i, d, batch):
        assert i == chain["i"]
        chain["key"], sk = jax.random.split(chain["key"])
        chain["i"] += 1
        k_ny2, k_ey2, k_ndem, k_edem, k_probe, _ = jax.random.split(sk, 6)
        noise = (d, batch, noise_size, 1)
        draws = {"noises_y2": jax.random.normal(k_ny2, noise),
                 "eps_y2": jax.random.uniform(k_ey2, (d, batch, 1, 1, 1)),
                 "noises_dem": jax.random.normal(k_ndem, noise),
                 "eps_dem": jax.random.uniform(k_edem, (d, batch, 1, 1, 1)),
                 "probe_noises": jax.random.normal(k_probe, (K_NOISE,) + noise[1:])}
        return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}

    return fixed, draws_fn


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's ``fit_fold`` from a state with randomized BatchNorm statistics
    and Adam moments (the weights from the port's numpy initializers, in
    the Flax layout); the same state as numpy trees, the data, its stream,
    its checkpoint calls, final state and counters."""
    model_cfg = jax_config.ModelConfig(image_size=32, first_fm=8, compute_dtype="float32")
    train_cfg = jax_config.GanTrainConfig(**TRAIN, dispatch_chunk=1)
    trainer = jax_gan_trainer.GanTrainer(model_cfg, train_cfg, jax_config.DataConfig())
    ours = ModelConfig(image_size=32, first_fm=8)
    rng = np.random.default_rng(3)
    gen = init_generator(ours, seed=0)
    trees = {"g_params": gen["params"], "dy2_params": init_critic(ours, seed=1)["params"],
             "ddem_params": init_critic(ours, seed=2)["params"],
             "g_stats": _map(lambda a: (np.abs(rng.normal(0.3, 0.2, a.shape)) + 0.05)
                             .astype(np.float32), gen["batch_stats"])}
    jax_trees = {k: _map(jnp.asarray, v) for k, v in trees.items()}
    for name, tx in (("g", trainer.tx_g), ("dy2", trainer.tx_d), ("ddem", trainer.tx_d)):
        params = trees[f"{name}_params"]
        mu = _map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), params)
        nu = _map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32), params)
        trees[f"{name}_opt"] = {"count": 3, "mu": mu, "nu": nu}
        jax_trees[f"{name}_opt"] = _adam_state(tx, jax_trees[f"{name}_params"], 3,
                                               _map(jnp.asarray, mu), _map(jnp.asarray, nu))
    data = [rng.uniform(size=(n, 32, 32, 1)).astype(np.float32)
            for n in (N_TRAIN, N_TRAIN, N_VAL, N_VAL)]
    cap, ckpts = Capture(), []
    new_state, counters = trainer.fit_fold(
        JaxGanTrainState(**jax_trees), JaxCounters(**START), *data, logger=cap, fold=FOLD,
        seed=SEED, checkpoint_fn=lambda s, c: ckpts.append(dataclasses.asdict(c)))
    return dict(trainer=trainer, trees=trees, data=data, cap=cap, ckpts=ckpts,
                state=jax.tree.map(np.asarray, new_state), counters=dataclasses.asdict(counters),
                noise_size=model_cfg.noise_size)


def port_fit(ref, use_pallas, log_dir, **overrides):
    model_cfg = ModelConfig(image_size=32, first_fm=8, compute_dtype="float32",
                            use_pallas=use_pallas)
    train_cfg = GanTrainConfig(**{**TRAIN, **overrides})
    trainer = GanTrainer(model_cfg, train_cfg, DataConfig(), device="cpu")
    state = gan_train_state_from_trees(ref["trees"], train_cfg.lr_g, train_cfg.lr_d,
                                       train_cfg.adam_b1, train_cfg.adam_b2, device="cpu")
    fixed, draws_fn = key_chain_draws(SEED, ref["noise_size"])
    logger, ckpts = CaptureLogger(log_dir), []
    state, counters = trainer.fit_fold(
        state, Counters(**START), *ref["data"], logger=logger, fold=FOLD,
        checkpoint_fn=lambda s, c: ckpts.append(dataclasses.asdict(c)), fixed_noise=fixed,
        draws_fn=draws_fn)
    logger.close()
    return trainer, state, counters, logger, ckpts


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_fit_fold_matches_jax(jax_fit, use_pallas, tmp_path):
    ref = jax_fit
    _, state, counters, logger, ckpts = port_fit(ref, use_pallas, tmp_path)

    # The stream: the same (tag, step) pairs in the same order; the values
    # within tolerance but the host timings (perf/*).
    want = ref["cap"].scalars
    assert [(t, s) for t, _, s in logger.scalars] == [(t, s) for t, _, s in want]
    got_v = [v for t, v, _ in logger.scalars if not t.startswith("perf/")]
    want_v = [v for t, v, _ in want if not t.startswith("perf/")]
    np.testing.assert_allclose(got_v, want_v, rtol=VALUE_RTOL, atol=VALUE_ATOL)
    assert sum(t == "val_D_fake_loss" for t, _, _ in want) == 3
    assert {t for t, _, _ in want} >= {"errCrit_aaLosses", "errDC_aaLosses", "errG_losses",
                                       "perf/steps_per_sec"}
    # The images: the same tags and steps, the DEMs and fake follow-ups
    # within tolerance.
    assert [(t, s) for t, s, _ in logger.images] == [(t, s) for t, s, _ in ref["cap"].images]
    for (tag, _, got), (_, _, img) in zip(logger.images, ref["cap"].images):
        np.testing.assert_allclose(got, img, rtol=VALUE_RTOL, atol=VALUE_ATOL, err_msg=tag)

    # Checkpoint calls and counters.
    assert ckpts == ref["ckpts"] and len(ckpts) == 2
    assert dataclasses.asdict(counters) == ref["counters"] == {
        "gen_iterations": 5, "crit_iterations": 4 + N_TRAIN // BATCH,
        "crit_dem_iterations": 9 + N_TRAIN // BATCH}

    # Final parameters: each network's updates.
    cfg = GanTrainConfig()
    for name, lr in (("g", cfg.lr_g), ("dy2", cfg.lr_d), ("ddem", cfg.lr_d)):
        final = flatten_tree(getattr(ref["state"], f"{name}_params"))
        start = flatten_tree(ref["trees"][f"{name}_params"])
        got = {k: p.detach().numpy() for k, p in getattr(state, f"{name}_params").items()}
        assert got.keys() == final.keys()
        err = np.sqrt(sum(((got[k] - final[k]) ** 2).sum() for k in final))
        size = np.sqrt(sum(((final[k] - start[k]) ** 2).sum() for k in final))
        assert err <= UPDATES_REL_L2 * size, (name, err / size)
        worst = max(float(np.abs(got[k] - final[k]).max()) for k in final)
        assert worst <= MAX_ABS_LR * lr, (name, worst / lr)

    # The graph of the first superstep went to the event file, after the
    # first validation images, as one record among the scalars.
    (events,) = [tb_writer.read_events(p) for p in tmp_path.glob("events.*")]
    graphs = [e["graph"] for e in events if e["graph"] is not None]
    assert len(graphs) == 1
    nodes = tb_writer.graph_nodes(graphs[0])
    assert 1000 < len([n for n in nodes if n[1] != "Placeholder"]) <= 5000  # max_nodes
    assert {"aten.convolution.default", "aten.mm.default"} & {op for _, op, _ in nodes}
    scalars = [(v[0], e["step"]) for e in events for v in e["values"] if v[1] == "scalar"]
    assert scalars == [(t, s) for t, _, s in want]


def test_metric_packing_matches_jax():
    """Pack, unpack and log against JAX's functions on the same values:
    the port's epoch-tail rows are NaN, JAX's computed and discarded."""
    rng = np.random.default_rng(4)
    d, n_valid = 4, 3
    rows = {k: rng.normal(size=d).astype(np.float32) for k in gan_trainer.CRIT_KEYS}
    gen = {k: np.float32(rng.normal()) for k in gan_trainer.GEN_KEYS}
    ours = {k: torch.tensor(np.where(np.arange(d) < n_valid, v, np.nan)) for k, v in rows.items()}
    ours["gen"] = {k: torch.tensor(v) for k, v in gen.items()}
    theirs = {k: jnp.asarray(v) for k, v in rows.items()}
    theirs["gen"] = {k: jnp.asarray(v) for k, v in gen.items()}
    vec = gan_trainer.pack_superstep_metrics(ours)
    ref = np.asarray(jax_gan_trainer.pack_superstep_metrics(theirs))
    assert vec.dtype == torch.float32 and vec.shape == ref.shape == (4 * d + 6,)
    valid = np.concatenate([np.arange(d) < n_valid] * 4 + [np.ones(6, bool)])
    np.testing.assert_array_equal(vec.numpy()[valid], ref[valid])
    assert np.isnan(vec.numpy()[~valid]).all()

    counters = Counters(gen_iterations=7, crit_iterations=30, crit_dem_iterations=41)
    got, want = [], []
    aux = gan_trainer.log_superstep_metrics(
        lambda *a: got.append(a), gan_trainer.unpack_superstep_metrics(vec.numpy(), d),
        counters, n_valid)
    ref_aux = jax_gan_trainer.log_superstep_metrics(
        lambda *a: want.append(a), jax_gan_trainer.unpack_superstep_metrics(ref, d),
        JaxCounters(**dataclasses.asdict(counters)), n_valid)
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    assert len(got) == 6 * n_valid + 12
    np.testing.assert_array_equal([float(v) for _, v, _ in got], [float(v) for _, v, _ in want])
    assert aux == ref_aux


@pytest.mark.parametrize("use_pallas", [True, False], ids=["k8", "plain"])
def test_val_step_matches_jax(jax_fit, use_pallas):
    """``val_step`` from the JAX fit's final state against JAX's
    ``_val_step``: the three scores (the generated one on the raw DEM) and
    the DEM; with ``use_pallas`` the FiLM sites through K8's plain version."""
    ref = jax_fit
    s = ref["state"]
    trees = {"g_params": s.g_params, "g_stats": s.g_stats, "dy2_params": s.dy2_params,
             "ddem_params": s.ddem_params}
    for name in ("g", "dy2", "ddem"):
        trees[f"{name}_opt"] = {"count": 0,
                                "mu": _map(np.zeros_like, trees[f"{name}_params"]),
                                "nu": _map(np.zeros_like, trees[f"{name}_params"])}
    cfg = GanTrainConfig(**TRAIN)
    state = gan_train_state_from_trees(trees, cfg.lr_g, cfg.lr_d, cfg.adam_b1, cfg.adam_b2,
                                       device="cpu")
    trainer = GanTrainer(ModelConfig(image_size=32, first_fm=8, use_pallas=use_pallas), cfg,
                         device="cpu")
    fixed, _ = key_chain_draws(SEED, ref["noise_size"])
    xv, yv = ref["data"][2:]
    got = trainer.val_step(state, torch.tensor(xv), torch.tensor(yv), torch.tensor(fixed))
    jstate = jax.tree.map(jnp.asarray, s)
    want = ref["trainer"]._val_step(jstate, jnp.asarray(xv), jnp.asarray(yv),
                                    jnp.asarray(fixed))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert got[3].shape == (N_VAL, 32, 32, 1)


def test_buffered_flush_equals_per_step_flush(jax_fit, tmp_path):
    """The port's fit with one flush at the end and with a flush per
    superstep: the same stream, value for value, and the same parameters."""
    runs = {}
    for every in (1, 100):
        _, state, _, logger, _ = port_fit(jax_fit, False, tmp_path / str(every),
                                          metric_flush_every=every)
        runs[every] = ([(t, v, s) for t, v, s in logger.scalars if not t.startswith("perf/")],
                       {k: p.detach().clone() for k, p in state.g_params.items()})
    assert runs[1][0] == runs[100][0]
    for k, p in runs[1][1].items():
        assert torch.equal(p, runs[100][1][k]), k
