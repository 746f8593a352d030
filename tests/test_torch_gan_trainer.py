"""The port's GAN training against the JAX package: the training configs,
the WGAN-GP losses, one Adam step against optax, and one whole superstep
from the same state with the same random draws.

The superstep runs at image 32, first_fm 8, batch 2, float32, D = 2 with
one epoch-tail row and k = 2. The JAX side is ``GanTrainer.superstep`` with
``use_pallas=False`` (the plain Flax graphs, which ``tests/test_fused_grad.py``
pins to the fused path); the port runs both its fused path (the kernels'
plain versions on the CPU, with their autograd rules) and its plain path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depgan_tpu import config as jax_config
from depgan_tpu.train import wgan_gp as jax_wgan_gp
from depgan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer
from depgan_tpu.train.state import Counters as JaxCounters
from depgan_tpu_torch import config
from depgan_tpu_torch.config import DataConfig, GanTrainConfig, ModelConfig
from depgan_tpu_torch.io.flax_bridge import flatten_tree, gan_train_state_from_trees
from depgan_tpu_torch.train import wgan_gp
from depgan_tpu_torch.train.gan_trainer import GEN_KEYS, GanTrainer
from depgan_tpu_torch.train.state import Counters, adam_moments, make_adam
from test_torch_models import _map

D, BATCH, K_NOISE, N_VALID = 2, 2, 2, 1


@pytest.mark.parametrize("name", ["DataConfig", "GanTrainConfig", "EvalConfig"])
def test_train_configs_match_jax(name):
    """The port's configs are subsets of the JAX package's: same names,
    types and defaults, and the same WMH thresholds; DataConfig and
    EvalConfig are the JAX ones in full, GanTrainConfig JAX's with only
    ``dispatch_chunk`` left out, in JAX's order."""
    ref, ours = getattr(jax_config, name), getattr(config, name)
    ref_fields = {f.name: f for f in dataclasses.fields(ref)}
    for field in dataclasses.fields(ours):
        assert field.name in ref_fields, field.name
        assert field.type == ref_fields[field.name].type, field.name
        assert field.default == ref_fields[field.name].default, field.name
    if name == "GanTrainConfig":
        assert [f.name for f in dataclasses.fields(ours)] == [
            n for n in ref_fields if n != "dispatch_chunk"]
    else:
        assert [f.name for f in dataclasses.fields(ours)] == list(ref_fields)
        for pm in (True, False):
            assert (ours(use_probability_map=pm).wmh_threshold
                    == ref(use_probability_map=pm).wmh_threshold)


def test_warmup_schedule_and_counters_match_jax():
    """``_d_iters_for_gi`` gives the JAX trainer's critic steps for every
    generator iteration, and ``Counters`` has the JAX fields."""
    model_cfg = ModelConfig(image_size=32, first_fm=8)
    train_cfg = GanTrainConfig(d_iters=3, warmup_d_iters=7, warmup_until=4, warmup_every=10)
    ours = GanTrainer(model_cfg, train_cfg, device="cpu")
    ref = JaxGanTrainer(jax_config.ModelConfig(image_size=32, first_fm=8),
                        jax_config.GanTrainConfig(**dataclasses.asdict(train_cfg)))
    assert [ours._d_iters_for_gi(gi) for gi in range(25)] == [
        ref._d_iters_for_gi(gi) for gi in range(25)]
    assert dataclasses.asdict(Counters()) == dataclasses.asdict(JaxCounters())


def _toy_critic(xp, v):
    """A nonlinear stand-in critic, the same function in both frameworks:
    (B, H, W, 1) -> (B, 1)."""
    return xp.sum(xp.tanh(v) ** 2 + v, axis=(1, 2, 3))[:, None]


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_wgan_gp_losses_match_jax(mode):
    rng = np.random.default_rng(1)
    cfg = GanTrainConfig(threshold_mode=mode)
    jcfg = jax_config.GanTrainConfig(threshold_mode=mode)
    thr = DataConfig().wmh_threshold
    y1, y2 = (rng.uniform(size=(2, 8, 8, 1)).astype(np.float32) for _ in range(2))
    dem = rng.uniform(-0.6, 0.6, size=(2, 8, 8, 1)).astype(np.float32)
    eps = rng.uniform(size=(2, 1, 1, 1)).astype(np.float32)
    wc = rng.normal(size=(1, 8, 8, 1)).astype(np.float32)

    def jcritic(img, w=jnp.asarray(wc)):
        return _toy_critic(jnp, img * w)

    def tcritic(img, w=torch.from_numpy(wc)):
        return _toy_critic(torch, img * w)

    def jgen(d):
        return jax_wgan_gp.generator_loss(jcfg, thr, d, jnp.asarray(y1), jnp.asarray(y2),
                                          jcritic, jcritic)

    (ref, ref_aux), ref_grad = jax.value_and_grad(jgen, has_aux=True)(jnp.asarray(dem))
    d = torch.from_numpy(dem).requires_grad_()
    loss, aux = wgan_gp.generator_loss(cfg, thr, d, torch.from_numpy(y1), torch.from_numpy(y2),
                                       tcritic, tcritic)
    (grad,) = torch.autograd.grad(loss, d)
    for key in GEN_KEYS:
        np.testing.assert_allclose(float(aux[key].detach()), float(ref_aux[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-7)

    # The critic loss with its gradient penalty, and its gradient wrt the
    # critic's parameter through the double backward.
    def jcrit_loss(w):
        return jax_wgan_gp.critic_step_loss(lambda m: jcritic(m, w), jnp.asarray(y2),
                                            jnp.asarray(y1 + dem), jnp.asarray(eps), 10.0)

    (ref_l, (ref_real, ref_fake)), ref_gw = jax.value_and_grad(jcrit_loss, has_aux=True)(
        jnp.asarray(wc))
    w = torch.from_numpy(wc).requires_grad_()
    loss, (real, fake) = wgan_gp.critic_step_loss(
        lambda m: tcritic(m, w), torch.from_numpy(y2), torch.from_numpy(y1 + dem),
        torch.from_numpy(eps), 10.0)
    (gw,) = torch.autograd.grad(loss, w)
    for got, want in ((loss, ref_l), (real, ref_real), (fake, ref_fake)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ref_gw), rtol=1e-4, atol=1e-6)


def _adam_state(tx, params, count, mu, nu):
    state = tx.init(params)
    return (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu), state[1])


def test_adam_step_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=5)}
    grads, mu = ({k: rng.normal(size=v.shape) for k, v in params.items()} for _ in range(2))
    nu = {k: rng.uniform(0.1, 1.0, v.shape) for k, v in params.items()}
    grads["b"][:2] = 0.0  # zero gradients take the pure-moment update
    params, grads, mu, nu = (_map(lambda a: a.astype(np.float32), t)
                             for t in (params, grads, mu, nu))
    tx = optax.adam(1e-4, b1=0.0, b2=0.9)
    jp = _map(jnp.asarray, params)
    ups, new_state = tx.update(_map(jnp.asarray, grads), _adam_state(
        tx, jp, 3, _map(jnp.asarray, mu), _map(jnp.asarray, nu)), jp)
    ref = optax.apply_updates(jp, ups)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_adam(tp, 1e-4, 0.0, 0.9, 3, _map(torch.from_numpy, mu), _map(torch.from_numpy, nu))
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    count, new_mu, new_nu = adam_moments(opt, tp)
    assert count == int(new_state[0].count) == 4
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(ref[k]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(new_mu[k].numpy(), np.asarray(new_state[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(new_nu[k].numpy(), np.asarray(new_state[0].nu[k]), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_superstep():
    """One superstep of the JAX trainer from a state with randomized
    BatchNorm statistics and non-zero Adam moments, and the same state and
    draws in numpy."""
    model_cfg = jax_config.ModelConfig(image_size=32, first_fm=8, compute_dtype="float32")
    train_cfg = jax_config.GanTrainConfig(batch_size=BATCH, d_iters=D, warmup_d_iters=D,
                                          k_noise=K_NOISE)
    trainer = JaxGanTrainer(model_cfg, train_cfg, jax_config.DataConfig())
    state = trainer.init_state(jax.random.key(0))
    rng = np.random.default_rng(3)
    stats = _map(lambda a: (np.abs(rng.normal(0.3, 0.2, a.shape)) + 0.05).astype(np.float32),
                 _map(np.asarray, state.g_stats))
    trees = {"g_stats": stats}
    replace = {"g_stats": _map(jnp.asarray, stats)}
    for name, tx in (("g", trainer.tx_g), ("dy2", trainer.tx_d), ("ddem", trainer.tx_d)):
        params = _map(np.asarray, getattr(state, f"{name}_params"))
        mu = _map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), params)
        nu = _map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32), params)
        trees[f"{name}_params"] = params
        trees[f"{name}_opt"] = {"count": 3, "mu": mu, "nu": nu}
        replace[f"{name}_opt"] = _adam_state(tx, getattr(state, f"{name}_params"), 3,
                                             _map(jnp.asarray, mu), _map(jnp.asarray, nu))
    state = state.replace(**replace)

    x_all = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    y_all = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    idx = np.array([[3, 5], [0, 7]], np.int32)
    key = jax.random.key(11)
    new_state, metrics = trainer.superstep(state, jnp.asarray(x_all), jnp.asarray(y_all), idx,
                                           N_VALID, key)
    # The draws, with the key splits of gan_trainer.py:316-321, 470-475.
    k_ny2, k_ey2, k_ndem, k_edem, k_probe, _ = jax.random.split(key, 6)
    noise = (D, BATCH, model_cfg.noise_size, 1)
    draws = {"noises_y2": jax.random.normal(k_ny2, noise),
             "eps_y2": jax.random.uniform(k_ey2, (D, BATCH, 1, 1, 1)),
             "noises_dem": jax.random.normal(k_ndem, noise),
             "eps_dem": jax.random.uniform(k_edem, (D, BATCH, 1, 1, 1)),
             "probe_noises": jax.random.normal(k_probe, (K_NOISE,) + noise[1:])}
    return dict(trees=trees, x_all=x_all, y_all=y_all, idx=idx,
                draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()},
                state=jax.tree.map(np.asarray, new_state), metrics=jax.tree.map(np.asarray, metrics))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_superstep_matches_jax(jax_superstep, use_pallas):
    ref = jax_superstep
    model_cfg = ModelConfig(image_size=32, first_fm=8, compute_dtype="float32",
                            use_pallas=use_pallas)
    train_cfg = GanTrainConfig(batch_size=BATCH, d_iters=D, warmup_d_iters=D, k_noise=K_NOISE)
    trainer = GanTrainer(model_cfg, train_cfg, DataConfig(), device="cpu")
    state = gan_train_state_from_trees(ref["trees"], train_cfg.lr_g, train_cfg.lr_d,
                                       train_cfg.adam_b1, train_cfg.adam_b2, device="cpu")
    state, metrics = trainer.superstep(state, torch.from_numpy(ref["x_all"]),
                                       torch.from_numpy(ref["y_all"]), ref["idx"], N_VALID,
                                       draws=ref["draws"])

    want = ref["metrics"]
    for key in ("crit_y2_real", "crit_y2_fake", "crit_dem_real", "crit_dem_fake"):
        got = metrics[key].numpy()
        np.testing.assert_allclose(got[:N_VALID], want[key][:N_VALID], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
        assert np.isnan(got[N_VALID:]).all()  # epoch-tail rows are skipped
    for key in GEN_KEYS:
        np.testing.assert_allclose(float(metrics["gen"][key]), float(want["gen"][key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert int(metrics["best_noise_idx"]) == int(want["best_noise_idx"])

    # Parameters and Adam moments after the step: f32 on both sides, so the
    # updates agree to rounding (the moments make Adam's step smooth in the
    # gradient; a zero moment would turn a rounding-level gradient into +-lr).
    for name in ("g", "dy2", "ddem"):
        params = getattr(state, f"{name}_params")
        want_params = flatten_tree(getattr(ref["state"], f"{name}_params"))
        count, mu, nu = adam_moments(getattr(state, f"{name}_opt"), params)
        want_opt = getattr(ref["state"], f"{name}_opt")[0]
        assert count == int(want_opt.count) == 4
        want_mu, want_nu = flatten_tree(want_opt.mu), flatten_tree(want_opt.nu)
        for leaf, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_params[leaf], rtol=0, atol=2e-6,
                                       err_msg=f"{name} {leaf}")
            np.testing.assert_allclose(mu[leaf].numpy(), want_mu[leaf], rtol=1e-3, atol=1e-7,
                                       err_msg=f"{name} mu {leaf}")
            np.testing.assert_allclose(nu[leaf].numpy(), want_nu[leaf], rtol=1e-3, atol=1e-10,
                                       err_msg=f"{name} nu {leaf}")
