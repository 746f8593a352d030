"""One GAN superstep with ``bn_mode='batch'`` against the JAX superstep.

Image 32, first_fm 8, batch 4, float32, D = 2, k = 2, ``dropout_mode='gan'``.
The critic loops and the probe see the generator in inference mode; the
generator's step runs it in training mode (batch statistics, dropout at
every site) and keeps the new statistics. The JAX side runs the plain Flax
graphs (its batch mode never takes the fused path); the port runs its K8
path (the kernel's plain version on the CPU) and its plain path. The draws
are the JAX key splits', and the generator step's dropout masks are
recovered from the Flax module's captured Dropout outputs under JAX's
``k_drop`` (``gan_trainer.py:316``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from depgan_tpu import config as jax_config
from depgan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer
from depgan_tpu.train.state import GanTrainState as JaxGanTrainState
from depgan_tpu_torch.config import DataConfig, GanTrainConfig, ModelConfig
from depgan_tpu_torch.io.flax_bridge import flatten_tree, gan_train_state_from_trees
from depgan_tpu_torch.models import init_critic
from depgan_tpu_torch.ops import conv_s2d
from depgan_tpu_torch.train.gan_trainer import GEN_KEYS, GanTrainer
from depgan_tpu_torch.train.state import adam_moments
from test_torch_gan_trainer import _adam_state
from test_torch_models import _map, randomized_variables

D, BATCH, K_NOISE = 2, 4, 2


@pytest.fixture(scope="module")
def jax_superstep():
    """One batch-BN superstep of the JAX trainer from a state with random
    BatchNorm statistics and non-zero Adam moments; the same state, draws
    and dropout masks in numpy and torch."""
    model_cfg = jax_config.ModelConfig(image_size=32, first_fm=8, compute_dtype="float32")
    train_cfg = jax_config.GanTrainConfig(batch_size=BATCH, d_iters=D, warmup_d_iters=D,
                                          k_noise=K_NOISE, bn_mode="batch")
    trainer = JaxGanTrainer(model_cfg, train_cfg, jax_config.DataConfig())
    # Random generator weights and statistics (test_torch_models), critics
    # from the port's numpy initializer, Adam moments at random. At the
    # initializer's generator (zero biases) and batch 2, float32 itself is
    # 1e-2 to 1e-1 (relative L2) off float64 in some kernels' gradients on
    # either side: BatchNorm in training mode over 2 samples normalizes
    # each feature to about +-1, so the gradient of the dense before it is
    # a difference of near-equal terms.
    cfg = ModelConfig(image_size=32, first_fm=8)
    rng = np.random.default_rng(4)
    g = randomized_variables(cfg, seed=1)
    trees = {"g_params": g["params"], "g_stats": g["batch_stats"],
             "dy2_params": init_critic(cfg, seed=2)["params"],
             "ddem_params": init_critic(cfg, seed=3)["params"]}
    parts = {"g_stats": _map(jnp.asarray, trees["g_stats"])}
    for name, tx in (("g", trainer.tx_g), ("dy2", trainer.tx_d), ("ddem", trainer.tx_d)):
        params = trees[f"{name}_params"]
        mu = _map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), params)
        nu = _map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32), params)
        trees[f"{name}_opt"] = {"count": 3, "mu": mu, "nu": nu}
        parts[f"{name}_params"] = _map(jnp.asarray, params)
        parts[f"{name}_opt"] = _adam_state(tx, parts[f"{name}_params"], 3,
                                           _map(jnp.asarray, mu), _map(jnp.asarray, nu))
    state = JaxGanTrainState(**parts)

    x_all = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    y_all = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    idx = np.array([[3, 5, 1, 6], [0, 7, 2, 4]], np.int32)
    key = jax.random.key(13)
    k_ny2, k_ey2, k_ndem, k_edem, k_probe, k_drop = jax.random.split(key, 6)
    noise = (D, BATCH, model_cfg.noise_size, 1)
    draws = {"noises_y2": jax.random.normal(k_ny2, noise),
             "eps_y2": jax.random.uniform(k_ey2, (D, BATCH, 1, 1, 1)),
             "noises_dem": jax.random.normal(k_ndem, noise),
             "eps_dem": jax.random.uniform(k_edem, (D, BATCH, 1, 1, 1)),
             "probe_noises": jax.random.normal(k_probe, (K_NOISE,) + noise[1:])}
    variables = {"params": _map(jnp.asarray, trees["g_params"]),
                 "batch_stats": _map(jnp.asarray, trees["g_stats"])}  # the step donates state
    new_state, metrics = trainer.superstep(state, jnp.asarray(x_all), jnp.asarray(y_all), idx,
                                           D, key)
    metrics = jax.tree.map(np.asarray, metrics)

    # The generator step's masks, from its own inputs (the last batch, the
    # best probe noise, the generator before the step, which the critic
    # loops leave as it is), so that its ReLU zeros fall where the step's do.
    @jax.jit
    def dropout_outputs(variables, x, z):
        return trainer.gen.apply(
            variables, x, z, train=True, rngs={"dropout": k_drop},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))[1]["intermediates"]

    outputs = dropout_outputs(variables, jnp.asarray(x_all[idx[-1]]),
                              draws["probe_noises"][metrics["best_noise_idx"]])
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    draws["dropout"] = {name: torch.from_numpy(np.asarray(v["__call__"][0]) != 0)
                        for name, v in outputs.items()}
    return dict(trees=trees, x_all=x_all, y_all=y_all, idx=idx, draws=draws,
                state=jax.tree.map(np.asarray, new_state), metrics=metrics)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["k8", "plain"])
def test_batch_bn_superstep_matches_jax(jax_superstep, use_pallas):
    ref = jax_superstep
    assert len(ref["draws"]["dropout"]) == 14  # 'gan': both layers of every site
    model_cfg = ModelConfig(image_size=32, first_fm=8, compute_dtype="float32",
                            use_pallas=use_pallas)
    train_cfg = GanTrainConfig(batch_size=BATCH, d_iters=D, warmup_d_iters=D, k_noise=K_NOISE,
                               bn_mode="batch")
    trainer = GanTrainer(model_cfg, train_cfg, DataConfig(), device="cpu")
    assert not trainer.use_fused
    state = gan_train_state_from_trees(ref["trees"], train_cfg.lr_g, train_cfg.lr_d,
                                       train_cfg.adam_b1, train_cfg.adam_b2, device="cpu")
    conv_s2d.reset_launch_counts()
    state, metrics = trainer.superstep(state, torch.from_numpy(ref["x_all"]),
                                       torch.from_numpy(ref["y_all"]), ref["idx"], D,
                                       draws=ref["draws"])
    assert not any(conv_s2d.launches().values())

    want = ref["metrics"]
    for key in ("crit_y2_real", "crit_y2_fake", "crit_dem_real", "crit_dem_fake"):
        np.testing.assert_allclose(metrics[key].numpy(), want[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    for key in GEN_KEYS:
        np.testing.assert_allclose(float(metrics["gen"][key]), float(want["gen"][key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert int(metrics["best_noise_idx"]) == int(want["best_noise_idx"])

    for name in ("g", "dy2", "ddem"):
        params = getattr(state, f"{name}_params")
        want_params = flatten_tree(getattr(ref["state"], f"{name}_params"))
        count, mu, nu = adam_moments(getattr(state, f"{name}_opt"), params)
        want_opt = getattr(ref["state"], f"{name}_opt")[0]
        assert count == int(want_opt.count)
        want_mu, want_nu = flatten_tree(want_opt.mu), flatten_tree(want_opt.nu)
        for leaf, p in params.items():
            # Each parameter within 0.05 lr (1e-4) of JAX's: Adam's step
            # divides by sqrt(nu), so it carries the gradient's error below.
            np.testing.assert_allclose(p.detach().numpy(), want_params[leaf], rtol=0, atol=5e-6,
                                       err_msg=f"{name} {leaf}")
            if name != "g":  # the critics: as in the frozen superstep's test
                np.testing.assert_allclose(mu[leaf].numpy(), want_mu[leaf], rtol=1e-3,
                                           atol=1e-7, err_msg=f"{name} mu {leaf}")
                np.testing.assert_allclose(nu[leaf].numpy(), want_nu[leaf], rtol=1e-3,
                                           atol=1e-10, err_msg=f"{name} nu {leaf}")
                continue
            owner = leaf.split(".")[-2]
            if leaf.endswith(".bias") and owner.startswith(
                    ("conv2d_", "deconv2d_", "dense_")) and not owner.startswith("dense_bn_"):
                # These biases feed a BatchNorm in training mode, which
                # subtracts the batch mean: the exact gradient is zero, and
                # both sides hold rounding noise (up to ~4e-6).
                np.testing.assert_allclose(mu[leaf].numpy(), 0.0, atol=1e-5)
                np.testing.assert_allclose(want_mu[leaf], 0.0, atol=1e-5)
                continue
            # The gradient (mu, with b1 = 0) and nu as vectors, within 5e-3
            # relative L2. Both sides are float32 (float64 agrees to ~1e-5):
            # through the training BatchNorms a gradient element is a
            # difference of sums over B*H*W values, ~1e-6 off beside
            # elements of ~1e-2; the largest leaf reads 1.0e-3.
            for got, ref_leaf, what in ((mu[leaf], want_mu[leaf], "mu"),
                                        (nu[leaf], want_nu[leaf], "nu")):
                err = np.linalg.norm(got.numpy() - ref_leaf) / np.linalg.norm(ref_leaf)
                assert err < 5e-3, f"{name} {what} {leaf}: relative L2 {err:.2e}"
    want_stats = flatten_tree(ref["state"].g_stats)
    assert state.g_stats.keys() == want_stats.keys()
    for leaf, s in state.g_stats.items():
        np.testing.assert_allclose(s.numpy(), want_stats[leaf], rtol=1e-5, atol=1e-6,
                                   err_msg=leaf)
        # The step's batch statistics moved every running statistic.
        assert not np.array_equal(s.numpy(), flatten_tree(ref["trees"]["g_stats"])[leaf])
