"""The port's UResNet trainer against the JAX package: its config, the
Keras-clipped cross-entropy, one training step and the validation loss from
the same state, the numpy data helpers, and the epoch loop's mechanics.

The step runs at image 32, first_fm 8, batch 4, float32,
``dropout_mode='uresnet'``. The JAX side is ``UResNetTrainer._step`` with
``use_pallas=False`` (``tests/test_ops.py`` pins the Flax FiLM to K8's path);
the port runs its K8 path (the kernel's plain version on the CPU). The JAX
dropout mask is recovered from the Flax module's captured Dropout output
under the step's dropout key and handed to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from depgan_tpu import config as jax_config
from depgan_tpu.data.pipeline import EpochShuffler as JaxEpochShuffler
from depgan_tpu.data.preprocess import one_hot as jax_one_hot
from depgan_tpu.train import uresnet_trainer as jax_uresnet
from depgan_tpu.train.state import UResNetTrainState as JaxUResNetTrainState
from depgan_tpu_torch import config
from depgan_tpu_torch.config import ModelConfig, UResNetTrainConfig
from depgan_tpu_torch.data.pipeline import EpochShuffler
from depgan_tpu_torch.data.preprocess import one_hot
from depgan_tpu_torch.io.flax_bridge import flatten_tree, uresnet_train_state_from_trees
from depgan_tpu_torch.ops import conv_s2d
from depgan_tpu_torch.train.state import adam_moments
from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer, categorical_crossentropy
from test_torch_models import _map, jax_cfg, randomized_variables

CFG = ModelConfig(image_size=32, first_fm=8, n_out=4, dropout_mode="uresnet")
BATCH = 4


def test_configs_match_jax():
    """UResNetTrainConfig is a subset of the JAX one (all but the TPU
    dispatch knob), and ModelConfig carries the dropout rate."""
    ref = {f.name: f for f in dataclasses.fields(jax_config.UResNetTrainConfig)}
    ours = {f.name: f for f in dataclasses.fields(UResNetTrainConfig)}
    assert set(ref) - set(ours) == {"dispatch_chunk"}
    for name, field in ours.items():
        assert field.type == ref[name].type and field.default == ref[name].default, name
    assert config.N_CHANGE_CLASSES == jax_config.N_CHANGE_CLASSES
    assert ModelConfig().dropout_rate == jax_config.ModelConfig().dropout_rate == 0.25


def test_categorical_crossentropy_matches_jax():
    """Value and gradient, with probabilities at exactly 1.0 and at and
    below the 1e-7 clip, where jnp.clip's gradient is half."""
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(4), size=(2, 3, 3)).astype(np.float32)
    probs[0, 0, 0] = [1.0, 0.0, 0.0, 0.0]
    probs[0, 0, 1] = [np.float32(1e-7), 1.0, 1e-9, 0.0]
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(2, 3, 3))]
    labels[0, 0, 0] = [1, 0, 0, 0]
    labels[0, 0, 1] = [1, 0, 0, 0]
    ref, ref_grad = jax.value_and_grad(jax_uresnet.categorical_crossentropy)(
        jnp.asarray(probs), jnp.asarray(labels))
    p = torch.tensor(probs, requires_grad=True)
    loss = categorical_crossentropy(p, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-6, atol=0)
    assert grad[0, 0, 0, 0] != 0  # half the gradient at p = 1.0, as JAX's


def test_data_helpers_match_jax():
    ours, ref = EpochShuffler(37, 8, seed=3), JaxEpochShuffler(37, 8, seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(ours.epoch(), ref.epoch())
    labels = np.random.default_rng(1).integers(0, 4, size=(2, 5, 5, 1))
    np.testing.assert_array_equal(one_hot(labels, 4), jax_one_hot(labels, 4))


def _adam_trees(params, seed):
    rng = np.random.default_rng(seed)
    return {"count": 3,
            "mu": _map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), params),
            "nu": _map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32), params)}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step from a state with random weights and BatchNorm
    statistics and non-zero Adam moments, the dropout mask it drew, and the
    same state and data in numpy."""
    variables = randomized_variables(CFG, seed=8)
    opt = _adam_trees(variables["params"], seed=9)
    trainer = jax_uresnet.UResNetTrainer(
        dataclasses.replace(jax_cfg(CFG), use_pallas=False),
        jax_config.UResNetTrainConfig(batch_size=BATCH))
    jparams = _map(jnp.asarray, variables["params"])
    adam = trainer.tx.init(jparams)
    adam = (adam[0]._replace(count=jnp.asarray(3, jnp.int32), mu=_map(jnp.asarray, opt["mu"]),
                             nu=_map(jnp.asarray, opt["nu"])), adam[1])
    state = JaxUResNetTrainState(params=jparams,
                                 batch_stats=_map(jnp.asarray, variables["batch_stats"]),
                                 opt_state=adam)
    rng = np.random.default_rng(10)
    x_all = rng.uniform(size=(10, 32, 32, 1)).astype(np.float32)
    labels = np.digitize(x_all, [0.3, 0.6, 0.85])
    y_all = np.eye(4, dtype=np.float32)[labels[..., 0]]
    noise_all = rng.normal(size=(10, CFG.noise_size, 1)).astype(np.float32)
    idx = np.array([7, 2, 9, 4], np.int32)
    dk = jax.random.key(12)

    # The mask the step's dropout draws: the same module, key and shapes.
    _, upd = trainer.model.apply(
        {"params": jparams, "batch_stats": state.batch_stats}, jnp.asarray(x_all[idx]),
        jnp.asarray(noise_all[idx]), train=True, rngs={"dropout": dk},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    masks = {name: torch.from_numpy(np.asarray(v["__call__"][0]) != 0)
             for name, v in upd["intermediates"].items()}

    new_state, loss = trainer._step(state, jnp.asarray(x_all), jnp.asarray(y_all),
                                    jnp.asarray(noise_all), jnp.asarray(idx), dk)
    val = trainer._val_step(new_state, jnp.asarray(x_all[:6]), jnp.asarray(noise_all[:6]),
                            jnp.asarray(y_all[:6]))
    return dict(variables=variables, opt=opt, x_all=x_all, y_all=y_all, noise_all=noise_all,
                idx=idx, masks=masks, loss=float(loss), val=float(val),
                state=jax.tree.map(np.asarray, new_state))


def test_step_and_val_loss_match_jax(jax_step):
    ref = jax_step
    assert set(ref["masks"]) == {"do_gen_1"}
    cfg = dataclasses.replace(CFG, use_pallas=True)
    trainer = UResNetTrainer(cfg, UResNetTrainConfig(batch_size=BATCH), device="cpu")
    state = uresnet_train_state_from_trees(ref["variables"]["params"],
                                           ref["variables"]["batch_stats"], ref["opt"],
                                           UResNetTrainConfig().lr, device="cpu")
    x_all, y_all, noise_all = (torch.from_numpy(ref[k]) for k in ("x_all", "y_all", "noise_all"))
    conv_s2d.reset_launch_counts()
    state, loss = trainer.step(state, x_all, y_all, noise_all, ref["idx"], dropout=ref["masks"])
    assert not any(conv_s2d.launches().values())
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)

    want = ref["state"]
    count, mu, nu = adam_moments(state.opt, state.params)
    assert count == int(want.opt_state[0].count) == 4
    want_params = flatten_tree(want.params)
    want_mu, want_nu = flatten_tree(want.opt_state[0].mu), flatten_tree(want.opt_state[0].nu)
    for leaf, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[leaf], rtol=0, atol=2e-6,
                                   err_msg=leaf)
        np.testing.assert_allclose(mu[leaf].numpy(), want_mu[leaf], rtol=1e-3, atol=1e-7,
                                   err_msg=f"mu {leaf}")
        np.testing.assert_allclose(nu[leaf].numpy(), want_nu[leaf], rtol=1e-3, atol=1e-10,
                                   err_msg=f"nu {leaf}")
    want_stats = flatten_tree(want.batch_stats)
    assert state.batch_stats.keys() == want_stats.keys()
    for leaf, s in state.batch_stats.items():
        np.testing.assert_allclose(s.numpy(), want_stats[leaf], rtol=1e-5, atol=1e-6,
                                   err_msg=leaf)

    # The validation loss over 6 slices: one chunk of 4 and a remainder of 2.
    val = trainer.val_loss(state, x_all[:6], noise_all[:6], y_all[:6])
    np.testing.assert_allclose(float(val), ref["val"], rtol=1e-5)


def test_fit_mechanics():
    """fit(): epoch counting, the logger's scalars, the histories and the
    checkpoint epochs over 2 epochs, as the JAX trainer's test reads them."""
    cfg = ModelConfig(image_size=16, first_fm=4, n_out=4, dropout_mode="uresnet")
    trainer = UResNetTrainer(cfg, UResNetTrainConfig(batch_size=4), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 1)).astype(np.float32)
    labels = np.digitize(x, [0.0]).astype(np.int32)
    state = trainer.init_state(0)
    seen: dict[str, list] = {}

    class Logger:
        def log_scalar(self, tag, value, step):
            seen.setdefault(tag, []).append((value, step))

    losses, val_losses, ckpts = [], [], []
    state = trainer.fit(state, x, labels, x[:3], labels[:3], n_epochs=2, logger=Logger(),
                        loss_history=losses, val_loss_history=val_losses,
                        checkpoint_fn=lambda s, e: ckpts.append((e, s.epoch)))
    assert state.epoch == 2
    assert [s for _, s in seen["loss"]] == [s for _, s in seen["val_loss"]] == [0, 1]
    assert [v for v, _ in seen["loss"]] == losses and [v for v, _ in seen["val_loss"]] == val_losses
    assert np.isfinite(losses + val_losses).all()
    assert len(seen["perf/steps_per_sec"]) == len(seen["perf/step_seconds"]) == 2
    assert ckpts == [(0, 1), (1, 2)]  # checkpoint_every=1, after the epoch's count
    count, _, _ = adam_moments(state.opt, state.params)
    assert count == 4  # 2 epochs of 8 // 4 batches
