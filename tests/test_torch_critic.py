"""The port's critic against the JAX package: DisC2DFCN1 against the Flax
module, its numpy initializer against ``init_critic``, and FusedCritic's
score, hand-chained input gradient and WGAN-GP double backward against
``jax.grad`` of the Flax critic (image 32, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.models.critic import DisC2DFCN1 as FlaxCritic
from depgan_tpu.models.critic import init_critic as flax_init_critic
from depgan_tpu_torch.io.flax_bridge import flatten_tree, load_flax_variables
from depgan_tpu_torch.models import DisC2DFCN1, init_critic
from depgan_tpu_torch.ops.fast_critic import FusedCritic
from test_torch_models import SMALL, _map, _shapes, jax_cfg

ATOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    """Critic parameters from numpy (non-zero biases, so every term of the
    gradient is exercised) and a batch of two 32x32 images."""
    rng = np.random.default_rng(0)
    tree = init_critic(SMALL, seed=0)
    tree = {"params": _map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32),
                           tree["params"])}
    x = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    return tree, x


def _gp(grad, xp):
    norm = xp.sqrt(xp.sum(xp.square(grad), axis=(1, 2, 3)))
    return xp.mean(xp.square(norm - 1.0))


def _torch_params(tree):
    return {k: torch.tensor(v, requires_grad=True) for k, v in flatten_tree(tree["params"]).items()}


def test_init_critic_tree_matches_flax():
    ref = jax.eval_shape(lambda key: flax_init_critic(jax_cfg(SMALL), key)[1], jax.random.key(0))
    assert _shapes(init_critic(SMALL, seed=0)) == _shapes(ref)


def test_critic_matches_flax(setup):
    tree, x = setup
    ref = FlaxCritic().apply(_map(jnp.asarray, tree), jnp.asarray(x))
    module = load_flax_variables(DisC2DFCN1(SMALL, device="cpu"), tree)
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    assert out.shape == (2, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_fused_critic_score_and_input_grad_match_flax(setup):
    tree, x = setup
    jparams = _map(jnp.asarray, tree)["params"]

    def score(x):
        return FlaxCritic().apply({"params": jparams}, x)

    ref_grad = jax.grad(lambda x: jnp.sum(score(x)))(jnp.asarray(x))
    fc = FusedCritic(SMALL, compute_dtype=torch.float32)
    params = _torch_params(tree)
    np.testing.assert_allclose(fc.forward(params, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(score(jnp.asarray(x))), atol=ATOL)
    s, grad = fc.score_and_input_grad(params, torch.from_numpy(x))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(score(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(grad.detach().numpy(), np.asarray(ref_grad), atol=ATOL)


def test_fused_critic_param_grads_match_flax(setup):
    """First-order parameter gradient of the score, through the kernels'
    rules."""
    tree, x = setup
    ref = jax.grad(lambda p: jnp.sum(FlaxCritic().apply({"params": p}, jnp.asarray(x))))(
        _map(jnp.asarray, tree)["params"])
    params = _torch_params(tree)
    FusedCritic(SMALL, compute_dtype=torch.float32).forward(params, torch.from_numpy(x)).sum() \
        .backward()
    for name, value in flatten_tree(_map(np.asarray, ref)).items():
        np.testing.assert_allclose(params[name].grad.numpy(), value, atol=ATOL, rtol=1e-4,
                                   err_msg=name)


def test_gradient_penalty_param_grads_match_flax(setup):
    """The WGAN-GP term's gradient wrt the critic's parameters: JAX's
    grad-of-grad of the Flax critic against the port's hand-chained input
    gradient differentiated once."""
    tree, x = setup

    def gp_flax(p):
        g = jax.grad(lambda m: jnp.sum(FlaxCritic().apply({"params": p}, m)))(jnp.asarray(x))
        return _gp(g, jnp)

    jparams = _map(jnp.asarray, tree)["params"]
    ref_value, ref = jax.value_and_grad(gp_flax)(jparams)
    params = _torch_params(tree)
    _, grad = FusedCritic(SMALL, compute_dtype=torch.float32).score_and_input_grad(
        params, torch.from_numpy(x))
    gp = _gp(grad, torch)
    gp.backward()
    np.testing.assert_allclose(float(gp.detach()), float(ref_value), rtol=1e-5)
    for name, value in flatten_tree(_map(np.asarray, ref)).items():
        # Biases reach the input gradient only through masks: zero on both
        # sides, absent on the port's.
        got = params[name].grad
        got = np.zeros_like(value) if got is None else got.numpy()
        np.testing.assert_allclose(got, value, atol=ATOL, rtol=1e-4, err_msg=name)
