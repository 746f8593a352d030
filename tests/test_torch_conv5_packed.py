"""The packed 5x5 conv (K11, ``CONV5_PACKED``) against the JAX package.

With the flag on, JAX's ``_conv5_impl`` runs ``_kernel5_packed`` for 4C <=
64 and ``_kernel5`` above (interpret mode here); the port's ``_conv5_impl``
takes the same gate to pick its CUDA kernel and, on the CPU, runs the
plain version either way. JAX reads the flag while it traces, so the JAX
calls here are not jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as csp
from depgan_tpu.ops.fast_critic import FusedCritic as JaxFusedCritic
from depgan_tpu_torch.io.flax_bridge import flatten_tree
from depgan_tpu_torch.models import init_critic
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops.fast_critic import FusedCritic
from test_torch_models import SMALL, _map

ATOL = 2e-4


@pytest.fixture
def packed(monkeypatch):
    """CONV5_PACKED on in both packages for the test."""
    monkeypatch.setattr(csp, "CONV5_PACKED", True)
    monkeypatch.setattr(K, "CONV5_PACKED", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("c4,co4,mode", [(16, 64, "relu"), (64, 16, "none"), (128, 64, "relu")])
def test_conv5_packed_matches_jax(packed, monkeypatch, c4, co4, mode):
    """The port's conv5x5_s2d_fused with the flag on against JAX's with it
    on, and the gate: JAX stages the packed taps exactly when 4C <= 64, and
    the port names the same kernel."""
    rng = np.random.default_rng(c4)
    n = 8
    x = np.zeros((2, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(2, n, n, c4))
    w5 = (rng.normal(size=(5, 5, c4 // 4, co4 // 4)) / np.sqrt(25 * c4 / 4)).astype(np.float32)
    bias = rng.normal(0, 0.1, co4 // 4).astype(np.float32)
    traced = []
    real = csp._kernel5_packed
    monkeypatch.setattr(csp, "_kernel5_packed", lambda *a, **k: traced.append(1) or real(*a, **k))
    ref = csp.conv5x5_s2d_fused(jnp.asarray(x), jnp.asarray(w5), jnp.asarray(bias), mode, strip=8)
    out = K.conv5x5_s2d_fused(torch.from_numpy(x), torch.from_numpy(w5), torch.from_numpy(bias),
                              mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert bool(traced) == (c4 <= 64)
    assert K.conv5_kernel_name(c4) == ("conv5x5_s2d_fused[packed]" if c4 <= 64
                                       else "conv5x5_s2d_fused")


def test_conv5_kernel_name_follows_the_flag():
    assert not K.CONV5_PACKED  # off by default, as in JAX
    assert K.conv5_kernel_name(16) == K.conv5_kernel_name(64) == "conv5x5_s2d_fused"


def test_fused_critic_packed_matches_jax(packed):
    """FusedCritic's score and hand-chained input gradient with the flag on
    against JAX's FusedCritic with it on (float32, image 32)."""
    rng = np.random.default_rng(3)
    tree = init_critic(SMALL, seed=3)
    tree = {"params": _map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32),
                           tree["params"])}
    x = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    ref_score, ref_grad = JaxFusedCritic(SMALL, strip=8, compute_dtype=jnp.float32) \
        .score_and_input_grad(_map(jnp.asarray, tree)["params"], jnp.asarray(x))
    params = {k: torch.tensor(v) for k, v in flatten_tree(tree["params"]).items()}
    score, grad = FusedCritic(SMALL, compute_dtype=torch.float32).score_and_input_grad(
        params, torch.from_numpy(x))
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(ref_score), atol=ATOL)
    np.testing.assert_allclose(grad.detach().numpy(), np.asarray(ref_grad), atol=ATOL)
