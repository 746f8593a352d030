"""The training path's pools and 5x5 conv against the JAX package: the
pools' VJPs and their tie splitting, the 5x5 conv's VJP and its
second-order gradient (the WGAN-GP double backward), against ``jax.vjp``
of the Pallas ops in interpret mode at tiny planes.

Split from ``test_torch_train_ops.py`` so that each file stays small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as P
from depgan_tpu_torch.ops import conv_s2d as K
from test_torch_train_ops import ATOL, B, N, _assert_grads, _plane, _t, _vjp_both


def _tied_plane(rng, n, c4):
    """A padded plane whose values come from {0, 1, 2}: most pool windows
    hold tied maxima."""
    x = np.zeros((B, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.integers(0, 3, size=(B, n, n, c4))
    return x


@pytest.mark.parametrize("to_s2d", [False, True])
def test_pool_vjp_matches_jax_with_ties(to_s2d):
    rng = np.random.default_rng(5)
    x = _tied_plane(rng, N, 16)
    out_shape = (B, N // 2 + 2, N // 2 + 2, 16) if to_s2d else (B, N, N, 4)
    ref, got = _vjp_both(P.pool_to_s2d_pallas if to_s2d else P.pool_s2d_pallas,
                         K.pool_to_s2d if to_s2d else K.pool_s2d, [x], out_shape)
    _assert_grads(ref, got, ["dx"])


def test_pool_splits_ties_evenly():
    """A window with two equal maxima gives each half of the cotangent, as
    JAX's max reduction does (torch's max_pool2d would give one all)."""
    x = np.zeros((1, 3, 3, 4), np.float32)
    x[0, 1, 1] = [2.0, 2.0, 1.0, -1.0]  # one channel, groups 0 and 1 tie
    xt = _t(x).requires_grad_()
    (dx,) = torch.autograd.grad(K.pool_s2d(xt).sum(), xt)
    np.testing.assert_array_equal(dx[0, 1, 1].numpy(), [0.5, 0.5, 0.0, 0.0])
    (ref,) = jax.grad(lambda a: jnp.sum(P.pool_s2d_pallas(a)))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref)[1, 1], [0.5, 0.5, 0.0, 0.0])


def _conv5_inputs(rng, c, co):
    return [_plane(rng, N, 4 * c), rng.normal(0, 0.2, (5, 5, c, co)).astype(np.float32),
            rng.normal(0, 0.1, co).astype(np.float32)]


@pytest.mark.parametrize("mode", ["relu", "none"])
def test_conv5x5_vjp_matches_jax(mode):
    rng = np.random.default_rng(6)
    inputs = _conv5_inputs(rng, 2, 4)
    ref, got = _vjp_both(lambda *a: P.conv5x5_s2d_fused(*a, mode=mode),
                         lambda *a: K.conv5x5_s2d_fused(*a, mode=mode),
                         inputs, (B, N + 2, N + 2, 16))
    _assert_grads(ref, got, ["dx", "dw5", "dbias"])


def test_conv5x5_second_order_matches_jax():
    """grad wrt (x, w5) of sum(dX^2), dX the input cotangent of the relu
    5x5 conv for a fixed output cotangent: the WGAN-GP double backward.
    JAX forms dX as its critic does, the op in primal position on the
    flip-transposed kernel (``fast_critic.conv5_bwd``); dX depends on x
    only through the relu mask, so its x-gradient is zero."""
    rng = np.random.default_rng(7)
    x, w5, bias = _conv5_inputs(rng, 2, 4)
    r = rng.normal(size=(B, N + 2, N + 2, 16)).astype(np.float32)
    out = P.conv5x5_s2d_fused(jnp.asarray(x), jnp.asarray(w5), jnp.asarray(bias))
    d_pre = P._zero_ring(jnp.where(out > 0, jnp.asarray(r), 0.0))

    def jax_f(w5):
        w_bwd = jnp.flip(w5, axis=(0, 1)).transpose(0, 1, 3, 2)
        dx = P.conv5x5_s2d_fused(d_pre, w_bwd, jnp.zeros(2), mode="none")
        return jnp.sum(jnp.square(dx))

    ref = np.asarray(jax.grad(jax_f)(jnp.asarray(w5)))
    xt, wt = _t(x).requires_grad_(), _t(w5).requires_grad_()
    (dx,) = torch.autograd.grad(K.conv5x5_s2d_fused(xt, wt, _t(bias)), xt, _t(r),
                                create_graph=True)
    gx, gw = torch.autograd.grad(dx.square().sum(), (xt, wt), allow_unused=True)
    assert gx is None or not gx.any()
    np.testing.assert_allclose(gw.numpy(), ref, atol=ATOL, rtol=1e-4)
    assert np.abs(ref).max() > 1e-2  # the check has something to hold
