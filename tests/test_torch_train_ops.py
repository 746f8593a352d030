"""The training path's ops against the JAX package: the autograd rules of
the s2d kernels (forward and VJP against ``jax.vjp`` of the Pallas ops in
interpret mode, at tiny planes), the pools' tie splitting, the 5x5 conv's
second-order gradient, and the new kernel transforms.

On the CPU every wrapper runs its kernel's plain version, so these hold the
rules and the plain versions; ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as P
from depgan_tpu.ops import s2d_conv as JS
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import s2d_conv as S

ATOL = 2e-4
B, N = 2, 4  # interpret-mode planes stay tiny: 4x4 s2d blocks of an 8x8 image


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _plane(rng, n, c4, b=B):
    x = np.zeros((b, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(b, n, n, c4))
    return x


def _w4(rng, ci, co):
    return np.asarray(JS.conv3x3_to_s2d_kernel(rng.normal(0, 0.3, (3, 3, ci, co)))[0],
                      np.float32)


def _vjp_both(jax_fn, torch_fn, inputs, out_shape, seed=0):
    """(JAX out, JAX cotangents), (torch out, torch gradients) of the same
    function for one random cotangent over the whole output."""
    r = np.random.default_rng(seed).normal(size=out_shape).astype(np.float32)
    out, vjp = jax.vjp(jax_fn, *map(jnp.asarray, inputs))
    ref_grads = vjp(jnp.asarray(r))
    leaves = [_t(a).requires_grad_() for a in inputs]
    got = torch_fn(*leaves)
    grads = torch.autograd.grad(got, leaves, _t(r), allow_unused=True)
    return (np.asarray(out), [np.asarray(g) for g in ref_grads]), (got, grads)


def _assert_grads(ref, got, names):
    (ref_out, ref_grads), (out, grads) = ref, got
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=ATOL)
    for name, g, rg in zip(names, grads, ref_grads):
        g = np.zeros_like(rg) if g is None else g.numpy()
        np.testing.assert_allclose(g, rg, atol=ATOL, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("mode", ["relu", "film", "none"])
def test_conv3x3_vjp_matches_jax(mode):
    rng = np.random.default_rng(1)
    c4, co4 = 16, 16 if mode == "film" else 24
    inputs = [_plane(rng, N, c4), _w4(rng, c4 // 4, co4 // 4),
              rng.normal(0, 0.1, co4).astype(np.float32)]
    if mode == "film":
        inputs += [rng.normal(1, 0.3, (B, c4)).astype(np.float32),
                   rng.normal(0, 0.3, (B, c4)).astype(np.float32)]
    ref, got = _vjp_both(lambda *a: P.conv3x3_s2d_fused(*a, mode=mode),
                         lambda *a: K.conv3x3_s2d_fused(*a, mode=mode),
                         inputs, (B, N + 2, N + 2, co4))
    _assert_grads(ref, got, ["dx", "dw4", "dbias", "dgamma", "dbeta"])


def test_conv3x3_film_mask_comes_from_c0():
    """Where the FiLM branch is off (gamma * c0 + beta <= 0) no gradient
    reaches the conv, however the output compares with the trunk."""
    rng = np.random.default_rng(2)
    x, w4 = _plane(rng, N, 16), _w4(rng, 4, 4)
    bias = np.zeros(16, np.float32)
    gamma = np.ones((B, 16), np.float32)
    beta = np.full((B, 16), -1e3, np.float32)  # the branch is off everywhere
    leaves = [_t(a).requires_grad_() for a in (x, w4, bias, gamma, beta)]
    out = K.conv3x3_s2d_fused(*leaves, mode="film")
    np.testing.assert_array_equal(out.detach().numpy(), x)  # out == the trunk
    dx, dw4, dbias, dgamma, dbeta = torch.autograd.grad(out.sum(), leaves)
    assert not dw4.any() and not dbias.any() and not dgamma.any() and not dbeta.any()
    np.testing.assert_array_equal(K.unpad_s2d(dx).numpy(), 1.0)  # the residual only


def test_conv3x3_s2d_fused2_vjp_matches_jax():
    rng = np.random.default_rng(3)
    inputs = [_plane(rng, N, 32), _plane(rng, N, 16), _w4(rng, 8, 6), _w4(rng, 4, 6),
              rng.normal(0, 0.1, 24).astype(np.float32)]
    ref, got = _vjp_both(P.conv3x3_s2d_fused2, K.conv3x3_s2d_fused2, inputs,
                         (B, N + 2, N + 2, 24))
    _assert_grads(ref, got, ["dx1", "dx2", "dw1", "dw2", "dbias"])


def test_deconv_s2d_vjp_matches_jax():
    rng = np.random.default_rng(4)
    m = N // 2
    inputs = [_plane(rng, m, 32), rng.normal(0, 0.3, (8, 24)).astype(np.float32),
              rng.normal(0, 0.1, 24).astype(np.float32)]
    ref, got = _vjp_both(P.deconv_s2d_pallas, K.deconv_s2d, inputs, (B, N + 2, N + 2, 24))
    _assert_grads(ref, got, ["dx", "dw2", "dbias"])


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


def test_kernel_transforms_match_jax():
    rng = np.random.default_rng(8)
    w5 = rng.normal(size=(5, 5, 3, 2)).astype(np.float32)
    b = rng.normal(size=2).astype(np.float32)
    w9, b9 = S.conv5x5_to_s2d_kernel(_t(w5), _t(b))
    rw9, rb9 = JS.conv5x5_to_s2d_kernel_j(jnp.asarray(w5), jnp.asarray(b))
    np.testing.assert_array_equal(w9.numpy(), np.asarray(rw9))
    np.testing.assert_array_equal(b9.numpy(), np.asarray(rb9))

    dw9 = rng.normal(size=(3, 3, 12, 8)).astype(np.float32)
    _, t_vjp = jax.vjp(lambda w: JS.conv5x5_to_s2d_kernel_j(w)[0], jnp.asarray(w5))
    np.testing.assert_allclose(S.conv5x5_to_s2d_kernel_adjoint(_t(dw9)).numpy(),
                               np.asarray(t_vjp(jnp.asarray(dw9))[0]), atol=1e-5)

    w4 = _w4(rng, 3, 5)
    np.testing.assert_array_equal(S.flip_transpose_w4(_t(w4)).numpy(),
                                  np.asarray(P._flip_transpose_w4(jnp.asarray(w4))))

    g = rng.normal(size=(2, 6, 9, 4)).astype(np.float32)  # cols != rows
    ring = K.zero_ring(_t(g)).numpy()
    np.testing.assert_array_equal(ring[:, 1:5, 1:8], g[:, 1:5, 1:8])
    assert not ring[:, [0, 5]].any() and not ring[:, :, [0, 8]].any()
