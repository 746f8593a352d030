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
