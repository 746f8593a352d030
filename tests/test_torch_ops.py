"""The port's ops against their JAX counterparts: BatchNorm folding, the s2d
layout algebra and weight transforms, and the plain versions of the four
serving kernels against the Pallas kernels in interpret mode.

The CUDA kernels themselves run only on a card; ``tests/test_torch_cuda.py``
holds them against the plain versions there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as P
from depgan_tpu.ops import fold_bn as jax_fold_bn
from depgan_tpu.ops import s2d_conv as JS
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import fold_bn, s2d_conv as S
from test_torch_models import SMALL, _map, randomized_variables

RNG_SEED = 7


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _plane(rng, b, n, c4):
    """A padded s2d plane with a zero ring."""
    x = np.zeros((b, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(b, n, n, c4))
    return x


def _assert_ring_zero(out):
    out = _np(out)
    n = out.shape[1] - 2
    ring = np.ones(out.shape[1:3], bool)
    ring[1:n + 1, 1:n + 1] = False
    assert not out[:, ring].any()


def test_fold_batch_norms_matches_jax():
    variables = randomized_variables(SMALL, seed=11)
    ref = jax_fold_bn.fold_batch_norms(_map(jnp.asarray, variables))
    out = fold_bn.fold_batch_norms(_map(_t, variables))
    flat_ref, flat_out = {}, {}

    def flatten(tree, dst, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, dst, f"{prefix}{k}/")
            else:
                dst[prefix + k] = _np(v)

    for col in ("params", "batch_stats"):
        flatten(ref[col], flat_ref, col + "/")
        flatten(out[col], flat_out, col + "/")
    assert flat_out.keys() == flat_ref.keys()
    for key in flat_ref:
        np.testing.assert_allclose(flat_out[key], flat_ref[key], atol=1e-6, err_msg=key)
    # The caller's tree is untouched.
    np.testing.assert_array_equal(
        variables["batch_stats"]["block_gen_0"]["bn_gen_0"]["mean"],
        randomized_variables(SMALL, seed=11)["batch_stats"]["block_gen_0"]["bn_gen_0"]["mean"])


def test_s2d_transforms_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    w3 = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    w4, b4 = S.conv3x3_to_s2d_kernel(_t(w3), _t(b))
    rw4, rb4 = JS.conv3x3_to_s2d_kernel(w3, b)
    np.testing.assert_allclose(_np(w4), rw4, atol=1e-6)
    np.testing.assert_allclose(_np(b4), rb4, atol=1e-6)
    w1 = rng.normal(size=(1, 1, 8, 4)).astype(np.float32)
    w14, b14 = S.conv1x1_to_s2d_kernel(_t(w1), _t(b[:4]))
    rw14, rb14 = JS.conv1x1_to_s2d_kernel(w1, b[:4])
    np.testing.assert_allclose(_np(w14), rw14, atol=1e-6)
    np.testing.assert_allclose(_np(b14), rb14, atol=1e-6)

    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(S.s2d_unshifted(_t(x))), JS.s2d_unshifted(x))
    y = rng.normal(size=(2, 4, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(_np(S.d2s(_t(y))), JS.d2s(y))
    v = rng.normal(size=(2, 5)).astype(np.float32)
    np.testing.assert_array_equal(_np(S.tile_channel_params(_t(v))), JS.tile_channel_params(v))
    np.testing.assert_array_equal(_np(K.pad_s2d(_t(y))), P.pad_s2d(y))
    np.testing.assert_array_equal(_np(K.unpad_s2d(K.pad_s2d(_t(y)))), y)
    for c_in in (1, 2):
        np.testing.assert_array_equal(_np(K.entry_pack(_t(x[..., :c_in]), c_pad=8)),
                                      P.entry_pack(jnp.asarray(x[..., :c_in]), c_pad=8))


def _conv_case(rng, b, n, c4, co4):
    x = _plane(rng, b, n, c4)
    w4 = (rng.normal(size=(2, 2, c4, co4)) / np.sqrt(4 * c4)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(co4,)).astype(np.float32)
    return x, w4, bias


@pytest.mark.parametrize("mode,c4,co4", [("relu", 32, 64), ("relu", 64, 32),
                                         ("film", 32, 32), ("film", 64, 64)])
def test_conv3x3_s2d_fused_plain_matches_pallas(mode, c4, co4):
    rng = np.random.default_rng(RNG_SEED)
    x, w4, bias = _conv_case(rng, 2, 8, c4, co4)
    gamma = beta = None
    if mode == "film":
        gamma = rng.normal(1, 0.3, size=(2, c4)).astype(np.float32)
        beta = rng.normal(0, 0.3, size=(2, c4)).astype(np.float32)
    ref = P.conv3x3_s2d_fused(jnp.asarray(x), jnp.asarray(w4), jnp.asarray(bias),
                              None if gamma is None else jnp.asarray(gamma),
                              None if beta is None else jnp.asarray(beta), mode=mode)
    out = K.conv3x3_s2d_fused(_t(x), _t(w4), _t(bias),
                              None if gamma is None else _t(gamma),
                              None if beta is None else _t(beta), mode=mode)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    _assert_ring_zero(out)


@pytest.mark.parametrize("pool", ["s2d", "pixel"])
def test_conv3x3_s2d_fused_pool_plain_matches_pallas(pool):
    rng = np.random.default_rng(RNG_SEED)
    x, w4, bias = _conv_case(rng, 2, 8, 32, 64)
    ref, ref_pool = P.conv3x3_s2d_fused_pool(jnp.asarray(x), jnp.asarray(w4),
                                             jnp.asarray(bias), pool=pool)
    out, pooled = K.conv3x3_s2d_fused_pool(_t(x), _t(w4), _t(bias), pool=pool)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(_np(pooled), np.asarray(ref_pool), atol=1e-5)
    _assert_ring_zero(out)
    if pool == "s2d":
        assert pooled.shape == (2, 6, 6, 64)
        _assert_ring_zero(pooled)
    else:
        assert pooled.shape == (2, 8, 8, 16)


def test_conv3x3_s2d_fused2_plain_matches_pallas():
    rng = np.random.default_rng(RNG_SEED)
    x1, w1, bias = _conv_case(rng, 2, 8, 64, 32)
    x2, w2, _ = _conv_case(rng, 2, 8, 32, 32)
    ref = P.conv3x3_s2d_fused2(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w1),
                               jnp.asarray(w2), jnp.asarray(bias))
    out = K.conv3x3_s2d_fused2(_t(x1), _t(x2), _t(w1), _t(w2), _t(bias))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    _assert_ring_zero(out)


def test_deconv_s2d_plain_matches_pallas():
    rng = np.random.default_rng(RNG_SEED)
    x = _plane(rng, 2, 4, 64)
    w2 = (rng.normal(size=(16, 32)) / 4).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(32,)).astype(np.float32)
    ref = P.deconv_s2d_pallas(jnp.asarray(x), jnp.asarray(w2), jnp.asarray(bias))
    out = K.deconv_s2d(_t(x), _t(w2), _t(bias))
    assert out.shape == (2, 10, 10, 32)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    _assert_ring_zero(out)
