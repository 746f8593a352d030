"""The serving forward's kernel-selecting options, ``fuse_head`` (K9) and
``fuse_chain`` (K10), against the JAX ``FastGenerator`` with the same flags
and against the port's default forward; and the refusals of the chained
and head-fused wrappers.

On the CPU the wrappers run their plain versions and launch nothing;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops.fast_gen import FastGenerator as JaxFastGenerator
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops.fast_gen import FastGenerator
from test_torch_models import CONFIGS, _map, inputs, jax_cfg, randomized_variables


def _port(cfg, variables, x, z, fuse_head=False, fuse_chain=False):
    fast = FastGenerator(cfg, variables, compute_dtype=torch.float32, device="cpu")
    assert not fast.fuse_head and not fast.fuse_chain  # off by default, as in JAX
    fast.fuse_head, fast.fuse_chain = fuse_head, fuse_chain
    return fast(torch.from_numpy(x), torch.from_numpy(z)).numpy()


def test_both_options_match_jax():
    cfg = CONFIGS["tanh"]
    variables = randomized_variables(cfg, seed=5)
    x, z = inputs(cfg)
    jax_fast = JaxFastGenerator(jax_cfg(cfg), _map(jnp.asarray, variables),
                                pallas_levels=(1, 2), compute_dtype=jnp.float32)
    jax_fast.fuse_head = jax_fast.fuse_chain = True
    ref = np.asarray(jax.jit(jax_fast.forward)(jax_fast.weights, jnp.asarray(x),
                                                jnp.asarray(z)))
    K.reset_launch_counts()
    out = _port(cfg, variables, x, z, fuse_head=True, fuse_chain=True)
    assert not any(K.launches().values())  # CPU tensors take the plain versions
    assert out.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_fuse_chain_matches_default():
    """The chain rounds each intermediate where the sequential kernels store
    it: the same forward."""
    cfg = CONFIGS["tanh"]
    variables = randomized_variables(cfg, seed=6)
    x, z = inputs(cfg)
    np.testing.assert_allclose(_port(cfg, variables, x, z, fuse_chain=True),
                               _port(cfg, variables, x, z), atol=2e-4)


def test_fuse_head_matches_default_within_bf16_rounding():
    """The fused head rounds the relu output and the head weights to
    bfloat16 (8 significant bits: 2**-9 relative each); the default head
    multiplies float32. The logits differ by up to ~1e-2 here, and tanh
    does not widen that. The softmax head keeps the default path."""
    for name, atol in (("tanh", 1e-2), ("softmax", 0.0)):
        cfg = CONFIGS[name]
        variables = randomized_variables(cfg, seed=7)
        x, z = inputs(cfg)
        out = _port(cfg, variables, x, z, fuse_head=True)
        ref = _port(cfg, variables, x, z)
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0, err_msg=name)


def _chain_args(n=8, c4=32):
    g = torch.Generator().manual_seed(0)
    x = K.pad_s2d(torch.randn(2, n, n, c4, generator=g))
    w = torch.randn(2, 2, c4, c4, generator=g) * 0.1
    v = torch.randn(c4, generator=g)
    gb = torch.randn(2, c4, generator=g)
    return x, w, v, gb


@pytest.mark.parametrize("refusal", ["modes", "film_width", "odd_s2d_pool", "requires_grad"])
def test_chain_and_head_wrappers_refuse(refusal):
    x, w, v, gb = _chain_args()
    if refusal == "modes":
        for modes in (("film", "film"), ("relu",), ("relu", "gelu")):
            with pytest.raises(ValueError, match="mode"):
                K.conv3x3_s2d_chain2(x, w, v, w, v, gb, gb, modes=modes)
    elif refusal == "film_width":
        wide = torch.cat([w, w], dim=-1)
        with pytest.raises(ValueError, match="film stage 2 requires C_out == C_mid"):
            K.conv3x3_s2d_chain2(x, w, v, wide, torch.cat([v, v]), modes=("relu", "film"))
        with pytest.raises(ValueError, match="film stage 1 requires C_mid == C_in"):
            K.conv3x3_s2d_chain2(x, wide, torch.cat([v, v]), w, v, modes=("film", "relu"))
        with pytest.raises(ValueError, match="film conv must keep channels"):
            K.conv3x3_s2d_chain3(x, w, v, wide, torch.cat([v, v]), gb, gb, w, v)
    elif refusal == "odd_s2d_pool":
        x7, w7, v7, gb7 = _chain_args(n=7)
        with pytest.raises(ValueError, match="even n"):
            K.conv3x3_s2d_chain3(x7, w7, v7, w7, v7, gb7, gb7, w7, v7, pool="s2d")
        with pytest.raises(ValueError, match="unknown pool"):
            K.conv3x3_s2d_chain3(x, w, v, w, v, gb, gb, w, v, pool="max")
    else:
        wg = w.clone().requires_grad_()
        head = torch.randn(1, 1, 32, 4)
        calls = (lambda: K.conv3x3_s2d_chain2(x, wg, v, w, v, gb, gb),
                 lambda: K.conv3x3_s2d_chain3(x, wg, v, w, v, gb, gb, w, v),
                 lambda: K.conv3x3_s2d_fused_head(x, wg, v, head, v[:4]))
        for call in calls:
            with pytest.raises(RuntimeError, match="inference-only"):
                call()
            with torch.no_grad():
                call()
