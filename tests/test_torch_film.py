"""The port's training-mode modules against the JAX package: K8
(``film_residual``, forward and VJP) against the Pallas kernel in interpret
mode, training BatchNorm against Flax ``nn.BatchNorm``, dropout against
Flax ``nn.Dropout``, the FiLM site with and without K8, and the generator's
training forward with its dropout placement and new batch statistics.

Inputs come from numpy and go to both frameworks; on the CPU the K8 wrapper
runs its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from depgan_tpu.models import GenUNet2D as FlaxGenUNet2D
from depgan_tpu.ops import film_pallas
from depgan_tpu_torch.config import ModelConfig
from depgan_tpu_torch.io.flax_bridge import flatten_tree, load_flax_variables
from depgan_tpu_torch.models import FilmSite, GenUNet2D
from depgan_tpu_torch.models.blocks import Dropout
from depgan_tpu_torch.models.generator import dropout_masks, dropout_shapes
from depgan_tpu_torch.ops import conv_s2d
from depgan_tpu_torch.ops.film import film_residual, film_residual_plain
from test_torch_models import _map, inputs, jax_cfg, randomized_variables


def _film_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.5, size=(b, c)).astype(np.float32),
            rng.normal(size=(b, c)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (3, 5, 7, 13)], ids=["c128", "ragged"])
def test_film_residual_matches_pallas(shape):
    """Forward at atol 1e-6, and the VJP of sum(out^2) wrt all four inputs
    (rtol 1e-5, atol 1e-4: the (B, C) sums' order)."""
    args = _film_inputs(shape, seed=sum(shape))
    jargs = [jnp.asarray(a) for a in args]
    ref = film_pallas.film_residual(*jargs)
    ref_grads = jax.grad(lambda *a: jnp.sum(film_pallas.film_residual(*a) ** 2),
                         argnums=(0, 1, 2, 3))(*jargs)

    conv_s2d.reset_launch_counts()
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = film_residual(*leaves)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    assert not any(conv_s2d.launches().values())  # CPU tensors take the plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4,
                                   err_msg=f"input {i}")


def test_film_residual_bf16_rounds_once():
    """bf16 inputs: within one bf16 ulp of the Pallas kernel, which
    accumulates in f32 and rounds once at the store."""
    args = _film_inputs((2, 8, 16, 64), seed=7)
    ref = np.asarray(film_pallas.film_residual(*[jnp.asarray(a, jnp.bfloat16) for a in args])
                     .astype(jnp.float32))
    out = film_residual_plain(*[torch.tensor(a).bfloat16() for a in args])
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out - ref) <= ulp).all()


def test_film_wrapper_refuses_mismatched_inputs():
    h, gamma, beta, trunk = (torch.tensor(a) for a in _film_inputs((2, 4, 4, 8), seed=1))
    with pytest.raises(ValueError, match="one shape and dtype"):
        film_residual(h, gamma, beta, trunk.double())
    with pytest.raises(ValueError, match="gamma and beta"):
        film_residual(h, gamma[:, :4], beta, trunk)


@pytest.mark.parametrize("train", [False, True])
def test_film_site_with_and_without_k8_agree(train):
    """K8's plain version is the unfused site's arithmetic in f32: equal
    outputs and gradients, with and without a dropout on the conv output."""
    rng = np.random.default_rng(4)
    trunk = torch.tensor(rng.normal(size=(2, 8, 8, 16)).astype(np.float32))
    gamma = torch.tensor(rng.normal(1, 0.5, size=(2, 16)).astype(np.float32))
    beta = torch.tensor(rng.normal(size=(2, 16)).astype(np.float32))
    keep = torch.from_numpy(rng.uniform(size=(2, 8, 8, 16)) < 0.75)
    results = []
    for use_pallas in (False, True):
        torch.manual_seed(0)
        site = FilmSite(16, "m2", use_pallas)
        torch.nn.init.normal_(site.block_gen_noise_m2.conv2d_gen_noise_m2.kernel, std=0.2)
        drop = Dropout(0.25, {"b": keep})
        out = site(trunk, gamma, beta, train, lambda h: drop("b", h))
        grads = torch.autograd.grad(out.square().sum(), list(site.parameters()))
        results.append((out, grads))
    (out, grads), (ref, ref_grads) = results
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["gan", "uresnet"])
def test_generator_training_forward_matches_flax(mode):
    """GenUNet2D(train=True) with K8 against the Flax module's training
    apply: the output and every new batch statistic, with the Flax dropout
    masks recovered from its captured Dropout outputs (where a Dropout's
    input is a ReLU zero, the mask bit moves nothing)."""
    cfg = ModelConfig(image_size=32, first_fm=8, n_out=4, dropout_mode=mode, use_pallas=True)
    variables = randomized_variables(cfg, seed=6)
    x, z = inputs(cfg)
    # The Flax side runs its plain FiLM: test_ops.py pins it to K8's path.
    flax_model = FlaxGenUNet2D(dataclasses.replace(jax_cfg(cfg), use_pallas=False))
    ref, upd = flax_model.apply(
        _map(jnp.asarray, variables), jnp.asarray(x), jnp.asarray(z), train=True,
        rngs={"dropout": jax.random.key(5)}, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    masks = {name: torch.from_numpy(np.asarray(v["__call__"][0]) != 0)
             for name, v in upd["intermediates"].items()}
    assert {k: tuple(m.shape) for k, m in masks.items()} == dropout_shapes(cfg, 2)

    conv_s2d.reset_launch_counts()
    module = load_flax_variables(GenUNet2D(cfg), variables)
    out = module(torch.from_numpy(x), torch.from_numpy(z), train=True,
                 dropout=Dropout(cfg.dropout_rate, masks))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    stats = module.updated_batch_stats()
    ref_stats = flatten_tree(jax.tree.map(np.asarray, upd["batch_stats"]))
    assert stats.keys() == ref_stats.keys()
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), ref_stats[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # Serving's buffers are untouched, and an inference forward needs no masks.
    np.testing.assert_array_equal(module.block_gen_0.bn_gen_0.var.numpy(),
                                  variables["batch_stats"]["block_gen_0"]["bn_gen_0"]["var"])
    with pytest.raises(ValueError, match="needs dropout"):
        module(torch.from_numpy(x), torch.from_numpy(z), train=True)
    drawn = dropout_masks(cfg, 2, torch.Generator().manual_seed(1))
    assert {k: tuple(m.shape) for k, m in drawn.items()} == dropout_shapes(cfg, 2)
