"""The training-mode layers against Flax: BatchNorm in training mode (its
output and new running statistics) and in frozen mode, and dropout with an
injected or drawn mask.

Split from ``test_torch_film.py`` so that each file stays small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from depgan_tpu.models.blocks import keras_bn
from depgan_tpu_torch.models import BatchNorm
from depgan_tpu_torch.models.blocks import Dropout


def _flax_bn(x, scale, bias, mean, var):
    """Flax BatchNorm with the repo's settings in training mode: output and
    the new running statistics."""
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    out, upd = keras_bn("bn").apply(variables, jnp.asarray(x), use_running_average=False,
                                    mutable=["batch_stats"])
    return np.asarray(out), np.asarray(upd["batch_stats"]["mean"]), np.asarray(
        upd["batch_stats"]["var"])


@pytest.mark.parametrize("shape,loc", [((2, 4, 4, 8), 0.0), ((2, 2, 2, 8), 5.0),
                                       ((3, 32, 8), 0.0), ((4, 16), 0.0)],
                         ids=["nhwc", "large_mean", "noise_axis", "dense"])
def test_batch_norm_training_matches_flax(shape, loc):
    """Output and new running statistics against Flax nn.BatchNorm
    (momentum 0.99, eps 1e-3, biased variance); the large-mean case over 8
    values per channel, where the unbiased variance is 8/7 of it."""
    rng = np.random.default_rng(len(shape) + int(loc))
    c = shape[-1]
    x = rng.normal(loc, 1.0, size=shape).astype(np.float32)
    scale, bias = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    mean, var = rng.normal(0, 0.2, c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    ref_out, ref_mean, ref_var = _flax_bn(x, scale, bias, mean, var)

    bn = BatchNorm(c)
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean), (bn.var, var)):
            t.copy_(torch.from_numpy(v))
    out = bn(torch.from_numpy(x), train=True)
    new_mean, new_var = bn.running
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **tol)
    np.testing.assert_allclose(new_mean.numpy(), ref_mean, **tol)
    np.testing.assert_allclose(new_var.numpy(), ref_var, **tol)
    np.testing.assert_array_equal(bn.var.numpy(), var)  # the buffers stay
    if loc:
        unbiased = torch.from_numpy(var).clone()
        torch.nn.functional.batch_norm(torch.from_numpy(x).reshape(-1, c), torch.zeros(c),
                                       unbiased, training=True, momentum=0.01)
        assert np.abs(unbiased.numpy() - ref_var).max() > 1e-3


def test_batch_norm_frozen_forward_unchanged():
    """Without train: the running statistics, in the input's dtype."""
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.mean.fill_(0.5)
        bn.var.fill_(4.0)
    x = torch.linspace(-1, 1, 8).reshape(2, 4)
    torch.testing.assert_close(bn(x), (x - 0.5) * (4.0 + 1e-3) ** -0.5)
    assert bn.running is None


def test_dropout_with_injected_mask_matches_flax():
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 8)).astype(np.float32)
    ref = np.asarray(fnn.Dropout(rate=0.25, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.key(3)}))
    keep = torch.from_numpy(ref != 0)
    out = Dropout(0.25, {"do_gen_1": keep})("do_gen_1", torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)

    # Drawn from a generator: recorded by name, kept at rate 1 - 0.25.
    drop = Dropout(0.25, generator=torch.Generator().manual_seed(0))
    big = torch.ones(64, 64, 16)
    out = drop("a", big)
    assert set(drop.masks) == {"a"} and abs(float(drop.masks["a"].float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(out, drop.masks["a"] / 0.75)
    with pytest.raises(ValueError, match="shape"):
        drop("a", torch.ones(2, 2))
