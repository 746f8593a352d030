"""The plain versions of the serving forward's chained and head-fused
kernels against the Pallas kernels in interpret mode, in float32 at the
smallest shapes they take (n = 8, 4C = 32): ``conv3x3_s2d_chain3`` (each
pool mode, and the two-operand form), ``conv3x3_s2d_chain2`` over its
modes, and ``conv3x3_s2d_fused_head``.

On the CPU the wrappers run their plain versions; ``tests/test_torch_cuda.py``
holds the CUDA kernels against them on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops import conv_s2d_pallas as P
from depgan_tpu_torch.ops import conv_s2d as K

ATOL = 2e-4
B, N, C4 = 2, 8, 32


def _plane(rng, c4=C4, n=N):
    x = np.zeros((B, n + 2, n + 2, c4), np.float32)
    x[:, 1:n + 1, 1:n + 1] = rng.normal(size=(B, n, n, c4))
    return x


def _w4(rng, c4, co4):
    return (rng.normal(size=(2, 2, c4, co4)) / np.sqrt(4 * c4)).astype(np.float32)


def _vec(rng, *shape, mean=0.0):
    return rng.normal(mean, 0.3, size=shape).astype(np.float32)


def _both(jax_fn, torch_fn, args):
    """The JAX op on the numpy arguments and the port's wrapper on the same
    values as CPU tensors (None stays None); outputs as numpy tuples."""
    ref = jax_fn(*[None if a is None else jnp.asarray(a) for a in args])
    with torch.no_grad():
        out = torch_fn(*[None if a is None else torch.from_numpy(a) for a in args])
    as_tuple = lambda o: tuple(np.asarray(t) for t in (o if isinstance(o, tuple) else (o,)))  # noqa: E731
    return as_tuple(ref), as_tuple(out)


def _assert_ring_zero(plane):
    n = plane.shape[1] - 2
    ring = np.ones(plane.shape[1:3], bool)
    ring[1:n + 1, 1:n + 1] = False
    assert not plane[:, ring].any()


def _chain3_args(rng, two_op):
    x2, w1b = (_plane(rng), _w4(rng, C4, C4)) if two_op else (None, None)
    return [_plane(rng), _w4(rng, C4, C4), _vec(rng, C4), _w4(rng, C4, C4), _vec(rng, C4),
            _vec(rng, B, C4, mean=1.0), _vec(rng, B, C4), _w4(rng, C4, C4), _vec(rng, C4),
            x2, w1b]


@pytest.mark.parametrize("pool", ["", "s2d", "pixel"])
def test_chain3_plain_matches_pallas(pool):
    args = _chain3_args(np.random.default_rng(1), two_op=False)
    ref, out = _both(lambda *a: P.conv3x3_s2d_chain3(*a, pool=pool),
                     lambda *a: K.conv3x3_s2d_chain3(*a, pool=pool), args)
    assert len(out) == (2 if pool else 1)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=ATOL)
    _assert_ring_zero(out[0])
    if pool == "s2d":
        _assert_ring_zero(out[1])


def test_chain3_two_operand_plain_matches_pallas():
    args = _chain3_args(np.random.default_rng(2), two_op=True)
    (ref,), (out,) = _both(P.conv3x3_s2d_chain3, K.conv3x3_s2d_chain3, args)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    _assert_ring_zero(out)


@pytest.mark.parametrize("modes", [("relu", "film"), ("film", "relu"), ("none", "relu")])
def test_chain2_plain_matches_pallas(modes):
    rng = np.random.default_rng(3)
    args = [_plane(rng), _w4(rng, C4, C4), _vec(rng, C4), _w4(rng, C4, C4), _vec(rng, C4),
            _vec(rng, B, C4, mean=1.0), _vec(rng, B, C4)]
    (ref,), (out,) = _both(lambda *a: P.conv3x3_s2d_chain2(*a, modes=modes),
                           lambda *a: K.conv3x3_s2d_chain2(*a, modes=modes), args)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    _assert_ring_zero(out)


def test_fused_head_plain_matches_pallas():
    """The unpadded tanh head output, relu output and head weights rounded
    to bfloat16 on both sides."""
    rng = np.random.default_rng(4)
    args = [_plane(rng), _w4(rng, C4, C4), _vec(rng, C4),
            rng.normal(0, 0.5, size=(1, 1, C4, 4)).astype(np.float32), _vec(rng, 4)]
    (ref,), (out,) = _both(P.conv3x3_s2d_fused_head, K.conv3x3_s2d_fused_head, args)
    assert out.shape == (B, N, N, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL)
