"""K4's wgmma deconv plan and K9's head chain on the CPU.

``ops/wgmma_plan.py`` mirrors ``DeconvPlan`` in ``csrc/s2d_wgmma.cuh``: a
tile is one input row and its two output rows, and each output row's A is
one TMA box a 32-deep half of the input plane viewed as the 5-d tensor
(C, 2 [q], 2 [p], m + 2 [j], B (m + 2) [b, i]). Here A is read from that
view as the kernel's tile walk reads it and held to the plain gather of
``conv_s2d.deconv_s2d_plain``; relu(A @ w2 + b4), laid out by the plan, to
the JAX package's ``deconv_s2d_pallas`` through its XLA twin ``_deconv_ref``
(f32, atol 2e-4); and K9's head chain, read through the wgmma accumulator's
lane map, to the columns 0 .. 4Co - 1 in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depgan_tpu.ops.conv_s2d_pallas import _deconv_ref
from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import wgmma_plan as W

ATOL = 2e-4
# (batch, m, 4C, 4O): the serving and superstep shape (first_fm 32), the
# first_fm 8 widths at the same m, the card tests' C = 8 at m 6 (2m = 12 of a
# 64-row tile), and 4O past 256 (two column blocks of 192).
SHAPES = {"first_fm_32": (1, 64, 256, 256), "first_fm_8": (1, 64, 64, 64),
          "ragged_c8": (2, 6, 32, 64), "two_blocks": (2, 8, 128, 320)}


def _inputs(b, m, c4, o4, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((b, m + 2, m + 2, c4), np.float32)
    x[:, 1:m + 1, 1:m + 1] = rng.normal(size=(b, m, m, c4))
    w2 = (rng.normal(size=(c4 // 4, o4)) / np.sqrt(c4 / 4)).astype(np.float32)
    b4 = rng.normal(0.0, 0.1, size=o4).astype(np.float32)
    return x, w2, b4


@pytest.mark.parametrize("shape", ["first_fm_32", "first_fm_8", "ragged_c8"])
def test_boxes_gather_the_plain_rows(shape):
    """The 5-d box view gives every output position (b, 2i + p, 2j + q) the
    input channels of group 2p + q at (i + 1, j + 1), zeros past C up to the
    16-deep steps; no position is left unread."""
    b, m, c4, o4 = SHAPES[shape]
    x = torch.from_numpy(_inputs(b, m, c4, o4)[0])
    p = W.deconv_plan(m, c4, o4)
    a = W.gather_deconv(p, x)
    c = c4 // 4
    groups = K.unpad_s2d(x).reshape(b, m, m, 2, 2, c)  # (b, i, j, p, q, c)
    plain = groups.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * m, 2 * m, c)
    assert torch.equal(a[..., :c], plain)
    assert not a[..., c:].any()


@pytest.mark.parametrize("shape", ["first_fm_8", "ragged_c8", "two_blocks"])
def test_plan_products_match_jax(shape):
    """relu(A @ w2 + b4) with A from the plan's boxes and w2's rows past C
    read as zeros (B's box), each column block of the plan in turn, laid out
    in the padded plane: equal to ``_deconv_ref`` and to the plain deconv,
    f32, atol 2e-4."""
    b, m, c4, o4 = SHAPES[shape]
    x, w2, b4 = _inputs(b, m, c4, o4, seed=1)
    p = W.deconv_plan(m, c4, o4)
    a = W.gather_deconv(p, torch.from_numpy(x))
    w = torch.zeros(p.steps * 16, p.n_blocks * p.bn)
    w[:c4 // 4, :o4] = torch.from_numpy(w2)
    bias = torch.zeros(p.n_blocks * p.bn)
    bias[:o4] = torch.from_numpy(b4)
    blocks = [torch.relu(a @ w[:, nb * p.bn:(nb + 1) * p.bn] + bias[nb * p.bn:(nb + 1) * p.bn])
              for nb in range(p.n_blocks)]
    out = K.pad_s2d(torch.cat(blocks, dim=-1)[..., :o4]).numpy()
    ref = np.asarray(_deconv_ref(jnp.asarray(x), jnp.asarray(w2), jnp.asarray(b4)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    plain = K.deconv_s2d_plain(torch.from_numpy(x), torch.from_numpy(w2), torch.from_numpy(b4))
    np.testing.assert_allclose(out, plain.numpy(), atol=ATOL, rtol=0)


def test_production_plans_and_refusals():
    """The serving and superstep shape takes one column block of 256, two
    output rows of 128 GEMM rows a tile, two A tiles, two staging buffers a
    consumer and all of B (32 KB) inside the shared memory; the library's
    layout; wider shapes give up the second A tile, then the second staging
    buffer; widths the kernel refuses raise."""
    p = W.deconv_plan(64, 256, 256)
    assert (p.bn, p.n_blocks, p.wrow, p.steps, p.halves, p.kt) == (256, 1, 128, 4, 2, 1)
    assert (p.a_row, p.a_stages, p.b_bytes, p.bufs, p.box) == (16384, 2, 32768, 2,
                                                                (32, 2, 1, 64, 1))
    assert p.smem <= W.SMEM_MAX
    assert W.deconv_ints(p) == [256, 1, 128, 4, 2, 1, 16384, 2, 32768, 2, p.smem, 32, 2, 1, 64, 1]
    small = W.deconv_plan(6, 32, 64)
    assert (small.bn, small.wrow, small.steps, small.halves) == (64, 64, 1, 1)
    wide = W.deconv_plan(8, 128, 320)
    assert (wide.bn, wide.n_blocks, wide.b_bytes) == (192, 2, 2 * 192 * 128)
    # where two A tiles, then two staging buffers, do not fit beside all of B
    assert (W.deconv_plan(64, 256, 512).a_stages, W.deconv_plan(64, 256, 512).bufs) == (1, 2)
    deep = W.deconv_plan(48, 384, 384)
    assert (deep.kt, deep.halves, deep.steps, deep.a_stages, deep.bufs) == (2, 3, 6, 1, 1)
    for m, c4, o4 in ((257, 32, 64), (8, 40, 64), (8, 32, 60), (4, 1024, 1024), (0, 32, 64)):
        with pytest.raises(ValueError):
            W.deconv_plan(m, c4, o4)


def test_head_chain_visits_the_columns_in_order():
    """K9's head chain reads column c from lane (c // 2) % 4 of the quad, and
    through the wgmma accumulator's lane map those reads are the columns
    0 .. 4Co - 1 in order, for every tile width 64 to 256 and every 4Co of
    that tile; each lane's 8-column blocks are its own."""
    for bn in (64, 128, 192, 256):
        lanes = W.fragment_columns(bn)
        for co4 in range(bn - 56, bn + 1, 8):
            assert [lanes[k] for k in W.head_chain(bn, co4)] == list(range(co4)), (bn, co4)
        for q in range(4):
            own = sorted(c for (lane, _), c in lanes.items() if lane == q)
            assert own == [8 * j + 2 * q + h for j in range(bn // 8) for h in range(2)]
