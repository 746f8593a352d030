"""The wgmma mainloop's plan for K7 (the 5x5 gather) and K2 (the pool) on the CPU.

``ops/wgmma_plan.py`` mirrors how ``csrc/s2d_wgmma.cuh`` loads the GEMM's A
operand. Here the 5x5 gather's A is rebuilt from the plan over random planes
and held to ``conv_s2d._taps5``, zero tail past K included, at small n with
the critic's real 4C widths; the product of the rebuilt A with the weights
is held to ``conv5x5_s2d_fused_plain``, which the CPU tests hold to JAX; and
each production K7 and K2 launch gets the route and tile that PERF.md
states. No JAX: the plan is the port's own.
"""

import pytest
import torch

from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import wgmma_plan as W

# 4C -> 4Co of every K7 launch: the critic's forward and its transposes.
K7_WIDTHS = ((16, 64), (64, 64), (64, 128), (128, 128), (64, 16), (128, 64))
# (n, 4C, 4Co, pool or gather) -> (route, tile rows, tile columns): the
# production launches at image 256, first_fm 32.
PRODUCTION = {
    (128, 16, 64, "conv5x5"): ("cp.async", 128, 64),    # L0a
    (128, 64, 64, "conv5x5"): ("tma", 256, 64),         # L0b, L0b dX
    (64, 64, 128, "conv5x5"): ("tma", 256, 128),        # L1a
    (64, 128, 128, "conv5x5"): ("tma", 256, 128),       # L1b, L1b dX
    (128, 64, 16, "conv5x5"): ("tma", 256, 64),         # L0a dX
    (64, 128, 64, "conv5x5"): ("tma", 256, 64),         # L1a dX
    (128, 128, 128, "s2d"): ("tma", 256, 128),          # K2 L1
    (64, 256, 256, "pixel"): ("tma", 128, 256),         # K2 L2
}


def _plan(n, c4, co4, kind):
    if kind == "conv5x5":
        return W.plan(n, (c4,), co4, gather="conv5x5")
    return W.plan(n, (c4,), co4, pool=kind)


@pytest.mark.parametrize("n", [8, 12, 16])
def test_plan_rebuilds_the_taps5(n):
    """Every k column of A rebuilt from the plan equals the 5x5 gather's
    taps, and the columns past K are zeros; n 8 (a 256-row tile spans four
    images, the last past the batch), 12 (no box fits: cp.async) and 16."""
    g = torch.Generator().manual_seed(n)
    for c4, co4 in K7_WIDTHS:
        p = W.plan(n, (c4,), co4, gather="conv5x5")
        x = K.pad_s2d(torch.randn(3, n, n, c4, generator=g))
        a = W.gather_a(p, [x])
        k = 9 * c4
        assert a.shape[1] == -(-k // W.BK) * W.BK and len(p.runs) * p.run == a.shape[1]
        assert torch.equal(a[:, :k], K._taps5(x).reshape(-1, k)), (n, c4, co4, p.route)
        assert not a[:, k:].any()
        assert p.route == ("cp.async" if n == 12 or c4 == 16 else "tma")


def test_production_routes_and_tiles():
    """The route and tile of every production K7 and K2 launch, each tile
    of whole image rows staying inside the plane for every tap, every
    column in one block, and 4C = 16 the only K that is no whole k-tile."""
    for (n, c4, co4, kind), (route, bm, bn) in PRODUCTION.items():
        p = _plan(n, c4, co4, kind)
        assert (p.route, p.bm, p.bn, p.n_blocks) == (route, bm, bn, 1), (n, c4, co4, kind)
        past = [r for r in p.runs if r[1] == W.PAST]
        assert len(past) == (6 if c4 == 16 else 0)  # K 144 of 192: six 8-deep runs
        if route == "cp.async":
            assert p.box == (0, 0, 0, 0) and p.run == W.VEC
            continue
        _, bx, by, bb = p.box
        assert bx * by * bb == p.bm and bb == 1 and bx == n
        for _, c, dx, dy in p.runs:
            assert dy + by <= n + 2 and dx + bx <= n + 2 and c % W.HALF == 0


@pytest.mark.parametrize("mode", ["relu", "none"])
def test_rebuilt_product_equals_plain(mode):
    """rebuilt A @ w9 (zero rows past K, as the B box reads them) + bias is
    the plain 5x5 conv, at the entry width (cp.async, zero tail) and a TMA
    width."""
    g = torch.Generator().manual_seed(7)
    for n, c4, co4 in ((12, 16, 64), (16, 64, 16)):
        p = W.plan(n, (c4,), co4, gather="conv5x5")
        x = K.pad_s2d(torch.randn(2, n, n, c4, generator=g))
        w9 = torch.randn(3, 3, c4, co4, generator=g) * (9 * c4) ** -0.5
        bias = torch.randn(co4, generator=g) * 0.1
        a = W.gather_a(p, [x])
        w = torch.cat([w9.reshape(-1, co4), w9.new_zeros(a.shape[1] - 9 * c4, co4)])
        y = a @ w + bias
        y = torch.relu(y) if mode == "relu" else y
        torch.testing.assert_close(K.pad_s2d(y.reshape(2, n, n, co4)),
                                   K.conv5x5_s2d_fused_plain(x, w9, bias, mode))


def test_pool_plans_and_refusals():
    """A pooled launch owns every column in one block at each width the
    pooled epilogue takes; other widths, two operands and the 5x5 gather
    with a pool are refused, as the library refuses them."""
    for co4 in W.POOL_WIDTHS:
        for pool in ("s2d", "pixel"):
            p = W.plan(16, (32,), co4, pool=pool)
            assert p.n_blocks == 1 and p.bn >= co4
    for args in (((16, (32,), 96), {"pool": "s2d"}), ((16, (32,), 384), {"pool": "pixel"}),
                 ((9, (32,), 128), {"pool": "s2d"}),
                 ((16, (32, 32), 128), {"pool": "s2d"}),
                 ((16, (64,), 64), {"gather": "conv5x5", "pool": "s2d"}),
                 ((16, (64, 64), 64), {"gather": "conv5x5"}),
                 ((16, (20,), 64), {"gather": "conv5x5"})):
        with pytest.raises(ValueError):
            W.plan(*args[0], **args[1])


def test_plan_layout_and_taps():
    """The integer layout the library reports for a 5x5 plan, past-K runs
    as (operand, -1, 0, 0), and the taps in (A, B) order, tap 3A + B at
    offset (dx, dy) = (B, A)."""
    p = W.plan(128, (16,), 64, gather="conv5x5")
    ints = W.as_ints(p)
    assert ints[:8] == [1, 128, 64, 1, 0, 0, 0, 0]
    assert len(ints) == 8 + 4 * 24 and ints[8 + 4 * 18:] == [0, -1, 0, 0] * 6
    assert [W.chunk(16, k, "conv5x5") for k in (0, 8, 16, 40, 136)] == [
        (0, 0, 0), (8, 0, 0), (0, 1, 0), (8, 2, 0), (8, 2, 2)]
    assert W.chunk(64, 4 * 64 + 32, "conv5x5") == (32, 1, 1)
