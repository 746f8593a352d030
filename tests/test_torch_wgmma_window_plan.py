"""P2's window on the bf16 wgmma mainloop, on the CPU.

``ops/wgmma_plan.py`` mirrors ``Window`` in ``csrc/s2d_wgmma.cuh``: the
work units of ``probes.conv3x3_rowblk`` (padded output rows an image cut
into ``units`` blocks), the ring of input-row slots each unit loads once,
and the 16-deep steps that read A from it at a slot row, a pixel offset and
a channel. Here A is rebuilt by walking the units as a block does, read at
the matrix descriptors' addresses, and held to ``conv_s2d._taps``; and P1's
stage_only sums are held to the mainloop's tile. No JAX: the plan is the
port's own.
"""

import pytest
import torch

from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import probes
from depgan_tpu_torch.ops import wgmma_plan as W

# (4C, 4Co) at small n: one and two column blocks, four and two B stages,
# a 128-row tile where 4Co <= 128 (4C 256: six slots of a 256-row tile do
# not fit).
WIDTHS = ((64, 64), (128, 96), (64, 256), (64, 384), (256, 256), (256, 64))


def _divisors(m):
    return [d for d in range(1, m + 1) if m % d == 0]


@pytest.mark.parametrize("n", [8, 12, 16])
def test_window_rebuilds_the_taps(n):
    """A rebuilt from the window at every block count that divides n+2
    equals the gathered taps: n 8 and 12 (a tile of four 64-row outputs
    holding 1 to 4 rows of a unit), 16 (units of 1 to 18 padded rows, whose
    tail tiles are masked); rows no tile stores would stay NaN."""
    g = torch.Generator().manual_seed(n)
    for c4, co4 in WIDTHS:
        w = W.window(n, c4, co4)
        x = K.pad_s2d(torch.randn(2, n, n, c4, generator=g))
        taps = K._taps(x).reshape(-1, 4 * c4)
        for units in _divisors(n + 2):
            assert torch.equal(W.gather_window(w, x, units), taps), (n, c4, co4, units)


def test_units_cover_every_padded_row_once():
    """Units partition the padded rows and the interior rows; each unit's
    tiles cover its rows once, the last tile masked where rows_u is not a
    multiple of the tile's rows; the rows a unit loads stay in the plane."""
    for n in range(6, 21):
        for units in _divisors(n + 2):
            rb = (n + 2) // units
            padded, interior = [], []
            for s in range(units):
                padded += range(s * rb, (s + 1) * rb)
                ya, yb = W.unit_rows(n, units, s)
                interior += range(ya, yb)
                assert 0 <= ya <= yb <= n and yb + 1 <= n + 1
                for bm in (128, 256):
                    rows = bm // W.window(n, 64, 64 if bm == 256 else 256).wrow
                    tiles = [min(rows, yb - ya - t0) for t0 in range(0, yb - ya, rows)]
                    assert sum(tiles) == yb - ya and all(0 < r <= rows for r in tiles)
            assert padded == list(range(n + 2)) and interior == list(range(n))


def test_production_windows():
    """At level 1 (n 128, 128 -> 128) and level 2 (n 64, 256 -> 256): K1's
    tile, output rows a tile, four slots, the B stages beside them inside
    the shared memory; widths the kernel refuses raise."""
    l1, l2 = W.window(128, 128, 128), W.window(64, 256, 256)
    assert (l1.bm, l1.bn, l1.wrow, l1.rows, l1.pitch, l1.slots, l1.b_stages) == (
        256, 128, 128, 2, 136, 4, 4)
    assert (l2.bm, l2.bn, l2.wrow, l2.rows, l2.pitch, l2.slots, l2.b_stages) == (
        128, 256, 64, 2, 72, 4, 2)
    for w, c4 in ((l1, 128), (l2, 256)):
        assert w.smem <= W.SMEM_MAX
        assert (w.bm, w.bn) == W.geometry(128 if w is l1 else 64, (c4,), c4)[1:3]
        assert W.window_ints(w)[:9] == [w.bm, w.bn, w.n_blocks, w.wrow, w.rows, w.pitch,
                                       w.slots, w.b_stages, w.smem]
    assert W.window(16, 256, 64).bm == 128  # six slots of a 256-row tile do not fit
    for n, c4, co4 in ((16, 32, 64), (16, 64, 60), (255, 64, 64)):
        with pytest.raises(ValueError):
            W.window(n, c4, co4)


def test_window_steps_read_one_tap_group():
    """Each 16-deep step is chunk() of its depth, in k order, and its two
    8-channel halves are consecutive channels of one tap group."""
    for c4 in (64, 128, 256):
        w = W.window(16, c4, 64)
        assert w.steps == tuple(W.chunk(c4, k0) for k0 in range(0, 4 * c4, 16))
        for k0, (c, dx, dy) in zip(range(0, 4 * c4, 16), w.steps):
            assert W.chunk(c4, k0 + 8) == (c + 8, dx, dy)
            assert c % 8 == 0 and c // (c4 // 4) == (c + 15) // (c4 // 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stage_only_sums_follow_the_route_tile(dtype):
    """P1's stage_only sums per tile of ``stage_tile_rows``: the mainloop's
    bm (``wgmma_plan.geometry``) in bfloat16, the engine's tile in float32;
    its plain version sums the gathered taps over those tiles."""
    n, c4, co4 = 12, 64, 96
    x = K.pad_s2d(torch.randn(3, n, n, c4)).to(dtype)
    w4, bias = torch.randn(2, 2, c4, co4).to(dtype), torch.randn(co4)
    rows = probes.stage_tile_rows(co4, dtype, n, c4)
    want = W.geometry(n, (c4,), co4)[1] if dtype == torch.bfloat16 else 256
    assert rows == want
    for n2, c42, co42 in ((8, 128, 40), (16, 128, 128), (64, 128, 128), (128, 128, 128)):
        if dtype == torch.bfloat16:
            assert probes.stage_tile_rows(co42, dtype, n2, c42) == W.plan(n2, (c42,), co42).bm
    per_row = K._taps(x).double().reshape(3 * n * n, -1).sum(-1)
    per_row = torch.nn.functional.pad(per_row, (0, -per_row.shape[0] % rows))
    sums = probes.kernel_anatomy("stage_only", x, w4, bias)
    assert sums.shape == (-(-3 * n * n // rows),)
    torch.testing.assert_close(sums.double(), per_row.reshape(-1, rows).sum(-1), rtol=1e-5,
                               atol=1e-4)
