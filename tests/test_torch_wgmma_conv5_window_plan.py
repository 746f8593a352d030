"""K11's window on the bf16 wgmma machinery, on the CPU.

``ops/wgmma_plan.py`` mirrors ``Conv5Window`` in ``csrc/s2d_wgmma.cuh``: K7's
5x5 gather on K1's tile walk, a tile's rows + 2 padded input rows staged
once a tile as one TMA box an 8-channel chunk, and the 16-deep steps that
read A from that window at a row, a pixel shift and a chunk. Here A is
rebuilt by walking the tiles as a block does, read at the matrix
descriptors' addresses, and held to ``conv_s2d._taps5``; and the critic's
five packed shapes get the window that PERF.md states. No JAX: the window
is the port's own.
"""

import pytest
import torch

from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import wgmma_plan as W

# (n, 4C, 4Co) of K11's launches at image 256, first_fm 32 -> (bm, bn, output
# rows a tile, pitch): L0a, L0b, L1a and the transposes of L0a and L0b.
PRODUCTION = {(128, 16, 64): (256, 64, 2, 130), (128, 64, 64): (256, 64, 2, 130),
              (64, 64, 128): (256, 128, 4, 66), (128, 64, 16): (256, 64, 2, 130)}


@pytest.mark.parametrize("n", [8, 12, 16, 136])
def test_window_rebuilds_the_taps5(n):
    """A rebuilt from the window equals the 5x5 gather's taps at 4C 16
    (K 144: the steps stop at K, inside the third k-tile) and 64, at 4Co
    16, 64 and 128 (one tile width) and 256 (a 128-row tile of two or
    one rows): n 8 (two tiles an image, the last with rows past the plane),
    12 (a tail tile), 16 (junk pixels past n reading the next row and the
    pad) and 136 (one row of 256 GEMM rows a tile); positions no tile stores
    would stay NaN."""
    g = torch.Generator().manual_seed(n)
    widths = ((16, 32),) if n > 128 else ((16, 64), (16, 16), (64, 128), (64, 256))
    for c4, co4 in widths:
        w = W.conv5_window(n, c4, co4)
        x = K.pad_s2d(torch.randn(2, n, n, c4, generator=g))
        assert torch.equal(W.gather_conv5_window(w, x), K._taps5(x).reshape(-1, 9 * c4)), (
            n, c4, co4)


def test_production_windows():
    """The critic's packed shapes: K1's tile (two output rows at n 128, four
    at n 64), all of B kept inside the shared memory beside two windows at
    4Co <= 64 and beside one at L1a (144 KB of B); B streamed through four
    stages beside two windows where it does not fit (4C 64, 4Co 256: 288 KB);
    the library's layout; widths the kernel refuses raise and are not
    taken."""
    for (n, c4, co4), (bm, bn, rows, pitch) in PRODUCTION.items():
        w = W.conv5_window(n, c4, co4)
        assert (w.bm, w.bn, w.rows, w.pitch, w.mt) == (bm, bn, rows, pitch, 2)
        assert w.wrow * w.rows == w.bm and w.wrow >= n
        assert w.resident and w.w_stages == (2 if co4 <= 64 else 1) and w.smem <= W.SMEM_MAX
        assert w.b_stages == w.kt and W.conv5_window_takes(n, c4, co4)
        assert w.lead % 128 == 0 and w.lead >= (rows + 2) * pitch * 16
        assert w.win_bytes >= c4 // 8 * w.lead + (w.wrow - n) * 16
        assert W.conv5_window_ints(w)[:14] == [w.bm, w.bn, w.mt, w.wrow, w.rows, w.pitch,
                                              w.lead, w.win_bytes, w.w_stages, w.b_stages,
                                              int(w.resident), len(w.steps), w.kt, w.smem]
        # a window's last row's junk pixels stay inside its pad
        assert (c4 // 8 - 1) * w.lead + ((rows + 1) * pitch + w.wrow + 1) * 16 <= w.win_bytes
    streamed = W.conv5_window(64, 64, 256)
    assert (streamed.resident, streamed.w_stages, streamed.b_stages) == (False, 2, 4)
    assert streamed.smem <= W.SMEM_MAX
    for n, c4, co4 in ((16, 24, 64), (16, 64, 60), (16, 64, 264), (255, 64, 64)):
        with pytest.raises(ValueError):
            W.conv5_window(n, c4, co4)
        assert not W.conv5_window_takes(n, c4, co4)


def test_window_steps_stay_in_one_tap():
    """Each 16-deep step is chunk() of its depth in k order up to K and no
    further, its two 8-channel halves consecutive channels of one tap, and
    the k-tiles of B cover the steps with the last one partly past K at
    4C 16."""
    for c4 in (16, 32, 64, 128):
        w = W.conv5_window(16, c4, 64)
        assert w.steps == tuple(W.chunk(c4, k0, "conv5x5") for k0 in range(0, 9 * c4, 16))
        for k0, (c, dx, dy) in zip(range(0, 9 * c4, 16), w.steps):
            assert W.chunk(c4, k0 + 8, "conv5x5") == (c + 8, dx, dy) and c % 16 == 0
        assert (w.kt - 1) * W.BK < 9 * c4 <= w.kt * W.BK
