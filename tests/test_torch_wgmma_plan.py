"""The A-operand load plan of the bf16 wgmma mainloop (K1, K3) on the CPU.

``ops/wgmma_plan.py`` mirrors how ``csrc/s2d_wgmma.cuh`` loads the GEMM's A
operand: TMA boxes of the padded plane, or 16-byte cp.async copies. Here A
is rebuilt from the plan over random planes and held to ``conv_s2d._taps``
in the engine's k order, at small n with the real 4C widths of the serving
forward and the superstep's transposes. No JAX: the plan is the port's own.
"""

import pytest
import torch

from depgan_tpu_torch.ops import conv_s2d as K
from depgan_tpu_torch.ops import wgmma_plan as W

# 4C -> 4Co of every K1 launch without a pool (serving relu and film, the
# superstep's transposes) and of both K3 launches.
K1_WIDTHS = (((32,), 128), ((128,), 128), ((128,), 256), ((256,), 256), ((256,), 128),
             ((256,), 384))
K3_WIDTHS = (((384, 256), 256), ((256, 128), 128))
# The production shapes (n, 4C..., 4Co) and the route each takes.
PRODUCTION = {(128, (32,), 128): "cp.async", (128, (128,), 128): "tma",
              (64, (128,), 256): "tma", (64, (256,), 256): "tma", (128, (128,), 256): "tma",
              (64, (256,), 128): "tma", (64, (256,), 384): "tma",
              (64, (384, 256), 256): "tma", (128, (256, 128), 128): "tma"}


def _taps_matrix(planes):
    return torch.cat([K._taps(x).reshape(-1, 4 * x.shape[-1]) for x in planes], dim=1)


@pytest.mark.parametrize("n", [8, 12, 16])
@pytest.mark.parametrize("widths", ["K1", "K3"])
def test_plan_rebuilds_the_taps(widths, n):
    """Every k column of A, rebuilt from the plan, equals the gathered taps;
    n 8 (a 256-row tile spans four images, the last past the batch), 12 (no
    box fits: cp.async) and 16 (boxes of whole image rows)."""
    g = torch.Generator().manual_seed(n)
    for c4s, co4 in K1_WIDTHS if widths == "K1" else K3_WIDTHS:
        p = W.plan(n, c4s, co4)
        planes = [K.pad_s2d(torch.randn(3, n, n, c4, generator=g)) for c4 in c4s]
        a = W.gather_a(p, planes)
        assert torch.equal(a, _taps_matrix(planes)), (n, c4s, co4, p.route)
        assert len(p.runs) * p.run == 4 * sum(c4s)
        assert p.route == ("cp.async" if n == 12 or c4s == (32,) else "tma")


def test_production_routes_and_boxes():
    """At the serving and training shapes: the route, a tile of whole image
    rows that stays inside the plane for every tap, and every output column
    in one block up to 4Co = 256 (two of 192 at 384)."""
    for (n, c4s, co4), route in PRODUCTION.items():
        p = W.plan(n, c4s, co4)
        assert p.route == route, (n, c4s, co4)
        assert (p.bn, p.n_blocks) == ((192, 2) if co4 == 384 else (co4, 1))
        assert p.bm == (256 if p.bn <= 128 and route == "tma" else 128)
        if route == "cp.async":
            assert p.box == (0, 0, 0, 0) and p.run == W.VEC
            continue
        _, bx, by, bb = p.box
        assert bx * by * bb == p.bm and bb == 1 and bx == n
        for _, c, dx, dy in p.runs:
            assert dy + by <= n + 2 and dx + bx <= n + 2
            assert c % W.HALF == 0


def test_plan_layout_and_k_order():
    """The integer layout the library reports, and runs in k order: operand
    0's runs before operand 1's, each operand's taps in (A, B, dst) order."""
    p = W.plan(64, (384, 256), 256)
    ints = W.as_ints(p)
    assert ints[:8] == [0, p.bm, p.bn, p.n_blocks, *p.box]
    assert len(ints) == 8 + 4 * len(p.runs)
    ops = [r[0] for r in p.runs]
    assert ops == sorted(ops) and ops.count(0) == 4 * 384 // W.HALF
    c = 384 // 4
    first = [W.chunk(384, k) for k in range(0, 4 * c, W.HALF)]
    assert first[0] == (3 * c, 0, 0)          # tap (0, 0), dst 0 reads group 3 in place
    assert first[c // W.HALF] == (2 * c, 1, 0)  # dst 1 reads group 2 one block right
