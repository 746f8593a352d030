"""The load plan of the bf16 wgmma mainloop of K1 and K3, in Python.

``csrc/s2d_wgmma.cuh`` decides, for each launch, how its producer loads the
GEMM's A operand: by TMA boxes of the padded plane, or by 16-byte
``cp.async`` copies where the gather is not a box. This module is the same
decision and the same addressing, written out so that the CPU tests can
rebuild A from the plan and hold it against ``conv_s2d._taps``, and so that
``chip_smoke.py`` can hold the library's own plan (``depgan_wgmma_plan``) to
it. Nothing here launches a kernel.

The GEMM: rows m = (b, y, x), the output positions; depth k = (tap, dst, c)
over 4 taps x 4C of each operand, operand 1's k range after operand 0's
(w4's row order). Row m at depth k reads the padded plane at
(b, y + dy, x + dx, (3 - dst) * C + c), dy = tap // 2 + dst // 2,
dx = tap % 2 + dst % 2.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BM = 128    # GEMM rows of a block with one m64 tile a consumer warpgroup
BK = 64     # GEMM depth of one ring stage
HALF = 32   # depth of one A box (TMA route)
VEC = 8     # depth of one 16-byte copy (cp.async route)
ROUTES = ("tma", "cp.async")  # the library's kRouteTma, kRouteCpAsync


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str                      # "tma" or "cp.async"
    bm: int                         # rows of a block: 128, or 256 where bn <= 128
    bn: int                         # columns of a block
    n_blocks: int                   # column blocks
    box: tuple[int, int, int, int]  # A box extents (32, bx, by, bb); zeros for cp.async
    run: int                        # depth loaded in one piece: HALF or VEC
    runs: tuple[tuple[int, int, int, int], ...]  # (operand, channel, dx, dy), k order


def chunk(c4: int, k0: int) -> tuple[int, int, int]:
    """(channel, dx, dy) that depth k0 of an operand with 4C = c4 reads."""
    c = c4 // 4
    tap, r = divmod(k0, c4)
    dst, ch = divmod(r, c)
    return (3 - dst) * c + ch, tap % 2 + dst % 2, tap // 2 + dst // 2


def origin(n: int, m: int) -> tuple[int, int, int]:
    """Position (x, y, b) of GEMM row m: a tile's box origin at its first row."""
    b, rem = divmod(m, n * n)
    return rem % n, rem // n, b


def _boxes(n: int, bm: int, c4s: tuple[int, ...]) -> bool:
    """Whether every tile of bm rows is one box of the plane and every
    operand's C whole HALF-deep chunks."""
    return (n % bm == 0 or bm % n == 0) and all((c4 // 4) % HALF == 0 for c4 in c4s)


def plan(n: int, c4s: tuple[int, ...], co4: int) -> Plan:
    """The launch plan of K1 (one operand) or K3 (two) at interior side n,
    input widths 4C = ``c4s`` and 4Co = ``co4``: tiles of 256 rows where
    at most 128 columns and the boxes allow, else 128; TMA boxes when every
    C is a multiple of 32 and a tile is a box of the plane (n a multiple or
    a divisor of its rows), else cp.async."""
    n_blocks = -(-co4 // 256)
    per_block = -(-co4 // n_blocks)
    bn = -(-per_block // 64) * 64
    bm = 2 * BM if bn <= 128 and _boxes(n, 2 * BM, c4s) else BM
    boxes = _boxes(n, bm, c4s)
    box = (0, 0, 0, 0)
    if boxes:
        bx = bm if n >= bm else n
        by = 1 if n >= bm else min(n, bm // n)
        box = (HALF, bx, by, bm // (bx * by))
    run = HALF if boxes else VEC
    runs = tuple((o, *chunk(c4, k0)) for o, c4 in enumerate(c4s) for k0 in range(0, 4 * c4, run))
    return Plan(ROUTES[0] if boxes else ROUTES[1], bm, bn, n_blocks, box, run, runs)


def as_ints(p: Plan) -> list[int]:
    """The plan in the layout of the library's ``depgan_wgmma_plan``."""
    return [ROUTES.index(p.route), p.bm, p.bn, p.n_blocks, *p.box,
            *(v for r in p.runs for v in r)]


def gather_a(p: Plan, planes: list[torch.Tensor]) -> torch.Tensor:
    """The GEMM's A operand (B*n*n, 16 * sum(C)) as the producer loads it:
    for TMA, each tile's box of each run, zero where the box runs
    past the batch (as TMA fills it); for cp.async, each row's 8-channel
    copy of each run. Raises if a box would leave the plane's interior
    side, where TMA would read zeros in place of data."""
    b, side = planes[0].shape[0], planes[0].shape[1]
    n = side - 2
    rows = b * n * n
    cols = []
    if p.route == "cp.async":
        for o, c, dx, dy in p.runs:
            cols.append(planes[o][:, dy:dy + n, dx:dx + n, c:c + p.run].reshape(rows, p.run))
        return torch.cat(cols, dim=1)
    _, bx, by, bb = p.box
    tiles = -(-rows // p.bm)
    padded = [F.pad(x, (0, 0, 0, 0, 0, 0, 0, bb)) for x in planes]  # batch past B: zeros
    for o, c, dx, dy in p.runs:
        parts = []
        for t in range(tiles):
            x0, y0, b0 = origin(n, t * p.bm)
            if y0 + dy + by > side or x0 + dx + bx > side:
                raise ValueError(f"box of tile {t} leaves the plane: ({x0 + dx}, {y0 + dy})")
            box = padded[o][b0:b0 + bb, y0 + dy:y0 + dy + by, x0 + dx:x0 + dx + bx, c:c + HALF]
            parts.append(box.reshape(p.bm, HALF))
        cols.append(torch.cat(parts)[:rows])
    return torch.cat(cols, dim=1)


def library_plan(n: int, c4s: tuple[int, ...], co4: int) -> list[int]:
    """The built library's own plan (``depgan_wgmma_plan``), in the layout
    of ``as_ints``: needs the library, so a machine with the CUDA toolkit."""
    import ctypes

    from . import _cuda

    cap = 8 + 4 * sum(4 * c4 // VEC for c4 in c4s)
    buf = (ctypes.c_int * cap)()
    wrote = _cuda.library().depgan_wgmma_plan(n, c4s[0], c4s[1] if len(c4s) > 1 else 0, co4,
                                             buf, cap)
    if wrote < 0:
        raise ValueError(f"depgan_wgmma_plan refused n {n}, 4C {c4s}, 4Co {co4}")
    return list(buf[:wrote])
