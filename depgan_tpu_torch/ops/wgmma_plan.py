"""The load plan of the bf16 wgmma mainloop of K1, K2, K3 and K7, in Python.

``csrc/s2d_wgmma.cuh`` decides, for each launch, how its producer loads the
GEMM's A operand: by TMA boxes of the padded plane, or by 16-byte
``cp.async`` copies where the gather is not a box. This module is the same
decision and the same addressing, written out so that the CPU tests can
rebuild A from the plan and hold it against ``conv_s2d._taps`` and
``conv_s2d._taps5``, and so that ``chip_smoke.py`` can hold the library's own
plan (``depgan_wgmma_plan``) to it. Nothing here launches a kernel.

The GEMM: rows m = (b, y, x), the output positions. The gather decides what
depth k of row m reads from the padded plane:

- ``conv3x3`` (K1, K2, K3): k = (tap, dst, c) over 4 taps x 4C of each
  operand, operand 1's k range after operand 0's (w4's row order); it reads
  (b, y + dy, x + dx, (3 - dst) * C + c), dy = tap // 2 + dst // 2,
  dx = tap % 2 + dst % 2.
- ``conv5x5`` (K7): k = (tap, c) over 9 taps x 4C (w9's row order); it reads
  (b, y + dy, x + dx, c), dy = tap // 3, dx = tap % 3.

Each operand's K is loaded in whole k-tiles of BK; the runs past K (the 5x5
at 4C = 16: K = 144 of 192) are copies of zeros.
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
GATHERS = {"conv3x3": 0, "conv5x5": 2}  # the library's kGatherConv3x3, kGatherConv5x5
POOLS = {"": 0, "pixel": 1, "s2d": 2}    # the library's PoolMode
PAST = -1   # the channel of a run past K: its copies are zeros
POOL_WIDTHS = (32, 64, 128, 256)  # the 4Co the pooled epilogue takes (K2)


@dataclasses.dataclass(frozen=True)
class Plan:
    gather: str                     # "conv3x3" or "conv5x5"
    route: str                      # "tma" or "cp.async"
    bm: int                         # rows of a block: 128, or 256 where bn <= 128
    bn: int                         # columns of a block
    n_blocks: int                   # column blocks
    box: tuple[int, int, int, int]  # A box extents (32, bx, by, bb); zeros for cp.async
    run: int                        # depth loaded in one piece: HALF or VEC
    runs: tuple[tuple[int, int, int, int], ...]  # (operand, channel or PAST, dx, dy), k order


def depth(c4: int, gather: str = "conv3x3") -> int:
    """GEMM depth K of an operand with 4C = c4: 4 taps or 9 of 4C."""
    return (9 if gather == "conv5x5" else 4) * c4


def chunk(c4: int, k0: int, gather: str = "conv3x3") -> tuple[int, int, int]:
    """(channel, dx, dy) that depth k0 of an operand with 4C = c4 reads."""
    tap, r = divmod(k0, c4)
    if gather == "conv5x5":
        return r, tap % 3, tap // 3
    c = c4 // 4
    dst, ch = divmod(r, c)
    return (3 - dst) * c + ch, tap % 2 + dst % 2, tap // 2 + dst // 2


def origin(n: int, m: int) -> tuple[int, int, int]:
    """Position (x, y, b) of GEMM row m: a tile's box origin at its first row."""
    b, rem = divmod(m, n * n)
    return rem % n, rem // n, b


def _boxes(gather: str, n: int, bm: int, c4s: tuple[int, ...]) -> bool:
    """Whether every tile of bm rows is one box of the plane, every 32-deep
    half one chunk of one tap group (C channels of the 3x3 gather, 4C of
    the 5x5), and K whole k-tiles (the 5x5's 9 * 4C needs 4C % 64 == 0)."""
    whole = (lambda c4: c4 % (2 * HALF) == 0) if gather == "conv5x5" else (
        lambda c4: (c4 // 4) % HALF == 0)
    return (n % bm == 0 or bm % n == 0) and all(whole(c4) for c4 in c4s)


def plan(n: int, c4s: tuple[int, ...], co4: int, gather: str = "conv3x3",
         pool: str = "") -> Plan:
    """The launch plan at interior side n, input widths 4C = ``c4s`` and
    4Co = ``co4``: K1 (``conv3x3``, one operand), K2 (the same with a
    ``pool``), K3 (two operands) or K7 (``conv5x5``): tiles of 256 rows
    where at most 128 columns and the boxes allow, else 128; TMA boxes when
    each 32-deep half is one tap group's chunk, K whole k-tiles and a tile a
    box of the plane (n a multiple or a divisor of its rows), else cp.async.
    Raises ValueError for widths the mainloop refuses (``takes`` in the
    header): a pool needs every column in one block and 4Co in
    POOL_WIDTHS."""
    conv5 = gather == "conv5x5"
    if gather not in GATHERS or pool not in POOLS or not 1 <= len(c4s) <= (1 if conv5 else 2):
        raise ValueError(f"no such launch: gather {gather!r}, pool {pool!r}, 4C {c4s}")
    if any(c4 <= 0 or c4 % (VEC if conv5 else 4 * VEC) for c4 in c4s) or co4 <= 0 or co4 % 8:
        raise ValueError(f"the mainloop takes whole 16-byte runs, got 4C {c4s}, 4Co {co4}")
    if pool and (conv5 or len(c4s) != 1 or co4 not in POOL_WIDTHS or (pool == "s2d" and n % 2)):
        raise ValueError(f"the pooled epilogue takes one 3x3 operand, 4Co {POOL_WIDTHS} and an "
                         f"even n for s2d, got {gather} n {n} 4C {c4s}, 4Co {co4}")
    n_blocks = -(-co4 // 256)
    per_block = -(-co4 // n_blocks)
    bn = -(-per_block // 64) * 64
    bm = 2 * BM if bn <= 128 and _boxes(gather, n, 2 * BM, c4s) else BM
    boxes = _boxes(gather, n, bm, c4s)
    box = (0, 0, 0, 0)
    if boxes:
        bx = bm if n >= bm else n
        by = 1 if n >= bm else min(n, bm // n)
        box = (HALF, bx, by, bm // (bx * by))
    run = HALF if boxes else VEC
    runs = tuple((o, *(chunk(c4, k0, gather) if k0 < depth(c4, gather) else (PAST, 0, 0)))
                 for o, c4 in enumerate(c4s)
                 for k0 in range(0, -(-depth(c4, gather) // BK) * BK, run))
    return Plan(gather, ROUTES[0] if boxes else ROUTES[1], bm, bn, n_blocks, box, run, runs)


def as_ints(p: Plan) -> list[int]:
    """The plan in the layout of the library's ``depgan_wgmma_plan``."""
    return [ROUTES.index(p.route), p.bm, p.bn, p.n_blocks, *p.box,
            *(v for r in p.runs for v in r)]


def gather_a(p: Plan, planes: list[torch.Tensor]) -> torch.Tensor:
    """The GEMM's A operand (B*n*n, sum of each operand's K in whole
    k-tiles) as the producer loads it: for TMA, each tile's box of each run,
    zero where the box runs past the batch (as TMA fills it); for cp.async,
    each row's 8-channel copy of each run, zeros past K. Raises if a box
    would leave the plane's interior side, where TMA would read zeros in
    place of data."""
    b, side = planes[0].shape[0], planes[0].shape[1]
    n = side - 2
    rows = b * n * n
    cols = []
    if p.route == "cp.async":
        for o, c, dx, dy in p.runs:
            if c == PAST:
                cols.append(planes[o].new_zeros(rows, p.run))
                continue
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


def library_plan(n: int, c4s: tuple[int, ...], co4: int, gather: str = "conv3x3",
                 pool: str = "") -> list[int]:
    """The built library's own plan (``depgan_wgmma_plan``), in the layout
    of ``as_ints``: needs the library, so a machine with the CUDA toolkit."""
    import ctypes

    from . import _cuda

    cap = 8 + 4 * sum(-(-depth(c4, gather) // BK) * BK // VEC for c4 in c4s)
    buf = (ctypes.c_int * cap)()
    wrote = _cuda.library().depgan_wgmma_plan(n, c4s[0], c4s[1] if len(c4s) > 1 else 0, co4,
                                             GATHERS[gather], POOLS[pool], buf, cap)
    if wrote < 0:
        raise ValueError(f"depgan_wgmma_plan refused n {n}, 4C {c4s}, 4Co {co4}, {gather}, "
                         f"pool {pool!r}")
    return list(buf[:wrote])
