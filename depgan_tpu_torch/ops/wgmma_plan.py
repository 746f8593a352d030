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

P2 (``probes.conv3x3_rowblk`` in bfloat16) reads A from a window of input
rows staged once a work unit (``Window`` in the header): ``window`` is its
geometry and step plan, ``unit_rows`` its work units, and ``gather_window``
rebuilds A by walking the units as a block does, the window held as the
header lays it out and read at the addresses the kernel's matrix
descriptors give.
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
STAGES = 4                # the B ring's stages (at most, for P2)
SMEM_MAX = 227 * 1024 - 256  # dynamic shared memory a block may take beside its barriers


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


def geometry(n: int, c4s: tuple[int, ...], co4: int,
             gather: str = "conv3x3") -> tuple[str, int, int, int, tuple[int, int, int, int]]:
    """(route, bm, bn, n_blocks, box) of a launch, as ``geometry()`` in the
    header: tiles of 256 rows where at most 128 columns and the boxes allow,
    else 128; TMA boxes when each 32-deep half is one tap group's chunk, K
    whole k-tiles and a tile a box of the plane, else cp.async."""
    n_blocks = -(-co4 // 256)
    per_block = -(-co4 // n_blocks)
    bn = -(-per_block // 64) * 64
    bm = 2 * BM if bn <= 128 and _boxes(gather, n, 2 * BM, c4s) else BM
    if not _boxes(gather, n, bm, c4s):
        return ROUTES[1], bm, bn, n_blocks, (0, 0, 0, 0)
    bx = bm if n >= bm else n
    by = 1 if n >= bm else min(n, bm // n)
    return ROUTES[0], bm, bn, n_blocks, (HALF, bx, by, bm // (bx * by))


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
    route, bm, bn, n_blocks, box = geometry(n, c4s, co4, gather)
    run = HALF if route == ROUTES[0] else VEC
    runs = tuple((o, *(chunk(c4, k0, gather) if k0 < depth(c4, gather) else (PAST, 0, 0)))
                 for o, c4 in enumerate(c4s)
                 for k0 in range(0, -(-depth(c4, gather) // BK) * BK, run))
    return Plan(gather, route, bm, bn, n_blocks, box, run, runs)


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


@dataclasses.dataclass(frozen=True)
class Window:
    """P2's window (``Window`` in the header): K1's tile over output rows of
    ``wrow`` GEMM rows, a ring of ``slots`` input-row slots, each c4/8 chunks
    of ``pitch`` pixels of 8 channels, and B through ``b_stages`` stages."""
    bm: int        # rows of a tile: 256 where bn <= 128 and its slots fit, else 128
    bn: int        # columns of a column block
    n_blocks: int  # column blocks
    wrow: int      # GEMM rows an output row takes: n rounded up to 64
    rows: int      # output rows a tile: bm // wrow
    pitch: int     # pixels of a slot's chunk: wrow + 2 rounded up to 8
    slots: int     # row slots: rows + 2
    b_stages: int  # B ring stages: up to STAGES
    smem: int      # dynamic shared memory bytes, the 1 KB alignment included
    steps: tuple[tuple[int, int, int], ...]  # (channel, dx, dy) of each 16-deep step, k order


def window(n: int, c4: int, co4: int) -> Window:
    """P2's window at interior side n, 4C = c4, 4Co = co4. Raises
    ValueError where the kernel refuses it: 4C a multiple of 64 (a 16-deep
    step is two 8-channel chunks of one tap group), n + 2 at most 256 (a row
    is one TMA box), every output row inside one tile and two B stages
    beside the window. The tile is K1's where its slots fit, else 128 rows."""
    if n <= 0 or n + 2 > 256 or c4 <= 0 or c4 % 64 or co4 <= 0 or co4 % 8:
        raise ValueError(f"P2's window takes 4C a multiple of 64, 4Co of 8 and n + 2 <= 256, "
                         f"got n {n}, 4C {c4}, 4Co {co4}")
    _, _, bn, n_blocks, _ = geometry(n, (c4,), co4)  # K1's column blocks
    wrow = -(-n // 64) * 64
    pitch = -(-(wrow + 2) // 8) * 8
    for bm in (2 * BM, BM) if bn <= 128 else (BM,):  # K1's tile where its slots fit
        rows = bm // wrow
        fixed = 1024 + (rows + 2) * c4 // 8 * pitch * 16 + c4 // 4 * 8
        b_stages = min(STAGES, (SMEM_MAX - fixed) // (bn * BK * 2))
        if rows >= 1 and b_stages >= 2:
            break
    else:
        raise ValueError(f"P2's window does not fit: n {n}, 4C {c4}, 4Co {co4}")
    steps = tuple(chunk(c4, k0) for k0 in range(0, 4 * c4, 16))
    return Window(bm, bn, n_blocks, wrow, rows, pitch, rows + 2, b_stages,
                  fixed + b_stages * bn * BK * 2, steps)


def window_ints(w: Window) -> list[int]:
    """The window in the layout of the library's ``depgan_rowblk_plan``."""
    return [w.bm, w.bn, w.n_blocks, w.wrow, w.rows, w.pitch, w.slots, w.b_stages, w.smem,
            *(v for step in w.steps for v in step)]


def unit_rows(n: int, units: int, s: int) -> tuple[int, int]:
    """Interior output rows [ya, yb) of work unit s of ``units`` an image:
    it owns padded rows [s (n+2)/units, (s+1) (n+2)/units), ring included."""
    rb = (n + 2) // units
    return max(s * rb - 1, 0), min((s + 1) * rb - 1, n)


def gather_window(w: Window, x_padded: torch.Tensor, units: int) -> torch.Tensor:
    """A (B*n*n, 16C) as P2's consumers read it: one block walks every work
    unit, loading unit row j into slot (rows loaded so far) % slots, chunk k8
    of a slot at k8 * pitch * 8 elements, pixel p at p * 8; each m64 tile's
    16-deep step reads, from its output row's slot at +dy and its pixel x0
    + dx, row i at (i // 8) * 128 + (i % 8) * 16 bytes (the descriptor's
    stride offset) and its second 8-deep half pitch * 16 bytes on (the
    leading offset). Slots start as NaN, and a tile's rows past its unit
    read its last row, as the kernel does; rows no tile stores stay NaN."""
    b, side, c4 = x_padded.shape[0], x_padded.shape[1], x_padded.shape[-1]
    n = side - 2
    chunks = c4 // 8
    slot = chunks * w.pitch * 8
    ring = torch.full((w.slots, slot), float("nan"), dtype=x_padded.dtype)
    i, h, e = torch.meshgrid(torch.arange(64), torch.arange(2), torch.arange(8), indexing="ij")
    read = ((i // 8 * 128 + i % 8 * 16 + h * w.pitch * 16) // 2 + e).reshape(64, 16)
    a = torch.full((b, n, n, 4 * c4), float("nan"), dtype=x_padded.dtype)
    gi = 0
    for u in range(b * units):
        bb, (ya, yb) = u // units, unit_rows(n, units, u % units)
        rows_u = yb - ya
        if rows_u <= 0:
            continue
        loaded = 0
        for t0 in range(0, rows_u, w.rows):
            rg = min(w.rows, rows_u - t0)
            for j in range(loaded, min(t0 + w.rows + 2, rows_u + 2)):  # each input row once
                row = x_padded[bb, ya + j].reshape(side, chunks, 8).transpose(0, 1)
                ring[(gi + j) % w.slots].view(chunks, w.pitch, 8)[:, :side] = row
                loaded = j + 1
            for i64 in range(0, w.bm, 64):
                r, x0 = divmod(i64, w.wrow)
                s0 = gi + t0 + min(r, rg - 1)
                cols = [ring[(s0 + dy) % w.slots][read + (c // 8 * w.pitch + x0 + dx) * 8]
                        for c, dx, dy in w.steps]
                live = min(64, n - x0) if r < rg else 0
                if live > 0:
                    a[bb, ya + t0 + r, x0:x0 + live] = torch.cat(cols, dim=1)[:live]
        gi += rows_u + 2
    return a.reshape(b * n * n, 4 * c4)


def library_window(n: int, c4: int, co4: int) -> list[int]:
    """The built library's own window (``depgan_rowblk_plan``), in the
    layout of ``window_ints``: needs the library."""
    import ctypes

    from . import _cuda

    cap = 9 + 3 * c4 // 4
    buf = (ctypes.c_int * cap)()
    wrote = _cuda.library().depgan_rowblk_plan(n, c4, co4, buf, cap)
    if wrote < 0:
        raise ValueError(f"depgan_rowblk_plan refused n {n}, 4C {c4}, 4Co {co4}")
    return list(buf[:wrote])
