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
descriptors give. bf16 K11 does the same over a window of each tile's input
rows (``Conv5Window``: ``conv5_window``, ``gather_conv5_window``), and bf16
K10 chains three convs through two regions of shared memory (``ChainPlan``:
``chain_plan``, and ``run_chain``, its stages in plain torch).

bf16 K4 takes each output row's A as TMA boxes of the input plane viewed as
a 5-d tensor (``DeconvPlan``: ``deconv_plan``, and ``gather_deconv``, which
reads those boxes as the kernel's tile walk does). bf16 K9 sums its head in
the mainloop's epilogue by one chain a lane, each over its row's values in
column order (``fragment_columns``, the accumulator's lane map, and
``head_chain``, the order in which the chain reads it).
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



@dataclasses.dataclass(frozen=True)
class Conv5Window:
    """K11's window (``Conv5Window`` in the header): K7's 5x5 gather on K1's
    tile walk, a tile of ``rows`` output rows of ``wrow`` GEMM rows reading
    rows + 2 padded input rows staged once, each 8-channel chunk one TMA box
    of ``rows + 2`` rows x ``pitch`` pixels, chunks ``lead`` bytes apart."""
    bm: int        # tile rows: 256 where bn <= 128, else 128
    bn: int        # tile columns: 4Co rounded up to 64
    mt: int        # m64 tiles a consumer warpgroup: bm // 128
    wrow: int      # GEMM rows an output row takes: 64, 128 or 256, at least n
    rows: int      # output rows a tile: bm // wrow
    pitch: int     # pixels of a window row: n + 2
    lead: int      # bytes between chunks: (rows + 2) * pitch * 16 rounded up to 128
    win_bytes: int  # a window: its chunks and a pad of (wrow - n) pixels, rounded up to 1 KB
    w_stages: int  # windows: 2 where they fit beside 2 B stages
    b_stages: int  # B ring stages, up to STAGES; kt where B is kept
    resident: bool  # all of B loaded once a block and kept (else streamed)
    kt: int        # k-tiles of B
    smem: int      # dynamic shared memory bytes, the 1 KB alignment included
    steps: tuple[tuple[int, int, int], ...]  # (channel, dx, dy) of each 16-deep step up to K


def conv5_window(n: int, c4: int, co4: int) -> Conv5Window:
    """K11's window at interior side n, 4C = c4, 4Co = co4. Raises
    ValueError where the kernel refuses it: 4C a multiple of 16 (a 16-deep
    step is two chunks of one tap), 4Co a multiple of 8 up to 256 (one
    column block), n + 2 at most 256 (a row is one TMA box), two B stages
    beside one window. B is kept a block where all of it fits beside one
    window, else streamed."""
    if (n <= 0 or n + 2 > 256 or c4 <= 0 or c4 % 16 or c4 > 0xFFFF or co4 <= 0 or co4 % 8
            or co4 > 256):
        raise ValueError(f"K11's window takes 4C a multiple of 16, 4Co a multiple of 8 up to "
                         f"256 and n + 2 <= 256, got n {n}, 4C {c4}, 4Co {co4}")
    bn = -(-co4 // 64) * 64
    bm = 2 * BM if bn <= 128 else BM
    wrow = 64
    while wrow < n:  # the rows fill the tile: no m64 tile outside them
        wrow *= 2
    rows = bm // wrow
    pitch = n + 2
    lead = -(-(rows + 2) * pitch * 16 // 128) * 128
    win_bytes = -(-(c4 // 8 * lead + (wrow - n) * 16) // 1024) * 1024
    n_steps = 9 * c4 // 16
    b_stage, fixed, kt = bn * BK * 2, 1024 + n_steps * 4, -(-9 * c4 // BK)
    resident = fixed + win_bytes + kt * b_stage <= SMEM_MAX  # beside 2 windows or 1
    w_stages = 2 if fixed + 2 * win_bytes + (kt if resident else 2) * b_stage <= SMEM_MAX else 1
    b_stages = min(kt if resident else STAGES, (SMEM_MAX - fixed - w_stages * win_bytes) // b_stage)
    if rows < 1 or b_stages < 2:
        raise ValueError(f"K11's window does not fit: n {n}, 4C {c4}, 4Co {co4}")
    steps = tuple(chunk(c4, 16 * j, "conv5x5") for j in range(n_steps))
    return Conv5Window(bm, bn, bm // BM, wrow, rows, pitch, lead, win_bytes, w_stages, b_stages,
                       resident, kt, fixed + w_stages * win_bytes + b_stages * b_stage, steps)


def conv5_window_ints(w: Conv5Window) -> list[int]:
    """The window in the layout of the library's ``depgan_conv5_window_plan``."""
    return [w.bm, w.bn, w.mt, w.wrow, w.rows, w.pitch, w.lead, w.win_bytes, w.w_stages,
            w.b_stages, int(w.resident), len(w.steps), w.kt, w.smem,
            *(v for step in w.steps for v in step)]


def gather_conv5_window(w: Conv5Window, x_padded: torch.Tensor) -> torch.Tensor:
    """A (B*n*n, 9*4C) as K11's consumers read it: tile i of the walk is
    output rows y0 .. y0 + rows - 1 of image b, loaded into window i % w_stages
    (which starts as zeros and keeps what earlier tiles left) as one box a
    chunk: padded rows y0 .. y0 + rows + 1 (zeros past the plane), every
    pixel, 8 channels, at chunk * lead bytes. Each m64 tile's 16-deep step
    reads row i at 16 i bytes from its output row's first pixel shifted by
    the step's tap (the descriptor's stride offset over 8 rows is 128
    bytes) and its second 8-deep half ``lead`` bytes on. Raises if a read
    leaves the window; positions no tile stores stay NaN."""
    b, side, c4 = x_padded.shape[0], x_padded.shape[1], x_padded.shape[-1]
    n, r2 = side - 2, w.rows + 2
    elems = w.win_bytes // 2
    windows = [x_padded.new_zeros(elems) for _ in range(w.w_stages)]
    i, h, e = torch.meshgrid(torch.arange(64), torch.arange(2), torch.arange(8), indexing="ij")
    read = ((i * 16 + h * w.lead) // 2 + e).reshape(64, 16)
    a = torch.full((b, n, n, 9 * c4), float("nan"), dtype=x_padded.dtype)
    tiles_img = -(-n // w.rows)
    rows_past = F.pad(x_padded, (0, 0, 0, 0, 0, r2))  # TMA's zeros past the plane
    for tile in range(b * tiles_img):
        bb, y0 = tile // tiles_img, tile % tiles_img * w.rows
        win = windows[tile % w.w_stages]
        for k8 in range(c4 // 8):
            box = rows_past[bb, y0:y0 + r2, :, 8 * k8:8 * k8 + 8].reshape(-1)
            win[k8 * w.lead // 2:k8 * w.lead // 2 + box.numel()] = box
        for i64 in range(0, w.bm, 64):
            r, x0 = divmod(i64, w.wrow)
            base = (r * w.pitch + x0) * 8  # elements
            cols = []
            for c, dx, dy in w.steps:
                at = read + base + (c // 8 * w.lead + (dy * w.pitch + dx) * 16) // 2
                if int(at.max()) >= elems:
                    raise ValueError(f"tile {tile} row {r} reads past the window")
                cols.append(win[at])
            live = min(64, n - x0) if y0 + r < n else 0
            if live > 0:
                a[bb, y0 + r, x0:x0 + live] = torch.cat(cols, dim=1)[:live]
    return a.reshape(b * n * n, 9 * c4)


def conv5_window_takes(n: int, c4: int, co4: int) -> bool:
    """Whether K11's window kernel takes these widths (``conv5_window``
    raises for the others)."""
    try:
        conv5_window(n, c4, co4)
    except ValueError:
        return False
    return True


def library_conv5_window(n: int, c4: int, co4: int) -> list[int]:
    """The built library's own K11 window (``depgan_conv5_window_plan``), in
    the layout of ``conv5_window_ints``: needs the library."""
    import ctypes

    from . import _cuda

    cap = 14 + 3 * 9 * c4 // 16
    buf = (ctypes.c_int * cap)()
    wrote = _cuda.library().depgan_conv5_window_plan(n, c4, co4, buf, cap)
    if wrote < 0:
        raise ValueError(f"depgan_conv5_window_plan refused n {n}, 4C {c4}, 4Co {co4}")
    return list(buf[:wrote])


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """K10's plan (``ChainPlan`` in the header): a T x T tile of outputs,
    region 0 (stage 0's output over (T + 4)^2 positions) and region 1
    (stage 1's over T + 2 rows) at pitch T + 4, each stage's rows x pitch
    flattened into GEMM rows in passes of 128 * mt rows."""
    route: str      # stage 0's A: "tma" or "cp.async"
    bn: int         # columns: 4Cm
    mt: int         # m64 tiles a consumer warpgroup
    tile: int       # T
    pitch: int      # pixels of a region row: T + 4
    prow: tuple[int, int, int]    # region rows a pass, by stage
    passes: tuple[int, int, int]  # passes, by stage
    rpx: int        # pixels a region chunk holds
    lead: int       # bytes between a region's chunks: rpx * 16
    region: int     # bytes of a region, rounded up to 1 KB
    area1: int      # bytes from region 1 to the B ring: the region, or the A ring where larger
    stages: int     # ring stages
    smem: int       # dynamic shared memory bytes, the 1 KB alignment included


def chain_rows(tile: int, s: int) -> int:
    """Region rows of stage s: T + 4, T + 2, T."""
    return tile + 4 - 2 * s


def chain_plan(n: int, c4s: tuple[int, ...], c4m: int, c4o: int, pool: str = "") -> ChainPlan:
    """K10's plan at interior side n, stage-0 widths ``c4s``, 4Cm and 4Co.
    Raises ValueError where the kernel refuses it: 4Cm 128 or 256 with 4Co =
    4Cm, stage-0 widths of whole 16-byte runs of one channel group (4C a
    multiple of 32), one or two of them, pool s2d at an even n. T, from 2 to
    32, is the side that fits with two ring stages and computes the fewest
    GEMM rows an image, tail tiles included."""
    if (not 1 <= len(c4s) <= 2 or c4m not in (128, 256) or c4o != c4m or pool not in POOLS
            or (pool == "s2d" and n % 2) or n <= 0
            or any(c4 <= 0 or c4 % (4 * VEC) or c4 > 0xFFFF for c4 in c4s)):
        raise ValueError(f"K10's wgmma chain takes 4Cm = 4Co of 128 or 256 and stage-0 4C "
                         f"multiples of 32, got n {n}, 4C {c4s}, 4Cm {c4m}, 4Co {c4o}, "
                         f"pool {pool!r}")
    bn, mt = c4m, 2 if c4m <= 128 else 1
    bmp = BM * mt
    b_stage, a_stage = bn * BK * 2, bmp * BK * 2
    kt0 = sum(4 * c4 // BK for c4 in c4s)
    fixed = 1024 + kt0 * (BK // VEC) * 4 + c4m // 4 * 4
    route = ROUTES[0] if all((c4 // 4) % HALF == 0 for c4 in c4s) else ROUTES[1]
    best, best_rows = None, 0
    for t in range(2, 33):
        pitch = t + 4
        if pitch > bmp:
            break
        prow = tuple(min(bmp // pitch, chain_rows(t, s)) for s in range(3))
        passes = tuple(-(-chain_rows(t, s) // prow[s]) for s in range(3))
        rpx = max([pitch * chain_rows(t, 0)]
                  + [(passes[s] - 1) * prow[s] * pitch + bmp + 2 * pitch + 2 for s in (1, 2)])
        region = -(-(c4m // 8 * rpx * 16) // 1024) * 1024
        fits = [(stages, max(region, stages * a_stage)) for stages in range(STAGES, 1, -1)
                if fixed + region + max(region, stages * a_stage) + stages * b_stage <= SMEM_MAX]
        per_image = (-(-n // t)) ** 2 * sum(passes) * bmp
        if fits and (best is None or per_image < best_rows):
            stages, area1 = fits[0]  # the most ring stages, the A ring past region 1 if need be
            best, best_rows = ChainPlan(route, bn, mt, t, pitch, prow, passes, rpx, rpx * 16,
                                        region, area1, stages,
                                        fixed + region + area1 + stages * b_stage), per_image
    if best is None:
        raise ValueError(f"K10's wgmma chain does not fit: 4C {c4s}, 4Cm {c4m}")
    return best


def chain_takes(n: int, c4s: tuple[int, ...], c4m: int, c4o: int, pool: str = "") -> bool:
    """Whether K10's wgmma chain takes these widths (``chain_plan`` raises
    for the others)."""
    try:
        chain_plan(n, c4s, c4m, c4o, pool)
    except ValueError:
        return False
    return True


def chain_ints(p: ChainPlan) -> list[int]:
    """The plan in the layout of the library's ``depgan_chain_plan``."""
    return [ROUTES.index(p.route), p.bn, p.mt, p.tile, p.pitch, *p.prow, *p.passes, p.rpx,
            p.lead, p.region, p.area1, p.stages, p.smem]


def library_chain_plan(n: int, c4s: tuple[int, ...], c4m: int, c4o: int,
                       pool: str = "") -> list[int]:
    """The built library's own K10 plan (``depgan_chain_plan``), in the
    layout of ``chain_ints``: needs the library."""
    import ctypes

    from . import _cuda

    buf = (ctypes.c_int * 17)()
    wrote = _cuda.library().depgan_chain_plan(n, c4s[0], c4s[1] if len(c4s) > 1 else 0, c4m,
                                              c4o, POOLS[pool], buf, 17)
    if wrote < 0:
        raise ValueError(f"depgan_chain_plan refused n {n}, 4C {c4s}, 4Cm {c4m}, 4Co {c4o}, "
                         f"pool {pool!r}")
    return list(buf[:wrote])


def run_chain(p: ChainPlan, planes: list[torch.Tensor], w0s: list[torch.Tensor], b0, w1, b1,
              gamma, beta, w2, b2, pool: str = "", junk: float = float("nan")) -> dict:
    """K10's stages as the kernel runs them, in plain torch: each tile in
    walk order; stage 0's A from the planes by its load plan's runs (the
    TMA boxes or cp.async copies: zeros off the plane), stages 1 and 2 from
    the previous region, flattened at the plan's pitch, at + dy * pitch + dx
    pixels of each 16-deep step; every pass of 128 * mt GEMM rows in full,
    its rows past the pass not stored; float32 sums rounded to the planes'
    dtype where the kernel stores. Region pixels no stage writes hold
    ``junk``. Returns ``out`` (its ring and every position no tile stores
    left NaN), ``pooled`` (None without a pool), ``stores`` (how often each
    output position was stored) and ``regions`` (each tile's (b, Y0, X0),
    region 0 and region 1, flattened (pixels, 4Cm), after the tile)."""
    dt = planes[0].dtype
    b, side = planes[0].shape[0], planes[0].shape[1]
    n, T, pitch, c4m = side - 2, p.tile, p.pitch, p.bn
    bmp = BM * p.mt
    ts = -(-n // T)
    padded = [F.pad(x.float(), (0, 0, 3, 3 + bmp, 3, 3 + bmp)) for x in planes]  # zeros off it
    runs = [(o, *chunk(x.shape[-1], k0)) for o, x in enumerate(planes)
            for k0 in range(0, 4 * x.shape[-1], VEC)]
    steps = [chunk(c4m, k0) for k0 in range(0, 4 * c4m, 16)]
    w0 = torch.cat([w.float().reshape(-1, c4m) for w in w0s])
    mats = (w0, w1.float().reshape(-1, c4m), w2.float().reshape(-1, c4m))
    biases = (b0.float(), b1.float(), b2.float())
    out = torch.full((b, side, side, c4m), float("nan"))
    stores = torch.zeros((b, side, side), dtype=torch.int32)
    pooled_store = []
    regions = []
    region = [torch.full((p.rpx, c4m), junk), torch.full((p.rpx, c4m), junk)]
    for tile in range(b * ts * ts):
        bb, r = divmod(tile, ts * ts)
        y0, x0 = 1 + r // ts * T, 1 + r % ts * T
        for s in range(3):
            for pss in range(p.passes[s]):
                f0 = pss * p.prow[s] * pitch
                live = min(p.prow[s], chain_rows(T, s) - pss * p.prow[s]) * pitch
                f = torch.arange(f0, f0 + bmp)
                ry, rx = f // pitch, f % pitch
                yp, xp = y0 - 2 + s + ry, x0 - 2 + s + rx
                if s == 0:  # the box rows of the pass; rows past them are not stored
                    cols = [padded[o][bb, yp - 1 + dy + 3, xp - 1 + dx + 3, c:c + VEC]
                            for o, c, dx, dy in runs]
                else:
                    prev = region[s - 1]
                    cols = []
                    for c, dx, dy in steps:
                        at = f + dy * pitch + dx
                        if int(at.max()) >= p.rpx:
                            raise ValueError(f"stage {s} reads past region {s - 1}")
                        cols.append(prev[at, c:c + 16])
                y = torch.cat(cols, dim=1) @ mats[s] + biases[s]
                stored = torch.arange(bmp) < live
                inside = (yp >= 1) & (yp <= n) & (xp >= 1) & (xp <= n)
                keep = inside & (rx < T + 4 - 2 * s) & stored
                if s == 0:
                    val = torch.relu(y)
                elif s == 1:
                    trunk = region[0][f + pitch + 1].float()
                    val = trunk + torch.relu(y * gamma[bb].float() + beta[bb].float())
                else:
                    val = torch.relu(y)
                val = val.to(dt).float()
                if s < 2:
                    region[s][f[stored]] = torch.where(keep[:, None], val, 0.0)[stored]
                    continue
                out[bb, yp[keep], xp[keep]] = val[keep]
                stores[bb, yp[keep], xp[keep]] += 1
                if pool:
                    groups = val[keep].reshape(-1, 4, c4m // 4).amax(dim=1)
                    pooled_store.append((bb, yp[keep] - 1, xp[keep] - 1, groups))
        regions.append(((bb, y0, x0), region[0].clone(), region[1].clone()))
    out[:, 0] = out[:, -1] = 0.0
    out[:, :, 0] = out[:, :, -1] = 0.0
    pooled = None
    if pool == "pixel":
        pooled = torch.full((b, n, n, c4m // 4), float("nan"))
        for bb, oy, ox, v in pooled_store:
            pooled[bb, oy, ox] = v
    elif pool == "s2d":
        half = n // 2 + 2
        pooled = torch.zeros((b, half, half, c4m))
        pooled[:, 1:half - 1, 1:half - 1] = float("nan")
        cp = c4m // 4
        for bb, oy, ox, v in pooled_store:
            for j in range(len(oy)):
                y, x = int(oy[j]), int(ox[j])
                g = 2 * (y & 1) + (x & 1)
                pooled[bb, y // 2 + 1, x // 2 + 1, g * cp:(g + 1) * cp] = v[j]
    return {"out": out.to(dt), "pooled": None if pooled is None else pooled.to(dt),
            "stores": stores, "regions": regions}


@dataclasses.dataclass(frozen=True)
class DeconvPlan:
    """K4's plan (``DeconvPlan`` in the header): a tile is one input row i of
    an image and one column block, its two output rows 2i + p, each ``wrow``
    GEMM rows x = 2j + q; each output row's A is ``halves`` TMA boxes
    (32, 2, 1, m, 1) of the input plane viewed as (C, 2, 2, m + 2, B (m + 2))."""
    bn: int        # columns of a column block: 4O split into blocks of at most 256
    n_blocks: int  # column blocks
    wrow: int      # GEMM rows an output row takes: 2m rounded up to 64
    steps: int     # 16-deep steps: C / 16 rounded up
    halves: int    # 32-deep A boxes an output row: C / 32 rounded up
    kt: int        # 64-deep k-tiles of B: C / 64 rounded up
    a_row: int     # bytes of an output row's A: halves x wrow x 64
    a_stages: int  # A tiles: 2 where they fit, else 1
    b_bytes: int   # all of B, kept: n_blocks x kt x bn x 128
    bufs: int      # output staging buffers a consumer: 2 where they fit, else 1
    smem: int      # dynamic shared memory bytes, the 1 KB alignment included
    box: tuple[int, int, int, int, int]  # the A box (32, 2, 1, m, 1)


def deconv_plan(m: int, c4: int, o4: int) -> DeconvPlan:
    """K4's plan for input side m, 4C = c4, 4O = o4. Raises ValueError where
    the kernel refuses it: C a multiple of 8, m at most 256 (a box extent),
    4O a multiple of 8, and all of B with one A tile and one staging buffer
    a consumer inside the shared memory. Two A tiles and two staging buffers
    where they fit (the serving shape m 64, 4C 256, 4O 256 takes both)."""
    if m <= 0 or m > 256 or c4 <= 0 or c4 % (4 * VEC) or c4 > 0xFFFF or o4 <= 0 or o4 % 8:
        raise ValueError(f"K4's wgmma deconv takes 4C a multiple of 32, 4O of 8 and m <= 256, "
                         f"got m {m}, 4C {c4}, 4O {o4}")
    c = c4 // 4
    n_blocks = -(-o4 // 256)
    bn = -(-(-(-o4 // n_blocks)) // 64) * 64
    wrow = -(-2 * m // 64) * 64
    halves, kt = -(-c // HALF), -(-c // BK)
    a_row, b_bytes = halves * wrow * 64, n_blocks * kt * bn * BK * 2
    for bufs in (2, 1):
        for a_stages in (2, 1):
            smem = 1024 + a_stages * 2 * a_row + b_bytes + 2 * bufs * 64 * bn * 2
            if smem <= SMEM_MAX:
                return DeconvPlan(bn, n_blocks, wrow, -(-c // 16), halves, kt, a_row, a_stages,
                                  b_bytes, bufs, smem, (HALF, 2, 1, m, 1))
    raise ValueError(f"K4's wgmma deconv does not fit: m {m}, 4C {c4}, 4O {o4} ({b_bytes} bytes "
                     f"of B)")


def deconv_takes(m: int, c4: int, o4: int) -> bool:
    """Whether K4's wgmma deconv takes these widths (``deconv_plan`` raises
    for the others)."""
    try:
        deconv_plan(m, c4, o4)
    except ValueError:
        return False
    return True


def deconv_ints(p: DeconvPlan) -> list[int]:
    """The plan in the layout of the library's ``depgan_deconv_plan``."""
    return [p.bn, p.n_blocks, p.wrow, p.steps, p.halves, p.kt, p.a_row, p.a_stages, p.b_bytes,
            p.bufs, p.smem, *p.box]


def gather_deconv(p: DeconvPlan, x_padded: torch.Tensor) -> torch.Tensor:
    """A (B, 2m, 2m, 16 steps) as K4's consumers read it: each tile (input
    row i of image b) loads, for output row 2i + pp, box h of each half at
    origin (32 h, 0, pp, 1, b (m + 2) + i + 1) of the plane viewed as (C, 2
    [q], 2 [p], m + 2 [j], B (m + 2) [b, i]), zeros where the box runs past
    C, into rows 2j + q of its wrow GEMM rows; rows past 2m stay NaN and are
    not stored (the TMA store clips them). Consumer pp reads each m64 tile's
    16-deep step k at half k // 2, channels 16 (k % 2) onward."""
    b, mp, c4 = x_padded.shape[0], x_padded.shape[1], x_padded.shape[-1]
    m, c = mp - 2, c4 // 4
    view = x_padded.reshape(b * mp, mp, 2, 2, c)  # [b, i] [j] [p] [q] [c]: the plane itself
    view = F.pad(view, (0, p.halves * HALF - c))  # the box's channels past C: zeros
    a = torch.full((b, 2 * m, 2 * m, p.steps * 16), float("nan"), dtype=x_padded.dtype)
    for r in range(b * m):
        bb, i = divmod(r, m)
        for pp in range(2):
            rows = torch.full((p.wrow, p.halves * HALF), float("nan"), dtype=x_padded.dtype)
            for h in range(p.halves):
                box = view[bb * mp + i + 1, 1:1 + m, pp, 0:2, h * HALF:(h + 1) * HALF]
                rows[:2 * m, h * HALF:(h + 1) * HALF] = box.reshape(2 * m, HALF)  # row 2j + q
            for x0 in range(0, p.wrow, 64):  # the consumer's m64 tiles
                tile = torch.cat([rows[x0:x0 + 64, (k // 2) * HALF + 16 * (k % 2):][:, :16]
                                  for k in range(p.steps)], dim=1)
                live = min(64, 2 * m - x0)
                a[bb, 2 * i + pp, x0:x0 + live] = tile[:live]
    return a


def library_deconv_plan(m: int, c4: int, o4: int) -> list[int]:
    """The built library's own K4 plan (``depgan_deconv_plan``), in the
    layout of ``deconv_ints``: needs the library."""
    import ctypes

    from . import _cuda

    buf = (ctypes.c_int * 16)()
    wrote = _cuda.library().depgan_deconv_plan(m, c4, o4, buf, 16)
    if wrote < 0:
        raise ValueError(f"depgan_deconv_plan refused m {m}, 4C {c4}, 4O {o4}")
    return list(buf[:wrote])


def fragment_columns(bn: int) -> dict[tuple[int, int], int]:
    """The wgmma accumulator's lane map (``Wgmma`` in ``wgmma_device.cuh``):
    lane q of a quad holds, in register 4 j + 2 i + h, column 8 j + 2 q + h
    of its row in half i. Returns (q, register) -> column for i = 0."""
    return {(q, 4 * j + h): 8 * j + 2 * q + h for q in range(4) for j in range(bn // 8)
            for h in range(2)}


def head_chain(bn: int, co4: int) -> list[tuple[int, int]]:
    """K9's head chain (``head_epilogue``): the (lane, register) each step
    shuffles from, in order: step c reads lane (c // 2) % 4, register
    4 (c // 8) + c % 2, for c below 4Co."""
    return [((c >> 1) & 3, 4 * (c >> 3) + (c & 1)) for c in range(min(bn, co4))]
