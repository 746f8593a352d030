"""The kernel probes: the timing splits and relayouts that the JAX package's
``scripts/`` ran as Pallas kernels, as wrappers of hand-written CUDA kernels
with their plain PyTorch versions.

- ``kernel_anatomy`` (P1, ``scripts/kernel_anatomy.py:108``): K1's relu conv
  split into phases, each repeated ``reps`` times a tile in one launch:
  ``full``, ``no_epi`` (no bias or relu), ``matmul_only`` (the products over
  the pre-gathered taps of ``gathered_taps``), ``stage_only`` (the A loads
  alone, which returns one float32 sum of loaded values per tile of
  ``stage_tile_rows`` rows). bfloat16 runs the phases on K1's wgmma
  mainloop (``s2d_wgmma``'s PHASE argument, ``csrc/wgmma_kernels.cu``),
  float32 on the engine's Phase argument (``csrc/s2d_gemm.cuh``).
- ``conv3x3_rowblk`` (P2, ``scripts/rowblk_probe.py:125``): K1's relu conv
  with the output cut into row blocks, each block's input rows staged once;
  bfloat16 on the wgmma mainloop over a window of input rows
  (``rowblk_wgmma``, ``csrc/wgmma_kernels.cu``), float32 in
  ``csrc/window_kernels.cu``; equal to K1.
- ``deint`` (P3, ``scripts/packed_tap_probe.py:109``): the column
  deinterleave (B, n, 2m, c) -> (B, n, m, 2c), by index decode
  (``reshape_idx``) or as the flat copy it is on a row-major layout
  (``merge``).

``conv3x3_engine`` launches the GEMM engine's K1, K2 or K3,
``conv5x5_engine`` its K7, ``conv3x3_head_engine`` its K9 and
``deconv_engine`` its K4, which the wrappers no longer call in bfloat16:
the references that the wgmma kernels, the chains and P1, P2 equal bit for
bit. ``kernel_anatomy_engine``, ``conv3x3_rowblk_window``,
``conv5x5_packed_mma_sync`` and ``conv3x3_chain3_wmma`` are P1's, P2's,
K11's and K10's bfloat16 routes before the wgmma kernels took them over
(the engine's phases, the ``mma.sync`` window kernel, the engine's wmma
chain), kept to be timed beside them.

As in ``conv_s2d``: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel and counts the launch in ``conv_s2d.SHAPES`` under the
kernel's name; there is no fallback. The probes are timing tools with no
caller on a training or serving path; ``depgan_tpu_torch/scripts/`` runs them.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import conv_s2d as K
from . import wgmma_plan as W

ANATOMY_PHASES = {"full": 1, "no_epi": 2, "matmul_only": 3, "stage_only": 4}
DEINT_KINDS = {"reshape_idx": 0, "merge": 1}


def engine_tile_rows(co4: int, dtype: torch.dtype) -> int:
    """GEMM rows of the engine's block tile for an unpooled conv to 4Co
    (``launch`` in ``csrc/s2d_gemm.cuh``): 256 where 4Co <= 64, else 128,
    twice those in float32."""
    rows = 256 if co4 <= 64 else 128
    return 2 * rows if dtype == torch.float32 else rows


def stage_tile_rows(co4: int, dtype: torch.dtype, n: int, c4: int) -> int:
    """GEMM rows of the tile over which P1's stage_only sums, for a 3x3 conv
    of 4C -> 4Co at interior side n: in bfloat16 the wgmma mainloop's bm
    (``wgmma_plan.geometry``), in float32 the engine's block tile
    (``engine_tile_rows``)."""
    if dtype == torch.bfloat16:
        return W.geometry(n, (c4,), co4)[1]
    return engine_tile_rows(co4, dtype)


def gathered_taps(x_padded: torch.Tensor) -> torch.Tensor:
    """The taps of the 3x3 gather as a dense (B*n*n, 16C) matrix in the
    plane's dtype, rows (b, y, x), columns in the engine's k order: the
    pre-gathered A of ``matmul_only``."""
    c4 = x_padded.shape[-1]
    return K._taps(x_padded).to(x_padded.dtype).reshape(-1, 4 * c4).contiguous()


def kernel_anatomy_plain(phase, x_padded, w4, bias4, a_dense=None):
    """What each phase computes: the relu conv (``full``, and
    ``matmul_only`` over ``a_dense``), the conv without bias or relu
    (``no_epi``), or the float32 sums of the gathered taps over each tile of
    ``stage_tile_rows`` rows in the plane's dtype (``stage_only``)."""
    b, n, c4, co4 = x_padded.shape[0], x_padded.shape[1] - 2, x_padded.shape[-1], w4.shape[-1]
    if phase == "full":
        return K.conv3x3_s2d_fused_plain(x_padded, w4, bias4)
    if phase == "no_epi":
        return K.pad_s2d(K._matmul_taps(K._taps(x_padded), w4).to(x_padded.dtype))
    if phase == "matmul_only":
        y = torch.relu(K._matmul_taps(a_dense.float(), w4) + bias4.float())
        return K.pad_s2d(y.reshape(b, n, n, co4).to(x_padded.dtype))
    rows = stage_tile_rows(co4, x_padded.dtype, n, c4)
    taps = K._taps(x_padded).double().reshape(b * n * n, -1).sum(-1)
    taps = torch.nn.functional.pad(taps, (0, -taps.shape[0] % rows))
    return taps.reshape(-1, rows).sum(-1).float()


def _anatomy_launch(phase, x_padded, w4, bias4, reps, a_dense, engine: bool):
    """Checks P1's arguments and runs it: the plain version on a CPU
    tensor, else one launch of the phase on the wgmma mainloop (bfloat16,
    counted in ``conv_s2d.SHAPES``) or the engine (float32, counted; or
    either dtype with ``engine``, uncounted)."""
    b, n, c4 = K._check_plane("kernel_anatomy", x_padded)
    co4 = w4.shape[-1]
    K._check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    K._require(phase in ANATOMY_PHASES, f"unknown phase {phase!r}")
    K._require(isinstance(reps, int) and reps >= 1, f"reps must be a positive int, got {reps!r}")
    dense = (a_dense,) if phase == "matmul_only" else ()
    if dense:
        K._require(a_dense is not None and tuple(a_dense.shape) == (b * n * n, 4 * c4)
                   and a_dense.dtype == x_padded.dtype,
                   f"matmul_only takes a_dense {x_padded.dtype} {(b * n * n, 4 * c4)}")
    if not K._on_cuda(x_padded, w4, bias4, *dense):
        return kernel_anatomy_plain(phase, x_padded, w4, bias4, a_dense)
    K._check_kernel_widths(co4, c4)
    dev, dt = x_padded.device, x_padded.dtype
    wgmma = dt == torch.bfloat16 and not engine
    K._require(not wgmma or co4 <= 128,
               f"kernel_anatomy: the mainloop's phases take 4Co <= 128 in bfloat16, got {co4}")
    out = sums = None
    if phase == "stage_only":
        rows = stage_tile_rows(co4, dt, n, c4) if wgmma else engine_tile_rows(co4, dt)
        sums = torch.empty(-(-b * n * n // rows), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (ANATOMY_PHASES[phase], x_padded.data_ptr(), ptr(a_dense if dense else None),
            w4.data_ptr(), bias4.data_ptr(), ptr(out), ptr(sums), b, n, c4, co4, reps,
            _cuda.stream(dev))
    with torch.cuda.device(dev):
        if engine:
            _cuda.check(_cuda.library().depgan_s2d_gemm_probe(_cuda.DTYPE_CODES[dt], *args),
                        "kernel_anatomy_engine")
        elif wgmma:
            K._launch(f"kernel_anatomy[{phase}]", (b, n, c4, co4, reps), "depgan_wgmma_probe",
                      *args)
        else:
            K._launch(f"kernel_anatomy[{phase}]", (b, n, c4, co4, reps), "depgan_s2d_gemm_probe",
                      _cuda.DTYPE_CODES[dt], *args)
    return sums if phase == "stage_only" else out


def kernel_anatomy(phase, x_padded, w4, bias4, reps=1, a_dense=None):
    """One launch of P1's ``phase``, each tile's phase repeated ``reps``
    times inside it: on the wgmma mainloop in bfloat16 (4Co <= 128), on the
    engine in float32. Arguments as ``conv_s2d._conv3x3_s2d_impl`` (relu),
    with ``a_dense`` (B*n*n, 16C) in the plane's dtype for ``matmul_only``.
    Returns the padded output plane, or for ``stage_only`` the float32 sums
    of each tile of ``stage_tile_rows`` rows."""
    return _anatomy_launch(phase, x_padded, w4, bias4, reps, a_dense, engine=False)


def kernel_anatomy_engine(phase, x_padded, w4, bias4, reps=1, a_dense=None):
    """P1 on the GEMM engine's Phase argument in either dtype: bfloat16's
    route before the mainloop took it over. A reference for ``chip_smoke.py``
    to time in turns with ``kernel_anatomy``: no path calls it, and it counts
    no launch. stage_only sums over the engine's tiles."""
    return _anatomy_launch(phase, x_padded, w4, bias4, reps, a_dense, engine=True)


def conv3x3_engine(x_padded, w4, bias4, gamma4=None, beta4=None, mode="relu", x2_padded=None,
                   w4_2=None, pool=None):
    """The GEMM engine's K1 (``mode`` relu, film or none), with ``pool``
    ('s2d' or 'pixel', relu) its K2, or with ``x2_padded`` and ``w4_2`` its
    K3 (relu), on a CUDA tensor in either dtype: what ``conv_s2d``'s
    wrappers launched in bfloat16 before the wgmma mainloop took them over,
    and what the chains (K10, K12) and P1, P2 sum like. A reference for
    ``chip_smoke.py`` and the card's tests: no path calls it, and it counts
    no launch. Arguments as ``conv_s2d._conv3x3_s2d_impl``,
    ``conv3x3_s2d_fused_pool`` and ``_conv2_impl``; returns (out, pooled)
    with a pool, else out."""
    b, n, c4 = K._check_plane("conv3x3_engine", x_padded)
    co4 = w4.shape[-1]
    K._check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    two = x2_padded is not None
    K._require(mode in K._EPILOGUES and (not two or mode == "relu"), f"bad mode {mode!r}")
    K._require(pool is None or (pool in K._POOLS and mode == "relu" and not two
                                and (pool != "s2d" or n % 2 == 0)), f"bad pool {pool!r}")
    c4b = x2_padded.shape[-1] if two else 0
    if two:
        K._require(tuple(x2_padded.shape[:3]) == tuple(x_padded.shape[:3]),
                   "x and x2 must share batch and plane size")
        K._check_weight("w4_2", w4_2, (2, 2, c4b, co4), x_padded.dtype)
    film = mode == "film"
    if film:
        K._check_f32("gamma4", gamma4, (b, c4))
        K._check_f32("beta4", beta4, (b, c4))
    extra = [t for t in (x2_padded, w4_2, gamma4 if film else None, beta4 if film else None)
             if t is not None]
    if not K._on_cuda(x_padded, w4, bias4, *extra):
        if two:
            return K.conv3x3_s2d_fused2_plain(x_padded, x2_padded, w4, w4_2, bias4)
        if pool is not None:
            return K.conv3x3_s2d_fused_pool_plain(x_padded, w4, bias4, pool)
        return K.conv3x3_s2d_fused_plain(x_padded, w4, bias4, gamma4, beta4, mode)
    K._check_kernel_widths(co4, c4, *((c4b,) if two else ()))
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    pooled = None
    if pool == "s2d":
        pooled = torch.empty((b, n // 2 + 2, n // 2 + 2, co4), dtype=dt, device=dev)
    elif pool == "pixel":
        pooled = torch.empty((b, n, n, co4 // 4), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_conv3x3_s2d_engine(
            _cuda.DTYPE_CODES[dt], x_padded.data_ptr(), ptr(x2_padded), w4.data_ptr(),
            ptr(w4_2), bias4.data_ptr(), ptr(gamma4 if film else None),
            ptr(beta4 if film else None), out.data_ptr(), ptr(pooled), b, n, c4, c4b, co4,
            K._EPILOGUES[mode], K._POOLS.get(pool, 0), _cuda.stream(dev)), "conv3x3_engine")
    return out if pool is None else (out, pooled)


def conv5x5_engine(x_padded, w9, bias4, mode="relu"):
    """The GEMM engine's K7 on a CUDA tensor in either dtype: what
    ``conv_s2d._conv5_impl`` launched in bfloat16 before the wgmma mainloop
    took it over. A reference for ``chip_smoke.py`` and the card's tests: no
    path calls it, and it counts no launch. Arguments as ``_conv5_impl``."""
    b, n, c4 = K._check_plane("conv5x5_engine", x_padded)
    co4 = w9.shape[-1]
    K._check_weight("w9", w9, (3, 3, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    K._require(mode in ("relu", "none"), f"bad mode {mode!r}")
    if not K._on_cuda(x_padded, w9, bias4):
        return K.conv5x5_s2d_fused_plain(x_padded, w9, bias4, mode)
    K._check_kernel_widths(co4, c4, run=8)
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_conv5x5_s2d_engine(
            _cuda.DTYPE_CODES[dt], x_padded.data_ptr(), w9.data_ptr(), bias4.data_ptr(),
            out.data_ptr(), b, n, c4, co4, K._EPILOGUES[mode], _cuda.stream(dev)),
            "conv5x5_engine")
    return out


def conv3x3_head_engine(x_padded, w4, bias4, w_head4, b_head4):
    """The GEMM engine's K9 on a CUDA tensor in either dtype: what
    ``conv_s2d.conv3x3_s2d_fused_head`` launched in bfloat16 before the wgmma
    mainloop took it over. A reference for ``chip_smoke.py`` and the card's
    tests: no path calls it, and it counts no launch. Arguments as
    ``conv3x3_s2d_fused_head``."""
    b, n, c4 = K._check_plane("conv3x3_head_engine", x_padded)
    co4 = w4.shape[-1]
    K._check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    h4 = w_head4.shape[-1]
    K._check_f32("w_head4", w_head4, (1, 1, co4, h4))
    K._check_f32("b_head4", b_head4, (h4,))
    if not K._on_cuda(x_padded, w4, bias4, w_head4, b_head4):
        return K.conv3x3_s2d_fused_head_plain(x_padded, w4, bias4, w_head4, b_head4)
    K._require(co4 <= 256 and h4 <= 16, f"the engine's head takes 4Co <= 256 and Ho4 <= 16, "
                                        f"got {co4}, {h4}")
    K._check_kernel_widths(co4, c4)
    dev = x_padded.device
    w_head = w_head4.reshape(co4, h4).to(torch.bfloat16).contiguous()
    out = torch.empty((b, n, n, h4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_conv3x3_s2d_fused_head_engine(
            _cuda.DTYPE_CODES[x_padded.dtype], x_padded.data_ptr(), w4.data_ptr(),
            bias4.data_ptr(), w_head.data_ptr(), b_head4.data_ptr(), out.data_ptr(), b, n, c4,
            co4, h4, _cuda.stream(dev)), "conv3x3_head_engine")
    return out


def deconv_engine(x_padded, w2, bias4):
    """The GEMM engine's K4 on a CUDA tensor in either dtype: what
    ``conv_s2d._deconv_impl`` launched in bfloat16 before the wgmma deconv
    took it over. A reference for ``chip_smoke.py`` and the card's tests: no
    path calls it, and it counts no launch. Arguments as ``_deconv_impl``."""
    b, m, c4 = K._check_plane("deconv_engine", x_padded)
    o4 = w2.shape[-1]
    K._check_weight("w2", w2, (c4 // 4, o4), x_padded.dtype)
    K._check_f32("bias4", bias4, (o4,))
    if not K._on_cuda(x_padded, w2, bias4):
        return K.deconv_s2d_plain(x_padded, w2, bias4)
    K._check_kernel_widths(o4, c4)
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, 2 * m + 2, 2 * m + 2, o4), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_deconv_s2d_engine(
            _cuda.DTYPE_CODES[dt], x_padded.data_ptr(), w2.data_ptr(), bias4.data_ptr(),
            out.data_ptr(), b, m, c4, o4, _cuda.stream(dev)), "deconv_engine")
    return out


def conv5x5_packed_mma_sync(x_padded, w9, bias4, mode="relu"):
    """K11 on ``window_conv`` (``csrc/window_kernels.cu``, ``mma.sync``) in
    either dtype: bfloat16's route before the wgmma window took it over. A
    reference for ``chip_smoke.py`` to time in turns with K11 and for the
    card's tests: no path calls it, and it counts no launch. Arguments as
    ``conv_s2d._conv5_impl``."""
    b, n, c4 = K._check_plane("conv5x5_packed_mma_sync", x_padded)
    co4 = w9.shape[-1]
    K._check_weight("w9", w9, (3, 3, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    K._require(mode in ("relu", "none"), f"bad mode {mode!r}")
    if not K._on_cuda(x_padded, w9, bias4):
        return K.conv5x5_s2d_fused_plain(x_padded, w9, bias4, mode)
    K._check_kernel_widths(co4, c4, run=8)
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_conv5x5_s2d_packed(
            _cuda.DTYPE_CODES[dt], x_padded.data_ptr(), w9.data_ptr(), bias4.data_ptr(),
            out.data_ptr(), b, n, c4, co4, K._EPILOGUES[mode], _cuda.stream(dev)),
            "conv5x5_packed_mma_sync")
    return out


def conv3x3_chain3_wmma(x_padded, w1a4, bias14, wf4, biasf4, gamma4, beta4, w34, bias34,
                        x2_padded=None, w1b4=None, pool=""):
    """K10 on ``s2d_chain`` (``csrc/chain_kernels.cu``, the engine's wmma)
    in either dtype: bfloat16's route before the wgmma chain took it over.
    A reference for ``chip_smoke.py`` to time in turns with K10: no path
    calls it, and it counts no launch. Arguments and result as
    ``conv_s2d.conv3x3_s2d_chain3``, whose checks it leaves to that call."""
    if not K._on_cuda(x_padded, w1a4, wf4, w34):
        return K.conv3x3_s2d_chain3_plain(x_padded, w1a4, bias14, wf4, biasf4, gamma4, beta4,
                                          w34, bias34, x2_padded, w1b4, pool)
    b, n, c4o = x_padded.shape[0], x_padded.shape[1] - 2, w34.shape[-1]
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, n + 2, n + 2, c4o), dtype=dt, device=dev)
    pooled = None
    if pool == "s2d":
        pooled = torch.empty((b, n // 2 + 2, n // 2 + 2, c4o), dtype=dt, device=dev)
    elif pool == "pixel":
        pooled = torch.empty((b, n, n, c4o // 4), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        _cuda.check(_cuda.library().depgan_conv3x3_s2d_chain(
            _cuda.DTYPE_CODES[dt], *(ptr(t) for t in (
                x_padded, x2_padded, w1a4, w1b4, bias14, wf4, biasf4, w34, bias34, gamma4, beta4,
                out, pooled)),
            b, n, x_padded.shape[-1], 0 if x2_padded is None else x2_padded.shape[-1],
            w1a4.shape[-1], c4o, K._EPILOGUES["relu"], K._EPILOGUES["film"],
            K._EPILOGUES["relu"], K._POOLS.get(pool, 0), _cuda.stream(dev)),
            "conv3x3_chain3_wmma")
    return (out, pooled) if pool else out


def conv3x3_rowblk_plain(x_padded, w4, bias4, n_blocks):
    """The relu 3x3 conv: how the output is blocked does not change it."""
    return K.conv3x3_s2d_fused_plain(x_padded, w4, bias4)


def _rowblk_launch(x_padded, w4, bias4, n_blocks: int, window: bool):
    """Checks P2's arguments and runs it: the plain version on a CPU tensor,
    else the wgmma window kernel (bfloat16) or ``window_conv`` (float32),
    counted; with ``window``, ``window_conv`` in either dtype, uncounted."""
    b, n, c4 = K._check_plane("conv3x3_rowblk", x_padded)
    co4 = w4.shape[-1]
    K._check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    K._check_f32("bias4", bias4, (co4,))
    K._require(isinstance(n_blocks, int) and n_blocks >= 1 and (n + 2) % n_blocks == 0,
               f"n_blocks must divide the padded side {n + 2}, got {n_blocks!r}")
    if not K._on_cuda(x_padded, w4, bias4):
        return conv3x3_rowblk_plain(x_padded, w4, bias4, n_blocks)
    K._check_kernel_widths(co4, c4)
    dev, dt = x_padded.device, x_padded.dtype
    wgmma = dt == torch.bfloat16 and not window
    if wgmma:
        W.window(n, c4, co4)  # raises for what the window kernel refuses
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    args = (x_padded.data_ptr(), w4.data_ptr(), bias4.data_ptr(), out.data_ptr(), b, n, c4, co4,
            n_blocks, _cuda.stream(dev))
    with torch.cuda.device(dev):
        if window:
            _cuda.check(_cuda.library().depgan_conv3x3_rowblk(_cuda.DTYPE_CODES[dt], *args),
                        "conv3x3_rowblk_window")
        elif wgmma:
            K._launch("conv3x3_rowblk", (b, n, c4, co4, n_blocks), "depgan_conv3x3_rowblk_wgmma",
                      *args)
        else:
            K._launch("conv3x3_rowblk", (b, n, c4, co4, n_blocks), "depgan_conv3x3_rowblk",
                      _cuda.DTYPE_CODES[dt], *args)
    return out


def conv3x3_rowblk(x_padded, w4, bias4, n_blocks: int):
    """K1's relu conv, padded s2d (B, N+2, N+2, 4C) -> (B, N+2, N+2, 4Co),
    with the output cut into ``n_blocks`` blocks of (N+2)/n_blocks padded
    rows an image, each staging its input rows once: the wgmma window
    kernel in bfloat16 (4C a multiple of 64, N+2 <= 256), ``window_conv``
    in float32. ``n_blocks`` divides N+2."""
    return _rowblk_launch(x_padded, w4, bias4, n_blocks, window=False)


def conv3x3_rowblk_window(x_padded, w4, bias4, n_blocks: int):
    """P2 on ``window_conv`` (``csrc/window_kernels.cu``, ``mma.sync``) in
    either dtype: bfloat16's route before the mainloop took it over. A
    reference for ``chip_smoke.py`` to time in turns with
    ``conv3x3_rowblk``: no path calls it, and it counts no launch."""
    return _rowblk_launch(x_padded, w4, bias4, n_blocks, window=True)


def deint_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, n, 2m, c) -> (B, n, m, 2c): even columns in [:c], odd in [c:]
    (the JAX probe's ``xla_strided``)."""
    return torch.cat((x[:, :, 0::2], x[:, :, 1::2]), dim=-1)


def deint(x: torch.Tensor, kind: str = "reshape_idx") -> torch.Tensor:
    """The column deinterleave of ``deint_plain`` through the kernel
    ``kind``: 'reshape_idx' (index decode) or 'merge' (a flat copy). The
    kernels take c channels of a multiple of 16 bytes."""
    K._require(kind in DEINT_KINDS, f"unknown deinterleave {kind!r}")
    K._require(x.ndim == 4 and x.shape[2] % 2 == 0,
               f"deint: expected (B, n, 2m, c), got {tuple(x.shape)}")
    if not K._on_cuda(x):
        return deint_plain(x)
    b, n, m2, c = x.shape
    K._require(c * x.element_size() % 16 == 0,
               f"deint: the kernels take c of a multiple of 16 bytes, got {c} x {x.dtype}")
    out = torch.empty((b, n, m2 // 2, 2 * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        K._launch(f"deint_{kind}", (b, n, m2 // 2, c), "depgan_deint", DEINT_KINDS[kind],
                  x.data_ptr(), out.data_ptr(), b * n, m2 // 2, c * x.element_size(),
                  _cuda.stream(x.device))
    return out
