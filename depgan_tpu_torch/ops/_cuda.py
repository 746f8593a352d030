"""Build and bind the hand-written CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all at once, and the objects are linked into
one shared library under ``build/depgan_tpu_torch/`` of the checkout, named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. The library has a plain C
interface and is bound with ``ctypes``: pointers and the CUDA stream pass as
``c_void_p``; each entry point returns ``cudaGetLastError()`` after its
launch, which ``check`` turns into an exception. Each source compiles with
``-Xptxas -v``, and what ptxas reports (registers, stack frame and spills of
every kernel) is kept beside the library, ``ptxas_log()`` reads it and
``ptxas_figures`` parses it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "depgan_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
COMPILE_FLAGS = ("-Xptxas", "-v")  # what ptxas allocated, kept in the build directory

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # dtype, x, w4, bias, gamma, beta, out, pooled, batch, n, c4, co4,
    # epilogue, pool, stream
    "depgan_conv3x3_s2d_fused": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x1, x2, w1, w2, bias, out, batch, n, c4a, c4b, co4, stream
    "depgan_conv3x3_s2d_fused2": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, x, w2, bias, out, batch, m, c4, o4, stream
    "depgan_deconv_s2d": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "depgan_deconv_s2d_engine": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, x, w9, bias, out, batch, n, c4, co4, epilogue, stream
    "depgan_conv5x5_s2d_fused": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, x, out, batch, n, c4, stream
    "depgan_pool_s2d": [_I, _P, _P, _I, _I, _I, _P],
    "depgan_pool_to_s2d": [_I, _P, _P, _I, _I, _I, _P],
    # dtype, h, gamma, beta, trunk, out, batch, hw, c, stream
    "depgan_film_residual": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, x, w4, bias, w_head (bf16), b_head, out, batch, n, c4, co4, h4, stream
    "depgan_conv3x3_s2d_fused_head": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "depgan_conv3x3_s2d_fused_head_engine": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                             _P],
    # dtype, x1, x2, w1a, w1b, b1, w2, b2, w3, b3, gamma, beta, out, pooled,
    # batch, n, c4a, c4b, c4m, c4o, mode1, mode2, mode3, pool, stream
    "depgan_conv3x3_s2d_chain": [_I] + [_P] * 13 + [_I] * 10 + [_P],
    # dtype, x, w9, bias, out, batch, n, c4, co4, epilogue, stream
    "depgan_conv5x5_s2d_packed": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, x, w4, bias, out, batch, n, c4, co4, n_blocks, stream
    "depgan_conv3x3_rowblk": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, phase, x, a_dense, w4, bias, out, sums, batch, n, c4, co4, reps, stream
    "depgan_s2d_gemm_probe": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # phase, x, a_dense, w4, bias, out, sums, batch, n, c4, co4, reps, stream (bf16)
    "depgan_wgmma_probe": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w4, bias, out, batch, n, c4, co4, units, stream (bf16)
    "depgan_conv3x3_rowblk_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # kind, x, out, rows, m, c_bytes, stream
    "depgan_deint": [_I, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # dtype, x1, x2, w1, w2, bias, gamma, beta, out, pooled, batch, n, c4a,
    # c4b, co4, epilogue, pool, stream
    "depgan_conv3x3_s2d_engine": [_I] + [_P] * 9 + [_I] * 7 + [_P],
    # dtype, x, w9, bias, out, batch, n, c4, co4, epilogue, stream
    "depgan_conv5x5_s2d_engine": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w9, bias, out, batch, n, c4, co4, epilogue, stream (bf16)
    "depgan_conv5x5_s2d_window": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x1, x2, w1a, w1b, b1, w2, b2, w3, b3, gamma, beta, out, pooled, batch,
    # n, c4a, c4b, c4m, c4o, pool, stream (bf16)
    "depgan_conv3x3_s2d_chain3_wgmma": [_P] * 13 + [_I] * 7 + [_P],
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: building the kernels needs the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS + COMPILE_FLAGS:
        digest.update(flag.encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdepgan_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Builds the kernels if needed, loads them and declares their types."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.depgan_cuda_error_string.argtypes = [_I]
    lib.depgan_cuda_error_string.restype = ctypes.c_char_p
    # n, c4a, c4b, co4, gather, pool, out, cap -> ints written (a query, no launch)
    lib.depgan_wgmma_plan.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_int), _I]
    lib.depgan_wgmma_plan.restype = ctypes.c_int
    # n, c4, co4, out, cap -> ints written (P2's window, a query)
    lib.depgan_rowblk_plan.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int), _I]
    lib.depgan_rowblk_plan.restype = ctypes.c_int
    # n, c4, co4, out, cap -> ints written (K11's window, a query)
    lib.depgan_conv5_window_plan.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int), _I]
    lib.depgan_conv5_window_plan.restype = ctypes.c_int
    # n, c4a, c4b, c4m, c4o, pool, out, cap -> ints written (K10's plan, a query)
    lib.depgan_chain_plan.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_int), _I]
    lib.depgan_chain_plan.restype = ctypes.c_int
    # m, c4, o4, out, cap -> ints written (K4's plan, a query)
    lib.depgan_deconv_plan.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int), _I]
    lib.depgan_deconv_plan.restype = ctypes.c_int
    return lib


def _nvcc_all(commands: dict[str, list[str]]) -> str:
    """Runs the nvcc commands all at once; raises with the output of every
    one that failed, else returns what they printed."""
    procs = {what: subprocess.Popen([_nvcc(), *NVCC_FLAGS, *args], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for what, args in commands.items()}
    failed, printed = [], []
    for what, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{what}: nvcc failed with code {proc.returncode}:\n{out}\n{err}")
        printed.append(f"{what}:\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "\n".join(printed)


def _build(so: Path) -> None:
    """Compiles each source to an object, all at once, then links them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))}
    log = _nvcc_all({src.name: [*COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                     for src, obj in objs.items()})
    tmp = so.with_name(f"{tag}.so.tmp")
    _nvcc_all({"link": ["-shared", "-o", str(tmp), *map(str, objs.values())]})
    _log_path(so).write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    for obj in objs.values():
        obj.unlink()


def _log_path(so: Path) -> Path:
    return so.with_suffix(".ptxas.txt")


def ptxas_log() -> str:
    """What ptxas printed while building the current library (built if
    needed)."""
    library()
    return _log_path(library_path()).read_text()


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_figures(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's registers, stack frame and spill bytes from ptxas's
    ``-v`` report, keyed by the kernel's mangled name."""
    figures: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            figures[entry] = {}
        elif entry and (m := _FRAME.search(line)):
            figures[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        elif entry and (m := _REGS.search(line)):
            figures[entry]["registers"] = int(m.group(1))
    return figures


def check(code: int, what: str) -> None:
    """Raises if a launch returned a CUDA error."""
    if code != 0:
        msg = library().depgan_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
