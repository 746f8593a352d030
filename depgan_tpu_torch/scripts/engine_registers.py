"""What ptxas allocated for the GEMM engine's kernels: registers, stack
frame and spill bytes of every ``s2d_gemm`` instantiation (dtype, N tile,
phase), from ``nvcc -Xptxas -v``; ``wgmma_figures`` reads the same for the
wgmma mainloop of K1, K2, K3, K7, K9 and P1 (``s2d_wgmma``: N tile, m64
tiles a consumer warpgroup, K2's pooled epilogue or not, production or a P1
phase, K9's head epilogue or not), for P2's window kernel on it
(``rowblk_wgmma``: N tile, m64 tiles), for K11's (``conv5_wgmma``: N tile,
m64 tiles), for K10's chain (``chain_wgmma``: N tile, m64 tiles, K2's
pooled epilogue or not) and for K4's deconv (``deconv_wgmma``: N tile).

With no argument it reads the report kept beside the port's built library
(``ops/_cuda.py``). Given source directories (another checkout's
``depgan_tpu_torch/csrc``), it compiles each one's ``s2d_kernels.cu``, which
holds the production instantiations, with the port's flags into the build
directory and prints the same table for each, so two trees can be compared
on one machine:

    python -m depgan_tpu_torch.scripts.engine_registers [csrc_dir ...]
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

_NAME = re.compile(r"8s2d_gemmI(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?E")
_WGMMA = re.compile(r"9s2d_wgmmaILi(\d+)ELi(\d+)ELb([01])ELi(\d+)ELb([01])EE")
_ROWBLK = re.compile(r"(12rowblk_wgmma|11conv5_wgmma)ILi(\d+)ELi(\d+)EE")
_CHAIN = re.compile(r"11chain_wgmmaILi(\d+)ELi(\d+)ELb([01])EE")
_DECONV = re.compile(r"12deconv_wgmmaILi(\d+)EE")
PHASE_NAMES = {0: "production", 1: "probe full", 2: "probe no_epi", 3: "probe matmul_only",
               4: "probe stage_only"}


def engine_figures(log: str) -> dict[tuple, dict[str, int]]:
    """(dtype, N tile, phase) -> registers, stack, spill stores and loads of
    each ``s2d_gemm`` kernel in a ptxas ``-v`` report."""
    from depgan_tpu_torch.ops._cuda import ptxas_figures

    rows = {}
    for name, fig in ptxas_figures(log).items():
        if m := _NAME.search(name):
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            rows[dtype, int(m.group(2)), PHASE_NAMES[int(m.group(3) or 0)]] = fig
    return dict(sorted(rows.items()))


def wgmma_name(bn: int, mt: int, pool: bool | None = None, phase: int = 0,
               kernel: str = "", head: bool = False) -> str:
    """An instantiation's name: ``s2d_wgmma<BN, MT, POOL, phase>`` (with
    ``head``: ``s2d_wgmma<BN, MT, false, production, head>``),
    ``rowblk_wgmma<BN, MT>`` where ``pool`` is None, or the ``kernel``
    named: ``conv5_wgmma<BN, MT>``, ``chain_wgmma<BN, MT, POOL>``,
    ``deconv_wgmma<BN>``."""
    if kernel == "deconv_wgmma":
        return f"deconv_wgmma<{bn}>"
    if kernel == "chain_wgmma":
        return f"chain_wgmma<{bn}, {mt}, {str(pool).lower()}>"
    if kernel or pool is None:
        return f"{kernel or 'rowblk_wgmma'}<{bn}, {mt}>"
    return (f"s2d_wgmma<{bn}, {mt}, {str(pool).lower()}, {PHASE_NAMES[phase]}"
            f"{', head' if head else ''}>")


def wgmma_figures(log: str) -> dict[str, dict[str, int]]:
    """``wgmma_name`` -> registers, stack, spill stores and loads of each
    ``s2d_wgmma``, ``rowblk_wgmma``, ``conv5_wgmma``, ``chain_wgmma`` and
    ``deconv_wgmma`` kernel in a ptxas ``-v`` report."""
    from depgan_tpu_torch.ops._cuda import ptxas_figures

    rows = {}
    for name, fig in ptxas_figures(log).items():
        if m := _WGMMA.search(name):
            rows[wgmma_name(int(m.group(1)), int(m.group(2)), m.group(3) == "1",
                            int(m.group(4)), head=m.group(5) == "1")] = fig
        elif m := _ROWBLK.search(name):
            rows[wgmma_name(int(m.group(2)), int(m.group(3)), kernel=m.group(1)[2:])] = fig
        elif m := _CHAIN.search(name):
            rows[wgmma_name(int(m.group(1)), int(m.group(2)), m.group(3) == "1",
                            kernel="chain_wgmma")] = fig
        elif m := _DECONV.search(name):
            rows[wgmma_name(int(m.group(1)), 0, kernel="deconv_wgmma")] = fig
    return dict(sorted(rows.items()))


def format_rows(rows: dict) -> list[str]:
    return [f"s2d_gemm<{dt}, {bn}> {phase}: {f.get('registers')} registers, {f.get('stack')} "
            f"bytes stack frame, {f.get('spill_stores')} / {f.get('spill_loads')} bytes spill "
            f"stores / loads" for (dt, bn, phase), f in rows.items()]


def compile_report(csrc: Path) -> str:
    """ptxas's report for ``csrc/s2d_kernels.cu``, compiled with the port's
    flags into the build directory."""
    from depgan_tpu_torch.ops import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _cuda.BUILD_DIR / f"engine_registers.{abs(hash(str(csrc)))}.o"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *_cuda.COMPILE_FLAGS, "-c", "-o",
                           str(obj), str(csrc / "s2d_kernels.cu")],
                          capture_output=True, text=True, check=True)
    obj.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def main(argv=None) -> dict:
    from depgan_tpu_torch.ops import _cuda

    dirs = sys.argv[1:] if argv is None else argv
    reports = {str(d): compile_report(Path(d)) for d in dirs} or {"built": _cuda.ptxas_log()}
    tables = {}
    for what, log in reports.items():
        tables[what] = engine_figures(log)
        print(f"engine registers ({what}):")
        for line in format_rows(tables[what]):
            print(f"  {line}")
    return tables


if __name__ == "__main__":
    main()
