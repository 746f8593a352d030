"""Runs one cell of the benchmark of ``depgan_tpu_torch`` on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, weights and inputs made on
the device from the seed, the program built and every shape the cell uses
warmed up) is ``setup_s``; then the cell's traffic runs for ``--seconds``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profile of the first part
of the window. After the window the program's outputs are compared with
the plain reference (``portbench/reference/``); each number compared is
printed beside its limit as the last lines of standard error and under
``compared``, the last key of the result. The result is the last line of
standard output.

Exits with 2 and prints no result without a CUDA device (or with fewer
than the cell's chips), and with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import cell as cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "depgan_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None, device: str = "cuda", t_start: float | None = None, cell=None) -> int:
    """Runs the cell; returns the exit code. Tests only: ``device='cpu'``
    skips the look for a card and runs the program's plain versions, and
    ``cell`` replaces the cell named by ``--workload``."""
    args = _args(argv)
    cell = cell if cell is not None else cells.load(args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from portbench.drivers import common

    common.set_products(cell)
    if device == "cuda":
        print(f"card: {_power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}; "
              f"tf32 cudnn {torch.backends.cudnn.allow_tf32} "
              f"matmul {torch.backends.cuda.matmul.allow_tf32}", flush=True)

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START if t_start is None else t_start)

    if args.trace:
        ctx = SimpleNamespace(trace=out["trace"], cell=cell, **out["counters"])
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace:
        trace = out["trace"]
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in out["compared"]}
    found = forbidden_modules()  # after the window, the readers and the reference
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, limit in out["compared"]:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
