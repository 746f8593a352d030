"""A benchmark cell and the files it is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix. The harness then reads:

- ``portbench/configs/<config>.json``: the model's published sizes and
  training settings;
- ``portbench/reference/<config>.py``: its plain PyTorch reference;
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names the general generator in ``portbench/drivers/`` that reads it;
- ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``, with the readings they were set from;
- ``portbench/metrics/<metric>.py``: one reader a per-layer metric.

A later cell, configuration, mix or metric is a new file and a new entry,
and no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def reference(self):
        return _load_module(HERE / "reference" / f"{self.config_name}.py",
                            f"portbench_reference_{self.config_name.replace('-', '_')}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=w["chips"], config_name=w["config"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    return _load_module(HERE / "metrics" / f"{name}.py",
                        "portbench_metric_" + name.replace(".", "_").replace("-", "_")).read
