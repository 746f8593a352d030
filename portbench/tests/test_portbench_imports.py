"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``depgan_tpu_torch`` is not ``depgan_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "depgan_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert "depgan_tpu_torch" not in _top_level_imports(path), path.name


def test_the_whole_name_is_compared(monkeypatch):
    import sys
    import types

    from portbench import run

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("depgan_tpu_torch", "depgan_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "depgan_tpu.config", types.ModuleType("depgan_tpu.config"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["depgan_tpu", "jax"]


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_a_module_loaded_by_a_metric_reader_stops_the_result(reader_loads_jax, monkeypatch,
                                                             capsys):
    """The look at ``sys.modules`` comes after the per-layer readers: one
    that pulls in JAX by a side road still leaves the run without a result."""
    import sys
    import types

    from portbench import cell as cells
    from portbench import run

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    trace = types.SimpleNamespace(busy_s=0.5, window_s=1.0, device_ops=lambda: [],
                                  idle_gaps=lambda: [])
    out = {"correct": True, "attempted": 1, "failed": 0, "end_to_end": {},
           "memory_peak_bytes": 0, "trace": trace, "counters": {}, "compared": []}
    driver = types.SimpleNamespace(run=lambda *a: out)
    monkeypatch.setattr(run.importlib, "import_module", lambda name: driver)

    def reader(ctx):
        if reader_loads_jax:
            sys.modules["jax"] = types.ModuleType("jax")
        return 1.0

    monkeypatch.setattr(cells, "metric_reader", lambda name: reader)
    rc = run.main(["--workload", "depgan-serve-1c", "--seed", "1", "--seconds", "1",
                   "--trace", "1"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    sys.modules.pop("jax", None)
    if reader_loads_jax:
        assert rc == 3 and not any(line.startswith("{") for line in lines)
    else:
        assert rc == 0 and lines[-1].startswith('{"correct": true')
