"""On the card: one short run of each cell through the benchmark's own
command, with ``correct`` true and the result's keys in place. Skips
without a CUDA device (the harness itself refuses to run there)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import cell as cells

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "4294967311", "--seconds", "4", "--trace", "0"],
                         cwd=cells.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
    assert {m["name"] for m in cells.load(workload).end_to_end} == set(result["metrics"])


def test_without_a_card_the_harness_refuses(monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err
