"""The benchmark's files: found by name, and held to the benchmark's
contract (keys, names, bounds, the reference's parameters beside the
program's)."""

from __future__ import annotations

import copy
import json
import re

import pytest
import torch

from portbench import cell as cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(workload):
    cell = cells.load(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["driver"] in ("serve", "gan_train", "uresnet_train")
    assert cell.reference() is not None
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
        assert m["moves"] in names
    for key, limit in cell.limits.items():
        if isinstance(limit, dict):
            assert limit["limit"] > 0, key


def test_benchmark_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert json.loads((cells.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_float32_mixes_state_the_tf32_products_their_peak_stands_on():
    from portbench.drivers import common

    f32 = [c for c in (cells.load(w["name"]) for w in BENCH["workloads"])
           if c.traffic["compute_dtype"] == "float32"]
    assert f32 and all(c.traffic["products"] == "tf32" for c in f32)
    cell, before = copy.deepcopy(f32[0]), torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        common.set_products(cell)
        assert torch.backends.cudnn.allow_tf32
        del cell.traffic["products"]
        with pytest.raises(ValueError, match="tf32"):
            common.set_products(cell)
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("config", ["depgan-256", "depuresnet-256"])
def test_reference_parameters_match_the_programs(config):
    """The benchmark makes its weights under the reference's names and
    shapes; the program's modules must take exactly those."""
    from depgan_tpu_torch.config import ModelConfig
    from depgan_tpu_torch.models import DisC2DFCN1, GenUNet2D

    from portbench.reference import nets

    cfg = json.loads((cells.ROOT / f"portbench/configs/{config}.json").read_text())
    mc = ModelConfig(**{k: cfg[k] for k in ("image_size", "noise_size", "first_fm",
                                            "n_input_channels", "n_out", "dropout_mode",
                                            "dropout_rate")})
    gen = GenUNet2D(mc, device="meta")
    program = [(k, tuple(v.shape)) for k, v in gen.named_parameters()]
    program += [(k, tuple(v.shape)) for k, v in gen.named_buffers()]
    assert sorted(program) == sorted((k, s) for k, s, _ in nets.generator_spec(cfg))
    critic = [(k, tuple(v.shape)) for k, v in DisC2DFCN1(mc, device="meta").named_parameters()]
    assert critic == [(k, s) for k, s, _ in nets.critic_spec(cfg)]
