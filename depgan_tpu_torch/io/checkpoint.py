"""Checkpoints of the full training state, resume, and the ``.h5`` export.

Counterpart of ``depgan_tpu/io/checkpoint.py`` (:34-135). The reference
persists only the generator's weights, overwriting one .h5 every generator
iteration, with no optimizer state and no resume
(`...twoCritics_training_4fold.py:892`). Here the full state (generator,
both critics, each Adam's step count and moments, the BatchNorm
statistics, the iteration counters) is saved atomically and training
resumes exactly, the warm-up schedule included, which reads the restored
counters.

orbax is JAX's, so the port keeps its own format: ``<directory>/<step>/``
holds ``state.pt``, a flat dict of the state's leaves (``torch.save`` of
CPU tensors and ints, loaded with ``weights_only=True``) keyed by their
tree path (``g_params/block_gen_0/conv2d_gen_0/kernel``,
``g_opt/count``), and ``meta.json``, the counters and extras (orbax's
``meta``). A step is written under a temporary name and renamed into
place, so a step directory is whole or absent; the newest ``max_to_keep``
steps are kept. The port reads its own checkpoints, not orbax directories.

``export_generator_h5`` and ``export_uresnet_h5`` write the generator in
the reference's Keras .h5 layout (``io/h5_import.py``, which imports h5py
when called).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..train.state import Counters, GanTrainState, UResNetTrainState
from . import h5_import
from .flax_bridge import (gan_train_state_from_trees, gan_trees_from_state, numpy_tree,
                          uresnet_train_state_from_trees, uresnet_trees_from_state)

STATE_FILE, META_FILE = "state.pt", "meta.json"


def _flat_leaves(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> ``{"a/b/c": leaf}``, numpy leaves as tensors."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flat_leaves(value, name + "/"))
        else:
            flat[name] = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
    return flat


def _nested(flat: dict) -> dict:
    """Inverse of ``_flat_leaves``, tensor leaves back to numpy."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.numpy() if isinstance(value, torch.Tensor) else value
    return tree


def _state_trees(state) -> tuple[str, dict]:
    if isinstance(state, GanTrainState):
        return "gan", gan_trees_from_state(state)
    if isinstance(state, UResNetTrainState):
        return "uresnet", {**uresnet_trees_from_state(state), "epoch": state.epoch}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def _steps(directory: Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def _load(directory: Path, step: int | None) -> tuple[int, dict, dict]:
    """(step, nested trees, meta) of ``step`` or the latest."""
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    flat = torch.load(directory / str(step) / STATE_FILE, map_location="cpu",
                      weights_only=True)
    meta = json.loads((directory / str(step) / META_FILE).read_text())
    return step, _nested(flat), meta


class CheckpointManager:
    """Step-indexed checkpoints with retention, each written atomically."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state, counters: Counters | None = None,
             extra: dict | None = None) -> None:
        """Writes ``state`` (a ``GanTrainState`` or ``UResNetTrainState``)
        as step ``step``, replacing a step of that number, then drops all
        but the newest ``max_to_keep`` steps."""
        kind, trees = _state_trees(state)
        meta = {"kind": kind, "counters": dataclasses.asdict(counters) if counters else None,
                "extra": extra or {}}
        final = self.directory / str(step)
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_flat_leaves(trees), tmp / STATE_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta))
        if final.exists():
            old = self.directory / f".{step}.old-{os.getpid()}"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        for old_step in _steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old_step))

    def restore(self, state_template, step: int | None = None):
        """Returns (state, counters, extra) of ``step`` (the latest if
        None): a new state of the template's kind, learning rates, Adam
        betas and device, with the saved parameters, statistics and Adam
        step counts and moments."""
        step, trees, meta = _load(self.directory, step)
        if isinstance(state_template, GanTrainState):
            if meta["kind"] != "gan":
                raise ValueError(f"{self.directory} step {step} is a {meta['kind']} checkpoint")
            g, d = state_template.g_opt.param_groups[0], state_template.dy2_opt.param_groups[0]
            device = next(iter(state_template.g_params.values())).device
            state = gan_train_state_from_trees(trees, g["lr"], d["lr"], *g["betas"], device)
        else:
            if meta["kind"] != "uresnet":
                raise ValueError(f"{self.directory} step {step} is a {meta['kind']} checkpoint")
            group = state_template.opt.param_groups[0]
            device = next(iter(state_template.params.values())).device
            state = uresnet_train_state_from_trees(trees["params"], trees["batch_stats"],
                                                   trees["opt"], group["lr"], device)
            state.epoch = int(trees["epoch"])
        counters = Counters(**meta["counters"]) if meta.get("counters") else Counters()
        return state, counters, meta.get("extra", {})

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return _steps(self.directory)

    def close(self) -> None:
        pass  # every save has finished when it returns


def load_generator_variables(directory: str | Path, step: int | None = None) -> dict:
    """Template-free restore of just the generator variables from a GAN
    training checkpoint directory (the ones ``run_gan_training`` writes),
    so that ``test-gan`` runs straight off a checkpoint. Returns
    ``{"params", "batch_stats"}`` as numpy trees; ``step=None`` restores
    the latest."""
    directory = Path(directory).absolute()
    step, state, _ = _load(directory, step)
    for k in ("g_params", "g_stats"):
        if k not in state:
            raise ValueError(
                f"{directory} step {step} is not a GAN training checkpoint "
                f"(missing '{k}'; found {sorted(state)})"
            )
    return {"params": state["g_params"], "batch_stats": state["g_stats"]}


def export_generator_h5(state: GanTrainState, path: str | Path) -> None:
    """Write the generator as a reference-compatible Keras weights file."""
    h5_import.export_keras_h5({"params": numpy_tree(state.g_params),
                               "batch_stats": numpy_tree(state.g_stats)}, str(path))


def export_uresnet_h5(state: UResNetTrainState, path: str | Path) -> None:
    h5_import.export_keras_h5({"params": numpy_tree(state.params),
                               "batch_stats": numpy_tree(state.batch_stats)}, str(path))
