"""Runs of the harness with the timed path broken underneath: ``correct``
has to come out false. The look for a card is skipped (``device='cpu'``)
and the cells run at a small size on the program's plain versions; the
rest of the run is the benchmark's own."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests.small import small

SEED = 2_147_483_990


def _result(workload, capsys, limits):
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "1.5",
                   "--trace", "0"], device="cpu", cell=small(workload, limits))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


# At this size the CPU's bfloat16 serving path reads up to ~0.06 from the
# float32 reference; the card's limit is for the card's kernels at full size.
SERVE_LIMITS = {"max_abs_gap": {"limit": 0.1}, "control": "fp8"}
TRAIN_LIMITS = None  # the cells' own


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("broken", [None, "answer altered"])
def test_serving(broken, capsys, monkeypatch):
    from depgan_tpu_torch.eval.predict import EnsemblePredictor

    if broken:
        predict = EnsemblePredictor.predict

        def altered(self, x, mask):
            out = predict(self, x, mask)
            out[0, 0, 0] += 0.5
            return out

        monkeypatch.setattr(EnsemblePredictor, "predict", altered)
    res = _result("depgan-serve-1c", capsys, SERVE_LIMITS)
    assert res["correct"] is (broken is None)
    assert list(res)[-1] == "compared"


def test_serving_fails_when_predict_no_longer_calls_forward(monkeypatch):
    """The turns between clients and the host span hang on ``_forward``: a
    predictor that forwards by another name fails the run."""
    from depgan_tpu_torch.eval.predict import EnsemblePredictor

    from portbench.drivers import serve

    ensemble = EnsemblePredictor._ensemble

    def renamed(self, x, noises, mask):
        if not hasattr(self, "_renamed"):  # first called in warm-up, before any wrapping
            self._renamed = self._forward
        inner = types.SimpleNamespace(_forward=self._renamed)
        return ensemble(inner, x, noises, mask)

    monkeypatch.setattr(EnsemblePredictor, "_ensemble", renamed)
    with pytest.raises(RuntimeError, match="no longer calls it"):
        serve.run(small("depgan-serve-1c", SERVE_LIMITS), SEED, 1.0, False, "cpu", 0.0)


@pytest.mark.parametrize("broken", [None, "state unchanged", "half batch"])
def test_gan_training(broken, capsys, monkeypatch):
    from depgan_tpu_torch.train.gan_trainer import GanTrainer

    superstep = GanTrainer.superstep
    if broken == "state unchanged":
        monkeypatch.setattr(GanTrainer, "superstep",
                            lambda self, state, *a, **k: (state, superstep(
                                self, _copy(state), *a, **k)[1]))
    elif broken == "half batch":
        monkeypatch.setattr(GanTrainer, "superstep", lambda self, state, x, y, idx, n, **k:
                            superstep(self, state, x, y, np.asarray(idx)[:, : idx.shape[1] // 2],
                                      n, **k))
    res = _result("depgan-train-f32", capsys, TRAIN_LIMITS)
    assert res["correct"] is (broken is None)


@pytest.mark.parametrize("broken", [None, "state unchanged", "half batch"])
def test_uresnet_training(broken, capsys, monkeypatch):
    from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer

    step = UResNetTrainer.step
    if broken == "state unchanged":
        monkeypatch.setattr(UResNetTrainer, "step", lambda self, state, *a, **k: (
            state, step(self, _copy(state), *a, **k)[1]))
    elif broken == "half batch":
        monkeypatch.setattr(UResNetTrainer, "step", lambda self, state, x, y, z, idx, **k:
                            step(self, state, x, y, z, np.asarray(idx)[: len(idx) // 2], **k))
    res = _result("depuresnet-train-f32", capsys, TRAIN_LIMITS)
    assert res["correct"] is (broken is None)


def _copy(state):
    """A throw-away copy for a step whose update is then dropped."""
    import copy

    return copy.deepcopy(state)
