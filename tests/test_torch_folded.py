"""The plain serving generator on BN-folded weights (``models/folded.py``,
``EnsemblePredictor(fast=False)``) against ``GenUNet2D``'s eval forward on
the unfolded weights: one forward at both heads and both input widths, in
bfloat16, and with ``use_pallas`` (K8 at every FiLM site); a whole
ensemble; and the training forward it refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from depgan_tpu_torch.config import ModelConfig
from depgan_tpu_torch.eval.predict import EnsemblePredictor
from depgan_tpu_torch.io.flax_bridge import load_flax_variables
from depgan_tpu_torch.models import GenUNet2D
from depgan_tpu_torch.models import folded as folded_module
from depgan_tpu_torch.models.folded import FoldedGenerator
from test_torch_models import inputs, randomized_variables

ATOL = 2e-5
# bfloat16: each side rounds its own (folded or unfolded) weights and its own
# intermediates; 2.7x the largest gap of 12 seeded generators (3.66e-3).
ATOL_BF16 = 1e-2


def unfolded(cfg, variables):
    return load_flax_variables(GenUNet2D(cfg), variables).eval()


@pytest.mark.parametrize("n_out,n_in,options", [
    (1, 1, {}), (4, 1, {}), (1, 2, {}), (4, 2, {}),
    (1, 1, {"compute_dtype": "bfloat16"}), (4, 1, {"compute_dtype": "bfloat16"}),
    (1, 1, {"use_pallas": True})],
    ids=["1-1", "4-1", "1-2", "4-2", "1-1-bf16", "4-1-bf16", "1-1-pallas"])
def test_folded_forward_matches_generator(n_out, n_in, options, monkeypatch):
    """Against ``GenUNet2D`` built from the same config; with ``use_pallas``
    every FiLM site goes through ``film_residual`` (K8 on a card, its plain
    version here), and without it none does."""
    cfg = dataclasses.replace(ModelConfig(image_size=32, first_fm=8, n_out=n_out,
                                          n_input_channels=n_in), **options)
    variables = randomized_variables(cfg, seed=10 + n_out + n_in)
    x, z = (torch.from_numpy(a) for a in inputs(cfg, batch=3, seed=n_in))
    with torch.no_grad():
        want = unfolded(cfg, variables)(x, z)
    calls = []  # whether each call's tensors are contiguous, as K8 needs on a card
    film_residual = folded_module.film_residual
    monkeypatch.setattr(folded_module, "film_residual", lambda *a: calls.append(
        all(t.is_contiguous() for t in a)) or film_residual(*a))
    got = FoldedGenerator(cfg, variables, device="cpu")(x, z)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, n_out)
    assert calls == [True] * (7 if cfg.use_pallas else 0)
    atol = ATOL_BF16 if cfg.compute_dtype == "bfloat16" else ATOL
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol)


def test_folded_predict_matches_unfolded_ensemble():
    """``predict`` of the folded predictor and of one serving the unfolded
    module, with the same seed: the same noises, the same masked mean."""
    cfg = ModelConfig(image_size=32, first_fm=8)
    variables = randomized_variables(cfg, seed=7)
    folded = EnsemblePredictor(cfg, variables, n_repeat=3, seed=5, device="cpu")
    assert isinstance(folded._forward, FoldedGenerator)
    ref = EnsemblePredictor(cfg, variables, n_repeat=3, seed=5, device="cpu")
    ref._forward = unfolded(cfg, variables)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(4, 32, 32, 1)).astype(np.float32)
    mask = (rng.uniform(size=(4, 32, 32)) > 0.3).astype(np.float32)
    got, want = folded.predict(x, mask), ref.predict(x, mask)
    assert not got[mask == 0].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_folded_generator_refuses_training():
    cfg = ModelConfig(image_size=32, first_fm=8)
    x, z = (torch.from_numpy(a) for a in inputs(cfg))
    gen = FoldedGenerator(cfg, randomized_variables(cfg, seed=1), device="cpu")
    with pytest.raises(ValueError, match="no training forward"):
        gen.forward(x, z, train=True)
