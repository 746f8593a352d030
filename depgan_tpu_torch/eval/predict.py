"""Stochastic-ensemble inference.

Counterpart of ``depgan_tpu/eval/predict.py``. The reference runs 10 forward
passes per subject with fresh noise, masks each with the 2nd time point's
ICV and not-stroke-lesion mask, and averages them
(``DEP-GAN_testing_4fold.py:616-628``). Here the repeats are a loop on the
device with a float32 running sum, so the host sees one result per subject
and the device holds one forward's activations at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..models.folded import FoldedGenerator
from ..ops.fast_gen import FastGenerator
from ..utils.profiling import span


class EnsemblePredictor:
    """``n_repeat`` stochastic forward passes of one generator, averaged.

    ``fast=True`` runs the serving path (``ops.fast_gen.FastGenerator``:
    folded BN, the s2d kernels, trunk in ``compute_dtype``); ``fast=False``
    runs ``GenUNet2D``'s eval forward in plain torch and cuDNN, in
    ``model_cfg.compute_dtype``, on BN-folded weights
    (``models.folded.FoldedGenerator``).
    Noise comes from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, so two predictors with one seed draw the same noise.
    """

    def __init__(self, model_cfg: ModelConfig, variables: dict, n_repeat: int = 10,
                 seed: int = 0, fast: bool = False, device="cuda",
                 compute_dtype=torch.bfloat16):
        self.n_repeat = n_repeat
        self.noise_size = model_cfg.noise_size
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if fast:
            self._forward = FastGenerator(model_cfg, variables, compute_dtype, self.device)
        else:
            self._forward = FoldedGenerator(model_cfg, variables, self.device)

    @torch.no_grad()
    def _ensemble(self, x: torch.Tensor, noises: torch.Tensor, mask: torch.Tensor):
        """Masked mean over the repeats: x (Z, H, W, C), noises (R, Z,
        noise_size, 1), mask (Z, H, W) -> (Z, H, W, C_out) float32."""
        total = None
        for z in noises:
            with span("predict.forward"):
                pred = self._forward(x, z).float() * mask[..., None]
                total = pred if total is None else total.add_(pred)
        return total / noises.shape[0]

    def predict(self, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Returns the masked ensemble mean, shape (Z, H, W, C_out).

        ``mask`` is (Z, H, W), the ICV and not-stroke-lesion mask at the 2nd
        time point. Spans: ``predict`` around the call, ``predict.forward``
        around each repeat's forward, mask and sum.
        """
        with span("predict"):
            noises = torch.randn((self.n_repeat, x.shape[0], self.noise_size, 1),
                                 generator=self._gen, device=self.device)
            out = self._ensemble(
                torch.as_tensor(x, dtype=torch.float32, device=self.device), noises,
                torch.as_tensor(mask, dtype=torch.float32, device=self.device))
            return out.cpu().numpy()


def reconstruct_follow_up(y1: np.ndarray, dem: np.ndarray) -> np.ndarray:
    """Fake follow-up = baseline + DEM (``predict``'s output), clipped to
    [-1, 1]."""
    return np.clip(y1 + dem, -1.0, 1.0)
