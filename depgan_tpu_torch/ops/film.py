"""K8: the fused FiLM residual ``trunk + relu(h * gamma + beta)``.

Counterpart of ``depgan_tpu/ops/film_pallas.py``. h, trunk and the output
are NHWC (B, H, W, C); gamma and beta are (B, C), cast to h's dtype and
broadcast over H and W. The chain runs in float32 and rounds once, at the
store (``_film_kernel``, :28-38).

- ``film_residual_plain``: the plain PyTorch version.
- ``_film_impl``: a CPU tensor runs the plain version; a CUDA tensor
  launches ``csrc/film_kernels.cu`` and counts the launch in
  ``conv_s2d.SHAPES`` under ``"film_residual"``; any other device raises.
  No fallback from the kernel to the plain version.
- ``film_residual``: an ``autograd.Function`` whose backward is plain torch,
  as JAX's custom VJP is XLA (``_film_bwd``, :102-112): the relu mask is
  recomputed from the saved h, gamma and beta, so nothing else is kept.
"""

from __future__ import annotations

import torch

from . import _cuda
from .conv_s2d import _launch, _on_cuda, _require


def film_residual_plain(h, gamma, beta, trunk):
    """trunk + relu(h * gamma + beta) in float32, rounded once to h's dtype."""
    g = gamma.to(h.dtype).float()[:, None, None, :]
    b = beta.to(h.dtype).float()[:, None, None, :]
    out = trunk.float() + torch.relu(h.float() * g + b)
    return out.to(h.dtype)


def _film_impl(h, gamma, beta, trunk):
    _require(h.ndim == 4 and trunk.shape == h.shape and trunk.dtype == h.dtype,
             f"film_residual: h and trunk must be NHWC of one shape and dtype, got "
             f"{h.dtype} {tuple(h.shape)} and {trunk.dtype} {tuple(trunk.shape)}")
    b, hh, ww, c = h.shape
    _require(gamma.shape == (b, c) and beta.shape == (b, c),
             f"film_residual: gamma and beta must be {(b, c)}, got {tuple(gamma.shape)} "
             f"and {tuple(beta.shape)}")
    _require(gamma.device == h.device and beta.device == h.device,
             f"film_residual: tensors on different devices: {h.device}, {gamma.device}, "
             f"{beta.device}")
    # (B, C) vectors of a few hundred bytes: the cast is JAX's (:93).
    gamma, beta = gamma.to(h.dtype), beta.to(h.dtype)
    if not _on_cuda(h, trunk, gamma, beta):
        return film_residual_plain(h, gamma, beta, trunk)
    out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        _launch("film_residual", (b, hh, ww, c), "depgan_film_residual",
                _cuda.DTYPE_CODES[h.dtype], h.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                trunk.data_ptr(), out.data_ptr(), b, hh * ww, c, _cuda.stream(h.device))
    return out


class _FilmResidual(torch.autograd.Function):
    """``film_residual``'s rule (``_film_bwd``): the mask (h·γ + β) > 0 in
    h's dtype, dh = g·γ and dγ, dβ the masked cotangent's sums over H, W."""

    @staticmethod
    def forward(ctx, h, gamma, beta, trunk):
        ctx.save_for_backward(h, gamma, beta)
        return _film_impl(h, gamma, beta, trunk)

    @staticmethod
    def backward(ctx, g):
        h, gamma, beta = ctx.saved_tensors
        gb = gamma.to(h.dtype)[:, None, None, :]
        bb = beta.to(h.dtype)[:, None, None, :]
        g_masked = torch.where(h * gb + bb > 0, g, torch.zeros((), dtype=g.dtype,
                                                               device=g.device))
        dh = (g_masked * gb).to(h.dtype)
        dgamma = (g_masked * h).sum((1, 2)).to(gamma.dtype)
        dbeta = g_masked.sum((1, 2)).to(beta.dtype)
        return dh, dgamma, dbeta, g


def film_residual(h, gamma, beta, trunk):
    """trunk + relu(h * gamma[:, None, None, :] + beta[:, None, None, :]);
    h, trunk (B, H, W, C) contiguous of one dtype, gamma and beta (B, C).
    Differentiable (plain torch backward)."""
    return _FilmResidual.apply(h, gamma, beta, trunk)
