"""Gen_UNet2D's eval forward with every BatchNorm folded away: the plain
serving generator.

``EnsemblePredictor(fast=False)`` serves this (``test-gan`` and
``test-uresnet`` without ``--fast``): plain torch, cuDNN and cuBLAS, no hand
kernel. It computes ``GenUNet2D.forward(x, z)`` with frozen BatchNorm and
no dropout, in ``cfg.compute_dtype``. The weights are folded once, at
construction (``ops/fold_bn.py``), so no BatchNorm pass runs, and each
layer leaves the fewest full-tensor passes plain torch allows:

- conv -> BN -> relu: the conv with the folded kernel and bias, and the
  relu; on a card one cuDNN call (``torch.cudnn_convolution_relu``: TF32
  as cuDNN's setting says, and the bias and relu cost no pass of their
  own), on the CPU relu in place;
- a FiLM site, ``trunk + relu(conv_bn(trunk) * gamma + beta)``: the conv
  without its folded bias, which joins beta as ``beta + bias * gamma``,
  then ``addcmul``, relu and the residual add, in place; with
  ``cfg.use_pallas`` the last three through K8 (``film_residual``), as
  ``GenUNet2D``'s FiLM sites run them;
- deconv -> BN -> relu: one matmul with the folded bias tiled over the four
  sub-pixels, whose relu writes the sub-pixels interleaved straight into
  the skip concat's buffer;
- the noise encoder's denses fold their BN too, and the 14 site denses run
  as one matmul (``ops/fast_gen``'s ``noise_encoder_weights`` and
  ``site_mods``, which the fast generator runs too).

Conv kernels are kept OIHW with channels-last strides, the layout cuDNN
runs on the NHWC activations, so no forward converts a weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..io.flax_bridge import load_flax_variables
from ..ops.fast_gen import deconv_w2, noise_encoder_weights, site_mods, to_tensors
from ..ops.film import film_residual
from ..ops.fold_bn import fold_batch_norms
from .blocks import max_pool_2x2
from .generator import DECODER, ENCODER, MIDDLE, GenUNet2D


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO -> OIHW with channels-last strides (memory O, H, W, I)."""
    return kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


class FoldedGenerator:
    """``GenUNet2D``'s eval forward on BN-folded weights: ``__call__(x, z)``
    with x (B, H, W, C_in) and z (B, noise_size, 1) returns
    (B, H, W, n_out) float32. It has no training forward: BatchNorm's
    statistics are gone from its weights."""

    def __init__(self, cfg: ModelConfig, variables: dict, device=None):
        self.cfg = cfg
        self.dtype = dt = getattr(torch, cfg.compute_dtype)
        # Every leaf's name and shape, held to GenUNet2D's as its loader does.
        load_flax_variables(GenUNet2D(cfg, device="meta"), variables)
        p = fold_batch_norms(to_tensors(variables, device))["params"]
        W, self._site_slices = noise_encoder_weights(p["noise_encoder"])

        def put_conv(name, leaf):
            W[f"{name}/kernel"], W[f"{name}/bias"] = _oihw(leaf["kernel"]), leaf["bias"]

        for *_, deconv in DECODER:
            d = p[f"block_{deconv}"][f"deconv2d_{deconv}"]
            W[f"{deconv}/w2"], W[f"{deconv}/bias4"] = deconv_w2(d["kernel"]), d["bias"].repeat(4)
        for site, cin, cout, *_ in ENCODER + (MIDDLE,) + DECODER:
            put_conv(cin, p[f"block_{cin}"][f"conv2d_{cin}"])
            put_conv(f"noise_{site}", p[f"film_{site}"][f"block_gen_noise_{site}"]
                     [f"conv2d_gen_noise_{site}"])
            put_conv(cout, p[f"block_{cout}"][f"conv2d_{cout}"])
        put_conv("gen_segmentation", p["gen_segmentation"])
        self.weights = {k: v.to(dt) for k, v in W.items()}

    def _conv(self, x, name, bias=True, relu=False):
        """SAME conv of NHWC ``x`` [with relu]: an NHWC view of cuDNN's
        channels-last output, contiguous. On a card conv, bias and relu are
        one cuDNN call, whose bias and relu cost nothing beside the conv."""
        k = self.weights[f"{name}/kernel"]
        b = self.weights[f"{name}/bias"] if bias else None
        pad = k.shape[-1] // 2
        x = x.permute(0, 3, 1, 2)
        if relu and x.is_cuda:
            y = torch.cudnn_convolution_relu(x, k, b, (1, 1), (pad, pad), (1, 1), 1)
        else:
            y = F.conv2d(x, k, b, padding=pad)
            if relu:
                y.relu_()
        return y.permute(0, 2, 3, 1)

    def _level(self, x, mods, site, cin, cout):
        """conv_bn_relu -> FiLM site -> conv_bn_relu."""
        h = self._conv(x, cin, relu=True)
        gamma, beta = mods[site]
        beta = torch.addcmul(beta, gamma, self.weights[f"noise_{site}/bias"])
        s = self._conv(h, f"noise_{site}", bias=False)
        if self.cfg.use_pallas:
            # gamma is a column slice of the site denses' output: K8 takes
            # contiguous tensors.
            s = film_residual(s.contiguous(), gamma.contiguous(), beta, h.contiguous())
        else:
            torch.addcmul(beta[:, None, None, :], s, gamma[:, None, None, :], out=s)
            s.relu_().add_(h)
        return self._conv(s, cout, relu=True)

    def _up_concat(self, h, deconv, skip):
        """relu(deconv(h)) and ``skip`` along channels, the deconv's four
        sub-pixels interleaved by the relu's write."""
        b, hh, ww, c = h.shape
        w2 = self.weights[f"{deconv}/w2"]
        o = w2.shape[1] // 4
        y = torch.addmm(self.weights[f"{deconv}/bias4"], h.reshape(-1, c), w2)
        out = h.new_empty(b, 2 * hh, 2 * ww, o + skip.shape[-1])
        torch.clamp_min(y.view(b, hh, ww, 2, 2, o).permute(0, 1, 3, 2, 4, 5), 0,
                        out=out.view(b, hh, 2, ww, 2, -1)[..., :o])
        out[..., o:] = skip
        return out

    @torch.no_grad()
    def forward(self, x, z, train: bool = False, dropout=None):
        """``GenUNet2D.forward``'s signature; ``train`` raises."""
        if train:
            raise ValueError("FoldedGenerator has no training forward: its BatchNorms are "
                             "folded into the weights; train GenUNet2D")
        mods = site_mods(self.weights, z.to(self.dtype), self._site_slices)
        skips, h = {}, x.to(self.dtype)
        for site, cin, cout, _ in ENCODER:
            skips[site] = self._level(h, mods, site, cin, cout)
            h = max_pool_2x2(skips[site])
        h = self._level(h, mods, *MIDDLE[:3])
        for (site, cin, cout, _, deconv), skip in zip(DECODER, ("m3", "m2", "m1")):
            h = self._level(self._up_concat(h, deconv, skips[skip]), mods, site, cin, cout)
        logits = self._conv(h, "gen_segmentation").float()
        if self.cfg.n_out == 1:
            return torch.tanh(logits)
        return torch.softmax(logits, dim=-1)

    __call__ = forward
