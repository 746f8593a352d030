"""FusedCritic — the fused s2d path of the WGAN-GP critic DisC2DFCN1.

Counterpart of ``depgan_tpu/ops/fast_critic.py``. The critic's 5x5 levels
(16-32 channels at full and half resolution) run in padded s2d through
``conv5x5_s2d_fused`` and the pool kernels; the 64-256 channel tail stays
plain torch (``F.conv2d``).

WGAN-GP needs the critic's *input* gradient inside the training loss and
then differentiates that wrt the critic's parameters. As in JAX,
``score_and_input_grad`` writes the backward chain out op by op: the relu and
ring masks, the transposed 5x5 convs as the same op on the flip-transposed
kernel, the pools' backward, the adjoint of ``entry_pack``; the tail's input
gradient comes from autograd with ``create_graph``. Autograd of the result
wrt the parameters then needs the kernels' first-order rules only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.blocks import conv2d_same, max_pool_2x2
from .conv_s2d import (
    conv5x5_s2d_fused,
    entry_pack,
    interior_mask,
    pool_s2d,
    pool_s2d_bwd,
    pool_to_s2d,
    pool_to_s2d_bwd,
    unpad_s2d,
)
from .s2d_conv import d2s, flip_transpose_w5

# The tail after the fused levels; None is a 2x2 max-pool.
_TAIL = ("dis_2", "dis_3", None, "dis_4", "dis_5", None, "dis_6", "dis_7", "dis_8")


class FusedCritic:
    """Fused critic forward and hand-chained input gradient.

    Carries no parameters: every method takes the live critic parameters as
    a flat dict keyed by the dotted Flax path (the critic has no BatchNorm,
    so there is nothing to fold)."""

    entry_pad = 4  # the 1-channel image is padded to 4 channels a group

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.dtype = compute_dtype

    @staticmethod
    def _leaf(params, suffix):
        stem = f"block_{suffix}.conv2d_{suffix}"
        return params[f"{stem}.kernel"], params[f"{stem}.bias"]

    def _tail(self, params, h):
        """dis_2 ... dis_8, dis_9, flatten, dis_dense, in the pixel domain."""
        dt = self.dtype
        for suffix in _TAIL:
            if suffix is None:
                h = max_pool_2x2(h)
            else:
                k, b = self._leaf(params, suffix)
                h = torch.relu(conv2d_same(h, k.to(dt)) + b.to(dt))
        h = conv2d_same(h, params["dis_9.kernel"].to(dt)) + params["dis_9.bias"].to(dt)
        h = h.reshape(h.shape[0], -1)
        return (h @ params["dis_dense.kernel"].to(dt) + params["dis_dense.bias"].to(dt)).float()

    def _kernels(self, params):
        """The four 5x5 levels' pixel kernels (dis_0a's input channels
        padded to ``entry_pad``) and biases, as live parameters."""
        ks, bs = zip(*(self._leaf(params, s) for s in ("dis_0a", "dis_0b", "dis_1a", "dis_1b")))
        k0a = F.pad(ks[0], (0, 0, 0, self.entry_pad - ks[0].shape[2]))
        return (k0a, *ks[1:]), bs

    def _front(self, ks, bs, x):
        """Entry and the two fused levels. Returns the pixel-domain tensor
        the tail takes and the planes the input gradient needs."""
        dt = self.dtype
        xp = entry_pack(x.to(dt), c_pad=self.entry_pad)
        h0a = conv5x5_s2d_fused(xp, ks[0].to(dt), bs[0])
        h0b = conv5x5_s2d_fused(h0a, ks[1].to(dt), bs[1])
        hp = pool_to_s2d(h0b)
        h1a = conv5x5_s2d_fused(hp, ks[2].to(dt), bs[2])
        h1b = conv5x5_s2d_fused(h1a, ks[3].to(dt), bs[3])
        return pool_s2d(h1b), dict(xp=xp, h0a=h0a, h0b=h0b, hp=hp, h1a=h1a, h1b=h1b)

    def forward(self, params, x):
        """(B, H, W, 1) -> (B, 1) float32 score; differentiable wrt the
        parameters and x to first order."""
        pix, _ = self._front(*self._kernels(params), x)
        return self._tail(params, pix)

    def score_and_input_grad(self, params, x):
        """Returns (score (B, 1), d sum(score) / dx (B, H, W, 1) float32).

        The gradient is differentiable wrt the parameters when grad mode is
        on. It depends on the levels' activations only through relu, ring
        and pool masks, whose derivative is zero, so the levels run without
        a graph and the tail's input gradient is taken at a detached copy;
        the score's graph therefore reaches the tail's parameters only."""
        dt = self.dtype
        graph = torch.is_grad_enabled()
        ks, bs = self._kernels(params)
        with torch.no_grad():
            pix, res = self._front(ks, bs, x)
        with torch.enable_grad():
            pix = pix.requires_grad_()
            score = self._tail(params, pix)
            (d_pix,) = torch.autograd.grad(score.sum(), pix, create_graph=graph)

        def conv5_bwd(d_out, out, w5, c_in4):
            """Transpose of a relu 5x5 level: relu and ring masks in one
            multiply, then the flip-transposed conv through the same op."""
            d_pre = (torch.where(out > 0, d_out, 0.0) * interior_mask(out)).to(dt)
            zeros = torch.zeros(c_in4 // 4, dtype=torch.float32, device=out.device)
            return conv5x5_s2d_fused(d_pre, flip_transpose_w5(w5).to(dt), zeros, "none")

        k0a, k0b, k1a, k1b = ks
        d_h1b = pool_s2d_bwd(res["h1b"], d_pix.to(res["h1b"].dtype))
        d_h1a = conv5_bwd(d_h1b, res["h1b"], k1b, res["h1a"].shape[-1])
        d_hp = conv5_bwd(d_h1a, res["h1a"], k1a, res["hp"].shape[-1])
        d_h0b = pool_to_s2d_bwd(res["h0b"], d_hp)
        d_h0a = conv5_bwd(d_h0b, res["h0b"], k0b, res["h0a"].shape[-1])
        d_xp = conv5_bwd(d_h0a, res["h0a"], k0a, res["xp"].shape[-1])

        # Adjoint of entry_pack: drop the ring, keep the real channel of
        # each sub-pixel group, undo the s2d blocking.
        d_grp = unpad_s2d(d_xp)
        b, n = d_grp.shape[:2]
        d_real = d_grp.reshape(b, n, n, 4, self.entry_pad)[..., :1]
        return score, d2s(d_real.reshape(b, n, n, 4)).float()
