"""Fused s2d convolutions and pools: layout helpers, the kernel wrappers,
their plain PyTorch versions, and the autograd rules of the training path.

Counterpart of ``depgan_tpu/ops/conv_s2d_pallas.py``. Activations live in the
*padded unshifted s2d* layout ``(B, N+2, N+2, 4C)``: block (i, j) holds
pixels (2i+p-2, 2j+q-2) of the image in sub-pixel channel order (p, q, c),
and the 1-block border ring is zero, which gives the SAME padding of the
next conv for free.

Three layers, as in the JAX package:

- Plain versions (``*_plain``), written from the definitions: gathered taps
  and one float32 matmul for the convs, a channel-group max for the pools.
- Kernel dispatch (``_*_impl`` and ``conv3x3_s2d_fused_pool``): a CPU tensor
  runs the plain version; a CUDA tensor launches the hand-written kernel of
  ``csrc/`` and counts the launch in ``SHAPES``; any other device raises.
  There is no fallback from the kernel to the plain version. Both versions
  take activations and weights in one dtype, bias, gamma and beta in
  float32, accumulate in float32 and round once.
- The public ops (``conv3x3_s2d_fused``, ``conv3x3_s2d_fused2``,
  ``deconv_s2d``, ``pool_s2d``, ``pool_to_s2d``, ``conv5x5_s2d_fused``):
  ``torch.autograd.Function``s mirroring the JAX custom VJPs. The 3x3 convs
  and the deconv are first-order only, as in JAX; the pools' backward is
  plain torch and the 5x5 conv's backward goes through the op itself, so
  both differentiate again (the WGAN-GP double backward).
- The serving-only ops (``conv3x3_s2d_fused_pool``,
  ``conv3x3_s2d_fused_head``, ``conv3x3_s2d_chain2``,
  ``conv3x3_s2d_chain3``): no gradient, as in JAX; the last three refuse
  inputs that require grad while grad mode is on.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _cuda
from .s2d_conv import (
    conv5x5_to_s2d_kernel,
    conv5x5_to_s2d_kernel_adjoint,
    d2s,
    flip_transpose_w4,
    flip_transpose_w5,
    s2d_unshifted,
)
from .wgmma_plan import POOL_WIDTHS, chain_plan, chain_takes, conv5_window_takes, deconv_takes

_EPILOGUES = {"relu": 0, "film": 1, "none": 2}
_POOLS = {"pixel": 1, "s2d": 2}

# The packed 5x5 conv (K11, JAX ``CONV5_PACKED``, ``conv_s2d_pallas.py:72``):
# read at every call of ``_conv5_impl``, which on a CUDA tensor launches K11
# in place of K7 when this is on and 4C <= 64, as JAX selects
# ``_kernel5_packed``. Off by default, as in JAX. Its autograd rule needs no
# change: the transposed convs of the backward and of the critic's input
# gradient go back through ``_conv5_impl`` and take the same gate.
CONV5_PACKED = False

# Kernel launches by (name, problem), counted where each wrapper launches its
# kernel, the problem being the wrapper's shape arguments, so a run's
# launches can be replayed and timed shape by shape. K1's 'none' epilogue
# (the backward's transposed convs) and K11 (the packed 5x5 conv) count under
# names of their own; K8 (``ops/film.py``) and the probes P1-P3
# (``ops/probes.py``) count here too.
KERNEL_NAMES = ("conv3x3_s2d_fused", "conv3x3_s2d_fused[none]", "conv3x3_s2d_fused_pool",
                "conv3x3_s2d_fused2", "deconv_s2d", "pool_to_s2d", "pool_s2d",
                "conv5x5_s2d_fused", "film_residual", "conv3x3_s2d_fused_head",
                "conv3x3_s2d_chain3", "conv3x3_s2d_chain2", "conv5x5_s2d_fused[packed]",
                "kernel_anatomy[full]", "kernel_anatomy[no_epi]", "kernel_anatomy[matmul_only]",
                "kernel_anatomy[stage_only]", "conv3x3_rowblk", "deint_reshape_idx",
                "deint_merge")
SHAPES: Counter = Counter()


def launches() -> dict[str, int]:
    """Kernel launches by name since the last reset."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for (name, _), count in SHAPES.items():
        counts[name] += count
    return counts


def reset_launch_counts() -> None:
    SHAPES.clear()


def pad_s2d(y: torch.Tensor) -> torch.Tensor:
    """Unshifted s2d (B, N, N, 4C) -> padded layout (B, N+2, N+2, 4C)."""
    return F.pad(y, (0, 0, 1, 1, 1, 1))


def unpad_s2d(y: torch.Tensor) -> torch.Tensor:
    """Padded s2d -> unshifted s2d interior."""
    n = y.shape[1] - 2
    return y[:, 1:n + 1, 1:n + 1, :]


def entry_pack(x: torch.Tensor, c_pad: int = 8) -> torch.Tensor:
    """Pixel (B, 2N, 2N, C_in) -> padded s2d (B, N+2, N+2, 4*c_pad), each
    sub-pixel group zero-padded from C_in to c_pad channels."""
    b, h, _, c_in = x.shape
    p = h // 2 + 2
    grp = pad_s2d(s2d_unshifted(x)).reshape(b, p, p, 4, c_in)
    return F.pad(grp, (0, c_pad - c_in)).reshape(b, p, p, 4 * c_pad)


def interior_mask(plane: torch.Tensor) -> torch.Tensor:
    """(1, rows, cols, 1) 0/1 mask of a padded plane's interior, each bound
    taken from its own dim."""
    rows, cols = plane.shape[1], plane.shape[2]
    r = torch.arange(rows, device=plane.device)
    c = torch.arange(cols, device=plane.device)
    inside = ((r >= 1) & (r <= rows - 2))[:, None] & ((c >= 1) & (c <= cols - 2))[None, :]
    return inside.to(plane.dtype)[None, :, :, None]


def zero_ring(g: torch.Tensor) -> torch.Tensor:
    """A padded plane's cotangent with its border ring zeroed: the forward
    writes constant zeros there, so they carry no gradient."""
    return g * interior_mask(g)


# --------------------------------------------------------------------------
# Plain versions, written from the definitions.
# --------------------------------------------------------------------------


def _taps(x_padded: torch.Tensor) -> torch.Tensor:
    """Gathered taps of the shifted-s2d 3x3 conv, (B, n, n, 16C) float32, in
    the row order (A, B, dst, c) of the flattened kernel w4 (2, 2, 4C, 4Co):
    tap (A, B), destination group dst = 2p+q reads source group 3-dst at
    block offset (A+p, B+q)."""
    n = x_padded.shape[1] - 2
    c = x_padded.shape[-1] // 4
    xf = x_padded.float()
    parts = []
    for a in range(2):
        for b in range(2):
            for dst in range(4):
                p, q = divmod(dst, 2)
                src = 3 - dst
                parts.append(xf[:, a + p:a + p + n, b + q:b + q + n, src * c:(src + 1) * c])
    return torch.cat(parts, dim=-1)


def _taps5(x_padded: torch.Tensor) -> torch.Tensor:
    """Gathered taps of the dense 3x3-tap conv (the 5x5 pixel conv),
    (B, n, n, 9*4C) float32 in the row order (A, B, c) of w9: tap (A, B)
    reads block offset (A, B) of the padded plane."""
    n = x_padded.shape[1] - 2
    xf = x_padded.float()
    return torch.cat([xf[:, a:a + n, b:b + n, :] for a in range(3) for b in range(3)], dim=-1)


def _matmul_taps(taps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return taps @ w.float().reshape(-1, w.shape[-1])


def conv3x3_s2d_fused_plain(x_padded, w4, bias4, gamma4=None, beta4=None, mode="relu"):
    """relu(conv + b), conv + b for 'none', or x + relu((conv + b) * gamma +
    beta) for 'film'; padded s2d in and out."""
    y = _matmul_taps(_taps(x_padded), w4) + bias4.float()
    if mode == "relu":
        y = torch.relu(y)
    elif mode == "film":
        trunk = unpad_s2d(x_padded).float()
        y = trunk + torch.relu(y * gamma4.float()[:, None, None, :]
                               + beta4.float()[:, None, None, :])
    return pad_s2d(y.to(x_padded.dtype))


def conv3x3_s2d_fused_pool_plain(x_padded, w4, bias4, pool="s2d"):
    """The relu conv and the 2x2 max-pool of its stored (rounded) output:
    the next level's padded s2d plane, or the pixel-domain pool."""
    out = conv3x3_s2d_fused_plain(x_padded, w4, bias4)
    return out, (pool_to_s2d_plain if pool == "s2d" else pool_s2d_plain)(out)


def conv3x3_s2d_fused2_plain(x1_padded, x2_padded, w4_1, w4_2, bias4):
    """relu(conv(x1, W1) + conv(x2, W2) + b); padded s2d in and out."""
    y = (_matmul_taps(_taps(x1_padded), w4_1) + _matmul_taps(_taps(x2_padded), w4_2)
         + bias4.float())
    return pad_s2d(torch.relu(y).to(x1_padded.dtype))


def _deinterleave(plane: torch.Tensor) -> torch.Tensor:
    """Finer-level padded plane (B, 2m+2, 2m+2, K) -> (B, m, m, 4, K), the
    4 axis the sub-pixel group 2p+q of each coarse block."""
    b, side, _, k = plane.shape
    m = (side - 2) // 2
    t = unpad_s2d(plane).reshape(b, m, 2, m, 2, k).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, m, m, 4, k)


def deconv_s2d_plain(x_padded, w2, bias4):
    """out[b, 2i+p+1, 2j+q+1] = relu(x[b, i+1, j+1, group 2p+q] @ w2 + b4)."""
    b, mp, _, c4 = x_padded.shape
    m, c, o4 = mp - 2, c4 // 4, w2.shape[-1]
    groups = unpad_s2d(x_padded).float().reshape(b, m, m, 4, c)
    y = torch.relu(groups @ w2.float() + bias4.float())       # (B, m, m, 4, 4O)
    y = y.reshape(b, m, m, 2, 2, o4).permute(0, 1, 3, 2, 4, 5)  # (B, m, p, m, q, 4O)
    return pad_s2d(y.reshape(b, 2 * m, 2 * m, o4).to(x_padded.dtype))


def pool_s2d_plain(x_padded):
    """Padded s2d (B, n+2, n+2, 4C) -> the pixel-domain 2x2 max-pool
    (B, n, n, C): the max over the four sub-pixel groups."""
    b, n, c4 = x_padded.shape[0], x_padded.shape[1] - 2, x_padded.shape[-1]
    return unpad_s2d(x_padded).reshape(b, n, n, 4, c4 // 4).amax(dim=3)


def pool_to_s2d_plain(x_padded):
    """The 2x2 max-pool as the next level's padded s2d (B, n/2+2, n/2+2, 4C)."""
    return pad_s2d(s2d_unshifted(pool_s2d_plain(x_padded)))


def conv3x3_s2d_fused_head_plain(x_padded, w4, bias4, w_head4, b_head4):
    """tanh(relu(conv + b) @ W_head + b_head) on the interior: the relu
    output and the head weights rounded to bfloat16 (the Pallas kernel's
    roundings, :602-603 and :1172), the head summed in float32. Returns the
    unpadded (B, N, N, Ho4) float32."""
    y = torch.relu(_matmul_taps(_taps(x_padded), w4) + bias4.float())
    w_head = w_head4.reshape(w4.shape[-1], -1).to(torch.bfloat16).float()
    return torch.tanh(y.to(torch.bfloat16).float() @ w_head + b_head4.float())


def conv3x3_s2d_chain2_plain(x_padded, w4_1, bias4_1, w4_2, bias4_2, gamma4=None, beta4=None,
                             modes=("relu", "film")):
    """Two chained 3x3 convs, each with its epilogue of ``modes`` and its
    output rounded to the plane's dtype: the sequential composition."""
    h = conv3x3_s2d_fused_plain(x_padded, w4_1, bias4_1, gamma4, beta4, modes[0])
    return conv3x3_s2d_fused_plain(h, w4_2, bias4_2, gamma4, beta4, modes[1])


def conv3x3_s2d_chain3_plain(x_padded, w1a4, bias14, wf4, biasf4, gamma4, beta4, w34, bias34,
                             x2_padded=None, w1b4=None, pool=""):
    """A whole site: conv_in (or the two-operand conv over (x, x2)), the
    FiLM site, conv_out [+ its 2x2 max-pool], each intermediate rounded to
    the plane's dtype: the sequential composition."""
    if x2_padded is None:
        h0 = conv3x3_s2d_fused_plain(x_padded, w1a4, bias14)
    else:
        h0 = conv3x3_s2d_fused2_plain(x_padded, x2_padded, w1a4, w1b4, bias14)
    s = conv3x3_s2d_fused_plain(h0, wf4, biasf4, gamma4, beta4, "film")
    if pool:
        return conv3x3_s2d_fused_pool_plain(s, w34, bias34, pool)
    return conv3x3_s2d_fused_plain(s, w34, bias34)


def conv5x5_s2d_fused_plain(x_padded, w9, bias4, mode="relu"):
    """relu(conv + b) or conv + b over the 9 dense taps; padded s2d in and
    out, w9 (3, 3, 4C, 4Co) from ``conv5x5_to_s2d_kernel``."""
    y = _matmul_taps(_taps5(x_padded), w9) + bias4.float()
    if mode == "relu":
        y = torch.relu(y)
    return pad_s2d(y.to(x_padded.dtype))


# --------------------------------------------------------------------------
# Kernel dispatch.
# --------------------------------------------------------------------------


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_plane(name: str, x: torch.Tensor) -> tuple[int, int, int]:
    _require(x.ndim == 4 and x.shape[1] == x.shape[2] and x.shape[1] > 2
             and x.shape[-1] % 4 == 0,
             f"{name}: expected a padded s2d plane (B, N+2, N+2, 4C), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1] - 2, x.shape[-1]


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    _require(t.dtype == torch.float32 and tuple(t.shape) == shape,
             f"{name}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")


def _check_weight(name: str, w: torch.Tensor, shape: tuple, dtype) -> None:
    _require(tuple(w.shape) == shape and w.dtype == dtype,
             f"{name}: expected {dtype} {shape}, got {w.dtype} {tuple(w.shape)}")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors (kernel);
    raises for any other device, mixed devices, or what the kernel does not
    take."""
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors),
             f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return False
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(tensors[0].dtype in _cuda.DTYPE_CODES,
             f"kernels take float32 or bfloat16, got {tensors[0].dtype}")
    _require(all(t.is_contiguous() for t in tensors), "kernels take contiguous tensors")
    _require(all(t.data_ptr() % 16 == 0 for t in tensors),
             "kernels take 16-byte aligned tensors")
    return True


def _check_kernel_widths(co4: int, *c4s: int, run: int = 32) -> None:
    """The kernels copy whole 16-byte vectors: each gathered channel run a
    multiple of 8 elements (4C a multiple of 32 for the 3x3 gathers and the
    deconv, of 8 for the 5x5) and 4Co a multiple of 8."""
    _require(all(c4 % run == 0 for c4 in c4s) and co4 % 8 == 0,
             f"kernels take 4C multiple of {run} and 4Co multiple of 8, "
             f"got 4C {c4s}, 4Co {co4}")


def _launch(name: str, problem: tuple, entry: str, *args) -> None:
    _cuda.check(getattr(_cuda.library(), entry)(*args), name)
    SHAPES[name, problem] += 1


def _conv3x3_s2d_impl(x_padded, w4, bias4, gamma4=None, beta4=None, mode="relu"):
    """Fused s2d 3x3 conv, padded s2d (B, N+2, N+2, 4C) -> (B, N+2, N+2, 4Co).

    w4 (2, 2, 4C, 4Co) in the dtype of x; bias4 (4Co,) float32. ``mode``
    'relu': relu(y + b); 'none': y + b; 'film': x + relu((y + b) * gamma4 +
    beta4) with gamma4, beta4 (B, 4C) float32 and C == Co.
    """
    b, n, c4 = _check_plane("conv3x3_s2d_fused", x_padded)
    co4 = w4.shape[-1]
    _check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    _check_f32("bias4", bias4, (co4,))
    _require(mode in _EPILOGUES, f"unknown mode {mode!r}")
    extra = ()
    if mode == "film":
        _require(c4 == co4, "film mode needs C_out == C_in (residual add)")
        _check_f32("gamma4", gamma4, (b, c4))
        _check_f32("beta4", beta4, (b, c4))
        extra = (gamma4, beta4)
    if not _on_cuda(x_padded, w4, bias4, *extra):
        return conv3x3_s2d_fused_plain(x_padded, w4, bias4, gamma4, beta4, mode)
    _check_kernel_widths(co4, c4)
    out = torch.empty((b, n + 2, n + 2, co4), dtype=x_padded.dtype, device=x_padded.device)
    name = "conv3x3_s2d_fused[none]" if mode == "none" else "conv3x3_s2d_fused"
    film = mode == "film"
    with torch.cuda.device(x_padded.device):
        _launch(name, (b, n, c4, co4, mode), "depgan_conv3x3_s2d_fused",
                _cuda.DTYPE_CODES[x_padded.dtype],
                x_padded.data_ptr(), w4.data_ptr(), bias4.data_ptr(),
                gamma4.data_ptr() if film else None, beta4.data_ptr() if film else None,
                out.data_ptr(), None, b, n, c4, co4, _EPILOGUES[mode], 0,
                _cuda.stream(x_padded.device))
    return out


def conv3x3_s2d_fused_pool(x_padded, w4, bias4, pool="s2d"):
    """The relu 3x3 conv that also emits the 2x2 max-pool of its stored
    output (serving only: no gradient, as in JAX). Returns (out, pooled):
    pooled is the next level's padded s2d (B, N/2+2, N/2+2, 4Co) for
    ``pool='s2d'`` or the pixel-domain pool (B, N, N, Co) for ``'pixel'``.
    The kernel takes 4Co <= 256: in bfloat16 the wgmma mainloop's pool in
    registers at 4Co of 32, 64, 128 or 256 and the engine at the other
    widths (``kernel_route``), in float32 the engine."""
    b, n, c4 = _check_plane("conv3x3_s2d_fused_pool", x_padded)
    co4 = w4.shape[-1]
    _check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    _check_f32("bias4", bias4, (co4,))
    _require(pool in _POOLS, f"unknown pool mode {pool!r}")
    _require(pool != "s2d" or n % 2 == 0, "pool='s2d' needs an even interior size")
    if not _on_cuda(x_padded, w4, bias4):
        return conv3x3_s2d_fused_pool_plain(x_padded, w4, bias4, pool)
    _require(co4 <= 256, "the fused pool kernel takes at most 256 output channels")
    _check_kernel_widths(co4, c4)
    dev, dt = x_padded.device, x_padded.dtype
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    if pool == "s2d":
        pooled = torch.empty((b, n // 2 + 2, n // 2 + 2, co4), dtype=dt, device=dev)
    else:
        pooled = torch.empty((b, n, n, co4 // 4), dtype=dt, device=dev)
    problem = (b, n, c4, co4, pool)
    ptrs = (x_padded.data_ptr(), w4.data_ptr(), bias4.data_ptr())
    with torch.cuda.device(dev):
        if dt == torch.bfloat16 and kernel_route("conv3x3_s2d_fused_pool", problem[1:],
                                                 dt) == "engine":
            _launch("conv3x3_s2d_fused_pool", problem, "depgan_conv3x3_s2d_engine",
                    _cuda.DTYPE_CODES[dt], ptrs[0], None, ptrs[1], None, ptrs[2], None, None,
                    out.data_ptr(), pooled.data_ptr(), b, n, c4, 0, co4, _EPILOGUES["relu"],
                    _POOLS[pool], _cuda.stream(dev))
        else:
            _launch("conv3x3_s2d_fused_pool", problem, "depgan_conv3x3_s2d_fused",
                    _cuda.DTYPE_CODES[dt], *ptrs, None, None, out.data_ptr(),
                    pooled.data_ptr(), b, n, c4, co4, _EPILOGUES["relu"], _POOLS[pool],
                    _cuda.stream(dev))
    return out, pooled


def _conv2_impl(x1_padded, x2_padded, w4_1, w4_2, bias4):
    """relu(conv(x1, W1) + conv(x2, W2) + b): the decoder's first conv over
    concat(x1, x2) without the concat. x1 (B, N+2, N+2, 4C1), x2 (B, N+2,
    N+2, 4C2), w4_i (2, 2, 4Ci, 4Co) -> (B, N+2, N+2, 4Co)."""
    b, n, c4a = _check_plane("conv3x3_s2d_fused2 x1", x1_padded)
    b2, n2, c4b = _check_plane("conv3x3_s2d_fused2 x2", x2_padded)
    _require((b2, n2) == (b, n), "x1 and x2 must share batch and plane size")
    co4 = w4_1.shape[-1]
    _check_weight("w4_1", w4_1, (2, 2, c4a, co4), x1_padded.dtype)
    _check_weight("w4_2", w4_2, (2, 2, c4b, co4), x1_padded.dtype)
    _require(x2_padded.dtype == x1_padded.dtype, "x1 and x2 must share a dtype")
    _check_f32("bias4", bias4, (co4,))
    if not _on_cuda(x1_padded, x2_padded, w4_1, w4_2, bias4):
        return conv3x3_s2d_fused2_plain(x1_padded, x2_padded, w4_1, w4_2, bias4)
    _check_kernel_widths(co4, c4a, c4b)
    dev, dt = x1_padded.device, x1_padded.dtype
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _launch("conv3x3_s2d_fused2", (b, n, c4a, c4b, co4), "depgan_conv3x3_s2d_fused2",
                _cuda.DTYPE_CODES[dt],
                x1_padded.data_ptr(), x2_padded.data_ptr(), w4_1.data_ptr(), w4_2.data_ptr(),
                bias4.data_ptr(), out.data_ptr(), b, n, c4a, c4b, co4, _cuda.stream(dev))
    return out


def _deconv_impl(x_padded, w2, bias4):
    """Deconv2x2 + bias + relu from padded s2d (B, M+2, M+2, 4C) into the
    finer level's padded s2d (B, 2M+2, 2M+2, 4O); w2 (C, 4O) is the Keras
    kernel in matmul form, bias4 (4O,) float32. bfloat16 runs the wgmma
    deconv at the widths ``wgmma_plan.deconv_plan`` takes (M <= 256, B and
    the tiles inside the shared memory) and the engine, the same sums, at
    the others (``kernel_route``); float32 runs the engine."""
    b, m, c4 = _check_plane("deconv_s2d", x_padded)
    o4 = w2.shape[-1]
    _check_weight("w2", w2, (c4 // 4, o4), x_padded.dtype)
    _check_f32("bias4", bias4, (o4,))
    if not _on_cuda(x_padded, w2, bias4):
        return deconv_s2d_plain(x_padded, w2, bias4)
    _check_kernel_widths(o4, c4)
    dev, dt = x_padded.device, x_padded.dtype
    entry = ("depgan_deconv_s2d_engine" if dt == torch.bfloat16
             and kernel_route("deconv_s2d", (m, c4, o4), dt) == "engine" else "depgan_deconv_s2d")
    out = torch.empty((b, 2 * m + 2, 2 * m + 2, o4), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _launch("deconv_s2d", (b, m, c4, o4), entry, _cuda.DTYPE_CODES[dt],
                x_padded.data_ptr(), w2.data_ptr(), bias4.data_ptr(), out.data_ptr(),
                b, m, c4, o4, _cuda.stream(dev))
    return out


def _pool_impl(x_padded, to_s2d: bool):
    """The 2x2 max-pool of a padded s2d plane: into the next level's padded
    s2d plane (``to_s2d``) or into the pixel domain."""
    name = "pool_to_s2d" if to_s2d else "pool_s2d"
    b, n, c4 = _check_plane(name, x_padded)
    _require(not to_s2d or n % 2 == 0, f"{name} needs an even interior size")
    if not _on_cuda(x_padded):
        return (pool_to_s2d_plain if to_s2d else pool_s2d_plain)(x_padded)
    _require(c4 % 32 == 0, f"{name}: the kernel takes 4C multiple of 32, got {c4}")
    dev, dt = x_padded.device, x_padded.dtype
    shape = (b, n // 2 + 2, n // 2 + 2, c4) if to_s2d else (b, n, n, c4 // 4)
    out = torch.empty(shape, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _launch(name, (b, n, c4), f"depgan_{name}", _cuda.DTYPE_CODES[dt], x_padded.data_ptr(),
                out.data_ptr(), b, n, c4, _cuda.stream(dev))
    return out


def kernel_route(name: str, problem: tuple, dtype) -> str | None:
    """The kernel that a CUDA call of the wrapper counted as ``name`` runs at
    ``problem`` (its shape arguments as ``SHAPES`` counts them, without the
    batch) in ``dtype``, decided from the widths alone: 'wgmma' (the bf16
    wgmma kernels), 'engine' (the GEMM engine, which sums as they do: every
    float32 conv, and bf16 K2 at 4Co outside ``POOL_WIDTHS`` and K4 where
    ``deconv_plan`` refuses), 'chain' (float32 K10, ``s2d_chain``), 'pool'
    (K5, K6); None where no kernel takes the widths and the wrapper raises.
    Covers the kernels of the generator's fused forward: K1-K6, K9, K10."""
    bf16 = dtype == torch.bfloat16

    def takes(co4, *c4s):
        return co4 > 0 and co4 % 8 == 0 and all(c4 > 0 and c4 % 32 == 0 for c4 in c4s)

    if name in ("conv3x3_s2d_fused", "conv3x3_s2d_fused[none]"):
        _, c4, co4, _ = problem
        ok = takes(co4, c4)
    elif name == "conv3x3_s2d_fused2":
        _, c4a, c4b, co4 = problem
        ok = takes(co4, c4a, c4b)
    elif name == "conv3x3_s2d_fused_pool":
        n, c4, co4, pool = problem
        if not (takes(co4, c4) and co4 <= 256 and (pool != "s2d" or n % 2 == 0)):
            return None
        return "wgmma" if bf16 and co4 in POOL_WIDTHS else "engine"
    elif name == "conv3x3_s2d_fused_head":
        _, c4, co4, h4 = problem
        ok = takes(co4, c4) and co4 <= 256 and 0 < h4 <= 16
    elif name == "deconv_s2d":
        m, c4, o4 = problem
        if not takes(o4, c4):
            return None
        return "wgmma" if bf16 and deconv_takes(m, c4, o4) else "engine"
    elif name in ("pool_to_s2d", "pool_s2d"):
        n, c4 = problem
        return "pool" if c4 > 0 and c4 % 32 == 0 and (name == "pool_s2d" or n % 2 == 0) else None
    elif name == "conv3x3_s2d_chain3":
        n, c4a, c4b, c4m, c4o, pool = problem
        c4s = (c4a, c4b) if c4b else (c4a,)
        if not takes(c4o, *c4s, c4m) or (pool == "s2d" and n % 2):
            return None
        if not bf16:
            return "chain"
        return "wgmma" if chain_takes(n, c4s, c4m, c4o, pool) else None
    else:
        raise ValueError(f"no route rule for {name!r}")
    return ("wgmma" if bf16 else "engine") if ok else None


def conv5_kernel_name(c4: int, co4: int = 0, n: int = 0, dtype=torch.float32) -> str:
    """The kernel a CUDA call of ``_conv5_impl`` with 4C input channels
    launches: K11 when ``CONV5_PACKED`` is on and 4C <= 64 (JAX's gate,
    ``conv_s2d_pallas.py:1952``), else K7. bfloat16 K11 runs the wgmma
    window, so a bfloat16 call (4Co output channels at interior side n)
    launches K11 only at widths the window takes
    (``wgmma_plan.conv5_window_takes``) and K7, the same sums, elsewhere."""
    packed = CONV5_PACKED and c4 <= 64 and (
        dtype != torch.bfloat16 or conv5_window_takes(n, c4, co4))
    return "conv5x5_s2d_fused[packed]" if packed else "conv5x5_s2d_fused"


def _conv5_impl(x_padded, w9, bias4, mode="relu"):
    """Dense 3x3-tap s2d conv (the SAME 5x5 pixel conv), padded s2d
    (B, N+2, N+2, 4C) -> (B, N+2, N+2, 4Co). w9 (3, 3, 4C, 4Co) in the dtype
    of x, bias4 (4Co,) float32; ``mode`` 'relu' or 'none'. On a CUDA tensor
    it launches K11 (``conv5x5_s2d_fused[packed]``) when ``CONV5_PACKED`` is
    on and 4C <= 64, else K7; both take 4C and 4Co multiples of 8. bfloat16
    K11 runs the wgmma window kernel at the widths it takes (4C a multiple
    of 16, 4Co up to 256, N+2 <= 256: ``conv5_kernel_name``), and other
    bfloat16 widths launch K7; float32 K11 runs ``window_conv``."""
    b, n, c4 = _check_plane("conv5x5_s2d_fused", x_padded)
    co4 = w9.shape[-1]
    _check_weight("w9", w9, (3, 3, c4, co4), x_padded.dtype)
    _check_f32("bias4", bias4, (co4,))
    _require(mode in ("relu", "none"), f"unknown mode {mode!r}")
    if not _on_cuda(x_padded, w9, bias4):
        return conv5x5_s2d_fused_plain(x_padded, w9, bias4, mode)
    _check_kernel_widths(co4, c4, run=8)
    dev, dt = x_padded.device, x_padded.dtype
    name = conv5_kernel_name(c4, co4, n, dt)
    window = name.endswith("[packed]") and dt == torch.bfloat16
    out = torch.empty((b, n + 2, n + 2, co4), dtype=dt, device=dev)
    args = (x_padded.data_ptr(), w9.data_ptr(), bias4.data_ptr(), out.data_ptr(), b, n, c4, co4,
            _EPILOGUES[mode])
    with torch.cuda.device(dev):
        if window:
            _launch(name, (b, n, c4, co4, mode), "depgan_conv5x5_s2d_window", *args,
                    _cuda.stream(dev))
        else:
            entry = ("depgan_conv5x5_s2d_packed" if name.endswith("[packed]")
                     else "depgan_conv5x5_s2d_fused")
            _launch(name, (b, n, c4, co4, mode), entry, _cuda.DTYPE_CODES[dt], *args,
                    _cuda.stream(dev))
    return out


def _inference_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is inference-only (no gradient, as in JAX): call it "
                           "under torch.no_grad() or on tensors that do not require grad")


def conv3x3_s2d_fused_head(x_padded, w4, bias4, w_head4, b_head4):
    """tanh(relu(conv3x3_s2d(x) + b) @ W_head + b_head): the relu conv with
    the 1x1 head in its epilogue, the relu output and the head weights
    rounded to bfloat16, the head summed in float32. x (B, N+2, N+2, 4C),
    w4 (2, 2, 4C, 4Co) in the dtype of x, bias4 (4Co,) float32, w_head4
    (1, 1, 4Co, Ho4) and b_head4 (Ho4,) float32. Returns the unpadded
    (B, N, N, Ho4) float32. Inference-only. The kernel takes 4Co <= 256 and
    Ho4 <= 16: in bfloat16 the wgmma mainloop's head epilogue, in float32
    the engine's."""
    b, n, c4 = _check_plane("conv3x3_s2d_fused_head", x_padded)
    co4 = w4.shape[-1]
    _check_weight("w4", w4, (2, 2, c4, co4), x_padded.dtype)
    _check_f32("bias4", bias4, (co4,))
    _require(w_head4.ndim == 4 and tuple(w_head4.shape[:3]) == (1, 1, co4),
             f"w_head4: expected (1, 1, {co4}, Ho4), got {tuple(w_head4.shape)}")
    h4 = w_head4.shape[-1]
    _check_f32("w_head4", w_head4, (1, 1, co4, h4))
    _check_f32("b_head4", b_head4, (h4,))
    _inference_only("conv3x3_s2d_fused_head", x_padded, w4, bias4, w_head4, b_head4)
    if not _on_cuda(x_padded, w4, bias4, w_head4, b_head4):
        return conv3x3_s2d_fused_head_plain(x_padded, w4, bias4, w_head4, b_head4)
    _require(co4 <= 256 and h4 <= 16,
             f"the fused head kernel takes 4Co <= 256 and Ho4 <= 16, got {co4}, {h4}")
    _check_kernel_widths(co4, c4)
    dev = x_padded.device
    w_head = w_head4.reshape(co4, h4).to(torch.bfloat16).contiguous()
    out = torch.empty((b, n, n, h4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("conv3x3_s2d_fused_head", (b, n, c4, co4, h4), "depgan_conv3x3_s2d_fused_head",
                _cuda.DTYPE_CODES[x_padded.dtype],
                x_padded.data_ptr(), w4.data_ptr(), bias4.data_ptr(), w_head.data_ptr(),
                b_head4.data_ptr(), out.data_ptr(), b, n, c4, co4, h4, _cuda.stream(dev))
    return out


def _launch_chain(name, problem, x1, x2, w1a, w1b, b1, w2, b2, w3, b3, gamma4, beta4, out,
                  pooled, modes, pool):
    """One chain launch: stage 1 over (x1[, x2]) into w1a's 4Cm channels,
    then one or two (``w3``) more 3x3 convs, each stage's epilogue from
    ``modes``; ``None`` for what the launch does not take."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = x1.device
    with torch.cuda.device(dev):
        _launch(name, problem, "depgan_conv3x3_s2d_chain", _cuda.DTYPE_CODES[x1.dtype],
                ptr(x1), ptr(x2), ptr(w1a), ptr(w1b), ptr(b1), ptr(w2), ptr(b2), ptr(w3),
                ptr(b3), ptr(gamma4), ptr(beta4), ptr(out), ptr(pooled), x1.shape[0],
                x1.shape[1] - 2, x1.shape[-1], 0 if x2 is None else x2.shape[-1],
                w1a.shape[-1], out.shape[-1], *(_EPILOGUES[m] for m in modes),
                _POOLS.get(pool, 0), _cuda.stream(dev))


def conv3x3_s2d_chain2(x_padded, w4_1, bias4_1, w4_2, bias4_2, gamma4=None, beta4=None,
                       modes=("relu", "film")):
    """conv2[modes[1]](conv1[modes[0]](x)) in one kernel: the intermediate
    padded plane never exists in device memory. ``modes``: two of relu /
    film / none, at most one film, whose trunk is that stage's own input and
    which takes gamma4, beta4 (B, 4C of that stage) float32 (zeros when
    None, as in JAX). x (B, N+2, N+2, 4Ci), w4_1 (2, 2, 4Ci, 4Cm), w4_2
    (2, 2, 4Cm, 4Co) in the dtype of x, biases float32. Inference-only."""
    b, n, c4i = _check_plane("conv3x3_s2d_chain2", x_padded)
    if len(modes) != 2 or sum(m == "film" for m in modes) > 1:
        raise ValueError(f"chain2 modes must be 2 with <=1 film: {modes}")
    _require(all(m in _EPILOGUES for m in modes), f"unknown mode in {modes}")
    c4m, c4o = w4_1.shape[-1], w4_2.shape[-1]
    if modes[0] == "film" and c4i != c4m:
        raise ValueError("film stage 1 requires C_mid == C_in")
    if modes[1] == "film" and c4m != c4o:
        raise ValueError("film stage 2 requires C_out == C_mid")
    _check_weight("w4_1", w4_1, (2, 2, c4i, c4m), x_padded.dtype)
    _check_weight("w4_2", w4_2, (2, 2, c4m, c4o), x_padded.dtype)
    _check_f32("bias4_1", bias4_1, (c4m,))
    _check_f32("bias4_2", bias4_2, (c4o,))
    film = "film" in modes
    if film:
        c4f = c4m if modes[0] == "film" else c4o
        if gamma4 is None:
            gamma4 = torch.zeros((b, c4f), dtype=torch.float32, device=x_padded.device)
            beta4 = torch.zeros_like(gamma4)
        _check_f32("gamma4", gamma4, (b, c4f))
        _check_f32("beta4", beta4, (b, c4f))
    extra = (gamma4, beta4) if film else ()
    _inference_only("conv3x3_s2d_chain2", x_padded, w4_1, bias4_1, w4_2, bias4_2, *extra)
    if not _on_cuda(x_padded, w4_1, bias4_1, w4_2, bias4_2, *extra):
        return conv3x3_s2d_chain2_plain(x_padded, w4_1, bias4_1, w4_2, bias4_2, gamma4, beta4,
                                        modes)
    _check_kernel_widths(c4o, c4i, c4m)
    out = torch.empty((b, n + 2, n + 2, c4o), dtype=x_padded.dtype, device=x_padded.device)
    _launch_chain("conv3x3_s2d_chain2", (b, n, c4i, c4m, c4o, *modes), x_padded, None, w4_1,
                  None, bias4_1, w4_2, bias4_2, None, None, gamma4 if film else None,
                  beta4 if film else None, out, None, (*modes, "none"), "")
    return out


def conv3x3_s2d_chain3(x_padded, w1a4, bias14, wf4, biasf4, gamma4, beta4, w34, bias34,
                       x2_padded=None, w1b4=None, pool=""):
    """A whole generator site in one kernel: conv_out(film_site(conv_in(x)))
    or, with ``x2_padded``, conv_in the two-operand conv over (x, x2);
    h0 and the site output never exist in device memory. x (B, N+2, N+2,
    4Ca), x2 (B, N+2, N+2, 4Cb), w1a4 (2, 2, 4Ca, 4Cm), w1b4 (2, 2, 4Cb,
    4Cm), wf4 (2, 2, 4Cm, 4Cm), w34 (2, 2, 4Cm, 4Co) in the dtype of x;
    biases, gamma4 and beta4 (B, 4Cm) float32. Returns out, or (out, pooled)
    for ``pool`` 's2d' / 'pixel' as ``conv3x3_s2d_fused_pool``.
    Inference-only. bfloat16 runs the wgmma chain, which takes the widths
    ``wgmma_plan.chain_plan`` takes (4Cm = 4Co of 128 or 256) and raises for
    others; float32 runs ``s2d_chain``."""
    b, n, c4a = _check_plane("conv3x3_s2d_chain3", x_padded)
    c4m, c4o = w1a4.shape[-1], w34.shape[-1]
    if wf4.shape[-1] != c4m:
        raise ValueError("film conv must keep channels (residual add)")
    if pool not in ("", "s2d", "pixel"):
        raise ValueError(f"unknown pool mode {pool!r}")
    if pool == "s2d" and n % 2:
        raise ValueError("pool='s2d' needs an even n")
    dt = x_padded.dtype
    two_op = x2_padded is not None
    c4b = 0
    if two_op:
        b2, n2, c4b = _check_plane("conv3x3_s2d_chain3 x2", x2_padded)
        _require((b2, n2) == (b, n) and x2_padded.dtype == dt,
                 "x and x2 must share batch, plane size and dtype")
        _require(w1b4 is not None, "the two-operand chain needs w1b4")
        _check_weight("w1b4", w1b4, (2, 2, c4b, c4m), dt)
    _check_weight("w1a4", w1a4, (2, 2, c4a, c4m), dt)
    _check_weight("wf4", wf4, (2, 2, c4m, c4m), dt)
    _check_weight("w34", w34, (2, 2, c4m, c4o), dt)
    for name, t, shape in (("bias14", bias14, (c4m,)), ("biasf4", biasf4, (c4m,)),
                           ("gamma4", gamma4, (b, c4m)), ("beta4", beta4, (b, c4m)),
                           ("bias34", bias34, (c4o,))):
        _check_f32(name, t, shape)
    ops = [t for t in (x_padded, x2_padded, w1a4, w1b4) if t is not None]
    rest = (bias14, wf4, biasf4, gamma4, beta4, w34, bias34)
    _inference_only("conv3x3_s2d_chain3", *ops, *rest)
    if not _on_cuda(*ops, *rest):
        return conv3x3_s2d_chain3_plain(x_padded, w1a4, bias14, wf4, biasf4, gamma4, beta4,
                                        w34, bias34, x2_padded, w1b4, pool)
    _check_kernel_widths(c4o, c4a, c4m, *((c4b,) if two_op else ()))
    wgmma = dt == torch.bfloat16
    if wgmma:
        chain_plan(n, (c4a, c4b) if two_op else (c4a,), c4m, c4o, pool)  # raises for refusals
    dev = x_padded.device
    out = torch.empty((b, n + 2, n + 2, c4o), dtype=dt, device=dev)
    pooled = None
    if pool == "s2d":
        pooled = torch.empty((b, n // 2 + 2, n // 2 + 2, c4o), dtype=dt, device=dev)
    elif pool == "pixel":
        pooled = torch.empty((b, n, n, c4o // 4), dtype=dt, device=dev)
    problem = (b, n, c4a, c4b, c4m, c4o, pool)
    if not wgmma:
        _launch_chain("conv3x3_s2d_chain3", problem, x_padded, x2_padded, w1a4, w1b4, bias14, wf4,
                      biasf4, w34, bias34, gamma4, beta4, out, pooled, ("relu", "film", "relu"),
                      pool)
        return (out, pooled) if pool else out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        _launch("conv3x3_s2d_chain3", problem, "depgan_conv3x3_s2d_chain3_wgmma",
                *(ptr(t) for t in (x_padded, x2_padded, w1a4, w1b4, bias14, wf4, biasf4, w34,
                                   bias34, gamma4, beta4, out, pooled)),
                b, n, c4a, c4b, c4m, c4o, _POOLS.get(pool, 0), _cuda.stream(dev))
    return (out, pooled) if pool else out


# --------------------------------------------------------------------------
# Autograd rules (the custom VJPs of conv_s2d_pallas.py).
# --------------------------------------------------------------------------


def _interior_f32(plane: torch.Tensor) -> torch.Tensor:
    return unpad_s2d(plane).float()


def _dw(taps: torch.Tensor, dpre: torch.Tensor, shape) -> torch.Tensor:
    """Weight cotangent from gathered taps and the output cotangent: one
    float32 matmul over every output position (the einsums of
    ``_dw4_einsums`` / ``_conv5_bwd``)."""
    dint = _interior_f32(dpre)
    return (taps.reshape(-1, taps.shape[-1]).T @ dint.reshape(-1, dint.shape[-1])).reshape(shape)


def _dbias(dpre: torch.Tensor) -> torch.Tensor:
    return _interior_f32(dpre).sum((0, 1, 2))


def _transposed_conv3x3(dpre, w4, c_in4):
    """dX of a 3x3 s2d conv: the flip-transposed conv through the kernel in
    'none' mode with zero bias (first-order only, as in JAX)."""
    zeros = torch.zeros(c_in4, dtype=torch.float32, device=dpre.device)
    return _conv3x3_s2d_impl(dpre, flip_transpose_w4(w4).contiguous(), zeros, mode="none")


class _Conv3x3(torch.autograd.Function):
    """``conv3x3_s2d_fused``'s rule (``_conv3x3_s2d_bwd``, :846-915)."""

    @staticmethod
    def forward(ctx, x_padded, w4, bias4, gamma4, beta4, mode):
        out = _conv3x3_s2d_impl(x_padded, w4, bias4, gamma4, beta4, mode)
        ctx.mode = mode
        ctx.save_for_backward(x_padded, w4, bias4, gamma4, beta4, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w4, bias4, gamma4, beta4, out = ctx.saved_tensors
        need_x, need_w, need_b, need_g, need_bt = ctx.needs_input_grad[:5]
        g = zero_ring(g)
        dx = dw4 = dbias = dgamma = dbeta = None
        if ctx.mode == "film":
            # The relu mask is (gamma * c0 + beta) > 0 with the pre-
            # modulation conv c0 recomputed by one 'none' launch: differencing
            # the rounded output (out - x) can flip it where the FiLM branch
            # cancels against the residual trunk.
            c0 = _conv3x3_s2d_impl(x, w4, bias4, mode="none").float()
            gb, bb = gamma4[:, None, None, :], beta4[:, None, None, :]
            gm = torch.where(c0 * gb + bb > 0, g.float(), 0.0)
            dpre = (gm * gb).to(x.dtype)
            if need_g:
                dgamma = (gm * c0).sum((1, 2))
            if need_bt:
                dbeta = gm.sum((1, 2))
        elif ctx.mode == "relu":
            dpre = torch.where(out > 0, g, 0.0).to(x.dtype)
        else:
            dpre = g.to(x.dtype)
        if need_x:
            dx = _transposed_conv3x3(dpre, w4, x.shape[-1])
            if ctx.mode == "film":
                dx = dx + g  # the residual trunk
            dx = dx.to(x.dtype)
        if need_w:
            dw4 = _dw(_taps(x), dpre, w4.shape).to(w4.dtype)
        if need_b:
            dbias = _dbias(dpre)
        return dx, dw4, dbias, dgamma, dbeta, None


def conv3x3_s2d_fused(x_padded, w4, bias4, gamma4=None, beta4=None, mode="relu"):
    """Fused s2d 3x3 conv, padded s2d (B, N+2, N+2, 4C) -> (B, N+2, N+2, 4Co),
    differentiable to first order. Arguments as ``_conv3x3_s2d_impl``."""
    return _Conv3x3.apply(x_padded, w4, bias4, gamma4, beta4, mode)


class _Conv3x3Two(torch.autograd.Function):
    """``conv3x3_s2d_fused2``'s rule (``_conv2_bwd``, :1369-1396): one relu
    mask, two transposed convs, two weight cotangents."""

    @staticmethod
    def forward(ctx, x1, x2, w4_1, w4_2, bias4):
        out = _conv2_impl(x1, x2, w4_1, w4_2, bias4)
        ctx.save_for_backward(x1, x2, w4_1, w4_2, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x1, x2, w4_1, w4_2, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        dpre = torch.where(out > 0, zero_ring(g), 0.0).to(x1.dtype)
        grads = [None] * 5
        for i, (x, w4) in enumerate(((x1, w4_1), (x2, w4_2))):
            if need[i]:
                grads[i] = _transposed_conv3x3(dpre, w4, x.shape[-1]).to(x.dtype)
            if need[2 + i]:
                grads[2 + i] = _dw(_taps(x), dpre, w4.shape).to(w4.dtype)
        if need[4]:
            grads[4] = _dbias(dpre)
        return tuple(grads)


def conv3x3_s2d_fused2(x1_padded, x2_padded, w4_1, w4_2, bias4):
    """relu(conv(x1, W1) + conv(x2, W2) + b), differentiable to first order.
    Arguments as ``_conv2_impl``."""
    return _Conv3x3Two.apply(x1_padded, x2_padded, w4_1, w4_2, bias4)


class _Deconv(torch.autograd.Function):
    """``deconv_s2d_pallas``'s rule: the backward of the plain deconv
    (``_deconv_ref``, :381, :467-473); JAX has no backward kernel either."""

    @staticmethod
    def forward(ctx, x_padded, w2, bias4):
        out = _deconv_impl(x_padded, w2, bias4)
        ctx.save_for_backward(x_padded, w2, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w2, out = ctx.saved_tensors
        b, mp, _, c4 = x.shape
        m, c, o4 = mp - 2, c4 // 4, w2.shape[-1]
        dpre = torch.where(_deinterleave(out) > 0, _deinterleave(g).float(), 0.0)
        dx = dw2 = dbias = None
        if ctx.needs_input_grad[0]:
            dx = pad_s2d((dpre @ w2.float().T).reshape(b, m, m, c4)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            groups = _interior_f32(x).reshape(-1, c)
            dw2 = (groups.T @ dpre.reshape(-1, o4)).to(w2.dtype)
        if ctx.needs_input_grad[2]:
            dbias = dpre.sum((0, 1, 2, 3))
        return dx, dw2, dbias


def deconv_s2d(x_padded, w2, bias4):
    """Deconv2x2 + bias + relu into the finer padded s2d plane,
    differentiable to first order. Arguments as ``_deconv_impl``."""
    return _Deconv.apply(x_padded, w2, bias4)


def pool_s2d_bwd(x_padded, g):
    """VJP of ``pool_s2d`` (``_pool_ref`` :188-194 under ``jax.vjp``): the
    cotangent of each window split evenly among its tied maxima, as JAX's
    max reduction does. Plain torch, linear in ``g``, so it differentiates
    again."""
    b, n, c4 = x_padded.shape[0], x_padded.shape[1] - 2, x_padded.shape[-1]
    inter = unpad_s2d(x_padded).reshape(b, n, n, 4, c4 // 4)
    hit = (inter == inter.amax(dim=3, keepdim=True)).to(g.dtype)
    share = g[:, :, :, None, :] / hit.sum(dim=3, keepdim=True)
    return pad_s2d((hit * share).reshape(b, n, n, c4))


def pool_to_s2d_bwd(x_padded, g):
    """VJP of ``pool_to_s2d`` (``_pool_to_s2d_ref`` :300-317): the next
    level's padded cotangent back to pixels, then ``pool_s2d_bwd``."""
    return pool_s2d_bwd(x_padded, d2s(unpad_s2d(g)))


class _Pool(torch.autograd.Function):
    """The pools' rule: ``pool_s2d_bwd`` / ``pool_to_s2d_bwd``, whose plain
    torch ops autograd differentiates again."""

    @staticmethod
    def forward(ctx, x_padded, to_s2d):
        ctx.to_s2d = to_s2d
        ctx.save_for_backward(x_padded)
        return _pool_impl(x_padded, to_s2d)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (pool_to_s2d_bwd if ctx.to_s2d else pool_s2d_bwd)(x, g), None


def pool_s2d(x_padded):
    """2x2 max-pool of a padded s2d plane (B, N+2, N+2, 4C) into the pixel
    domain (B, N, N, C)."""
    return _Pool.apply(x_padded, False)


def pool_to_s2d(x_padded):
    """2x2 max-pool of a padded s2d plane (B, N+2, N+2, 4C) into the next
    level's padded s2d plane (B, N/2+2, N/2+2, 4C)."""
    return _Pool.apply(x_padded, True)


class _Conv5x5(torch.autograd.Function):
    """``conv5x5_s2d_fused``'s rule (``_conv5_bwd``, :1993-2046). dX is this
    op again on the flipped, io-swapped kernel, and dW is a matmul gathered
    back through the transform's adjoint, so the backward differentiates
    again (the WGAN-GP double backward)."""

    @staticmethod
    def forward(ctx, x_padded, w5, bias, mode):
        w9, bias4 = conv5x5_to_s2d_kernel(w5, bias)
        out = _conv5_impl(x_padded, w9.to(x_padded.dtype).contiguous(),
                          bias4.float().contiguous(), mode)
        ctx.mode = mode
        ctx.save_for_backward(x_padded, w5, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w5, out = ctx.saved_tensors
        g = zero_ring(g)
        dpre = (torch.where(out > 0, g, 0.0) if ctx.mode == "relu" else g).to(x.dtype)
        dx = dw5 = dbias = None
        if ctx.needs_input_grad[0]:
            zeros = torch.zeros(w5.shape[2], dtype=torch.float32, device=x.device)
            dx = conv5x5_s2d_fused(dpre, flip_transpose_w5(w5), zeros, "none").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw9 = _dw(_taps5(x), dpre, (3, 3, x.shape[-1], out.shape[-1]))
            dw5 = conv5x5_to_s2d_kernel_adjoint(dw9).to(w5.dtype)
        if ctx.needs_input_grad[2]:
            dbias = _dbias(dpre).reshape(4, -1).sum(0)
        return dx, dw5, dbias, None


def conv5x5_s2d_fused(x_padded, w5, bias, mode="relu"):
    """relu(conv5x5_SAME(x, w5) + b), or without the relu for 'none', in
    padded s2d: (B, N+2, N+2, 4C) -> (B, N+2, N+2, 4Co). Takes the live pixel
    kernel w5 (5, 5, C, Co) and bias (Co,) and transforms them inside, so
    its cotangents are the pixel kernel's. Differentiable twice over."""
    return _Conv5x5.apply(x_padded, w5, bias, mode)
