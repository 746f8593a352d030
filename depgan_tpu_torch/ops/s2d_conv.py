"""Space-to-depth layout algebra and kernel transforms (the subset of
``depgan_tpu/ops/s2d_conv.py`` that the serving and training paths use).

An image (B, 2N, 2N, C) in *unshifted* s2d is (B, N, N, 4C): block (i, j)
holds pixels (2i+p, 2j+q) with sub-pixel channel order (p, q, c). A SAME 3x3
conv on the image is a 2x2-tap conv over the shifted s2d layout with the
transformed kernel (2, 2, 4Ci, 4Co) of ``conv3x3_to_s2d_kernel``; a SAME 5x5
conv is a 3x3-tap conv over the padded unshifted layout with the kernel
(3, 3, 4Ci, 4Co) of ``conv5x5_to_s2d_kernel``.

Both transforms place each pixel tap (dy, dx) once for every output
sub-pixel (p, q), in distinct cells: they are injective scatters, written as
one ``index_put`` so that autograd differentiates them (the training path
transforms live parameters), and their adjoints are gathers.
"""

from __future__ import annotations

import functools

import torch


def s2d_unshifted(x: torch.Tensor) -> torch.Tensor:
    """(B, 2N, 2N, C) -> unshifted s2d (B, N, N, 4C)."""
    return torch.cat([x[:, p::2, q::2, :] for p in range(2) for q in range(2)], dim=-1)


def d2s(y: torch.Tensor) -> torch.Tensor:
    """Unshifted s2d (B, N, M, 4C) -> (B, 2N, 2M, C)."""
    b, n, m, c4 = y.shape
    c = c4 // 4
    yr = y.reshape(b, n, m, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return yr.reshape(b, 2 * n, 2 * m, c)


def tile_channel_params(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector (..., C) -> s2d channel vector (..., 4C)."""
    return v.repeat((1,) * (v.ndim - 1) + (4,))


def _cell(k: int, p: int, q: int, dy: int, dx: int) -> tuple[int, int, int]:
    """Where pixel tap (dy, dx) of a k x k kernel lands for output sub-pixel
    (p, q): (tap row, tap col, source sub-pixel group).

    3x3 on the shifted layout: output pixel (2i+p, 2j+q) reads input row
    2i+p+dy-1, which sits in shifted block i+A, sub-row r, p + dy = 2A + r.
    5x5 on the padded unshifted layout: it reads row 2i+p+dy-2, u = p+dy-2
    in {-2..3}, which sits in unshifted block i + (u-r)/2 with r = u mod 2:
    padded tap row (u-r)/2 + 1 in {0, 1, 2}, no group permutation.
    """
    if k == 3:
        (a, r), (b, s) = divmod(p + dy, 2), divmod(q + dx, 2)
    else:
        u, v = p + dy - 2, q + dx - 2
        r, s = u % 2, v % 2
        a, b = (u - r) // 2 + 1, (v - s) // 2 + 1
    return a, b, 2 * r + s


@functools.cache
def _cells(k: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Index tensors (tap row, tap col, source group, destination group) of
    every placement, in (p, q, dy, dx) order."""
    rows = [(*_cell(k, p, q, dy, dx), 2 * p + q)
            for p in range(2) for q in range(2) for dy in range(k) for dx in range(k)]
    return tuple(torch.tensor(col, device=device) for col in zip(*rows))


def _to_s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    k, _, ci, co = w.shape
    taps = 2 if k == 3 else 3
    a, b, src, dst = _cells(k, w.device)
    vals = w.unsqueeze(0).expand(4, k, k, ci, co).reshape(-1, ci, co)
    out = w.new_zeros((taps, taps, 4, 4, ci, co)).index_put((a, b, src, dst), vals)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(taps, taps, 4 * ci, 4 * co)


def _check_kernel(w: torch.Tensor, k: int) -> None:
    if w.ndim != 4 or tuple(w.shape[:2]) != (k, k):
        raise ValueError(f"expected a {k}x{k} HWIO kernel, got {tuple(w.shape)}")


def conv3x3_to_s2d_kernel(w: torch.Tensor, bias: torch.Tensor | None = None):
    """SAME 3x3 HWIO kernel (3, 3, Ci, Co) -> the shifted-s2d 2x2 kernel
    (2, 2, 4Ci, 4Co), and the bias tiled to (4Co,)."""
    _check_kernel(w, 3)
    return _to_s2d_kernel(w), None if bias is None else bias.repeat(4)


def conv5x5_to_s2d_kernel(w: torch.Tensor, bias: torch.Tensor | None = None):
    """SAME 5x5 HWIO kernel (5, 5, Ci, Co) -> the dense 3x3-tap kernel
    (3, 3, 4Ci, 4Co) over the padded unshifted layout, and the bias tiled
    to (4Co,). Port of ``conv5x5_to_s2d_kernel_j``."""
    _check_kernel(w, 5)
    return _to_s2d_kernel(w), None if bias is None else bias.repeat(4)


def conv5x5_to_s2d_kernel_adjoint(dw9: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``conv5x5_to_s2d_kernel``: an s2d kernel cotangent
    (3, 3, 4Ci, 4Co) -> the pixel kernel's (5, 5, Ci, Co), each tap summed
    over its four placements."""
    ci, co = dw9.shape[2] // 4, dw9.shape[3] // 4
    a, b, src, dst = _cells(5, dw9.device)
    cells = dw9.reshape(3, 3, 4, ci, 4, co).permute(0, 1, 2, 4, 3, 5)[a, b, src, dst]
    return cells.reshape(4, 5, 5, ci, co).sum(0)


def flip_transpose_w4(w4: torch.Tensor) -> torch.Tensor:
    """s2d kernel of the transposed 3x3 conv: read the pixel kernel back out
    of w4 (output sub-pixel (0, 0) holds every tap verbatim), flip it
    spatially, swap input and output channels, transform again. Port of
    ``_flip_transpose_w4`` (``conv_s2d_pallas.py:785-809``)."""
    ci, co = w4.shape[2] // 4, w4.shape[3] // 4
    a, b, src, _ = (t[:9] for t in _cells(3, w4.device))  # (p, q) = (0, 0)
    w_px = w4.reshape(2, 2, 4, ci, 4, co)[a, b, src, :, 0, :].reshape(3, 3, ci, co)
    return _to_s2d_kernel(torch.flip(w_px, (0, 1)).permute(0, 1, 3, 2))


def flip_transpose_w5(w5: torch.Tensor) -> torch.Tensor:
    """Pixel kernel of the transposed SAME 5x5 conv: flipped spatially,
    input and output channels swapped."""
    return torch.flip(w5, (0, 1)).permute(0, 1, 3, 2)


def conv1x1_to_s2d_kernel(w: torch.Tensor, bias: torch.Tensor | None = None):
    """1x1 conv (1, 1, Ci, Co) -> block-diagonal s2d 1x1 (1, 1, 4Ci, 4Co)."""
    ci, co = w.shape[-2:]
    w4 = torch.block_diag(*([w[0, 0]] * 4))
    return w4.reshape(1, 1, 4 * ci, 4 * co), None if bias is None else bias.repeat(4)
