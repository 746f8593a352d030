"""Weights made on the device from the seed: one ``torch.rand`` and one
``torch.randn`` call over all leaves of a network, each leaf a view scaled
by its kind (Flax's glorot-uniform convolutions and deconvolutions,
he-normal denses, small random biases, BatchNorm scale, offset and moving
statistics spread so that folding them is no identity)."""

from __future__ import annotations

import math

import torch


def make(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 leaves for ``spec`` ((name, shape, kind) triples) from ``seed``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        u, n = uniform[off:off + size].view(shape), normal[off:off + size].view(shape)
        off += size
        if kind in ("conv", "deconv"):
            receptive = math.prod(shape[:-2])
            limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
            value = (2 * u - 1) * limit
        elif kind == "dense":
            value = n * math.sqrt(2.0 / math.prod(shape[:-1]))
        elif kind == "bias":
            value = 0.02 * n
        elif kind == "scale":
            value = 0.8 + 0.4 * u
        elif kind in ("beta", "mean"):
            value = 0.1 * n
        elif kind == "var":
            value = 0.5 + u
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = value.clone()
    return out


def calibrate_head(params: dict, logits: torch.Tensor) -> None:
    """Rescales and re-centres the 1x1 head in place so that ``logits``
    (its output over a few slices) would have mean 0 and standard
    deviation 0.5 a channel: a DEM spread over (-1, 1), or class
    probabilities away from one-hot, as a trained generator's are, instead
    of saturated random logits whose gradients and rounding vanish."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    mean, std = flat.mean(0), flat.std(0).clamp_min(1e-6)
    scale = 0.5 / std
    params["gen_segmentation.kernel"].mul_(scale)
    params["gen_segmentation.bias"].sub_(mean).mul_(scale)


def split(leaves: dict, spec) -> tuple[dict, dict]:
    """(parameters, BatchNorm statistics) of a generator's leaves."""
    stats = {name for name, _, kind in spec if kind in ("mean", "var")}
    return ({k: v for k, v in leaves.items() if k not in stats},
            {k: v for k, v in leaves.items() if k in stats})


def tree(flat: dict) -> dict:
    """Nested dict of numpy arrays by the dotted names (the Flax layout the
    program's serving entry takes)."""
    root: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy()
    return root
