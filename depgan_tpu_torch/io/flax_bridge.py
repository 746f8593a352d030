"""Weights and training state carried across from Flax-layout trees.

A variable tree is ``{"params": ..., "batch_stats": ...}``, nested dicts
keyed by the reference Keras layer names with array leaves: what
``depgan_tpu.models.init_generator`` and ``init_critic`` return, what
``io/h5_import.py`` fills from a Keras ``.h5``, and what
``models.init_generator`` and ``models.init_critic`` here write in numpy.
The port's modules keep the Flax names and layouts, so parameter
``a.b.kernel`` is ``params["a"]["b"]["kernel"]`` and buffer ``a.b.mean`` is
``batch_stats["a"]["b"]["mean"]``. ``gan_trees_from_state`` and
``uresnet_trees_from_state`` carry a training state back into such trees,
with its Adam moments: checkpoints and the ``.h5`` export build on them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..train.state import GanTrainState, UResNetTrainState, adam_moments, make_adam


def _tree_get(tree: dict, dotted: str):
    node = tree
    for key in dotted.split("."):
        node = node[key]
    return node


def _leaf_names(tree: dict, prefix: str = "") -> set[str]:
    names = set()
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            names |= _leaf_names(value, name + ".")
        else:
            names.add(name)
    return names


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Copies ``variables`` into ``module``'s parameters and buffers.

    Strict: every parameter and buffer must find a leaf of the same shape,
    and every leaf must find a parameter or buffer; anything else raises.
    Returns ``module``.
    """
    targets = {"params": dict(module.named_parameters()),
               "batch_stats": dict(module.named_buffers())}
    for collection, tensors in targets.items():
        tree = variables.get(collection, {})
        extra = _leaf_names(tree) - tensors.keys()
        if extra:
            raise KeyError(f"{collection} leaves with no module tensor: {sorted(extra)}")
        for name, tensor in tensors.items():
            try:
                value = np.asarray(_tree_get(tree, name))
            except KeyError:
                raise KeyError(f"{collection} has no leaf for {name}") from None
            if value.shape != tuple(tensor.shape):
                raise ValueError(f"{collection}/{name}: shape {value.shape}, "
                                 f"module expects {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(value.astype(np.float32)))
    return module


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {dotted name: leaf}."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(flatten_tree(value, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def unflatten_tree(flat: dict) -> dict:
    """{dotted name: leaf} -> nested dicts; inverse of ``flatten_tree``."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def zeros_like_tree(tree: dict) -> dict:
    """A tree of numpy zeros shaped like ``tree``: fresh Adam moments."""
    return {k: zeros_like_tree(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def _tensors(tree: dict, device, requires_grad: bool = False) -> dict[str, torch.Tensor]:
    return {name: torch.tensor(np.asarray(v), dtype=torch.float32, device=device,
                               requires_grad=requires_grad)
            for name, v in flatten_tree(tree).items()}


def gan_train_state_from_trees(trees: dict, lr_g: float, lr_d: float, b1: float, b2: float,
                               device="cuda") -> GanTrainState:
    """The port's ``GanTrainState`` from the numpy trees of a JAX one.

    ``trees`` holds ``g_params``, ``g_stats``, ``dy2_params`` and
    ``ddem_params`` as Flax-layout trees, and ``g_opt``, ``dy2_opt`` and
    ``ddem_opt`` as ``{"count": int, "mu": tree, "nu": tree}``: optax's
    ``ScaleByAdamState`` of ``optax.adam``. Both sides can then start one
    superstep from the same state.
    """
    def part(prefix, lr):
        params = _tensors(trees[f"{prefix}_params"], device, requires_grad=True)
        opt = trees[f"{prefix}_opt"]
        adam = make_adam(params, lr, b1, b2, int(opt["count"]),
                         _tensors(opt["mu"], device), _tensors(opt["nu"], device))
        return params, adam

    g_params, g_opt = part("g", lr_g)
    dy2_params, dy2_opt = part("dy2", lr_d)
    ddem_params, ddem_opt = part("ddem", lr_d)
    return GanTrainState(g_params=g_params, g_stats=_tensors(trees["g_stats"], device),
                         g_opt=g_opt, dy2_params=dy2_params, dy2_opt=dy2_opt,
                         ddem_params=ddem_params, ddem_opt=ddem_opt)


def uresnet_train_state_from_trees(params: dict, batch_stats: dict, opt: dict, lr: float,
                                   device="cuda") -> UResNetTrainState:
    """The port's ``UResNetTrainState`` from the numpy trees of a JAX one:
    Flax-layout ``params`` and ``batch_stats``, and ``opt`` as ``{"count":
    int, "mu": tree, "nu": tree}``, the ``ScaleByAdamState`` of
    ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8)."""
    tensors = _tensors(params, device, requires_grad=True)
    adam = make_adam(tensors, lr, 0.9, 0.999, int(opt["count"]), _tensors(opt["mu"], device),
                     _tensors(opt["nu"], device))
    return UResNetTrainState(params=tensors, batch_stats=_tensors(batch_stats, device), opt=adam)


def numpy_tree(tensors: dict[str, torch.Tensor]) -> dict:
    """Flat ``{dotted name: tensor}`` -> a Flax-layout tree of numpy
    arrays on the host (copies)."""
    return unflatten_tree({name: t.detach().cpu().numpy().copy() for name, t in tensors.items()})


def _adam_tree(opt: torch.optim.Adam, params: dict[str, torch.Tensor]) -> dict:
    count, mu, nu = adam_moments(opt, params)
    return {"count": count, "mu": numpy_tree(mu), "nu": numpy_tree(nu)}


def gan_trees_from_state(state: GanTrainState) -> dict:
    """Inverse of ``gan_train_state_from_trees``: the numpy Flax-layout
    trees of ``state``, with each Adam's ``count``, ``mu`` and ``nu``
    (optax's ``ScaleByAdamState``), in the layout that function takes."""
    trees = {"g_stats": numpy_tree(state.g_stats)}
    for prefix in ("g", "dy2", "ddem"):
        params = getattr(state, f"{prefix}_params")
        trees[f"{prefix}_params"] = numpy_tree(params)
        trees[f"{prefix}_opt"] = _adam_tree(getattr(state, f"{prefix}_opt"), params)
    return trees


def uresnet_trees_from_state(state: UResNetTrainState) -> dict:
    """Inverse of ``uresnet_train_state_from_trees``: ``{"params",
    "batch_stats", "opt"}`` of ``state`` as numpy Flax-layout trees, ``opt``
    as ``{"count", "mu", "nu"}``."""
    return {"params": numpy_tree(state.params), "batch_stats": numpy_tree(state.batch_stats),
            "opt": _adam_tree(state.opt, state.params)}
