"""Keras HDF5 weight files <-> Flax-layout variable trees.

Counterpart of ``depgan_tpu/io/h5_import.py``: a numpy copy working on the
tree that ``models.init_generator`` writes and ``io.flax_bridge.
load_flax_variables`` loads. ``h5py`` is imported inside the functions that
read or write a file, so importing the port does not need it.

The reference ships 20 trained-weight families as Keras `.h5` files
(the reference's `models/readme.txt`) saved by ``netG.save``
(`...twoCritics_training_4fold.py:892`) and loaded with
``load_weights`` (`DEP-GAN_testing_4fold.py:383`). This module reads that
format directly with h5py — no TF/Keras import — and maps each layer's
weights onto the matching Flax module (module names mirror Keras layer
names, see models/blocks.py).

Keras h5 layout: a root (or 'model_weights') group with attr 'layer_names';
each layer group has attr 'weight_names' like ``b'conv2d_gen_0/kernel:0'``
with datasets at those paths.

Weight-name mapping:

==================  =====================  =========================
Keras weight        Flax collection        Flax param
==================  =====================  =========================
kernel              params                 kernel  (layout identical)
bias                params                 bias
gamma               params                 scale   (BatchNorm)
beta                params                 bias    (BatchNorm)
moving_mean         batch_stats            mean
moving_variance     batch_stats            var
==================  =====================  =========================

Conv2D kernels are HWIO in both frameworks; Conv2DTranspose kernels keep the
Keras (kh, kw, out, in) layout because our Deconv2x2 stores them that way.
"""

from __future__ import annotations

from typing import Any

import numpy as np

_KERAS_TO_FLAX = {
    "kernel": ("params", "kernel"),
    "bias": ("params", "bias"),
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
_FLAX_TO_KERAS_BN = {"scale": "gamma", "bias": "beta"}
_FLAX_TO_KERAS_STATS = {"mean": "moving_mean", "var": "moving_variance"}


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict[tuple, Any]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _layer_index(variables: dict) -> dict[str, dict[str, tuple]]:
    """Map leaf-module name -> {flax param name: (collection, full path)}.

    Leaf-module name is the second-to-last path element, which by
    construction equals the Keras layer name (models/blocks.py).
    """
    index: dict[str, dict[str, tuple]] = {}
    for coll in ("params", "batch_stats"):
        if coll not in variables:
            continue
        for path, leaf in _flatten(variables[coll]).items():
            layer, pname = path[-2], path[-1]
            index.setdefault(layer, {})[f"{coll}/{pname}"] = (coll, path, leaf)
    return index


def _weights_group(f):
    return f["model_weights"] if "model_weights" in f else f


def _decode(names) -> list[str]:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def load_keras_h5(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read {layer_name: {weight_leaf_name: array}} from a Keras h5 file."""
    import h5py

    out: dict[str, dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = _weights_group(f)
        layer_names = _decode(g.attrs.get("layer_names", list(g.keys())))
        for lname in layer_names:
            if lname not in g:
                continue
            lg = g[lname]
            weight_names = _decode(lg.attrs.get("weight_names", []))
            if not weight_names:
                continue
            weights = {}
            for wname in weight_names:
                leaf = wname.split("/")[-1].split(":")[0]
                weights[leaf] = np.asarray(lg[wname])
            out[lname] = weights
    return out


def import_keras_h5(
    path: str,
    variables: dict,
    aliases: dict[str, str] | None = None,
    strict: bool = True,
) -> dict:
    """Load Keras weights into a Flax variables pytree (returns a new tree).

    ``aliases`` maps Flax leaf-module names to Keras layer names for layers
    Keras auto-named (e.g. the critic's final ``Dense(1)``, reference :342).
    Unaliased mismatches fall back to unique-shape matching; ``strict``
    raises if any model parameter ends up without a source.
    """
    aliases = dict(aliases or {})
    keras_layers = load_keras_h5(path)
    index = _layer_index(variables)

    flat_updates: dict[tuple[str, tuple], np.ndarray] = {}
    matched_keras: set[str] = set()
    unmatched_flax: list[str] = []

    def shapes_of(weights: dict[str, np.ndarray]) -> tuple:
        return tuple(sorted((k, v.shape) for k, v in weights.items()))

    def apply_layer(flax_name: str, weights: dict[str, np.ndarray]) -> None:
        slots = index[flax_name]
        for leaf, arr in weights.items():
            if leaf not in _KERAS_TO_FLAX:
                raise ValueError(f"unknown Keras weight '{leaf}' in layer {flax_name}")
            coll, pname = _KERAS_TO_FLAX[leaf]
            key = f"{coll}/{pname}"
            if key not in slots:
                raise ValueError(
                    f"layer {flax_name}: model has no slot for Keras weight '{leaf}'"
                )
            _, fpath, current = slots[key]
            if tuple(current.shape) != tuple(arr.shape):
                raise ValueError(
                    f"layer {flax_name}/{leaf}: shape {arr.shape} != model "
                    f"{tuple(current.shape)}"
                )
            flat_updates[(coll, fpath)] = arr.astype(np.float32)

    for flax_name in index:
        keras_name = aliases.get(flax_name, flax_name)
        if keras_name in keras_layers:
            apply_layer(flax_name, keras_layers[keras_name])
            matched_keras.add(keras_name)
        else:
            unmatched_flax.append(flax_name)

    # Fallback: unique shape-signature matching for auto-named Keras layers.
    remaining_keras = {
        k: v for k, v in keras_layers.items() if k not in matched_keras
    }
    for flax_name in list(unmatched_flax):
        want = tuple(
            sorted(
                (key.split("/")[-1], tuple(leaf.shape))
                for key, (_, _, leaf) in index[flax_name].items()
            )
        )

        def keras_sig(w):
            renamed = {
                _KERAS_TO_FLAX[k][1]: v for k, v in w.items() if k in _KERAS_TO_FLAX
            }
            return tuple(sorted((k, tuple(v.shape)) for k, v in renamed.items()))

        candidates = [k for k, w in remaining_keras.items() if keras_sig(w) == want]
        if len(candidates) == 1:
            apply_layer(flax_name, remaining_keras.pop(candidates[0]))
            unmatched_flax.remove(flax_name)

    if strict and unmatched_flax:
        raise ValueError(
            f"no Keras source for model layers: {sorted(unmatched_flax)}; "
            f"unused Keras layers: {sorted(remaining_keras)}"
        )

    # Rebuild the variables tree with updates applied.
    new_vars = {}
    for coll, tree in variables.items():
        flat = _flatten(tree)
        for (c, fpath), arr in flat_updates.items():
            if c == coll:
                flat[fpath] = arr
        new_vars[coll] = _unflatten(flat)
    return new_vars


def export_keras_h5(variables: dict, path: str) -> None:
    """Write a Flax variables pytree as a Keras-layout weights h5 file.

    Lets trained models round-trip back into Keras tooling, and provides
    the fixture format for importer tests.
    """
    import h5py

    index = _layer_index(variables)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [n.encode() for n in index], dtype="S"
        )
        f.attrs["backend"] = b"depgan_tpu_torch"
        for lname, slots in index.items():
            lg = f.create_group(lname)
            weight_names = []
            for key, (coll, _, leaf) in sorted(slots.items()):
                pname = key.split("/")[-1]
                if coll == "batch_stats":
                    kname = _FLAX_TO_KERAS_STATS[pname]
                elif any(k.startswith("batch_stats/") for k in slots) and pname in _FLAX_TO_KERAS_BN:
                    kname = _FLAX_TO_KERAS_BN[pname]
                else:
                    kname = pname  # kernel / bias
                wname = f"{lname}/{kname}:0"
                lg.create_dataset(wname, data=np.asarray(leaf))
                weight_names.append(wname.encode())
            lg.attrs["weight_names"] = np.array(weight_names, dtype="S")


# Flax-module-name -> Keras-layer-name aliases for layers Keras auto-names.
CRITIC_ALIASES: dict[str, str] = {}  # final Dense matched by unique shape
