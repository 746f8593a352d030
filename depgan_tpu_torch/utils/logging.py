"""Training observability: TensorBoard logger + loss-history files.

Counterpart of ``depgan_tpu/utils/logging.py``: the reference ``Logger``'s
surface — ``log_scalar``, ``log_images``, ``log_histogram``
(`...twoCritics_training_4fold.py:167-248`) — on top of the self-contained
tfevents writer (utils/tb_writer.py), plus the UResNet trainer's
append-only loss-history text files
(`DEP-UResNet-wNoises-training-4fold.py:608-618`). The files are the JAX
package's byte for byte, but for ``log_graph``, whose graph records torch's
operators where JAX's records a jaxpr's.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from . import tb_writer as tb


def _to_png(img: np.ndarray, denorm=(0, 255)) -> tuple[bytes, int, int]:
    """Encode one image (H, W) or (H, W, C) to PNG bytes.

    Single-channel images get a viridis-like colormap, mirroring the
    reference's ``plt.imsave(..., cmap='viridis')`` (reference :204); RGB
    images are denormalised from [-1, 1] (reference :199).
    """
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        lo, hi = float(img.min()), float(img.max())
        norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        rgb = _viridis(norm)
    else:
        rgb = ((img + 1) / 2 * denorm[1]).clip(*denorm).astype(np.uint8)
    pil = Image.fromarray(rgb)
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    return buf.getvalue(), rgb.shape[0], rgb.shape[1]


def _viridis(x: np.ndarray) -> np.ndarray:
    """Cheap viridis approximation via piecewise-linear control points."""
    stops = np.array(
        [
            [68, 1, 84], [59, 82, 139], [33, 145, 140],
            [94, 201, 98], [253, 231, 37],
        ],
        dtype=np.float64,
    )
    pos = np.linspace(0, 1, len(stops))
    r = np.interp(x, pos, stops[:, 0])
    g = np.interp(x, pos, stops[:, 1])
    b = np.interp(x, pos, stops[:, 2])
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


class _OpRecorder(TorchDispatchMode):
    """Records each aten operator that runs while it is active as a
    NodeDef: op = the overload's name (``aten.convolution.default``),
    inputs = the nodes that produced its tensor arguments; a tensor no
    recorded operator produced becomes a ``Placeholder`` where it is first
    read. At most ``max_nodes`` operators are recorded."""

    def __init__(self, max_nodes: int):
        super().__init__()
        self.max_nodes = max_nodes
        self.nodes: list[bytes] = []
        self.names = WeakTensorKeyDictionary()
        self.n_ops = self.n_inputs = 0

    def _name_of(self, t: torch.Tensor) -> str:
        name = self.names.get(t)
        if name is None:
            name = f"input_{self.n_inputs}"
            self.n_inputs += 1
            self.nodes.append(tb.node_def(name, "Placeholder"))
            self.names[t] = name
        return name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.n_ops < self.max_nodes:
            inputs = [self._name_of(t) for t in pytree.tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            name = f"{func}_{self.n_ops}"
            self.nodes.append(tb.node_def(name, str(func), inputs))
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.names[t] = name
            self.n_ops += 1
        return out


class Logger:
    """TensorBoard logger with the reference Logger's method surface."""

    def __init__(self, log_dir: str | Path):
        self.writer = tb.EventWriter(log_dir)

    def log_scalar(self, tag: str, value, step: int) -> None:
        self.writer.add_summary(tb.scalar_summary(tag, float(value)), step)

    def log_scalars(self, scalars: dict, step: int) -> None:
        for tag, value in scalars.items():
            self.log_scalar(tag, value, step)

    def log_images(self, tag: str, images, step: int, denorm=(0, 255)) -> None:
        for i, img in enumerate(images):
            png, h, w = _to_png(np.asarray(img), denorm)
            self.writer.add_summary(
                tb.image_summary(f"{tag}/{i}", png, h, w), step
            )

    def log_histogram(self, tag: str, values, step: int = 0, bins: int = 1000) -> None:
        self.writer.add_summary(tb.histogram_summary(tag, np.asarray(values), bins), step)

    def log_graph(self, fn, example_args, max_nodes: int = 5000):
        """TensorBoard graph tab (reference ``log_graph``,
        `...twoCritics_training_4fold.py:174-175`, which dumps the TF1
        graph). JAX's traces ``fn`` into a jaxpr without running it; torch
        has no such trace of an eager function, so this runs
        ``fn(*example_args)`` once — the caller's real call, not an extra
        one — under a dispatch mode that records each aten operator as a
        GraphDef node (op = the overload's name, inputs = the nodes that
        produced its tensors, the first ``max_nodes`` operators), and
        returns ``fn``'s result. The backward's operators are recorded too.
        A hand-written kernel bound outside the dispatcher (``ops/_cuda.py``
        launches through ctypes) records no node: its output tensor shows as
        the aten operator that allocated it (``aten.empty``...), with no
        edge from the kernel's inputs."""
        recorder = _OpRecorder(max_nodes)
        with recorder:
            out = fn(*example_args)
        self.writer.add_graph(tb.graph_def(recorder.nodes))
        return out

    def close(self) -> None:
        self.writer.close()


class LossHistory:
    """Append-only loss history .txt, one value per line
    (`DEP-UResNet-wNoises-training-4fold.py:608-618`)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, values) -> None:
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
        with open(self.path, "ab") as f:
            np.savetxt(f, arr)


class NullLogger:
    """No-op logger for benchmarks and tests; ``log_graph`` still runs
    ``fn``, as ``Logger.log_graph`` does."""

    def log_scalar(self, *a, **k):
        pass

    def log_scalars(self, *a, **k):
        pass

    def log_images(self, *a, **k):
        pass

    def log_histogram(self, *a, **k):
        pass

    def log_graph(self, fn, example_args, max_nodes: int = 5000):
        return fn(*example_args)

    def close(self):
        pass
