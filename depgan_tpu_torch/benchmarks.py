"""Benchmarks of the port on the card.

Counterpart of ``depgan_tpu/benchmarks.py``. ``gan_step_bench`` is the same
workload as the JAX package's (``benchmarks.py:142-193``): one two-critic
superstep (D critic updates per critic, the best-of-k probe, the generator
update) of the DEP-GAN at ``image_size`` 256, ``first_fm`` 32, bf16 trunk,
random weights and data from ``seed``, timed with CUDA events.
``uresnet_step_bench`` times one ``UResNetTrainer.step`` (the training
forward through K8 at every FiLM site, the cross-entropy, the backward,
Adam) of the DEP-UResNet at the same widths, batch 16, with
``dropout_mode='uresnet'``, as ``train-uresnet --use-pallas`` runs it.
``gen_inference_bench`` and ``uresnet_inference_bench`` are the JAX
package's (:33-139): the bf16 ``FastGenerator`` (the serving forward, K1-K4
at 8/2/2/1 launches a forward), ``n_scan`` forwards chained so that none
can be skipped or overlapped, in 256x256 slices per second. All need a card
and refuse to run without one.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DataConfig, GanTrainConfig, ModelConfig, UResNetTrainConfig
from .data.pipeline import EpochShuffler
from .models import init_generator
from .ops import conv_s2d
from .ops.fast_gen import FastGenerator
from .train.gan_trainer import GanTrainer
from .train.uresnet_trainer import UResNetTrainer

BASELINE_SLICES_PER_SEC = 5000.0  # BASELINE.json's north-star target


def _cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmarks need a CUDA device")
    return torch.device("cuda")


def _time_reps(run, repeats: int) -> dict:
    """ms of each of ``repeats`` calls of ``run`` after one warm-up call
    (cuDNN and cuBLAS plans, the kernels' first launches), CUDA events
    around each; the last call's result, kernel launches by name and by
    problem shape, and the peak device memory of the timed calls."""
    device = _cuda_device()
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reps = []
    for _ in range(repeats):
        conv_s2d.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = run()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end))
    return {"reps_ms": reps, "result": result,
            "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "launches": conv_s2d.launches(), "shapes": dict(conv_s2d.SHAPES)}


def gan_superstep(batch: int = 16, d_iters: int = 5, k_noise: int = 10, image_size: int = 256,
                  use_pallas: bool = True, seed: int = 0):
    """A callable that runs one superstep of the benchmark's workload on
    the card and returns its metrics; each call continues the training."""
    device = _cuda_device()
    model_cfg = ModelConfig(image_size=image_size, first_fm=32, n_input_channels=1,
                            compute_dtype="bfloat16", use_pallas=use_pallas)
    train_cfg = GanTrainConfig(batch_size=batch, d_iters=d_iters, warmup_d_iters=d_iters,
                               k_noise=k_noise)
    trainer = GanTrainer(model_cfg, train_cfg, DataConfig(), device)
    state = trainer.init_state(seed)
    rng = np.random.default_rng(seed)
    n = 8 * batch
    x_all = torch.tensor(rng.uniform(0, 1, (n, image_size, image_size, 1)), dtype=torch.float32,
                         device=device)
    y_all = torch.tensor(rng.uniform(0, 1, (n, image_size, image_size, 1)), dtype=torch.float32,
                         device=device)
    idx = np.arange(d_iters * batch).reshape(d_iters, batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda: trainer.superstep(state, x_all, y_all, idx, d_iters, generator=gen)[1]


def gan_step_bench(batch: int = 16, d_iters: int = 5, k_noise: int = 10, image_size: int = 256,
                   use_pallas: bool = True, seed: int = 0, repeats: int = 3) -> dict:
    """ms per superstep (the least of ``repeats`` after one warm-up
    superstep), with the last superstep's kernel launches by name and by
    problem shape, and the peak device memory of the timed supersteps."""
    t = _time_reps(gan_superstep(batch, d_iters, k_noise, image_size, use_pallas, seed), repeats)
    return {"ms_per_superstep": min(t["reps_ms"]), "reps_ms": t["reps_ms"],
            "peak_memory_gib": t["peak_memory_gib"], "launches": t["launches"],
            "shapes": t["shapes"], "errG": float(t["result"]["gen"]["errG"])}


def uresnet_step(batch: int = 16, image_size: int = 256, compute_dtype: str = "float32",
                 seed: int = 0):
    """A callable that runs one UResNet training step on the card and
    returns its loss; each call continues the training over a synthetic
    fold of 4 batches (slices uniform in [0, 1), labels thresholded from
    them, made on the device), shuffled per epoch as ``fit`` does."""
    device = _cuda_device()
    model_cfg = ModelConfig(image_size=image_size, first_fm=32, n_out=4,
                            dropout_mode="uresnet", compute_dtype=compute_dtype,
                            use_pallas=True)
    train_cfg = UResNetTrainConfig(batch_size=batch, seed=seed)
    trainer = UResNetTrainer(model_cfg, train_cfg, device)
    state = trainer.init_state(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 4 * batch
    x_all = torch.rand((n, image_size, image_size, 1), generator=gen, device=device)
    labels = torch.bucketize(x_all[..., 0], torch.tensor([0.3, 0.6, 0.85], device=device))
    y_all = torch.nn.functional.one_hot(labels, train_cfg.n_classes).float()
    noise_all = torch.randn((n, model_cfg.noise_size, 1), generator=gen, device=device)
    shuffler = EpochShuffler(n, batch, seed)
    batches: list = []

    def run():
        if not batches:
            batches.extend(shuffler.epoch())
        return trainer.step(state, x_all, y_all, noise_all, batches.pop(), generator=gen)[1]

    return run


def uresnet_step_bench(batch: int = 16, image_size: int = 256, compute_dtype: str = "float32",
                       seed: int = 0, repeats: int = 3) -> dict:
    """ms per UResNet training step (the least of ``repeats`` after one
    warm-up step), with the last step's kernel launches by name and by
    problem shape, and the peak device memory of the timed steps."""
    t = _time_reps(uresnet_step(batch, image_size, compute_dtype, seed), repeats)
    return {"ms_per_step": min(t["reps_ms"]), "reps_ms": t["reps_ms"],
            "peak_memory_gib": t["peak_memory_gib"], "launches": t["launches"],
            "shapes": t["shapes"], "loss": float(t["result"])}


def _inference_bench(cfg: ModelConfig, metric: str, n_scan: int, batch: int, seed: int) -> dict:
    """``n_scan`` bf16 ``FastGenerator`` forwards of ``batch`` slices, each
    forward's input ``tanh(carry + 1e-12 * y)`` of the last one's output
    (JAX's ``lax.scan`` chain), timed between CUDA events: the least of 4
    runs after a first run, in 256x256 slices per second, with the spread
    of the 4 and the kernel launches of the last run."""
    device = _cuda_device()
    fast = FastGenerator(cfg, init_generator(cfg, seed=seed), torch.bfloat16, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((batch, cfg.image_size, cfg.image_size, 1), generator=gen, device=device)
    zs = torch.randn((n_scan, batch, cfg.noise_size, 1), generator=gen, device=device)

    def chain():
        carry, total = x, torch.zeros((), device=device)
        for z in zs:
            y = fast(carry, z)
            carry = torch.tanh(carry + 1e-12 * y[..., :1])
            total = total + y.sum()
        return total

    t = _time_reps(chain, 4)
    slices_per_sec = n_scan * batch / (min(t["reps_ms"]) / 1e3)
    return {"metric": metric, "value": round(slices_per_sec, 1),
            "unit": "256x256_slices/sec/chip",
            "vs_baseline": round(slices_per_sec / BASELINE_SLICES_PER_SEC, 3),
            "reps_ms": t["reps_ms"],
            "spread": (max(t["reps_ms"]) - min(t["reps_ms"])) / min(t["reps_ms"]),
            "n_scan": n_scan, "batch": batch, "launches": t["launches"]}


def gen_inference_bench(n_scan: int = 32, batch: int = 512, seed: int = 0) -> dict:
    """Serving throughput of the DEP-GAN generator (reference hot loop
    ``DEP-GAN_testing_4fold.py:616-628``) at image 256, first_fm 32, bf16.
    Batch 512 is two in-flight subjects' 420-slice ensembles."""
    cfg = ModelConfig(image_size=256, first_fm=32, n_input_channels=1, compute_dtype="bfloat16")
    return _inference_bench(cfg, "gen_inference_throughput", n_scan, batch, seed)


def uresnet_inference_bench(n_scan: int = 32, batch: int = 256, seed: int = 0) -> dict:
    """Serving throughput of the DEP-UResNet's 4-class softmax generator
    (``DEP-UResNet_testing_4fold.py:552-564``), as ``gen_inference_bench``."""
    cfg = ModelConfig(image_size=256, first_fm=32, n_input_channels=1, n_out=4,
                      dropout_mode="uresnet", compute_dtype="bfloat16")
    return _inference_bench(cfg, "uresnet_inference_throughput", n_scan, batch, seed)
