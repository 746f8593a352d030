"""Benchmarks of the port on the card.

Counterpart of ``depgan_tpu/benchmarks.py``. ``gan_step_bench`` is the same
workload as the JAX package's (``benchmarks.py:142-193``): one two-critic
superstep (D critic updates per critic, the best-of-k probe, the generator
update) of the DEP-GAN at ``image_size`` 256, ``first_fm`` 32, bf16 trunk,
random weights and data from ``seed``, timed with CUDA events. It needs a
card and refuses to run without one.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DataConfig, GanTrainConfig, ModelConfig
from .ops import conv_s2d
from .train.gan_trainer import GanTrainer


def gan_superstep(batch: int = 16, d_iters: int = 5, k_noise: int = 10, image_size: int = 256,
                  use_pallas: bool = True, seed: int = 0):
    """A callable that runs one superstep of the benchmark's workload on
    the card and returns its metrics; each call continues the training."""
    if not torch.cuda.is_available():
        raise RuntimeError("the GAN benchmark needs a CUDA device")
    device = torch.device("cuda")
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
    run = gan_superstep(batch, d_iters, k_noise, image_size, use_pallas, seed)
    device = torch.device("cuda")
    run()  # warm-up: cuDNN and cuBLAS plans, the kernels' first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reps = []
    for _ in range(repeats):
        conv_s2d.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = run()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end))
    return {"ms_per_superstep": min(reps), "reps_ms": reps,
            "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "launches": conv_s2d.launches(), "shapes": dict(conv_s2d.SHAPES),
            "errG": float(metrics["gen"]["errG"])}
