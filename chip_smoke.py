#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the CUDA kernels in ``depgan_tpu_torch/csrc/``, with
   the registers, stack frame and spill bytes that ptxas gave every
   instantiation of the GEMM engine (``s2d_gemm``), the production ones
   held to ENGINE_FIGURES, and of the bf16 wgmma mainloop of K1, K2, K3,
   K7, K9 (its head epilogue) and P1's phases (``s2d_wgmma``), of P2's
   window kernel on it (``rowblk_wgmma``), of bf16 K11's window
   (``conv5_wgmma``), of bf16 K10's chain (``chain_wgmma``) and of bf16
   K4's deconv (``deconv_wgmma``), held to WGMMA_FIGURES; the library's own
   A-load plan of every K1, K2, K3, K7 and K9 shape, with the route it takes
   (TMA boxes or cp.async), P2's window, K11's window, K10's plan and K4's
   plan at their shapes, held to ``ops/wgmma_plan.py``.
2. Kernels: each kernel against its plain PyTorch version at every shape of
   the serving forward and the training superstep (256x256 slices,
   first_fm 32, batch 4), in float32 (atol 1e-4: the indexing) and in
   bfloat16 (atol = rtol = 1e-2 against the plain version computed in
   float32 from the same bf16 inputs and rounded once: the rounding), with
   exactly-zero border rings on NaN-poisoned outputs. K9, K10 and K12 at
   the serving options' shapes too (K9's float32 limit widened by what its
   bf16 rounding of a value within float32 error of a rounding tie can
   move: ``head_rounding_slack``), and the chains against the sequential
   kernels on the same inputs (K1 or K3 -> K1 film -> K1 or K2), whose
   largest difference is printed (0: bit-identical; K10 must be 0). K11
   (``CONV5_PACKED``) at the critic's five packed shapes, equal to K7 on the
   same inputs bit for bit; the probes: P1's four phases at a check shape (``full`` and
   ``matmul_only`` equal to K1 bit for bit, ``stage_only``'s sums within
   1e-5 of their absolute sum), P2 at the level-1/2 shapes with each block
   count (bfloat16, equal to K1 bit for bit), P3 equal to its plain version;
   bf16 P1 and P2 run the wgmma mainloop, bf16 K11 the wgmma window and
   bf16 K10 the wgmma chain.
   In bfloat16, K1, K2 (both outputs), K3, K7 and K9, which run the wgmma
   mainloop, and K4, which runs the wgmma deconv, equal the engine's kernel
   on the same inputs bit for bit; K4 also at the superstep's and the
   serving forward's batches (16, 42).
3. Serving: the 10-repeat ensemble (``EnsemblePredictor(fast=True)``) over
   two synthetic 42-slice subjects against the plain float32 generator
   (``GenUNet2D`` on the unfolded weights, ``plain_predictor``) with the
   same noise (max abs diff < 0.05), once more with the UResNet softmax
   head, and the launch counts of that run: exactly 8, 2, 2 and 1 per
   forward for K1-K4 and no other kernel. 3b. The serving options: a
   full-width bf16 ``FastGenerator`` over one 42-slice batch with
   ``fuse_chain``, ``fuse_head`` and both, each within 0.05 of the plain
   float32 generator with exactly the launches of OPTION_LAUNCHES,
   ``fuse_chain`` identical to the default forward (or within the kernel
   phase's chain-to-sequential difference), and ms per forward beside the
   default path's. 3c. The testing path: a synthetic fold (2 subjects of 42
   slices, every test modality, written as .nii.gz) through
   ``run_gan_testing`` and ``run_uresnet_testing`` at full width with
   n_repeat 10, fast (bf16, exactly 8/2/2/1 launches a forward) and plain
   float32, the weights passed in memory (the card's machine has no h5py):
   the written fast maps equal ``EnsemblePredictor.predict`` bit for bit,
   fast and plain maps within 0.05, both recaps 2 rows of 18 columns with
   Dice and volume differences within TESTING_LIMITS (a float32 control
   within, a run with wrong weights outside), ms per subject with its data
   load, ensemble and metrics + writers parts. 3d. The width gate: the bf16
   ``FastGenerator`` at first_fm 48 and 64 within 0.05 of the plain float32
   generator, each site's route printed, launches as the routes give them.
4. Backward: every autograd rule at the production shapes (float32, batch
   2) against autograd of its plain version, and the 5x5 conv's double
   backward; the 5x5 rule at L0a and L0b and its double backward at L0a
   again with ``CONV5_PACKED``, through K11, with its exact launches.
5. Critic: ``FusedCritic``'s score, input gradient and the gradient
   penalty's parameter gradient (float32, image 256, batch 2, three seeds)
   against the plain ``DisC2DFCN1`` in float64 with ``create_graph``,
   within CRITIC_LIMIT relative L2; the plain critic in float32 reported
   beside, and the fused critic in bfloat16 as a control that must fail;
   then all of it again with ``CONV5_PACKED``, through K11.
6. Superstep: the fused superstep (float32, full width, batch 2, D = 2,
   k = 2, three seeds) against the plain one in float64 from the same
   state with the same draws: the same best noise, and the logged losses,
   the updates, the last gradients (Adam's first moment) and each
   parameter within SUPERSTEP_LIMITS; the plain float32 superstep reported
   beside, and two controls that must fail every limit (the fused
   superstep in bfloat16, and without the gradient penalty). One seed again
   with ``CONV5_PACKED``, with its exact launch counts.
7. UResNet: ``UResNetTrainer.step`` through K8 (float32, full width,
   ``dropout_mode='uresnet'``, batch 2, 3 steps, three seeds) against the
   plain path in float64 from the same state with the same noises and
   dropout masks: the losses, the updates, the changes of the BatchNorm
   statistics and Adam's first moment within URESNET_LIMITS; the plain
   float32 path reported beside, and K8 in bfloat16 as a control that must
   fail every limit. Then ``fit`` for 2 epochs over a synthetic fold
   (64 slices, batch 16, 8 validation slices): finite losses, exactly 7 K8
   launches per training step and per validation chunk, no other kernel.
8. Batch-BN superstep: the superstep with ``bn_mode='batch'`` through K8
   (float32, full width, batch 2, D = 2, k = 2, three seeds) against the
   plain float64 one with the same draws and dropout masks, within
   BATCH_BN_LIMITS, a bfloat16 control that must fail them, and exactly
   7 (2D + k + 1) K8 launches and no other kernel.
9. Timing, for information: ``benchmarks.gan_step_bench`` (bf16, batch 16,
   D = 5, k = 10: ms per superstep, the least of 3 after a warm-up), its
   peak memory and exact launch counts, a profiler breakdown of one
   superstep; ``benchmarks.uresnet_step_bench`` (batch 16, float32 and
   bfloat16: ms per step, peak memory, a profiler breakdown); each
   kernel's launches of those steps replayed shape by shape against its
   plain version and the library call that computes the same function,
   beside the bound, each timed on the device over launches captured in
   a CUDA graph that rotate over input copies of twice the L2's size, K1,
   K2, K3, K4, K7 and K9 in turns with the engine's kernel at the same shape
   (engine, wgmma, wgmma, engine); the serving forward's kernels at batch 42
   and ms per
   served subject; K9 and K10 at the serving options' shapes per forward
   (bf16 K10 in turns with its old route, ``s2d_chain``), and K12 at four
   site shapes, at batch 42. ``gan_step_bench`` with ``CONV5_PACKED``
   beside the default in turns (default, packed, packed, default) with
   exact launch counts, and K11's launches replayed shape by shape beside
   K7's at the same shapes, in turns with its old route (``window_conv``).
10. Probes, for information: each probe's ``main`` at the JAX scripts'
   default shapes (``depgan_tpu_torch/scripts``: P1 and P2 at batch 64, P3
   at batch 256), with their launch counts, and each probe kernel timed
   against its plain version, the library call and its bound; bf16 P1 and
   P2 in turns with their routes before the mainloop (old, new, new, old:
   the engine's phases, ``window_conv``).
11. The training path, as ``train-gan --use-pallas`` and ``train-uresnet
   --use-pallas`` run it: a synthetic training fold (4 subjects x 90
   slices at 256, every training modality, as .nii.gz) through
   ``drivers.run_gan_training`` at full width in float32 (the engine's
   kernels), batch 16, D 5, k 10, over 2 epochs with a cut schedule
   (FIT_CFG, each cut printed): a warm-up superstep, epoch tails, 5
   validations, deferred flushes, checkpoints. Held: each superstep's D
   and n_valid; the exact kernel launches (``fit_launches``: each
   superstep's by its n_valid, 7 K8 a validation forward); every logged
   value finite, and the event file parsed back record by record with
   its CRCs, holding each (tag, step) given to the logger; the
   checkpoints (3 kept) and the final counters; resume (the second
   checkpoint restored into a fresh state and the next superstep rerun
   with the same draws, bit-identical, or within SUPERSTEP_LIMITS:
   printed which), beside two runs of that superstep with cuDNN's default
   algorithms; train -> test (the checkpoint directory through
   ``generator_loader`` and ``EnsemblePredictor(fast=True)``, within 0.05
   of the plain float32 generator, 8/2/2/1 launches a forward). The same
   fit in bf16 (times and launches); ``run_uresnet_training`` for 2 epochs
   (the loss histories, a checkpoint an epoch, 7 K8 a step and a
   validation chunk); ``bench --what gen-inference`` and
   ``uresnet-inference`` (8/2/2/1 launches a forward). The drivers' .h5
   export is replaced by a recorder (no h5py on the card's machine); ms
   per superstep (warm-up, steady, tails), validation, flush and
   checkpoint save (with MB) are printed beside the card's name and power
   limit.

Every phase prints its seconds. ``CONV5_PACKED`` is restored in a
``finally`` after each phase that sets it. Prints one JSON line with the
kernels, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
CUDA is absent or any check fails. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

IMAGE = 256         # image side of the model (ModelConfig's default)
BATCH_CHECK = 4     # batch of the kernel checks
BATCH_GRAD = 2      # batch of the backward, critic and superstep checks
BATCH_SERVE = 42    # slices of one synthetic subject
N_SUBJECTS = 2
N_REPEAT = 10
BATCH_TRAIN, D_ITERS, K_NOISE = 16, 5, 10  # benchmarks.gan_step_bench's workload
DEVICE = "cuda"
FIT_SLICES, FIT_VAL, FIT_EPOCHS = 64, 8, 2  # phase 7's fold (batch BATCH_TRAIN)
# Phases 5 and 6: seeds, and the limits against float64 (each set between
# the float32 readings over the seeds and the controls', PERF.md section 6).
CRITIC_SEEDS = (11, 21, 31)
SUPERSTEP_SEEDS = (12, 22, 32)
CRITIC_LIMIT = 2e-2  # relative L2 of the score and of each gradient
SUPERSTEP_LIMITS = {
    "losses": 1e-3,           # relative, each logged loss but the two below
    "updated scores": 1e-2,   # errG_CY2, errG_DEM, relative to the critic scores' size
    "updates": 5e-2,          # relative L2 of each network's parameter updates
    "gradient": 1e-1,         # relative L2 of each network's last gradient
    "max abs / lr": 2.0,      # largest error of one parameter, in units of lr
}
# Superstep paths: tag -> (use_pallas, compute dtype, with the gradient penalty)
SUPERSTEP_RUNS = {"float64": (False, "float64", True), "fused": (True, "float32", True),
                  "plain float32": (False, "float32", True),
                  "control bfloat16": (True, "bfloat16", True),
                  "control no GP": (True, "float32", False)}
# Phases 7 and 8, limits set as phase 6's (PERF.md section 6).
URESNET_SEEDS, URESNET_STEPS = (13, 23, 33), 3
URESNET_LIMITS = {
    "losses": 1e-4,           # relative, each step's loss
    "updates": 5e-2,          # relative L2 of the parameter updates
    "statistics": 1e-3,       # relative L2 of the BatchNorm statistics' changes
    "first moment": 1e-1,     # relative L2 of Adam's first moment
}
BATCH_BN_SEEDS = (14, 24, 34)
# Phase 6's readings but the largest single error, which cannot tell
# float32 from the control here: at batch 2 the training BatchNorm of each
# site's gamma/beta Dense normalizes two values to about +-1, so the
# gradient of that Dense is a difference of near-equal terms, and float32
# flips the sign of some saturated Adam steps (+-1.86 lr) there. The
# limits are wider than phase 6's: batch mode runs the plain critic, whose
# float32 GP double backward reads further off float64 than the fused
# critic's hand-chained one (PERF.md section 6).
BATCH_BN_LIMITS = {"losses": 5e-3, "updated scores": 5e-2, "updates": 1.5e-1,
                   "gradient": 2e-1, "statistics": 1e-3}
# UResNet and batch-BN superstep paths: tag -> (use_pallas, compute dtype)
TRAIN_MODE_RUNS = {"float64": (False, "float64"), "k8": (True, "float32"),
                   "plain float32": (False, "float32"), "control bfloat16": (True, "bfloat16")}
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
PEAK_F32 = 67e12  # H100 SXM float32 outside the tensor cores (K8's arithmetic)
PALLAS = "depgan_tpu/ops/conv_s2d_pallas.py"
GEMM_SRC = "depgan_tpu_torch/csrc/s2d_kernels.cu"  # entry points; engine in s2d_gemm.cuh
WGMMA_SRC = "depgan_tpu_torch/csrc/wgmma_kernels.cu"  # bf16 K1, K2, K3, K7 and K9
DECONV_WGMMA_SRC = "depgan_tpu_torch/csrc/wgmma_deconv.cu"  # bf16 K4
CONV5_WGMMA_SRC = "depgan_tpu_torch/csrc/wgmma_conv5.cu"  # bf16 K11
CHAIN_WGMMA_SRC = "depgan_tpu_torch/csrc/wgmma_chain.cu"  # bf16 K10
POOL_SRC = "depgan_tpu_torch/csrc/pool_kernels.cu"
FILM_SRC = "depgan_tpu_torch/csrc/film_kernels.cu"
CHAIN_SRC = "depgan_tpu_torch/csrc/chain_kernels.cu"
WINDOW_SRC = "depgan_tpu_torch/csrc/window_kernels.cu"
PROBE_SRC = "depgan_tpu_torch/csrc/probe_kernels.cu"

# name -> (source, the Pallas kernel it replaces)
KERNELS = {
    "conv3x3_s2d_fused": (WGMMA_SRC, f"{PALLAS}:758"),
    "conv3x3_s2d_fused[none]": (WGMMA_SRC, f"{PALLAS}:758"),
    "conv3x3_s2d_fused_pool": (WGMMA_SRC, f"{PALLAS}:1043"),
    "conv3x3_s2d_fused2": (WGMMA_SRC, f"{PALLAS}:1289"),
    "deconv_s2d": (DECONV_WGMMA_SRC, f"{PALLAS}:408"),
    "pool_to_s2d": (POOL_SRC, f"{PALLAS}:283"),
    "pool_s2d": (POOL_SRC, f"{PALLAS}:198"),
    "conv5x5_s2d_fused": (WGMMA_SRC, f"{PALLAS}:1918"),
    "film_residual": (FILM_SRC, "depgan_tpu/ops/film_pallas.py:58"),
    "conv3x3_s2d_fused_head": (WGMMA_SRC, f"{PALLAS}:1145"),
    "conv3x3_s2d_chain3": (CHAIN_WGMMA_SRC, f"{PALLAS}:1741"),
    "conv3x3_s2d_chain2": (CHAIN_SRC, f"{PALLAS}:1511"),
    "conv5x5_s2d_fused[packed]": (CONV5_WGMMA_SRC, f"{PALLAS}:1940"),
    "kernel_anatomy[full]": (WGMMA_SRC, "scripts/kernel_anatomy.py:80"),
    "kernel_anatomy[no_epi]": (WGMMA_SRC, "scripts/kernel_anatomy.py:80"),
    "kernel_anatomy[matmul_only]": (WGMMA_SRC, "scripts/kernel_anatomy.py:90"),
    "kernel_anatomy[stage_only]": (WGMMA_SRC, "scripts/kernel_anatomy.py:97"),
    "conv3x3_rowblk": (WGMMA_SRC, "scripts/rowblk_probe.py:125"),
    "deint_reshape_idx": (PROBE_SRC, "scripts/packed_tap_probe.py:92"),
    "deint_merge": (PROBE_SRC, "scripts/packed_tap_probe.py:101"),
}
PROBE_KERNELS = ("kernel_anatomy[full]", "kernel_anatomy[no_epi]", "kernel_anatomy[matmul_only]",
                 "kernel_anatomy[stage_only]", "conv3x3_rowblk", "deint_reshape_idx",
                 "deint_merge")
# What ptxas gives the GEMM engine's production instantiations (dtype, N
# tile) on the H100's toolchain (PERF.md section 6): bf16 as before the
# engine had probe phases, which are compiled away from them; float32 with
# its 16 x 8 register tiles, one block an SM (255 registers).
ENGINE_FIGURES = {
    ("bfloat16", 64): (128, 32, 68, 84), ("bfloat16", 128): (128, 0, 0, 0),
    ("bfloat16", 256): (126, 0, 0, 0), ("float32", 64): (255, 24, 20, 44),
    ("float32", 128): (255, 0, 0, 0), ("float32", 256): (255, 0, 0, 0),
}  # registers, stack frame bytes, spill store bytes, spill load bytes
# What ptxas gives the wgmma mainloop's instantiations (N tile, m64 tiles a
# consumer warpgroup, K2's pooled epilogue, phase: 0 production, 1-4 P1's
# full, no_epi, matmul_only, stage_only) and P2's window kernel (N tile, m64
# tiles, pool None), keys of ``engine_registers.wgmma_name``: 168 registers
# a thread at launch (384 threads, one block an SM; setmaxnreg then gives
# the consumers 224 and the producer 56), no stack frame and no spills.
# K7's 5x5 gather is a runtime case of the unpooled six (K7 runs (64, 1),
# (64, 2) and (128, 2)); K2 runs the pooled (128, 2) and (256, 1) at its
# production shapes and (64, 1 or 2) at 4Co 32 or 64. P1 takes 4Co <= 128;
# P2 runs (128, 2) at level 1 and (256, 1) at level 2 (MT 1 at BN <= 128
# where six slots do not fit). K11's window (conv5_wgmma: N tile, m64 tiles)
# runs (64, 2) and (128, 2) at the critic's shapes, (192, 1) and (256, 1)
# above 4Co 128; K10's chain (chain_wgmma: N tile, m64 tiles, pool) runs
# (128, 2) at level 1 and (256, 1) at level 2, pooled at m1 and m2. K9's
# head epilogue (s2d_wgmma's HEAD) runs (128, 2) at p1, the other five at
# other 4Co; K4's deconv (deconv_wgmma: N tile) runs 256 at the generator's
# p2 -> p1, 64 at first_fm 8, 128 and 192 at other 4O.
WGMMA_FIGURES = {
    **{(bn, mt, pool, 0): (168, 0, 0, 0)
       for bn, mt in ((64, 1), (128, 1), (192, 1), (256, 1), (64, 2), (128, 2))
       for pool in (False, True) if not (pool and bn == 192)},
    **{(bn, mt, False, phase): (168, 0, 0, 0)
       for bn in (64, 128) for mt in (1, 2) for phase in (1, 2, 3, 4)},
    **{(bn, mt, None, 0): (168, 0, 0, 0)
       for bn, mt in ((64, 1), (128, 1), (192, 1), (256, 1), (64, 2), (128, 2))},
    **{(bn, mt, None, 0, "conv5_wgmma"): (168, 0, 0, 0)
       for bn, mt in ((64, 2), (128, 2), (192, 1), (256, 1))},
    **{(bn, mt, pool, 0, "chain_wgmma"): (168, 0, 0, 0)
       for bn, mt in ((128, 2), (256, 1)) for pool in (False, True)},
    **{(bn, mt, False, 0, "", True): (168, 0, 0, 0)
       for bn, mt in ((64, 1), (128, 1), (192, 1), (256, 1), (64, 2), (128, 2))},
    **{(bn, 0, None, 0, "deconv_wgmma"): (168, 0, 0, 0) for bn in (64, 128, 192, 256)},
}
WGMMA_KERNELS = ("conv3x3_s2d_fused", "conv3x3_s2d_fused[none]", "conv3x3_s2d_fused_pool",
                 "conv3x3_s2d_fused2", "conv5x5_s2d_fused")
L2_BYTES = 50 * 2 ** 20  # the H100's L2: timed launches rotate over inputs twice its size
LAUNCHES_PER_FORWARD = {"conv3x3_s2d_fused": 8, "conv3x3_s2d_fused_pool": 2,
                        "conv3x3_s2d_fused2": 2, "deconv_s2d": 1}
# The serving forward's kernel-selecting options (fuse_pool on): launches
# per forward with each (JAX fast_gen.py:342-351, 397-432, 581-607).
OPTION_LAUNCHES = {
    "fuse_chain": {"conv3x3_s2d_chain3": 4, "deconv_s2d": 1},
    "fuse_head": {"conv3x3_s2d_fused": 7, "conv3x3_s2d_fused_pool": 2, "conv3x3_s2d_fused2": 2,
                  "deconv_s2d": 1, "conv3x3_s2d_fused_head": 1},
    "both": {"conv3x3_s2d_chain3": 3, "conv3x3_s2d_fused2": 1, "conv3x3_s2d_fused": 1,
             "conv3x3_s2d_fused_head": 1, "deconv_s2d": 1},
}

# (kernel, label, problem without the batch), the problem as the wrappers
# count it in conv_s2d.SHAPES: n is the interior side of the output plane
# (of the input plane for the deconv and the pools).
SERVING_CASES = (
    ("conv3x3_s2d_fused", "L1 relu 32->128", (128, 32, 128, "relu")),
    ("conv3x3_s2d_fused", "L1 relu 128->128", (128, 128, 128, "relu")),
    ("conv3x3_s2d_fused", "L1 film 128", (128, 128, 128, "film")),
    ("conv3x3_s2d_fused", "L2 relu 128->256", (64, 128, 256, "relu")),
    ("conv3x3_s2d_fused", "L2 relu 256->256", (64, 256, 256, "relu")),
    ("conv3x3_s2d_fused", "L2 film 256", (64, 256, 256, "film")),
    ("conv3x3_s2d_fused_pool", "L1 pool s2d 128->128", (128, 128, 128, "s2d")),
    ("conv3x3_s2d_fused_pool", "L2 pool pixel 256->256", (64, 256, 256, "pixel")),
    ("conv3x3_s2d_fused2", "p2 384+256->256", (64, 384, 256, 256)),
    ("conv3x3_s2d_fused2", "p1 256+128->128", (128, 256, 128, 128)),
    ("deconv_s2d", "p2->p1 256->256", (64, 256, 256)),
)
TRAINING_CASES = (
    ("conv3x3_s2d_fused[none]", "L1 dX 128->128", (128, 128, 128, "none")),
    ("conv3x3_s2d_fused[none]", "p1 dX 128->256", (128, 128, 256, "none")),
    ("conv3x3_s2d_fused[none]", "L2 dX 256->128", (64, 256, 128, "none")),
    ("conv3x3_s2d_fused[none]", "L2 dX 256->256", (64, 256, 256, "none")),
    ("conv3x3_s2d_fused[none]", "p2 dX 256->384", (64, 256, 384, "none")),
    ("pool_to_s2d", "generator L1 128", (128, 128)),
    ("pool_to_s2d", "critic L0 64", (128, 64)),
    ("pool_s2d", "generator L2 256", (64, 256)),
    ("pool_s2d", "critic L1 128", (64, 128)),
    ("conv5x5_s2d_fused", "L0a 16->64", (128, 16, 64, "relu")),
    ("conv5x5_s2d_fused", "L0b 64->64", (128, 64, 64, "relu")),
    ("conv5x5_s2d_fused", "L1a 64->128", (64, 64, 128, "relu")),
    ("conv5x5_s2d_fused", "L1b 128->128", (64, 128, 128, "relu")),
    ("conv5x5_s2d_fused", "L0a dX 64->16", (128, 64, 16, "none")),
    ("conv5x5_s2d_fused", "L0b dX 64->64", (128, 64, 64, "none")),
    ("conv5x5_s2d_fused", "L1a dX 128->64", (64, 128, 64, "none")),
    ("conv5x5_s2d_fused", "L1b dX 128->128", (64, 128, 128, "none")),
)
# K11 (CONV5_PACKED) at the critic's shapes with 4C <= 64: the forward's
# L0a, L0b and L1a and the transposes of L0a and L0b.
PACKED_CASES = (
    ("conv5x5_s2d_fused[packed]", "L0a 16->64", (128, 16, 64, "relu")),
    ("conv5x5_s2d_fused[packed]", "L0b 64->64", (128, 64, 64, "relu")),
    ("conv5x5_s2d_fused[packed]", "L1a 64->128", (64, 64, 128, "relu")),
    ("conv5x5_s2d_fused[packed]", "L0a dX 64->16", (128, 64, 16, "none")),
    ("conv5x5_s2d_fused[packed]", "L0b dX 64->64", (128, 64, 64, "none")),
)
# The probes' checks: P1 at a level-2 check shape (n, 4C, 4Co, reps), P2 at
# the JAX probe's shapes and block counts (n, 4C, 4Co, n_blocks; bfloat16
# only: a float32 window at these widths does not fit in shared memory), P3
# at a small shape (n, m, c).
PROBE_CASES = tuple((f"kernel_anatomy[{phase}]", "L2 check 128->128 reps 2", (64, 128, 128, 2))
                    for phase in ("full", "no_epi", "matmul_only", "stage_only")) + tuple(
    ("conv3x3_rowblk", f"{lvl} {c4}->{c4} nb {nb}", (n, c4, c4, nb))
    for lvl, n, c4, blocks in (("L1", 128, 128, (5, 10)), ("L2", 64, 256, (3, 6)))
    for nb in blocks) + (
    ("deint_reshape_idx", "32 rows 16 col-pairs c 32", (32, 16, 32)),
    ("deint_merge", "32 rows 16 col-pairs c 32", (32, 16, 32)))
CASE_DTYPES = {"conv3x3_rowblk": (torch.bfloat16,)}
# Batches of a kernel's checks other than BATCH_CHECK alone: K4 at the
# superstep's and the serving forward's too, as each runs it.
CASE_BATCHES = {"deconv_s2d": (BATCH_CHECK, BATCH_TRAIN, BATCH_SERVE)}
# The probes' entry points at the JAX scripts' default batches.
PROBE_BATCH = {"kernel_anatomy": 64, "rowblk_probe": 64, "packed_tap_probe": 256}
# K9, K10 and K12 at the serving forward's shapes: K9 at p1's conv_out
# (n, 4C, 4Co, Ho4); K10 at the four level-1/2 sites (n, 4Ca, 4Cb, 4Cm, 4Co,
# pool); K12, which no path calls, at the same sites' conv_in + FiLM and
# FiLM + conv_out pairs (n, 4Ci, 4Cm, 4Co, modes).
OPTION_CASES = (
    ("conv3x3_s2d_fused_head", "p1 head 128->128->4", (128, 128, 128, 4)),
    ("conv3x3_s2d_chain3", "m1 32->128->128 pool s2d", (128, 32, 0, 128, 128, "s2d")),
    ("conv3x3_s2d_chain3", "m2 128->256->256 pool pixel", (64, 128, 0, 256, 256, "pixel")),
    ("conv3x3_s2d_chain3", "p2 384+256->256->256", (64, 384, 256, 256, 256, "")),
    ("conv3x3_s2d_chain3", "p1 256+128->128->128", (128, 256, 128, 128, 128, "")),
    ("conv3x3_s2d_chain2", "m1 relu+film 32->128->128", (128, 32, 128, 128, "relu", "film")),
    ("conv3x3_s2d_chain2", "m1 film+relu 128->128->128", (128, 128, 128, 128, "film", "relu")),
    ("conv3x3_s2d_chain2", "m2 relu+film 128->256->256", (64, 128, 256, 256, "relu", "film")),
    ("conv3x3_s2d_chain2", "m2 film+relu 256->256->256", (64, 256, 256, 256, "film", "relu")),
)
# K8 at the generator's seven FiLM sites, (H, W, C); the decoder's p3, p2
# and p1 repeat the encoder's m3, m2 and m1.
FILM_CASES = tuple(("film_residual", f"{site} {h}x{h}x{c}", (h, h, c)) for site, h, c in (
    ("m1", 256, 32), ("m2", 128, 64), ("m3", 64, 96), ("p4", 32, 128),
    ("p3", 64, 96), ("p2", 128, 64), ("p1", 256, 32)))
# Phase 3c, the testing path: the synthetic fold's subjects and the limits
# on the CSV rows of the fast (bf16) run against the plain float32 run, per
# subject: the largest difference of the 8 Dice columns, and of the
# predicted WMH volume as a share of the subject's mask. bf16 moves voxels
# that sit near the 0.5 threshold (near the top-two tie of the softmax),
# so the limits sit between the float32 control (the fast path in float32)
# and a wrong run (the fast path with another checkpoint's weights), which
# must fail them: on the H100, bf16 read at most 6.0e-4 (Dice) and 6.5e-4
# (volume), the float32 control 8.5e-7, the wrong run at least 3.9e-2 and
# 4.8e-2; 5e-3 is near the geometric middle (PERF.md section 6).
TESTING_SUBJECTS, TESTING_SLICES = 2, 42
TESTING_LIMITS = {"dice": 5e-3, "volume": 5e-3}
# Phase 3d: first_fm widths at which the wgmma plans refuse some site.
WIDTH_CASES = (48, 64)
# Phase 11, the training path: a synthetic training fold of 4 subjects x 90
# slices (val_fraction 0.02: 8 validation slices, 352 training, 22 batches
# of 16 an epoch) and train-gan --use-pallas's schedule, cut where the
# comment says (the default beside).
TRAIN_SUBJECTS, TRAIN_SLICES = 4, 90
FIT_CFG = dict(batch_size=16, d_iters=5, k_noise=10,
               n_epochs=2,             # 200
               warmup_d_iters=10,      # 100
               warmup_until=1,         # 25
               validate_every=2,       # 10
               image_log_every=2,      # 500
               checkpoint_every=3,     # 100
               metric_flush_every=3)   # 25
FIT_DEFAULTS = dict(n_epochs=200, warmup_d_iters=100, warmup_until=25, validate_every=10,
                    image_log_every=500, checkpoint_every=100, metric_flush_every=25)
URESNET_EPOCHS = 2  # 200
RESUME_STEP = 6  # the second checkpoint; the fit's 7th superstep follows it


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def conv5_packed():
    """``CONV5_PACKED`` on inside the block, off again after it."""
    from depgan_tpu_torch.ops import conv_s2d as K

    K.CONV5_PACKED = True
    try:
        yield
    finally:
        K.CONV5_PACKED = False


def packed(fn):
    """``fn`` run with ``CONV5_PACKED`` on."""
    def run():
        with conv5_packed():
            return fn()
    return run


def make_case(name: str, problem: tuple, dtype, seed: int) -> dict:
    """Inputs of one launch on the card, and callables on them: the kernel
    wrapper, the plain version and, where one PyTorch call computes the same
    function, that call (on the same values in pixel layout, made before it
    is timed); with the bytes and pixel-conv FLOPs the function needs and
    which outputs are padded planes."""
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops import probes as P
    from depgan_tpu_torch.ops import s2d_conv as S

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = problem[0]

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=DEVICE) * std + mean

    def plane(n, c4):
        return K.pad_s2d(randn(b, n, n, c4)).to(dtype)

    def pixel(x_padded):  # NCHW view with channels-last strides
        return S.d2s(K.unpad_s2d(x_padded)).permute(0, 3, 1, 2)

    def conv_weight(w):  # HWIO -> OIHW, channels last
        return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def interior_bytes(*planes):  # input planes: their rings are zeros, never read
        return sum(p.numel() // p.shape[1] ** 2 * (p.shape[1] - 2) ** 2 * p.element_size()
                   for p in planes)

    # K1, K2, K3, K4, K7 and K9 also carry the engine's kernel on the same
    # inputs (``engine``): what they launched in bfloat16 before the wgmma kernels;
    # bf16 P1, P2, K10 and K11 their routes before it (``old``), timed, not
    # compared.

    case = {"padded": (True,), "flops": 0.0, "peak": PEAK_FLOPS, "library": None}
    if name in ("conv3x3_s2d_fused", "conv3x3_s2d_fused[none]", "conv3x3_s2d_fused_pool"):
        _, n, c4, co4, mode = problem
        c, co = c4 // 4, co4 // 4
        w3, b3 = randn(3, 3, c, co, std=(9 * c) ** -0.5), randn(co, std=0.1)
        w4, bias4 = S.conv3x3_to_s2d_kernel(w3, b3)
        x, w4 = plane(n, c4), w4.to(dtype).contiguous()
        args, extra = (x, w4, bias4), ()
        case["flops"] = 2.0 * b * (2 * n) ** 2 * 9 * c * co
        if name == "conv3x3_s2d_fused_pool":
            case["kernel"] = lambda: K.conv3x3_s2d_fused_pool(*args, pool=mode)
            case["plain"] = lambda: K.conv3x3_s2d_fused_pool_plain(*args, pool=mode)
            case["engine"] = lambda: P.conv3x3_engine(*args, pool=mode)
            case["padded"] = (True, mode == "s2d")
            pooled = b * ((n // 2 + 2) ** 2 * co4 if mode == "s2d" else n * n * co)
            case["bytes"] = (interior_bytes(x) + nbytes(*args[1:])
                             + (b * (n + 2) ** 2 * co4 + pooled) * x.element_size())
            return case
        if mode == "film":
            extra = (randn(b, c4, std=0.3, mean=1.0), randn(b, c4, std=0.3))
        case["kernel"] = lambda: K._conv3x3_s2d_impl(*args, *extra, mode=mode)
        case["plain"] = lambda: K.conv3x3_s2d_fused_plain(*args, *extra, mode=mode)
        case["engine"] = lambda: P.conv3x3_engine(*args, *extra, mode=mode)
        if mode != "film":
            xp, wl, bl = pixel(x), conv_weight(w3), b3.to(dtype)
            case["library"] = lambda: F.conv2d(xp, wl, bl, padding=1)
        case["bytes"] = (interior_bytes(x) + nbytes(*args[1:], *extra)
                         + b * (n + 2) ** 2 * co4 * x.element_size())
    elif name == "conv3x3_s2d_fused2":
        _, n, c4a, c4b, co4 = problem
        ca, cb, co = c4a // 4, c4b // 4, co4 // 4
        w3, b3 = randn(3, 3, ca + cb, co, std=(9 * (ca + cb)) ** -0.5), randn(co, std=0.1)
        w4a, bias4 = S.conv3x3_to_s2d_kernel(w3[:, :, :ca], b3)
        w4b, _ = S.conv3x3_to_s2d_kernel(w3[:, :, ca:])
        args = (plane(n, c4a), plane(n, c4b), w4a.to(dtype).contiguous(),
                w4b.to(dtype).contiguous(), bias4)
        case["kernel"] = lambda: K._conv2_impl(*args)
        case["plain"] = lambda: K.conv3x3_s2d_fused2_plain(*args)
        case["engine"] = lambda: P.conv3x3_engine(args[0], args[2], args[4], x2_padded=args[1],
                                                  w4_2=args[3])
        xp = torch.cat([pixel(args[0]), pixel(args[1])], dim=1).contiguous(
            memory_format=torch.channels_last)
        wl, bl = conv_weight(w3), b3.to(dtype)
        case["library"] = lambda: F.conv2d(xp, wl, bl, padding=1)
        case["flops"] = 2.0 * b * (2 * n) ** 2 * 9 * (ca + cb) * co
        case["bytes"] = (interior_bytes(*args[:2]) + nbytes(*args[2:])
                         + b * (n + 2) ** 2 * co4 * args[0].element_size())
    elif name == "deconv_s2d":
        _, m, c4, o4 = problem
        c = c4 // 4
        w2, bias = randn(c, o4, std=c ** -0.5), randn(o4 // 4, std=0.1)
        args = (plane(m, c4), w2.to(dtype), bias.repeat(4))
        case["kernel"] = lambda: K._deconv_impl(*args)
        case["plain"] = lambda: K.deconv_s2d_plain(*args)
        case["engine"] = lambda: P.deconv_engine(*args)
        xp = pixel(args[0])
        wt = w2.reshape(c, 2, 2, o4 // 4).permute(0, 3, 1, 2).contiguous().to(dtype)
        bl = bias.to(dtype)
        case["library"] = lambda: F.conv_transpose2d(xp, wt, bl, stride=2)
        case["flops"] = 2.0 * b * (2 * m) ** 2 * c * o4
        case["bytes"] = (interior_bytes(args[0]) + nbytes(*args[1:])
                         + b * (2 * m + 2) ** 2 * o4 * args[0].element_size())
    elif name in ("pool_to_s2d", "pool_s2d"):
        _, n, c4 = problem
        x = plane(n, c4)
        to_s2d = name == "pool_to_s2d"
        case["kernel"] = lambda: K._pool_impl(x, to_s2d)
        case["plain"] = lambda: (K.pool_to_s2d_plain if to_s2d else K.pool_s2d_plain)(x)
        case["padded"] = (to_s2d,)
        if not to_s2d:
            case["library"] = lambda: torch.amax(K.unpad_s2d(x).unflatten(-1, (4, c4 // 4)), dim=3)
        out = (b, n // 2 + 2, n // 2 + 2, c4) if to_s2d else (b, n, n, c4 // 4)
        case["bytes"] = interior_bytes(x) + np.prod(out) * x.element_size()
    elif name in ("conv5x5_s2d_fused", "conv5x5_s2d_fused[packed]"):
        _, n, c4, co4, mode = problem
        w5 = randn(5, 5, c4 // 4, co4 // 4, std=(25 * c4 / 4) ** -0.5)
        w9, bias4 = S.conv5x5_to_s2d_kernel(w5, randn(co4 // 4, std=0.1))
        args = (plane(n, c4), w9.to(dtype).contiguous(), bias4)
        case["kernel"] = lambda: K._conv5_impl(*args, mode=mode)
        if name == "conv5x5_s2d_fused[packed]":
            case["k7"], case["kernel"] = case["kernel"], packed(case["kernel"])
            if dtype == torch.bfloat16:  # window_conv, timed in turns with the wgmma window
                case["old"] = lambda: P.conv5x5_packed_mma_sync(*args, mode=mode)
        else:
            case["engine"] = lambda: P.conv5x5_engine(*args, mode=mode)
        case["plain"] = lambda: K.conv5x5_s2d_fused_plain(*args, mode=mode)
        xp, wl, bl = pixel(args[0]), conv_weight(w5), bias4[:co4 // 4].to(dtype)
        case["library"] = lambda: F.conv2d(xp, wl, bl, padding=2)
        case["flops"] = 2.0 * b * (2 * n) ** 2 * 25 * (c4 // 4) * (co4 // 4)
        case["bytes"] = (interior_bytes(args[0]) + nbytes(*args[1:])
                         + b * (n + 2) ** 2 * co4 * args[0].element_size())
    elif name == "conv3x3_s2d_fused_head":
        _, n, c4, co4, h4 = problem
        c, co, ho = c4 // 4, co4 // 4, h4 // 4
        w3, b3 = randn(3, 3, c, co, std=(9 * c) ** -0.5), randn(co, std=0.1)
        w4, bias4 = S.conv3x3_to_s2d_kernel(w3, b3)
        w1, b1 = S.conv1x1_to_s2d_kernel(randn(1, 1, co, ho, std=co ** -0.5),
                                         randn(ho, std=0.1))
        args = (plane(n, c4), w4.to(dtype).contiguous(), bias4, w1.contiguous(),
                b1.contiguous())
        case["kernel"] = lambda: K.conv3x3_s2d_fused_head(*args)
        case["plain"] = lambda: K.conv3x3_s2d_fused_head_plain(*args)
        case["engine"] = lambda: P.conv3x3_head_engine(*args)
        case["slack"] = lambda: head_rounding_slack(*args[:4])
        case["padded"] = (False,)
        case["flops"] = 2.0 * b * (2 * n) ** 2 * (9 * c * co + co * ho)
        case["bytes"] = interior_bytes(args[0]) + nbytes(*args[1:]) + b * n * n * h4 * 4
    elif name in ("conv3x3_s2d_chain3", "conv3x3_s2d_chain2"):
        # Each conv from a pixel kernel (HWIO), as the generator's weights
        # are; the FiLM vectors tiled from per-channel ones.
        def conv(ci4, co4):
            w3 = randn(3, 3, ci4 // 4, co4 // 4, std=(9 * ci4 / 4) ** -0.5)
            w4, bias4 = S.conv3x3_to_s2d_kernel(w3, randn(co4 // 4, std=0.1))
            return w4.to(dtype).contiguous(), bias4

        def film(c4):
            return (S.tile_channel_params(randn(b, c4 // 4, std=0.3, mean=1.0)),
                    S.tile_channel_params(randn(b, c4 // 4, std=0.3)))

        if name == "conv3x3_s2d_chain3":
            _, n, c4a, c4b, c4m, c4o, pool = problem
            x, x2 = plane(n, c4a), plane(n, c4b) if c4b else None
            (w1a, b1), (wf, bf), (w3, b3) = conv(c4a, c4m), conv(c4m, c4m), conv(c4m, c4o)
            w1b = conv(c4b, c4m)[0] if c4b else None
            gamma, beta = film(c4m)
            args = (x, w1a, b1, wf, bf, gamma, beta, w3, b3)
            case["kernel"] = lambda: K.conv3x3_s2d_chain3(*args, x2_padded=x2, w1b4=w1b,
                                                          pool=pool)
            case["plain"] = lambda: K.conv3x3_s2d_chain3_plain(*args, x2, w1b, pool)
            if dtype == torch.bfloat16:  # s2d_chain, timed in turns with the wgmma chain
                case["old"] = lambda: P.conv3x3_chain3_wmma(*args, x2_padded=x2, w1b4=w1b,
                                                            pool=pool)

            def sequential():  # K1 or K3 -> K1 film -> K2 or K1
                h = (K._conv3x3_s2d_impl(x, w1a, b1) if x2 is None
                     else K._conv2_impl(x, x2, w1a, w1b, b1))
                h = K._conv3x3_s2d_impl(h, wf, bf, gamma, beta, mode="film")
                if pool:
                    return K.conv3x3_s2d_fused_pool(h, w3, b3, pool=pool)
                return K._conv3x3_s2d_impl(h, w3, b3)

            case["padded"] = (True, pool == "s2d")
            inputs = [t for t in (x, x2) if t is not None]
            weights = [t for t in (w1a, w1b, b1, wf, bf, gamma, beta, w3, b3) if t is not None]
            macs = ((c4a + c4b) * c4m + c4m * c4m + c4m * c4o) / 16
            pooled = {"": 0, "s2d": (n // 2 + 2) ** 2 * c4o, "pixel": n * n * c4o // 4}[pool]
            out_elems = b * ((n + 2) ** 2 * c4o + pooled)
        else:
            _, n, c4i, c4m, c4o, mode1, mode2 = problem
            x = plane(n, c4i)
            (w1, b1), (w2, b2) = conv(c4i, c4m), conv(c4m, c4o)
            gamma, beta = film(c4m if mode1 == "film" else c4o)
            args = (x, w1, b1, w2, b2, gamma, beta)
            case["kernel"] = lambda: K.conv3x3_s2d_chain2(*args, modes=(mode1, mode2))
            case["plain"] = lambda: K.conv3x3_s2d_chain2_plain(*args, modes=(mode1, mode2))

            def sequential():
                h = K._conv3x3_s2d_impl(x, w1, b1, gamma, beta, mode=mode1)
                return K._conv3x3_s2d_impl(h, w2, b2, gamma, beta, mode=mode2)

            inputs, weights = [x], [w1, b1, w2, b2, gamma, beta]
            macs = (c4i * c4m + c4m * c4o) / 16
            out_elems = b * (n + 2) ** 2 * c4o
        case["sequential"] = sequential
        # Pixel-conv FLOPs of the convs; intermediates move no bytes.
        case["flops"] = 2.0 * b * (2 * n) ** 2 * 9 * macs
        case["bytes"] = interior_bytes(*inputs) + nbytes(*weights) + out_elems * x.element_size()
    elif name.startswith("kernel_anatomy[") or name == "conv3x3_rowblk":
        _, n, c4, co4, arg = problem  # arg: P1's reps, P2's block count
        c, co = c4 // 4, co4 // 4
        w3, b3 = randn(3, 3, c, co, std=(9 * c) ** -0.5), randn(co, std=0.1)
        w4, bias4 = S.conv3x3_to_s2d_kernel(w3, b3)
        x, w4 = plane(n, c4), w4.to(dtype).contiguous()
        phase = name[len("kernel_anatomy["):-1] if name != "conv3x3_rowblk" else "full"
        a = P.gathered_taps(x) if phase == "matmul_only" else None
        if name == "conv3x3_rowblk":
            case["kernel"] = lambda: P.conv3x3_rowblk(x, w4, bias4, arg)
            case["plain"] = lambda: P.conv3x3_rowblk_plain(x, w4, bias4, arg)
            old = lambda: P.conv3x3_rowblk_window(x, w4, bias4, arg)  # noqa: E731
        else:
            case["kernel"] = lambda: P.kernel_anatomy(phase, x, w4, bias4, arg, a)
            case["plain"] = lambda: P.kernel_anatomy_plain(phase, x, w4, bias4, a)
            old = lambda: P.kernel_anatomy_engine(phase, x, w4, bias4, arg, a)  # noqa: E731
        if dtype == torch.bfloat16:  # the route before the mainloop, timed in turns with it
            case["old"] = old
        if phase in ("full", "matmul_only"):  # K1's function, summed in K1's order
            case["k1"] = lambda: K._conv3x3_s2d_impl(x, w4, bias4)
        out_bytes = b * (n + 2) ** 2 * co4 * x.element_size()
        reps = arg if name != "conv3x3_rowblk" else 1
        case["flops"] = reps * 2.0 * b * (2 * n) ** 2 * 9 * c * co
        case["bytes"] = interior_bytes(x) + nbytes(w4, bias4) + out_bytes
        if phase in ("full", "no_epi"):
            xp, wl = pixel(x), conv_weight(w3)
            bl = b3.to(dtype) if phase == "full" else None
            case["library"] = lambda: F.conv2d(xp, wl, bl, padding=1)
        elif phase == "matmul_only":  # the GEMM over the dense taps
            case["flops"] = reps * 2.0 * a.shape[0] * a.shape[1] * co4
            case["bytes"] = nbytes(a, w4, bias4) + out_bytes
        else:  # stage_only: the gather, and its sums within 1e-5 of their absolute sum
            case["flops"], case["bytes"], case["padded"] = 0.0, interior_bytes(x), (False,)
            case["limit"] = lambda: 1e-5 * P.kernel_anatomy_plain(phase, x.abs(), w4, bias4)
    elif name in ("deint_reshape_idx", "deint_merge"):
        _, n, m, c = problem
        x = randn(b, n, 2 * m, c).to(dtype)
        kind = name[len("deint_"):]
        case["kernel"] = lambda: P.deint(x, kind)
        case["plain"] = case["library"] = lambda: P.deint_plain(x)
        case["padded"], case["limit"] = (False,), lambda: 0.0
        case["bytes"] = 2 * nbytes(x)
    elif name == "film_residual":
        from depgan_tpu_torch.ops import film

        _, hh, ww, c = problem
        h, trunk = randn(b, hh, ww, c).to(dtype), randn(b, hh, ww, c).to(dtype)
        gamma, beta = randn(b, c, std=0.5, mean=1.0).to(dtype), randn(b, c).to(dtype)
        case["kernel"] = lambda: film._film_impl(h, gamma, beta, trunk)
        case["plain"] = lambda: film.film_residual_plain(h, gamma, beta, trunk)
        # Exact in float32 arithmetic, rounded once: the reference of both.
        case["exact"] = lambda: film.film_residual_plain(h.float(), gamma.float(), beta.float(),
                                                          trunk.float())
        case["padded"] = (False,)
        # A multiply, an add, a max and an add per element, in float32.
        case["flops"], case["peak"] = 4.0 * h.numel(), PEAK_F32
        case["bytes"] = nbytes(h, trunk, gamma, beta) + nbytes(h)
    else:
        raise ValueError(name)
    return case


def head_rounding_slack(x_padded, w4, bias4, w_head4, rel: float = 5e-6) -> torch.Tensor:
    """What K9's bf16 rounding of its relu output may move each head logit
    when the conv's float32 sum is taken in another order than the plain
    version's: one bf16 ulp, times the head weight's size, for each relu
    output within ``rel`` (1 + |y|) of a bf16 rounding boundary (either
    rounding is right there: two float32 orders of a K = 512 sum differ by
    at most ~2e-6 (1 + |y|) on unit-normal data)."""
    from depgan_tpu_torch.ops import conv_s2d as K

    y = torch.relu(K._matmul_taps(K._taps(x_padded), w4) + bias4.float())
    tol = rel * (1 + y.abs())
    either = (y - tol).to(torch.bfloat16) != (y + tol).to(torch.bfloat16)
    w_head = w_head4.reshape(w4.shape[-1], -1).to(torch.bfloat16).float().abs()
    return (either * bf16_ulp(y + tol)) @ w_head


def ring_is_zero(plane: torch.Tensor) -> bool:
    """Whether the 1-block border ring of a padded plane is exactly zero."""
    n = plane.shape[1] - 2
    ring = torch.ones(plane.shape[1:3], dtype=torch.bool, device=plane.device)
    ring[1:n + 1, 1:n + 1] = False
    return not bool(plane[:, ring].any())


def poison_allocator(shapes, dtype) -> None:
    """Fill and free blocks of the output sizes, so the wrapper's
    ``torch.empty`` outputs likely reuse NaN-filled memory and a ring the
    kernel failed to write shows."""
    blocks = [torch.full(s, float("nan"), dtype=dtype, device=DEVICE) for s in shapes]
    del blocks


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of ``x`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def check_kernels() -> dict[str, float]:
    """Phase 2; returns the largest abs error of each kernel. K8's limits
    are its own: float32 within 2e-6 of the plain version on unit-normal
    data (one FMA's rounding), bfloat16 within one bf16 ulp of the plain
    version computed in float32 and rounded once. A case's own ``limit``
    replaces the tolerance (P3: exact; P1 stage_only: 1e-5 of the absolute
    sum); P1's full and matmul_only and P2 must equal K1 on the same inputs
    bit for bit, and K11 K7. In bfloat16, K1,
    K2 (both outputs), K3 and K7 must equal the engine's kernel on the same
    inputs bit for bit: the wgmma mainloop sums in the engine's order; so
    must K9 (the mainloop's head epilogue) and K4 (the wgmma deconv, at each
    batch of CASE_BATCHES)."""
    worst: dict[str, float] = {}
    for i, (name, label, problem) in enumerate(KERNEL_CASES):
        dtypes = CASE_DTYPES.get(name, (torch.float32, torch.bfloat16))
        for batch, dtype, tol in ((batch, dtype, tol)
                                  for batch in CASE_BATCHES.get(name, (BATCH_CHECK,))
                                  for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2))):
            if dtype not in dtypes:
                continue
            case = make_case(name, (batch, *problem), dtype, seed=i)
            ref = case["plain"]()
            ref = ref if isinstance(ref, tuple) else (ref,)
            poison_allocator([r.shape for r in ref], dtype)
            out = case["kernel"]()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            err = 0.0
            for j, (o, r) in enumerate(zip(out, ref)):
                check(o.shape == r.shape and o.dtype == r.dtype,
                      f"{name} {label}: output {j} {o.dtype} {tuple(o.shape)} "
                      f"vs {r.dtype} {tuple(r.shape)}")
                diff = (o.float() - r.float()).abs()
                check(bool(torch.isfinite(o).all()), f"{name} {label}: non-finite output")
                err = max(err, float(diff.max()))
                if name == "film_residual" and dtype == torch.float32:
                    limit, bound = 2e-6, "atol 2e-6"
                elif name == "film_residual":
                    exact = case["exact"]()
                    diff = (o.float() - exact).abs()
                    limit, bound = bf16_ulp(exact), "1 bf16 ulp of the float32 result"
                elif "limit" in case:
                    limit = case["limit"]()
                    bound = "exact" if isinstance(limit, float) else "1e-5 of the absolute sum"
                else:
                    limit = tol + (tol * r.float().abs() if dtype == torch.bfloat16 else 0.0)
                    bound = f"atol {tol:g}" + (f", rtol {tol:g}" if dtype == torch.bfloat16
                                               else "")
                    if "slack" in case and dtype == torch.float32:
                        limit = limit + case["slack"]()
                        bound += " + the head's bf16 rounding ties"
                check(bool((diff <= limit).all()),
                      f"{name} {label} {dtype}: max abs err {float(diff.max()):.3e} ({bound})")
                if case["padded"][j]:
                    check(ring_is_zero(o), f"{name} {label}: ring of output {j} not zero")
            worst[name] = max(worst.get(name, 0.0), err)
            rings = ", rings zero" if any(case["padded"]) else ""
            seq = ""
            if "sequential" in case:
                seq = f", {against_sequential(name, label, dtype, out, case['sequential'])}"
            for ref_kernel in ("k1", "k7", "engine"):
                if ref_kernel in case and (ref_kernel != "engine" or dtype == torch.bfloat16):
                    seq = f", {against_kernel(name, label, dtype, out, case, ref_kernel)}"
            print(f"kernel {name} [{label}] batch {batch} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} ({bound}){rings}{seq}")
    return worst


SEQUENTIAL_DIFF: dict[str, float] = {}  # chain -> largest difference from its sequential kernels
KERNEL_DIFF: dict[str, float] = {}  # K11 / P1, P2 / K1-K4, K7, K9 -> from K7 / K1 / the engine
KERNEL_CASES = (SERVING_CASES + TRAINING_CASES + FILM_CASES + OPTION_CASES + PACKED_CASES
                + PROBE_CASES)


def against_kernel(name: str, label: str, dtype, out: tuple, case: dict,
                   ref_kernel: str) -> str:
    """A kernel's outputs against the kernel that computes the same function
    on the same inputs in the same order (K7 for K11, K1 for P1 and P2, the
    engine's kernel for bf16 K1, K2, K3, K4, K7 and K9): the largest abs
    difference, recorded in KERNEL_DIFF. Each must be 0 (K2 both its
    outputs): P1 and P2 equal K1, K11 (the wgmma window in bf16, window_conv
    in float32) K7, and the wgmma kernels the engine, bit for bit."""
    ref = case[ref_kernel]()
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    diff = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
    what = {"k1": "K1", "k7": "K7", "engine": "the engine"}[ref_kernel]
    check(diff == 0.0, f"{name} {label} {dtype}: {diff:.3e} from {what}, not bit-identical")
    KERNEL_DIFF[name] = max(KERNEL_DIFF.get(name, 0.0), diff)
    return f"bit-identical to {what}" if diff == 0 else f"max abs {diff:.3e} from {what}"


def against_sequential(name: str, label: str, dtype, out: tuple, sequential) -> str:
    """A chain's outputs against the sequential kernels' on the same
    inputs: the largest abs difference, recorded in SEQUENTIAL_DIFF. The
    chain sums each product in the sequential kernels' order and rounds
    where they store, so the two agree bit for bit: K10 (the wgmma chain in
    bf16, s2d_chain in float32) is held to 0; K12 to the plain check's
    tolerance, a difference coming from the tensor cores' order inside a
    16-deep product."""
    ref = sequential()
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    diff = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
    if name == "conv3x3_s2d_chain3":
        check(diff == 0.0, f"{name} {label} {dtype}: {diff:.3e} from the sequential kernels, "
                           f"not bit-identical")
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for o, r in zip(out, ref):
        check(bool(((o.float() - r.float()).abs() <= tol + tol * r.float().abs()).all()),
              f"{name} {label} {dtype}: {diff:.3e} from the sequential kernels")
    SEQUENTIAL_DIFF[name] = max(SEQUENTIAL_DIFF.get(name, 0.0), diff)
    return "bit-identical to the sequential kernels" if diff == 0 else (
        f"max abs {diff:.3e} from the sequential kernels")


def time_case(name: str, problem: tuple, dtype, seed: int) -> dict:
    """Kernel, plain and library ms of one launch, and its bound.

    Each time is ``cuda_graph_ms``: device time over launches captured in a
    CUDA graph, so a launch shorter than the host's dispatch times the kernel
    and not the host. The kernel's and the library call's launches read
    their inputs cold: the graph rotates over copies of the case (same
    values from the same seed, buffers of their own) whose bytes together
    exceed twice the L2, so no launch finds its inputs in L2 from the launch
    before. The plain version, no yardstick of speed, runs on one copy. K1,
    K2, K3, K4, K7 and K9 also time the engine's kernel on the same copies,
    in turns with the wgmma kernel (engine, kernel, kernel, engine): ``ms``
    and ``engine_ms`` are the faster of each pair, ``turns_ms`` all four;
    bf16 P1, P2, K10 and K11 so their old routes (``old_ms``)."""
    from depgan_tpu_torch.utils.profiling import cuda_graph_ms

    first = make_case(name, problem, dtype, seed)
    copies = max(1, -(-2 * L2_BYTES // int(first["bytes"])))
    cases = [first] + [make_case(name, problem, dtype, seed) for _ in range(copies - 1)]
    rounds = max(1, -(-10 // copies))

    def cold_ms(key: str) -> float:
        fns = [c[key] for c in cases]
        return cuda_graph_ms(lambda: [fn() for fn in fns], rounds) / copies

    t = {}
    ref = next((key for key in ("engine", "old") if key in first), None)
    if ref:
        turns = [cold_ms(key) for key in (ref, "kernel", "kernel", ref)]
        t.update({"ms": min(turns[1:3]), f"{ref}_ms": min(turns[0], turns[3]),
                  "turns_ms": turns})
    else:
        t["ms"] = cold_ms("kernel")
    t["plain_ms"] = cuda_graph_ms(first["plain"], 3)
    t["library_ms"] = None if first["library"] is None else cold_ms("library")
    t["copies"] = copies
    t_ops, t_bytes = first["flops"] / first["peak"] * 1e3, first["bytes"] / PEAK_BYTES * 1e3
    t.update(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes)
    del cases, first
    return t


SHAPE_TIMES: dict[tuple, dict] = {}  # (kernel, problem) -> time_case of its last replay


def replay(shapes: dict, dtype, what: str) -> dict[str, dict]:
    """Times every (kernel, problem) of a run with its count of launches
    and sums them by kernel: ms, plain ms, library ms (null where a launch
    has no library call), bound ms and, for the wgmma kernels, the engine's
    ms of that run's kernel launches (bf16 P1, P2: their old routes' ms).
    Each shape's times are kept in SHAPE_TIMES."""
    totals: dict[str, dict] = {}
    for i, ((name, problem), count) in enumerate(sorted(shapes.items(), key=str)):
        t = SHAPE_TIMES[name, problem] = time_case(name, problem, dtype, seed=100 + i)
        lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        engine = ""
        for ref in ("engine", "old"):
            if f"{ref}_ms" in t:
                engine = (f", {ref} {t[f'{ref}_ms']:.4f} ms (turns {ref}, kernel, kernel, {ref}: "
                          f"{', '.join(f'{v:.4f}' for v in t['turns_ms'])})")
        print(f"time {what} {name} {problem} x{count}: kernel {t['ms']:.4f} ms{engine}, plain "
              f"{t['plain_ms']:.4f} ms, library {lib} ms, bound {t['bound_ms']:.4f} ms "
              f"(bytes {t['bytes_ms']:.4f}, operations {t['ops_ms']:.4f}), "
              f"{t['copies']} input copies rotated")
        tot = totals.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                       "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})
        for key in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms", "engine_ms", "old_ms"):
            if key in t:
                tot[key] = tot.get(key, 0.0) + count * t[key]
        tot["library_ms"] = (None if tot["library_ms"] is None or t["library_ms"] is None
                             else tot["library_ms"] + count * t["library_ms"])
    return totals


def randomized_variables(cfg, seed: int) -> dict:
    """Fresh generator variables with BatchNorm made non-trivial, so that
    folding it into the convs is no identity."""
    from depgan_tpu_torch.models import init_generator

    rng = np.random.default_rng(seed)
    variables = init_generator(cfg, seed=seed)

    def visit(tree):
        for key, value in tree.items():
            if not isinstance(value, dict):
                continue
            if "scale" in value:  # a BatchNorm's parameters
                value["scale"] = rng.uniform(0.8, 1.2, value["scale"].shape).astype(np.float32)
                value["bias"] = rng.normal(0, 0.1, value["bias"].shape).astype(np.float32)
            elif "var" in value:  # its statistics
                value["mean"] = rng.normal(0, 0.1, value["mean"].shape).astype(np.float32)
                value["var"] = rng.uniform(0.5, 1.5, value["var"].shape).astype(np.float32)
            else:
                visit(value)

    visit(variables["params"])
    visit(variables["batch_stats"])
    return variables


def plain_predictor(cfg, variables: dict, seed: int):
    """The plain float32 reference of the serving checks: an ensemble over
    ``GenUNet2D``'s eval forward on the unfolded weights, so that it shares
    no BatchNorm fold with the fast generator or with the folded plain
    generator that ``EnsemblePredictor(fast=False)`` serves."""
    from depgan_tpu_torch.eval.predict import EnsemblePredictor
    from depgan_tpu_torch.io.flax_bridge import load_flax_variables
    from depgan_tpu_torch.models import GenUNet2D

    plain = EnsemblePredictor(cfg, variables, n_repeat=N_REPEAT, seed=seed, fast=False,
                              device=DEVICE)
    plain._forward = load_flax_variables(GenUNet2D(cfg, device=DEVICE), variables).eval()
    return plain


def serve(cfg, seed: int, n_subjects: int):
    """Phase 3: fast ensemble vs the plain float32 generator (unfolded),
    same noise. Returns the largest abs diff, the fast predictor and the
    subjects."""
    from depgan_tpu_torch.eval.predict import EnsemblePredictor

    variables = randomized_variables(cfg, seed)
    fast = EnsemblePredictor(cfg, variables, n_repeat=N_REPEAT, seed=seed, fast=True,
                             device=DEVICE)
    plain = plain_predictor(cfg, variables, seed)
    rng = np.random.default_rng(100 + seed)
    worst, subjects = 0.0, []
    for s in range(n_subjects):
        x = rng.uniform(size=(BATCH_SERVE, cfg.image_size, cfg.image_size,
                              cfg.n_input_channels)).astype(np.float32)
        mask = (rng.uniform(size=x.shape[:3]) > 0.2).astype(np.float32)
        out, ref = fast.predict(x, mask), plain.predict(x, mask)
        check(out.shape == (BATCH_SERVE, cfg.image_size, cfg.image_size, cfg.n_out),
              f"output shape {out.shape}")
        check(bool(np.isfinite(out).all()), "non-finite ensemble output")
        check(not out[mask == 0].any(), "masked-out pixels are not zero")
        diff = float(np.abs(out - ref).max())
        check(diff < 0.05, f"subject {s}: fast vs plain max abs diff {diff:.4f}")
        if cfg.n_out == 1:
            check(float(out.min()) >= -1 and float(out.max()) <= 1, "DEM outside [-1, 1]")
        else:
            err = float(np.abs(out.sum(-1) - mask).max())
            check(err < 1e-3, f"softmax does not sum to 1 inside the mask ({err:.2e})")
        print(f"serve n_out={cfg.n_out} subject {s}: fast vs plain max abs diff {diff:.4e}, "
              f"output mean {float(out.mean()):.4f} std {float(out.std()):.4f}")
        worst = max(worst, diff)
        subjects.append((x, mask))
    return worst, fast, subjects


def forward_ms(fn, reps: int = 3) -> float:
    """Device ms of one call of ``fn`` (a whole forward, host dispatch
    included): CUDA events around ``reps`` calls after a warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_serving_options(cfg, seed: int, smi: str) -> tuple[dict, dict]:
    """Phase 3b: the full-width FastGenerator (bf16, one 42-slice batch,
    random weights from ``seed``) with fuse_chain, fuse_head and both,
    each against the plain float32 generator with the same noise (max abs
    < 0.05), with its exact launches (counts set to 0 just before the
    forward, read just after); fuse_chain against the default forward
    (identical, or within the kernel phase's difference between the chain
    and the sequential kernels); then ms per forward with CUDA events,
    each option beside the default path, in turns. Returns the launches of
    the three runs summed, and the timings."""
    from depgan_tpu_torch.io.flax_bridge import load_flax_variables
    from depgan_tpu_torch.models import GenUNet2D
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops.fast_gen import FastGenerator

    variables = randomized_variables(cfg, seed)
    rng = np.random.default_rng(200 + seed)
    x = torch.tensor(rng.uniform(size=(BATCH_SERVE, cfg.image_size, cfg.image_size,
                                       cfg.n_input_channels)), dtype=torch.float32, device=DEVICE)
    z = torch.tensor(rng.normal(size=(BATCH_SERVE, cfg.noise_size, 1)), dtype=torch.float32,
                     device=DEVICE)
    with torch.no_grad():
        ref = load_flax_variables(GenUNet2D(cfg, device=DEVICE), variables).eval()(x, z)
    fast = FastGenerator(cfg, variables, torch.bfloat16, DEVICE)
    default = fast(x, z)
    flags = {"default": (False, False), "fuse_chain": (False, True), "fuse_head": (True, False),
             "both": (True, True)}

    def run(option):
        fast.fuse_head, fast.fuse_chain = flags[option]
        return fast(x, z)

    total = dict.fromkeys(KERNELS, 0)
    for option, want in OPTION_LAUNCHES.items():
        K.reset_launch_counts()
        out = run(option)
        torch.cuda.synchronize()
        launches = K.launches()
        got = {k: v for k, v in launches.items() if v}
        check(got == want, f"serving {option}: launches {got}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"serving {option}: output {tuple(out.shape)}")
        diff = float((out - ref).abs().max())
        check(diff < 0.05, f"serving {option}: max abs diff {diff:.4f} from the plain float32 "
                           f"generator")
        line = f"serve option {option}: max abs diff {diff:.4e} from the plain float32 generator"
        if option == "fuse_chain":
            chain = float((out - default).abs().max())
            allowed = SEQUENTIAL_DIFF.get("conv3x3_s2d_chain3", 0.0)
            check(chain == 0.0 or chain <= allowed,
                  f"serving fuse_chain: {chain:.3e} from the default forward, the kernel phase "
                  f"found {allowed:.3e} between chain and sequential kernels")
            line += f", {chain:.4e} from the default forward"
        print(f"{line}, launches {got}")
    times = {option: [] for option in flags}
    for option in ("default", "fuse_chain", "fuse_head", "both",
                   "both", "fuse_head", "fuse_chain", "default"):
        times[option].append(forward_ms(lambda: run(option)))
    fast.fuse_head = fast.fuse_chain = False
    best = {option: min(t) for option, t in times.items()}
    print(f"time serving options on {smi}: ms per {BATCH_SERVE}-slice forward (least of 2 "
          f"turns, each 3 forwards after a warm-up): "
          + ", ".join(f"{o} {best[o]:.3f} ({', '.join(f'{t:.3f}' for t in times[o])})"
                      for o in flags))
    return total, best


def close(a: torch.Tensor | None, b: torch.Tensor | None, rel: float, what: str) -> float:
    """Checks max|a - b| <= rel * max|b| (None counts as zeros: a gradient
    that only masks reach); returns the relative error."""
    if a is None and b is None:
        return 0.0
    a = torch.zeros_like(b) if a is None else a.detach()
    b = torch.zeros_like(a) if b is None else b.detach()
    err, scale = float((a - b).double().abs().max()), float(b.abs().max())
    check(err <= rel * scale + 1e-12, f"{what}: error {err:.3e} at scale {scale:.3e}")
    return err / max(scale, 1e-30)


def check_backward() -> None:
    """Phase 4: each autograd rule against autograd of its plain version,
    float32, batch 2, production shapes; padded-plane gradients compared on
    the interior (the plain version also differentiates the ring)."""
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops import s2d_conv as S

    g = torch.Generator(device=DEVICE).manual_seed(7)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * std

    def plane(n, c4):
        return K.pad_s2d(randn(BATCH_GRAD, n, n, c4))

    def w4(ci, co):
        return S.conv3x3_to_s2d_kernel(randn(3, 3, ci, co, std=(9 * ci) ** -0.5))[0].contiguous()

    def conv5_plain(x, w5, b, mode="relu"):
        return K.conv5x5_s2d_fused_plain(x, *S.conv5x5_to_s2d_kernel(w5, b), mode=mode)

    gamma, beta = 1.0 + randn(BATCH_GRAD, 256, std=0.3), randn(BATCH_GRAD, 256, std=0.3)
    cases = {
        "K1 relu L1 128->128": (K.conv3x3_s2d_fused, K.conv3x3_s2d_fused_plain,
                                (plane(128, 128), w4(32, 32), randn(128, std=0.1))),
        "K1 film L2 256": (lambda *a: K.conv3x3_s2d_fused(*a, mode="film"),
                           lambda *a: K.conv3x3_s2d_fused_plain(*a, mode="film"),
                           (plane(64, 256), w4(64, 64), randn(256, std=0.1), gamma, beta)),
        "K3 p1 256+128->128": (K.conv3x3_s2d_fused2, K.conv3x3_s2d_fused2_plain,
                               (plane(128, 256), plane(128, 128), w4(64, 32), w4(32, 32),
                                randn(128, std=0.1))),
        "K4 p2->p1 256->256": (K.deconv_s2d, K.deconv_s2d_plain,
                               (plane(64, 256), randn(64, 256, std=0.125), randn(256, std=0.1))),
        "K5 generator L1": (K.pool_to_s2d, K.pool_to_s2d_plain, (plane(128, 128),)),
        "K5 critic L0": (K.pool_to_s2d, K.pool_to_s2d_plain, (plane(128, 64),)),
        "K6 generator L2": (K.pool_s2d, K.pool_s2d_plain, (plane(64, 256),)),
        "K6 critic L1": (K.pool_s2d, K.pool_s2d_plain, (plane(64, 128),)),
        "K7 relu L0a 16->64": (K.conv5x5_s2d_fused, conv5_plain,
                               (plane(128, 16), randn(5, 5, 4, 16, std=0.1), randn(16, std=0.1))),
        "K7 relu L1b 128->128": (K.conv5x5_s2d_fused, conv5_plain,
                                 (plane(64, 128), randn(5, 5, 32, 32, std=0.035),
                                  randn(32, std=0.1))),
        "K7 none L0a dX 64->16": (lambda *a: K.conv5x5_s2d_fused(*a, mode="none"),
                                  lambda *a: conv5_plain(*a, mode="none"),
                                  (plane(128, 64), randn(5, 5, 16, 4, std=0.05),
                                   randn(4, std=0.1))),
    }
    def against_plain(label, fn, plain, inputs):
        results = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            out = f(*leaves)
            r = torch.randn(out.shape, generator=torch.Generator(device=DEVICE).manual_seed(1),
                            device=DEVICE)
            results.append((out, torch.autograd.grad((out * r).sum(), leaves)))
        (out, grads), (ref, ref_grads) = results
        close(out, ref, 1e-5, f"{label} forward")
        worst = 0.0
        for i, (a, b) in enumerate(zip(grads, ref_grads)):
            if a.ndim == 4 and a.shape[1] == a.shape[2] and a.shape[1] > 5:
                a, b = K.unpad_s2d(a), K.unpad_s2d(b)
            worst = max(worst, close(a, b, 1e-4, f"{label} gradient {i}"))
        print(f"backward {label}: gradients within {worst:.2e} relative of autograd of plain")

    def double_backward(label, x, w5, b):
        """grad of sum(dX^2) wrt w5 and x."""
        r = randn(BATCH_GRAD, x.shape[1], x.shape[2], 4 * w5.shape[-1])
        second = []
        for conv in (K.conv5x5_s2d_fused, conv5_plain):
            xx, ww = x.clone().requires_grad_(), w5.clone().requires_grad_()
            (dx,) = torch.autograd.grad((conv(xx, ww, b) * r).sum(), xx, create_graph=True)
            second.append(torch.autograd.grad((K.unpad_s2d(dx) ** 2).sum(), (xx, ww),
                                              allow_unused=True))
        ex = close(second[0][0], second[1][0], 1e-4, f"{label} double backward wrt x")
        ew = close(second[0][1], second[1][1], 1e-4, f"{label} double backward wrt w5")
        print(f"backward {label} double backward: wrt x {ex:.2e}, wrt w5 {ew:.2e} relative")

    for label, (fn, plain, inputs) in cases.items():
        against_plain(label, fn, plain, inputs)
    double_backward("K7", plane(128, 16), randn(5, 5, 4, 16, std=0.1), randn(16, std=0.1))

    # CONV5_PACKED: the forward, the transposed conv of dX and the double
    # backward's convs at L0a and L0b take K11 (4C <= 64 each).
    with conv5_packed():
        K.reset_launch_counts()
        against_plain("K11 relu L0a 16->64", K.conv5x5_s2d_fused, conv5_plain,
                      (plane(128, 16), randn(5, 5, 4, 16, std=0.1), randn(16, std=0.1)))
        against_plain("K11 relu L0b 64->64", K.conv5x5_s2d_fused, conv5_plain,
                      (plane(128, 64), randn(5, 5, 16, 16, std=0.05), randn(16, std=0.1)))
        double_backward("K11 L0a", plane(128, 16), randn(5, 5, 4, 16, std=0.1),
                        randn(16, std=0.1))
        launches = K.launches()
    got = {k: v for k, v in launches.items() if v}
    # Forward and dX of each rule check and of the double backward (whose
    # second gradient reaches the dX conv through its weight only: its input
    # cotangent is masked by the forward's output, which carries none).
    check(got == {"conv5x5_s2d_fused[packed]": 6},
          f"backward with CONV5_PACKED: launches {got}, expected 6 of K11 and no other")


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 (||a|| where b is zero); a missing
    gradient counts as zeros (biases reach the input gradient only through
    masks)."""
    if a is None and b is None:
        return 0.0
    a = torch.zeros_like(b) if a is None else a.detach()
    b = torch.zeros_like(a) if b is None else b.detach()
    diff, scale = float((a.double() - b.double()).norm()), float(b.double().norm())
    return diff / scale if scale > 0 else diff


def critic_errors(seed: int) -> dict[str, list[float]]:
    """Relative L2 errors, against the plain critic in float64 with
    ``create_graph``, of the score, the input gradient and each gradient
    penalty's parameter gradient (image 256, batch 2, weights, biases and
    input from ``seed``): of the fused critic in float32, of the plain
    critic in float32, and of the fused critic in bfloat16 (the control)."""
    from depgan_tpu_torch.config import ModelConfig
    from depgan_tpu_torch.io.flax_bridge import (
        flatten_tree, load_flax_variables, unflatten_tree)
    from depgan_tpu_torch.models import DisC2DFCN1, init_critic
    from depgan_tpu_torch.ops.fast_critic import FusedCritic

    cfg = ModelConfig(image_size=IMAGE, first_fm=32)
    rng = np.random.default_rng(seed)
    flat = flatten_tree(init_critic(cfg, seed=seed)["params"])
    for name in flat:  # non-zero biases
        if name.endswith(".bias"):
            flat[name] = rng.normal(0, 0.05, flat[name].shape).astype(np.float32)
    tree = {"params": unflatten_tree(flat)}
    x = torch.tensor(rng.uniform(size=(BATCH_GRAD, IMAGE, IMAGE, 1)), dtype=torch.float32,
                     device=DEVICE)

    def gp(grad):
        return ((grad.square().sum((1, 2, 3)).sqrt() - 1) ** 2).mean()

    runs = {}
    for dt in (torch.float64, torch.float32):
        module = load_flax_variables(DisC2DFCN1(cfg, device=DEVICE), tree).to(dt)
        module.cfg = ModelConfig(image_size=IMAGE, first_fm=32, compute_dtype=str(dt)[6:])
        xx = x.to(dt).requires_grad_()
        score = module(xx)
        (grad,) = torch.autograd.grad(score.sum(), xx, create_graph=True)
        gp(grad).backward()
        runs[f"plain {str(dt)[6:]}"] = (score, grad, {k: p.grad for k, p in
                                                       module.named_parameters()})
    for dt in (torch.float32, torch.bfloat16):
        params = {k: torch.tensor(v, device=DEVICE, requires_grad=True) for k, v in flat.items()}
        score, grad = FusedCritic(cfg, dt).score_and_input_grad(params, x)
        gp(grad).backward()
        runs[f"fused {str(dt)[6:]}"] = (score, grad, {k: p.grad for k, p in params.items()})
    ref, ref_grad, ref_params = runs.pop("plain float64")
    return {tag: [rel_l2(score, ref), rel_l2(grad, ref_grad)]
            + [rel_l2(grads[name], g) for name, g in ref_params.items()]
            for tag, (score, grad, grads) in runs.items()}


def check_critic(tag: str = "") -> None:
    """Phase 5: FusedCritic against the plain critic in float64, image IMAGE,
    over CRITIC_SEEDS. Float32 itself is 1e-4 to 5e-3 (relative L2) off
    float64 here: a 2x2 max-pool window whose two largest values lie within
    float32 rounding of each other sends its cotangent to the other one.
    The limit sits between the float32 readings and the bfloat16 control's,
    and the control must exceed it, so the check still sees a fault of the
    size of a precision fault. ``tag`` names the run in the output."""
    worst, control = 0.0, float("inf")
    for seed in CRITIC_SEEDS:
        errs = critic_errors(seed)
        print(f"critic{tag} seed {seed}: relative L2 against the plain critic in float64 (score, "
              f"input gradient, the largest of {len(errs['fused float32']) - 2} GP parameter "
              f"gradients): " + "; ".join(f"{tag} {e[0]:.3e}, {e[1]:.3e}, {max(e[2:]):.3e}"
                                          for tag, e in errs.items()))
        worst = max(worst, max(errs["fused float32"]))
        control = min(control, max(errs["fused bfloat16"]))
    check(worst <= CRITIC_LIMIT, f"fused critic {worst:.3e} relative L2 off float64, "
                                 f"limit {CRITIC_LIMIT:g}")
    check(control > CRITIC_LIMIT, f"the bfloat16 control reads {control:.3e}, within the "
                                  f"limit {CRITIC_LIMIT:g}: the check cannot tell it apart")
    print(f"critic{tag}: fused float32 at most {worst:.3e}, bfloat16 control at least "
          f"{control:.3e}, limit {CRITIC_LIMIT:g} (relative L2 against float64)")


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def random_adam(rng: np.random.Generator, params: dict) -> dict:
    """Adam moments that are not zero, so that the updates are not all
    +-lr of a rounding-level gradient (biases before a BatchNorm)."""
    return {"count": 3,
            "mu": tree_map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), params),
            "nu": tree_map(lambda a: rng.uniform(1e-6, 1e-5, a.shape).astype(np.float32), params)}


def change(tensors: dict, start: dict) -> torch.Tensor:
    """All of ``tensors`` minus their numpy ``start`` values, as one
    float64 vector."""
    return torch.cat([(t.detach().double() - torch.as_tensor(start[k], device=t.device).double())
                      .flatten() for k, t in tensors.items()])


def superstep_errors(seed: int, runs: dict = SUPERSTEP_RUNS,
                     bn_mode: str = "frozen") -> tuple[dict, int]:
    """One superstep (full width, batch 2, D = 2, k = 2) from one state
    with the same draws, on each path of ``runs``, against the plain
    float64 superstep. The state (from ``seed``) has non-trivial BatchNorm
    and Adam moments that are not zero. Returns, for each path, its
    readings: each logged loss's error relative to its own size, or to the
    critic scores' size for errG_CY2 and errG_DEM (which sit near zero);
    for each network the relative L2 of its updates, their largest abs
    error and the largest update, and the relative L2 of Adam's first
    moment, which with b1 = 0 is the last step's gradient (linear in it,
    where the updates saturate at ~1.86 lr); with batch BatchNorm the
    relative L2 of the generator's statistics' changes; the best noise
    index, the kernel launches, and the summary that the limits read.
    Also the float64 best index."""
    from depgan_tpu_torch.config import DataConfig, GanTrainConfig, ModelConfig
    from depgan_tpu_torch.io.flax_bridge import flatten_tree as flatten
    from depgan_tpu_torch.io.flax_bridge import gan_train_state_from_trees
    from depgan_tpu_torch.models import init_critic
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.train.gan_trainer import GEN_KEYS, GanTrainer
    from depgan_tpu_torch.train.state import adam_moments

    d, k = 2, 2
    rng = np.random.default_rng(seed)
    gen = randomized_variables(ModelConfig(image_size=IMAGE, first_fm=32), seed=seed)
    trees = {"g_params": gen["params"], "g_stats": gen["batch_stats"]}
    for i, name in enumerate(("dy2", "ddem")):
        critic = init_critic(ModelConfig(image_size=IMAGE), seed=seed + 1 + i)
        trees[f"{name}_params"] = critic["params"]
    for name in ("g", "dy2", "ddem"):
        trees[f"{name}_opt"] = random_adam(rng, trees[f"{name}_params"])
    x_all, y_all = (torch.tensor(rng.uniform(size=(8, IMAGE, IMAGE, 1)), dtype=torch.float32,
                                 device=DEVICE) for _ in range(2))
    idx = np.array([[3, 5], [0, 7]])
    results, launches = {}, {}
    for tag, (use_pallas, dtype, with_gp) in runs.items():
        cfg = ModelConfig(image_size=IMAGE, first_fm=32, use_pallas=use_pallas,
                          compute_dtype=dtype)
        train_cfg = GanTrainConfig(batch_size=BATCH_GRAD, d_iters=d, warmup_d_iters=d,
                                   k_noise=k, bn_mode=bn_mode)
        if not with_gp:
            train_cfg = dataclasses.replace(train_cfg, gp_weight=0.0)
        trainer = GanTrainer(cfg, train_cfg, DataConfig(), DEVICE)
        state = gan_train_state_from_trees(trees, train_cfg.lr_g, train_cfg.lr_d,
                                           train_cfg.adam_b1, train_cfg.adam_b2, DEVICE)
        draws = trainer.draw(d, BATCH_GRAD, torch.Generator(device=DEVICE).manual_seed(seed + 1))
        K.reset_launch_counts()
        results[tag] = trainer.superstep(state, x_all, y_all, idx, d, draws=draws)
        launches[tag] = K.launches()
    ref_state, ref = results.pop("float64")
    crit = ("crit_y2_real", "crit_y2_fake", "crit_dem_real", "crit_dem_fake")
    scores = ("errG_CY2", "errG_DEM")
    score_size = max(float(ref[key].abs().max()) for key in crit)
    starts = {part: flatten(trees[f"{part}_params"]) for part in ("g", "dy2", "ddem")}
    lrs = {"g": GanTrainConfig().lr_g, "dy2": GanTrainConfig().lr_d, "ddem": GanTrainConfig().lr_d}

    def moment(state, part):
        params = getattr(state, f"{part}_params")
        return adam_moments(getattr(state, f"{part}_opt"), params)[1]

    out = {}
    for tag, (state, metrics) in results.items():
        losses = {key: (metrics[key], ref[key]) for key in crit}
        losses.update({key: (metrics["gen"][key], ref["gen"][key]) for key in GEN_KEYS})
        loss_err = {}
        for key, (a, b) in losses.items():
            floor = score_size if key in crit + scores else 0.0
            loss_err[key] = float(((a - b).abs() / b.abs().clamp_min(max(floor, 1e-30))).max())
        parts = {}
        for part, start in starts.items():
            a, b = getattr(state, f"{part}_params"), getattr(ref_state, f"{part}_params")
            du = torch.cat([(a[n] - b[n]).detach().flatten() for n in a]).double()
            up = change(b, start)
            mu, ref_mu = moment(state, part), moment(ref_state, part)
            grad = rel_l2(torch.cat([mu[n].flatten() for n in mu]),
                          torch.cat([ref_mu[n].flatten() for n in mu]))
            parts[part] = {"updates": float(du.norm() / up.norm()),
                           "max_abs": float(du.abs().max()), "size": float(up.abs().max()),
                           "gradient": grad}
        summary = {
            "losses": max(e for key, e in loss_err.items() if key not in scores),
            "updated scores": max(loss_err[key] for key in scores),
            "updates": max(p["updates"] for p in parts.values()),
            "gradient": max(p["gradient"] for p in parts.values()),
            "max abs / lr": max(p["max_abs"] / lrs[part] for part, p in parts.items())}
        if bn_mode == "batch":
            summary["statistics"] = rel_l2(change(state.g_stats, flatten(trees["g_stats"])),
                                           change(ref_state.g_stats, flatten(trees["g_stats"])))
        out[tag] = {"losses": loss_err, "parts": parts, "best": int(metrics["best_noise_idx"]),
                    "launches": launches[tag], "summary": summary}
    return out, int(ref["best_noise_idx"])


def hold_limits(what: str, summaries: list[dict], limits: dict, main: str) -> None:
    """Checks, over the seeds' summaries (path -> reading -> value), that
    the largest reading of path ``main`` stays within each limit and the
    least reading of every control path (tag 'control ...') exceeds it, so
    the check would see a fault of the size of a precision fault."""
    worst = {key: max(s[main][key] for s in summaries) for key in limits}
    controls = sorted({tag for s in summaries for tag in s if tag.startswith("control")})
    beside = sorted({tag for s in summaries for tag in s} - {main, *controls})
    least = {tag: {key: min(s[tag][key] for s in summaries) for key in limits}
             for tag in controls}
    print(f"{what}: against float64, the largest over seeds (the least for the controls): "
          + "; ".join(f"{key}: {main} {worst[key]:.3e}, "
                      + "".join(f"{tag} {max(s[tag][key] for s in summaries):.3e}, "
                                for tag in beside)
                      + ", ".join(f"{tag} {c[key]:.3e}" for tag, c in least.items())
                      + f", limit {limit:g}" for key, limit in limits.items()))
    for key, limit in limits.items():
        check(worst[key] <= limit, f"{what}: {main} {key} {worst[key]:.3e} off float64, "
                                   f"limit {limit:g}")
        for tag, c in least.items():
            check(c[key] > limit, f"{what}: {tag} {key} reads {c[key]:.3e}, within the limit "
                                  f"{limit:g}")


def print_superstep(what: str, seed: int, readings: dict, ref_best: int) -> None:
    for tag, r in readings.items():
        parts = "; ".join(f"{part} updates {p['updates']:.3e} (max abs {p['max_abs']:.3e} "
                          f"of {p['size']:.3e}), gradient {p['gradient']:.3e}"
                          for part, p in r["parts"].items())
        losses = ", ".join(f"{key} {err:.2e}" for key, err in r["losses"].items())
        stats = (f"; statistics {r['summary']['statistics']:.3e}"
                 if "statistics" in r["summary"] else "")
        print(f"{what} seed {seed} {tag} against float64: {parts}{stats}; losses {losses}; "
              f"best noise {r['best']} (float64 {ref_best})")


def check_superstep() -> None:
    """Phase 6: the fused superstep against the plain float64 one over
    SUPERSTEP_SEEDS (the plain float32 one reported beside). Float32 on
    either path comes out ~1e-2 (relative L2) off float64 in the critics'
    updates and gradients, as in phase 5, and so do the scores the updated
    critics give (errG_CY2, errG_DEM). Held, for every seed: the same best
    noise, and each reading of SUPERSTEP_LIMITS within its limit; each
    limit sits between the float32 readings and the controls' (the fused
    superstep in bfloat16, and without the gradient penalty), and the
    controls must exceed every limit."""
    summaries = []
    for seed in SUPERSTEP_SEEDS:
        readings, ref_best = superstep_errors(seed)
        print_superstep("superstep", seed, readings, ref_best)
        summaries.append({tag: r["summary"] for tag, r in readings.items()})
        best = readings["fused"]["best"]
        check(best == ref_best, f"seed {seed} best noise index: fused {best}, float64 {ref_best}")
    hold_limits("superstep", summaries, SUPERSTEP_LIMITS, "fused")


def check_superstep_packed() -> dict[str, int]:
    """Phase 6 with ``CONV5_PACKED``: the first seed of SUPERSTEP_SEEDS held
    as ``check_superstep`` holds each seed, and the fused superstep's exact
    launches (D = 2, k = 2). Returns them."""
    seed = SUPERSTEP_SEEDS[0]
    with conv5_packed():
        readings, ref_best = superstep_errors(seed)
    print_superstep("superstep CONV5_PACKED", seed, readings, ref_best)
    best = readings["fused"]["best"]
    check(best == ref_best, f"CONV5_PACKED seed {seed} best noise index: fused {best}, "
                            f"float64 {ref_best}")
    hold_limits("superstep CONV5_PACKED", [{tag: r["summary"] for tag, r in readings.items()}],
                SUPERSTEP_LIMITS, "fused")
    launches, want = readings["fused"]["launches"], expected_superstep_launches(2, 2, packed=True)
    check(launches == want, f"superstep CONV5_PACKED launches {launches}, expected {want}")
    return launches


def check_batch_bn_superstep() -> dict[str, int]:
    """Phase 8: the superstep with ``bn_mode='batch'`` through K8 against
    the plain float64 one over BATCH_BN_SEEDS, as phase 6 holds the fused
    one, with the generator's statistics' changes besides; exactly
    7 (2D + k + 1) K8 launches and no other kernel on the K8 path (the
    batch mode runs the plain modules, as JAX does). Returns the launches
    of the first seed's K8 superstep."""
    runs = {tag: (use_pallas, dtype, True) for tag, (use_pallas, dtype) in TRAIN_MODE_RUNS.items()}
    summaries, main_launches = [], None
    for seed in BATCH_BN_SEEDS:
        readings, ref_best = superstep_errors(seed, runs, bn_mode="batch")
        print_superstep("batch-BN superstep", seed, readings, ref_best)
        summaries.append({tag: r["summary"] for tag, r in readings.items()})
        best = readings["k8"]["best"]
        check(best == ref_best, f"batch-BN seed {seed} best noise index: K8 {best}, "
                                f"float64 {ref_best}")
        launches = readings["k8"]["launches"]
        want = {name: 7 * (2 * 2 + 2 + 1) if name == "film_residual" else 0 for name in launches}
        check(launches == want, f"batch-BN superstep launches {launches}, expected {want}")
        main_launches = main_launches or launches
    hold_limits("batch-BN superstep", summaries, BATCH_BN_LIMITS, "k8")
    return main_launches


def uresnet_errors(seed: int) -> dict:
    """URESNET_STEPS UResNet training steps (full width, batch 2,
    ``dropout_mode='uresnet'``) from one state (from ``seed``: randomized
    BatchNorm, Adam moments that are not zero) with the same batches,
    noises and dropout masks, on each path of TRAIN_MODE_RUNS, against the
    plain float64 path. Returns each path's readings: the largest relative
    error of a step's loss, and the relative L2 of the parameter updates,
    of the BatchNorm statistics' changes and of Adam's first moment."""
    from depgan_tpu_torch.config import ModelConfig, UResNetTrainConfig
    from depgan_tpu_torch.io.flax_bridge import flatten_tree, uresnet_train_state_from_trees
    from depgan_tpu_torch.models.generator import dropout_masks
    from depgan_tpu_torch.train.state import adam_moments
    from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer

    base = ModelConfig(image_size=IMAGE, first_fm=32, n_out=4, dropout_mode="uresnet")
    train_cfg = UResNetTrainConfig(batch_size=BATCH_GRAD)
    rng = np.random.default_rng(seed)
    variables = randomized_variables(base, seed)
    opt = random_adam(rng, variables["params"])
    n = BATCH_GRAD * URESNET_STEPS
    x = rng.uniform(size=(n, IMAGE, IMAGE, 1)).astype(np.float32)
    x_all = torch.tensor(x, device=DEVICE)
    y_all = torch.tensor(np.eye(4, dtype=np.float32)[np.digitize(x[..., 0], [0.3, 0.6, 0.85])],
                         device=DEVICE)
    noises = torch.tensor(rng.normal(size=(URESNET_STEPS, n, base.noise_size, 1)),
                          dtype=torch.float32, device=DEVICE)
    batches = rng.permutation(n).reshape(URESNET_STEPS, BATCH_GRAD)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    masks = [dropout_masks(base, BATCH_GRAD, gen, DEVICE) for _ in range(URESNET_STEPS)]
    results = {}
    for tag, (use_pallas, dtype) in TRAIN_MODE_RUNS.items():
        cfg = dataclasses.replace(base, use_pallas=use_pallas, compute_dtype=dtype)
        trainer = UResNetTrainer(cfg, train_cfg, DEVICE)
        state = uresnet_train_state_from_trees(variables["params"], variables["batch_stats"],
                                               opt, train_cfg.lr, DEVICE)
        losses = []
        for s in range(URESNET_STEPS):
            state, loss = trainer.step(state, x_all, y_all, noises[s], batches[s],
                                       dropout=masks[s])
            losses.append(float(loss))
        results[tag] = (state, losses)
    ref_state, ref_losses = results.pop("float64")
    start_p, start_s = flatten_tree(variables["params"]), flatten_tree(variables["batch_stats"])

    def first_moment(state):
        return torch.cat([m.flatten() for m in adam_moments(state.opt, state.params)[1].values()])

    return {tag: {"losses": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                  "updates": rel_l2(change(state.params, start_p),
                                    change(ref_state.params, start_p)),
                  "statistics": rel_l2(change(state.batch_stats, start_s),
                                       change(ref_state.batch_stats, start_s)),
                  "first moment": rel_l2(first_moment(state), first_moment(ref_state))}
            for tag, (state, losses) in results.items()}


def check_uresnet() -> None:
    """Phase 7, the steps: the K8 path in float32 against the plain path in
    float64 over URESNET_SEEDS (the plain float32 path reported beside),
    each reading of URESNET_LIMITS within its limit, and the bfloat16
    control beyond every limit."""
    summaries = []
    for seed in URESNET_SEEDS:
        readings = uresnet_errors(seed)
        for tag, r in readings.items():
            print(f"uresnet seed {seed} {tag} against float64: "
                  + ", ".join(f"{key} {v:.3e}" for key, v in r.items()))
        summaries.append(readings)
    hold_limits("uresnet", summaries, URESNET_LIMITS, "k8")


def check_uresnet_fit() -> dict[str, int]:
    """Phase 7, the epoch loop: ``UResNetTrainer.fit`` through K8 (float32,
    full width) for FIT_EPOCHS epochs over a synthetic fold of FIT_SLICES
    slices (labels thresholded from x), batch BATCH_TRAIN, FIT_VAL
    validation slices: finite losses, the hooks called once per epoch, and
    exactly 7 K8 launches per training step and per validation chunk, no
    other kernel. Returns the launches."""
    from depgan_tpu_torch.config import ModelConfig, UResNetTrainConfig
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer

    cfg = ModelConfig(image_size=IMAGE, first_fm=32, n_out=4, dropout_mode="uresnet",
                      use_pallas=True)
    train_cfg = UResNetTrainConfig(batch_size=BATCH_TRAIN, seed=5)
    trainer = UResNetTrainer(cfg, train_cfg, DEVICE)
    state = trainer.init_state(5)
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(FIT_SLICES + FIT_VAL, IMAGE, IMAGE, 1)).astype(np.float32)
    labels = np.digitize(x, [0.3, 0.6, 0.85]).astype(np.int32)
    losses, val_losses, ckpts = [], [], []
    K.reset_launch_counts()
    state = trainer.fit(state, x[:FIT_SLICES], labels[:FIT_SLICES], x[FIT_SLICES:],
                        labels[FIT_SLICES:], n_epochs=FIT_EPOCHS, loss_history=losses,
                        val_loss_history=val_losses,
                        checkpoint_fn=lambda s, e: ckpts.append(e))
    launches = K.launches()
    steps = FIT_EPOCHS * (FIT_SLICES // BATCH_TRAIN)
    val_chunks = FIT_EPOCHS * -(-FIT_VAL // BATCH_TRAIN)
    want = {name: 7 * (steps + val_chunks) if name == "film_residual" else 0 for name in launches}
    check(launches == want, f"fit launches {launches}, expected {want}")
    check(len(losses) == len(val_losses) == FIT_EPOCHS and np.isfinite(losses + val_losses).all(),
          f"fit losses {losses}, validation {val_losses}")
    check(state.epoch == FIT_EPOCHS and ckpts == list(range(FIT_EPOCHS)),
          f"fit epochs {state.epoch}, checkpoints {ckpts}")
    print(f"uresnet fit: {FIT_EPOCHS} epochs of {FIT_SLICES} slices, losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}, validation "
          f"{', '.join(f'{v:.5f}' for v in val_losses)}, launches {launches}")
    return launches


def expected_superstep_launches(d: int, k: int, packed: bool = False,
                                n_valid: int | None = None) -> dict[str, int]:
    """Kernel launches of one fused superstep with D critic steps per
    critic and k probe noises, with ``CONV5_PACKED`` when ``packed``. An
    epoch-tail superstep runs ``n_valid`` of its D critic steps (the rest
    are skipped), so it launches what a superstep of D = ``n_valid`` does.

    Generator forwards: 2D (critic loops) + k (probe) + 1 (its step), each
    K1 x10 (6 relu, 4 film), K3 x2, K4 x1, K5 x1, K6 x1; its backward adds
    17 K1 'none' launches (dX of 5 relu convs, c0 and dX of 4 FiLM sites,
    2 dX of each K3; the entry conv's dX is skipped). Critic forward: K7
    x4, K5 x1, K6 x1. A critic step: forwards of real and fake, the levels
    and the 4 transposed K7 of the input gradient, and in its backward 3 K7
    dX for each forward (the image needs none) and 4 for the chain: K7 26,
    K5 3, K6 3. The generator's step scores its output with both critics
    (8 K7, 2 K5, 2 K6) and takes their input gradient (8 K7); the probe
    scores k outputs with both critics. Frozen BatchNorm runs no K8.

    With ``CONV5_PACKED`` a conv5 launch takes K11 when its input has 4C <=
    64, the critic's levels being L0a 16 -> 64, L0b 64 -> 64, L1a 64 -> 128
    and L1b 128 -> 128 (4C -> 4Co). A forward: L0a, L0b, L1a packed, L1b
    dense. The input gradient's transposes read the levels' outputs: of L1b
    and L1a dense (128), of L0b and L0a packed (64). A forward's backward
    dX of L0b packed, of L1a and L1b dense. The chain's dX read the
    transposes' outputs, the levels' inputs: of L0a's, L0b's and L1a's
    transposes packed (16, 64, 64), of L1b's dense. So a critic step is 16
    packed and 10 dense (3 + 3 + 3 forwards, 2 + 2 transposes, 1 + 1 and
    2 + 2 forward dX, 3 + 1 chain); the generator's step 10 and 6 (2
    forwards, 2 x (2 + 2) input gradients: dX of L0a and L0b packed); a
    probe score 3 and 1.
    """
    d = d if n_valid is None else n_valid
    gen_fwd, steps, probe = 2 * d + k + 1, 2 * d, 2 * k
    counts = dict.fromkeys(KERNELS, 0)  # no other kernel, K2, K8 and K9-K12 included
    counts.update({"conv3x3_s2d_fused": 10 * gen_fwd, "conv3x3_s2d_fused[none]": 17,
                   "conv3x3_s2d_fused2": 2 * gen_fwd, "deconv_s2d": gen_fwd,
                   "pool_to_s2d": gen_fwd + 3 * steps + probe + 2,
                   "pool_s2d": gen_fwd + 3 * steps + probe + 2,
                   "conv5x5_s2d_fused": 26 * steps + 4 * probe + 16})
    if packed:
        counts.update({"conv5x5_s2d_fused[packed]": 16 * steps + 3 * probe + 10,
                       "conv5x5_s2d_fused": 10 * steps + probe + 6})
    return counts


def profile_once(fn, what: str, unprofiled_ms: float) -> None:
    """Device time by kernel over one call of ``fn``, and the device's idle
    share: of the profiled wall time (which holds the profiler's own
    overhead) and of ``unprofiled_ms``, the same call timed without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels and copies): operator rows, and the
    # device spans of ranges such as Optimizer.step or the superstep's
    # phases, would count their kernels' time a second time.
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)), reverse=True)
    if not rows:
        print(f"profile {what}: the profiler recorded no device time (idle share not measured)")
        return
    busy_ms = sum(r[0] for r in rows)
    print(f"profile {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; of the unprofiled {unprofiled_ms:.2f} ms "
          f"{1 - busy_ms / unprofiled_ms:.3f}")
    # The device time of each of the superstep's phases: the kernels
    # launched while its range was open on the host, from any thread (the
    # autograd engine launches the backward's from its own).
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    phases = {e.name: [e.time_range.start, e.time_range.end, 0.0] for e in host
              if getattr(e, "is_user_annotation", False) and e.name.startswith("superstep.")}
    for e in host:
        for span in phases.values():
            if span[0] <= e.time_range.start < span[1]:
                span[2] += sum(k.duration for k in e.kernels) / 1e3
    for name, (lo, hi, device_ms) in sorted(phases.items(), key=lambda kv: kv[1][0]):
        print(f"profile {what}: phase {name}: host span {(hi - lo) / 1e3:.3f} ms, device busy "
              f"{device_ms:.3f} ms")
    for ms, count, name in rows[:25]:
        print(f"profile {what}: {ms:9.3f} ms  x{count:<5d} {name[:90]}")


def check_engine_build(_cuda) -> None:
    """Phase 1's build check: what ptxas gave every instantiation of the
    engine (``s2d_gemm``), of the wgmma kernels (``s2d_wgmma``, P2's
    ``rowblk_wgmma``, K11's ``conv5_wgmma``, K10's ``chain_wgmma``) and of
    the window kernels, from the report kept beside the library; the
    production engine held to ENGINE_FIGURES and the wgmma kernels to
    WGMMA_FIGURES. Then the library's own load plan of every K1, K2, K3 and
    K7 shape of the serving forward and the superstep, with the A-load route
    each takes, P2's window, K11's window and K10's plan at their shapes,
    held to ``ops/wgmma_plan.py``."""
    from depgan_tpu_torch.ops import wgmma_plan
    from depgan_tpu_torch.scripts import engine_registers

    log = _cuda.ptxas_log()
    rows = engine_registers.engine_figures(log)
    for line in engine_registers.format_rows(rows):
        print(f"build: {line}")
    wgmma = engine_registers.wgmma_figures(log)
    for name, f in wgmma.items():
        print(f"build: {name}: {f.get('registers')} registers, {f.get('stack')} bytes stack "
              f"frame, {f.get('spill_stores')} / {f.get('spill_loads')} bytes spill stores / loads")
    for name, fig in _cuda.ptxas_figures(log).items():
        if "window_conv" in name:
            print(f"build: {name}: {fig.get('registers')} registers, {fig.get('stack')} bytes "
                  f"stack frame, {fig.get('spill_stores')} / {fig.get('spill_loads')} bytes "
                  f"spill stores / loads")
    production = {(dt, bn): (f.get("registers"), f.get("stack"), f.get("spill_stores"),
                             f.get("spill_loads"))
                  for (dt, bn, phase), f in rows.items() if phase == "production"}
    check(production == ENGINE_FIGURES,
          f"the engine's production instantiations read {production}, expected {ENGINE_FIGURES}")
    mainloop = {key: (f.get("registers"), f.get("stack"), f.get("spill_stores"),
                      f.get("spill_loads")) for key, f in wgmma.items()}
    expected = {engine_registers.wgmma_name(*key): f for key, f in WGMMA_FIGURES.items()}
    check(mainloop == expected,
          f"the wgmma mainloop's instantiations read {mainloop}, expected {expected}")
    for name, label, problem in SERVING_CASES + TRAINING_CASES:
        if name not in WGMMA_KERNELS:
            continue
        kind = {}
        if name == "conv3x3_s2d_fused2":
            n, c4a, c4b, co4 = problem
            c4s = (c4a, c4b)
        else:
            n, c4, co4, mode = problem
            c4s = (c4,)
            if name == "conv3x3_s2d_fused_pool":
                kind = {"pool": mode}
            elif name == "conv5x5_s2d_fused":
                kind = {"gather": "conv5x5"}
        plan = wgmma_plan.plan(n, c4s, co4, **kind)
        check(wgmma_plan.library_plan(n, c4s, co4, **kind) == wgmma_plan.as_ints(plan),
              f"{name} {label}: the library's wgmma plan differs from ops/wgmma_plan.py")
        print(f"build: wgmma plan {name} [{label}]: route {plan.route}, tile {plan.bm} x "
              f"{plan.bn}, {plan.n_blocks} column block(s), A box {plan.box}")
    for name, label, problem in SERVING_CASES + OPTION_CASES:
        if name == "conv3x3_s2d_fused_head":  # K1's relu tile, the head in its epilogue
            n, c4, co4, h4 = problem
            plan = wgmma_plan.plan(n, (c4,), co4)
            check(wgmma_plan.library_plan(n, (c4,), co4) == wgmma_plan.as_ints(plan),
                  f"K9 {label}: the library's wgmma plan differs from ops/wgmma_plan.py")
            print(f"build: wgmma plan {name} [{label}]: route {plan.route}, tile {plan.bm} x "
                  f"{plan.bn}, A box {plan.box}, the head's {h4} columns in the epilogue")
        elif name == "deconv_s2d":
            m, c4, o4 = problem
            dp = wgmma_plan.deconv_plan(m, c4, o4)
            check(wgmma_plan.library_deconv_plan(m, c4, o4) == wgmma_plan.deconv_ints(dp),
                  f"K4 {label}: the library's plan differs from ops/wgmma_plan.py")
            print(f"build: K4 plan [{label}]: {dp.n_blocks} column block(s) of {dp.bn}, "
                  f"{dp.wrow} GEMM rows an output row, A box {dp.box} x {dp.halves} an output "
                  f"row, {dp.steps} 16-deep steps, {dp.a_stages} A tiles, all of B kept "
                  f"({dp.b_bytes} bytes), {dp.bufs} staging buffers a consumer, {dp.smem} bytes "
                  f"of shared memory")
    for _, label, (n, c4, co4, _) in PACKED_CASES:
        win = wgmma_plan.conv5_window(n, c4, co4)
        check(wgmma_plan.library_conv5_window(n, c4, co4) == wgmma_plan.conv5_window_ints(win),
              f"K11 {label}: the library's window differs from ops/wgmma_plan.py")
        print(f"build: K11 window [{label}]: tile {win.bm} x {win.bn}, {win.rows} output row(s) "
              f"a tile, {win.w_stages} windows of {win.win_bytes} bytes, {win.b_stages} B "
              f"stages{' (all of B, kept)' if win.resident else ''}, {win.smem} bytes of "
              f"shared memory")
    for name, label, problem in OPTION_CASES:
        if name != "conv3x3_s2d_chain3":
            continue
        n, c4a, c4b, c4m, c4o, pool = problem
        c4s = (c4a, c4b) if c4b else (c4a,)
        plan = wgmma_plan.chain_plan(n, c4s, c4m, c4o, pool)
        check(wgmma_plan.library_chain_plan(n, c4s, c4m, c4o, pool) == wgmma_plan.chain_ints(plan),
              f"K10 {label}: the library's plan differs from ops/wgmma_plan.py")
        rows = sum(plan.passes) * wgmma_plan.BM * plan.mt
        print(f"build: K10 plan [{label}]: route {plan.route}, T {plan.tile}, pitch {plan.pitch}, "
              f"passes {plan.passes}, {rows} GEMM rows a tile for {plan.tile ** 2} outputs "
              f"({rows / (3 * plan.tile ** 2):.2f}x the sequential kernels'), regions of "
              f"{plan.region} bytes, {plan.stages} ring stages, {plan.smem} bytes of shared "
              f"memory")
    for n, c4, co4 in sorted({problem[:3] for name, _, problem in PROBE_CASES
                              if name == "conv3x3_rowblk"}):
        win = wgmma_plan.window(n, c4, co4)
        check(wgmma_plan.library_window(n, c4, co4) == wgmma_plan.window_ints(win),
              f"P2 n {n} {c4}->{co4}: the library's window differs from ops/wgmma_plan.py")
        print(f"build: rowblk window n {n} {c4}->{co4}: tile {win.bm} x {win.bn}, {win.rows} "
              f"output row(s) a tile, {win.slots} row slots of {c4 // 8 * win.pitch * 16} bytes, "
              f"{win.b_stages} B stages, {win.smem} bytes of shared memory")


def bench_packed_beside_default(benchmarks, bench: dict, smi: str) -> dict:
    """Phase 9: ``gan_step_bench`` with ``CONV5_PACKED`` beside the default
    run ``bench``, in turns (default, packed, packed, default), each with
    its exact launches. Returns the first packed run."""
    runs = {"default": [bench], "packed": []}
    for tag in ("packed", "packed", "default"):
        with conv5_packed() if tag == "packed" else contextlib.nullcontext():
            b = benchmarks.gan_step_bench(BATCH_TRAIN, D_ITERS, K_NOISE)
        want = expected_superstep_launches(D_ITERS, K_NOISE, packed=tag == "packed")
        check(b["launches"] == want, f"superstep {tag} launches {b['launches']}, expected {want}")
        runs[tag].append(b)
    print(f"time training CONV5_PACKED on {smi}: gan_step_bench batch {BATCH_TRAIN}, D {D_ITERS}, "
          f"k {K_NOISE}, ms per superstep in turns default, packed, packed, default: "
          + "; ".join(f"{tag} " + ", ".join(
              f"{b['ms_per_superstep']:.2f} (reps {', '.join(f'{r:.2f}' for r in b['reps_ms'])})"
              for b in bs) for tag, bs in runs.items())
          + f"; packed launches {runs['packed'][0]['launches']}")
    return runs["packed"][0]


def run_probes(smi: str) -> tuple[dict, dict]:
    """Phase 10: each probe's ``main`` at PROBE_BATCH, its launches counted
    from 0; then each probe kernel timed against its plain version, the
    library call and its bound at the main's shapes. Returns the launches
    and the timings by kernel."""
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.scripts import kernel_anatomy, packed_tap_probe, rowblk_probe

    K.reset_launch_counts()
    anatomy = kernel_anatomy.main([str(PROBE_BATCH["kernel_anatomy"])])
    rowblk_probe.main([str(PROBE_BATCH["rowblk_probe"])])
    packed_tap_probe.main([str(PROBE_BATCH["packed_tap_probe"])])
    launches = K.launches()
    for name in PROBE_KERNELS:
        check(launches[name] > 0, f"probe kernel {name} was not launched by its entry point")
    print(f"probes on {smi}: launches {({k: v for k, v in launches.items() if v})}")
    b = PROBE_BATCH["kernel_anatomy"]
    timing = {}
    for phase in ("full", "no_epi", "matmul_only", "stage_only"):
        name = f"kernel_anatomy[{phase}]"
        timing.update(replay({(name, (b, 128, 128, 128, 1)): 1}, torch.bfloat16,
                             f"probe kernel_anatomy batch {b} reps 1"))
        timing[name]["marginal_ms"] = anatomy["marginal_ms"][phase]
        timing[name]["old_marginal_ms"] = anatomy["engine_marginal_ms"][phase]
    b = PROBE_BATCH["rowblk_probe"]
    timing.update(replay({("conv3x3_rowblk", (b, n, c4, c4, nb)): 1
                          for n, c4, blocks in ((128, 128, (5, 10)), (64, 256, (3, 6)))
                          for nb in blocks}, torch.bfloat16, f"probe rowblk batch {b}"))
    b = PROBE_BATCH["packed_tap_probe"]
    timing.update(replay({(f"deint_{kind}", (b, n, m, c)): 1
                          for kind in ("reshape_idx", "merge")
                          for n, m, c in ((256, 128, 32), (128, 64, 64))}, torch.bfloat16,
                         f"probe deinterleave batch {b}"))
    return launches, timing


def write_test_fold(root: Path, n_subjects: int, size: int, n_slices: int, seed: int) -> Path:
    """A synthetic one-fold test set under ``root``, as the JAX package's
    ``tests/test_eval.py:106-143`` writes it: every modality of
    ``GAN_TEST_MODALITIES`` and ``URESNET_TEST_MODALITIES`` of each subject
    as .nii.gz (the sl_cleaned files listed but missing), the manifests and
    the names. Returns the manifest directory."""
    from depgan_tpu_torch.data import manifest, nifti

    rng = np.random.default_rng(seed)
    mdir = root / "manifests"
    mdir.mkdir()
    modalities = tuple(dict.fromkeys(manifest.GAN_TEST_MODALITIES
                                     + manifest.URESNET_TEST_MODALITIES))
    lists = {m: [] for m in modalities}
    shape = (size, size, n_slices)
    for s in range(n_subjects):
        sd = root / f"subj{s}"
        sd.mkdir()
        vols = {"flair_1tp": rng.uniform(0, 100, shape), "iam_1tp": rng.uniform(0, 1, shape),
                "wmh_prob_v2_1tp": rng.uniform(0, 1, shape),
                "wmh_prob_v2_2tp": rng.uniform(0, 1, shape),
                "icv_1tp": np.ones(shape), "icv_2tp": np.ones(shape),
                "wmh_1tp": rng.uniform(0, 1, shape) > 0.8,
                "wmh_2tp": rng.uniform(0, 1, shape) > 0.8,
                "wmh_subtracted_coded_2tp_1tp": rng.integers(0, 4, shape)}
        for m in modalities:
            path = sd / f"{m}.nii.gz"
            if m in vols:
                nifti.save(vols[m].astype(np.float32), np.eye(4), path)
            lists[m].append(str(path))
    for m, paths in lists.items():
        (mdir / f"{m}_fold1.txt").write_text("\n".join(paths) + "\n")
    (mdir / "name_fold1.txt").write_text(
        "\n".join(f"SUBJ{s:03d}" for s in range(n_subjects)) + "\n")
    return mdir


def row_differences(rows: np.ndarray, ref: np.ndarray, mask_ml: np.ndarray) -> dict[str, float]:
    """The largest per-subject difference of the 8 Dice columns of two
    recaps' rows, and of the predicted volume as a share of the subject's
    mask volume ``mask_ml`` (the ICV and not-lesion mask, where the
    prediction lives)."""
    from depgan_tpu_torch.eval.metrics import CSV_COLUMNS

    dice = [i for i, c in enumerate(CSV_COLUMNS) if "dice" in c]
    vol = CSV_COLUMNS.index("vol_pred_ml")
    return {"dice": float(np.abs(rows[:, dice] - ref[:, dice]).max()),
            "volume": float((np.abs(rows[:, vol] - ref[:, vol]) / mask_ml).max())}


def calibrated_variables(cfg, seed: int, x: torch.Tensor) -> dict:
    """``randomized_variables`` with the 1x1 head rescaled and re-centred so
    that its logits over the slices ``x`` have mean 0 and standard deviation
    0.5 (one noise draw, the plain float32 generator): a DEM spread over
    (-1, 1), or class probabilities away from one-hot, as a trained
    generator's are, instead of saturated random logits whose thresholded
    maps no small error can move."""
    from depgan_tpu_torch.io.flax_bridge import load_flax_variables
    from depgan_tpu_torch.models import GenUNet2D

    variables = randomized_variables(cfg, seed)
    module = load_flax_variables(GenUNet2D(cfg, device=DEVICE), variables).eval()
    logits = []
    hook = module.gen_segmentation.register_forward_hook(lambda m, i, o: logits.append(o))
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        module(x, torch.randn((x.shape[0], cfg.noise_size, 1), generator=g, device=DEVICE))
    hook.remove()
    mean = logits[0].float().mean(dim=(0, 1, 2)).cpu().numpy()
    scale = np.float32(0.5 / float(logits[0].float().std()))
    head = variables["params"]["gen_segmentation"]
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = ((head["bias"] - mean) * scale).astype(np.float32)
    return variables


def check_testing_path(seed: int, smi: str) -> dict[str, int]:
    """Phase 3c: the testing path end to end. A synthetic fold (2 subjects
    of 42 slices at 256x256, written with the port's NIfTI writer) through
    ``run_gan_testing`` and ``run_uresnet_testing`` at full width with
    ``n_repeat`` 10: once with ``fast`` (bf16, K1-K4, exactly 8/2/2/1
    launches a forward), once plain in float32. The fast run's written maps
    equal ``EnsemblePredictor.predict`` with the runner's seed bit for bit;
    fast and plain maps agree within 0.05; both recaps hold 2 rows of 18
    columns, whose Dice and volume differences are held to TESTING_LIMITS,
    which the float32 control passes and a run with another checkpoint's
    weights must fail. Prints ms per subject host to host, and the data
    load, ensemble and metrics + writers parts. Returns the fast runs'
    launches."""
    import tempfile

    from depgan_tpu_torch.config import DataConfig, EvalConfig, ModelConfig
    from depgan_tpu_torch.data import dataset, native, nifti
    from depgan_tpu_torch.eval import runner
    from depgan_tpu_torch.eval.metrics import CSV_COLUMNS, csv_row, volume_ml
    from depgan_tpu_torch.eval.predict import EnsemblePredictor, reconstruct_follow_up
    from depgan_tpu_torch.eval.writers import write_gan_outputs, write_uresnet_outputs
    from depgan_tpu_torch.ops import conv_s2d as K

    fold, total = 1, dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="depgan_fold_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        mdir = write_test_fold(root, TESTING_SUBJECTS, IMAGE, TESTING_SLICES, seed)
        print(f"testing: wrote {TESTING_SUBJECTS} subjects x 11 modalities of "
              f"{IMAGE}x{IMAGE}x{TESTING_SLICES} .nii.gz in {time.perf_counter() - t0:.2f} s; "
              f"NIfTI reader: {'native C++' if native.available() else 'numpy'}")
        data_cfg = DataConfig(manifest_dir=str(mdir), image_size=IMAGE)
        kinds = {
            "gan": (ModelConfig(image_size=IMAGE, first_fm=32), runner.run_gan_testing,
                    dataset.iter_gan_test_subjects, "RECAP_evaluation_for_allData.csv"),
            "uresnet": (ModelConfig(image_size=IMAGE, first_fm=32, n_out=4,
                                    dropout_mode="uresnet"), runner.run_uresnet_testing,
                        dataset.iter_uresnet_test_subjects, "vol_dsc_all.csv")}
        for i, (kind, (cfg, run, subjects_of, csv)) in enumerate(kinds.items()):
            first = next(iter(subjects_of(data_cfg, fold)))
            x = torch.as_tensor(first.gen_input if kind == "gan" else first.flair, device=DEVICE)
            variables = calibrated_variables(cfg, seed + i, x)
            wrong = calibrated_variables(cfg, seed + i + 100, x)
            eval_cfg = EvalConfig(n_repeat=N_REPEAT, seed=seed)
            rows, ms = {}, {}
            for tag, fast, weights in (("fast", True, variables), ("plain", False, variables)):
                out = root / f"{kind}_{tag}"
                K.reset_launch_counts()
                t0 = time.perf_counter()
                results = run(cfg, data_cfg, dataclasses.replace(eval_cfg, fast=fast),
                              lambda f, w=weights: w, folds=(fold,), out_dir=out, device=DEVICE)
                ms[tag] = (time.perf_counter() - t0) * 1e3 / TESTING_SUBJECTS
                launches = K.launches()
                check(len(results) == TESTING_SUBJECTS, f"{kind} {tag}: {len(results)} subjects")
                rows[tag] = np.loadtxt(out / csv, delimiter=",", skiprows=1, ndmin=2)
                check(rows[tag].shape == (TESTING_SUBJECTS, len(CSV_COLUMNS)) and
                      bool(np.isfinite(rows[tag]).all()),
                      f"{kind} {tag}: recap {rows[tag].shape}")
                forwards = TESTING_SUBJECTS * N_REPEAT if fast else 0
                want = {k: LAUNCHES_PER_FORWARD.get(k, 0) * forwards for k in KERNELS}
                check(launches == want, f"{kind} {tag}: launches {launches}, expected {want}")
                for k, v in launches.items():
                    total[k] += v

            # The written maps against the predictor, and fast against plain.
            t0 = time.perf_counter()
            subjects = list(subjects_of(data_cfg, fold))
            load_ms = (time.perf_counter() - t0) * 1e3 / TESTING_SUBJECTS
            predictor = EnsemblePredictor(cfg, variables, N_REPEAT, seed=seed + fold, fast=True,
                                          device=DEVICE)
            preds, ensemble_ms, rest_ms = [], 0.0, 0.0
            for subject in subjects:
                x = subject.gen_input if kind == "gan" else subject.flair
                t0 = time.perf_counter()
                pred = predictor.predict(x, subject.icv_sl_mask_2tp)
                ensemble_ms += (time.perf_counter() - t0) * 1e3 / TESTING_SUBJECTS
                t0 = time.perf_counter()
                scratch = root / f"{kind}_timing"
                if kind == "gan":
                    dem = np.squeeze(pred, axis=-1)
                    vol, dices, y2, code = runner.evaluate_gan_subject(
                        subject, dem, eval_cfg.wmh_threshold)
                    write_gan_outputs(scratch, subject.name, subject.affine, subject.pixdim, y2,
                                      dem, code)
                else:
                    vol, dices, labels = runner.evaluate_uresnet_subject(subject, pred)
                    write_uresnet_outputs(scratch, subject.name, subject.affine, subject.pixdim,
                                          labels, pred)
                csv_row(vol, dices)
                rest_ms += (time.perf_counter() - t0) * 1e3 / TESTING_SUBJECTS
                preds.append(pred)
            mask_ml = np.array([volume_ml(subj.icv_sl_mask_2tp, subj.pixdim) for subj in subjects])
            worst, near = 0.0, []
            for subject, pred in zip(subjects, preds):
                inside = subject.icv_sl_mask_2tp > 0
                if kind == "gan":  # masked-in y2_fake within 0.01 of the threshold
                    y2 = reconstruct_follow_up(subject.prob_1tp, pred[..., 0])
                    near.append(float((np.abs(y2 - eval_cfg.wmh_threshold) < 0.01)[inside].mean()))
                else:  # masked-in voxels whose top two classes lie within 0.01
                    top2 = np.sort(pred, axis=-1)[..., -2:]
                    near.append(float((top2[..., 1] - top2[..., 0] < 0.01)[inside].mean()))
                # The GAN's DEM map, the UResNet's class-probability maps.
                maps = ({"network_output": pred[..., 0]} if kind == "gan" else
                        {f"prb_map_c{c}": pred[..., c] for c in range(pred.shape[-1])})
                for what, slices in maps.items():
                    written = {tag: nifti.load(root / f"{kind}_{tag}" / (
                        "" if kind == "gan" else subject.name) / f"{subject.name}_{what}.nii.gz"
                    ).image for tag in ("fast", "plain")}
                    check(np.array_equal(written["fast"], nifti.slices_to_volume(slices).astype(
                        np.float32)), f"{kind} {subject.name} {what}: the written fast map is "
                                      f"not the predictor's bit for bit")
                    diff = float(np.abs(written["fast"] - written["plain"]).max())
                    check(diff < 0.05, f"{kind} {subject.name} {what}: fast vs plain {diff:.4f}")
                    worst = max(worst, diff)

            # The rows, with the float32 control and the wrong run beside.
            readings = {"fast bf16": row_differences(rows["fast"], rows["plain"], mask_ml)}
            for tag, weights, dtype in (("control float32", variables, torch.float32),
                                        ("control wrong weights", wrong, torch.bfloat16)):
                pred = EnsemblePredictor(cfg, weights, N_REPEAT, seed=seed + fold, fast=True,
                                         device=DEVICE, compute_dtype=dtype)
                ctl = []
                for subject in subjects:
                    if kind == "gan":
                        dem = np.squeeze(pred.predict(subject.gen_input, subject.icv_sl_mask_2tp),
                                         axis=-1)
                        vol, dices, _, _ = runner.evaluate_gan_subject(
                            subject, dem, eval_cfg.wmh_threshold)
                    else:
                        vol, dices, _ = runner.evaluate_uresnet_subject(
                            subject, pred.predict(subject.flair, subject.icv_sl_mask_2tp))
                    ctl.append(csv_row(vol, dices))
                readings[tag] = row_differences(np.array(ctl), rows["plain"], mask_ml)
            for tag, r in readings.items():
                passes = all(r[k] <= TESTING_LIMITS[k] for k in TESTING_LIMITS)
                print(f"testing {kind} {tag} against plain float32: max |d dice| "
                      f"{r['dice']:.4e}, max |d vol_pred| / mask volume {r['volume']:.4e}"
                      f" ({'within' if passes else 'outside'} {TESTING_LIMITS})")
                check(passes != tag.startswith("control wrong"),
                      f"testing {kind} {tag}: {r} against the limits {TESTING_LIMITS}")
            print(f"testing {kind} on {smi}: {TESTING_SUBJECTS} subjects of {TESTING_SLICES} "
                  f"slices, n_repeat {N_REPEAT}: fast {ms['fast']:.1f} ms a subject host to "
                  f"host (plain float32 {ms['plain']:.1f}); parts, run one after another: data "
                  f"load {load_ms:.1f}, ensemble {ensemble_ms:.1f}, metrics + writers "
                  f"{rest_ms:.1f} ms a subject; fast vs plain maps max abs {worst:.4e}; "
                  f"masked-in voxels within 0.01 of a decision {near}; "
                  f"vol_pred_ml fast {rows['fast'][:, CSV_COLUMNS.index('vol_pred_ml')]}, "
                  f"plain {rows['plain'][:, CSV_COLUMNS.index('vol_pred_ml')]}")
    return total


def check_widths(seed: int) -> dict[str, int]:
    """Phase 3d: the bf16 ``FastGenerator`` at each first_fm of WIDTH_CASES
    (image 256, one 42-slice batch) against the plain float32 generator
    (max abs < 0.05), each site's route printed (wgmma, engine, pool, or
    plain: the width gate's plain version); no site takes the plain path
    where a kernel takes its widths (``fast_gen.gate_message``), and the
    launches are those of the routes. Returns them."""
    import warnings

    from depgan_tpu_torch.config import ModelConfig
    from depgan_tpu_torch.io.flax_bridge import load_flax_variables
    from depgan_tpu_torch.models import GenUNet2D
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.ops.fast_gen import FastGenerator, gate_message, taken_launches

    total = dict.fromkeys(KERNELS, 0)
    for first_fm in WIDTH_CASES:
        cfg = ModelConfig(image_size=IMAGE, first_fm=first_fm)
        variables = randomized_variables(cfg, seed + first_fm)
        rng = np.random.default_rng(seed + first_fm)
        x = torch.tensor(rng.uniform(size=(BATCH_SERVE, IMAGE, IMAGE, 1)), dtype=torch.float32,
                         device=DEVICE)
        z = torch.tensor(rng.normal(size=(BATCH_SERVE, cfg.noise_size, 1)), dtype=torch.float32,
                         device=DEVICE)
        with torch.no_grad():
            ref = load_flax_variables(GenUNet2D(cfg, device=DEVICE), variables).eval()(x, z)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fast = FastGenerator(cfg, variables, torch.bfloat16, DEVICE)
        K.reset_launch_counts()
        out = fast(x, z)
        torch.cuda.synchronize()
        launches = K.launches()
        got = {k: v for k, v in launches.items() if v}
        check(got == taken_launches(cfg, fast.taken),
              f"first_fm {first_fm}: launches {got}, the routes give "
              f"{taken_launches(cfg, fast.taken)}")
        plain = sorted(k for k, r in fast.taken.items() if r == "plain")
        gated = gate_message(cfg, fast.routes)
        check(not plain or (gated is not None and all(k in gated for k in plain)),
              f"first_fm {first_fm}: {plain} ran plain, but a kernel takes their widths")
        check(bool(caught) == (gated is not None), f"first_fm {first_fm}: warnings {caught}")
        diff = float((out - ref).abs().max())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()) and diff < 0.05,
              f"first_fm {first_fm}: max abs {diff:.4f} from the plain float32 generator")
        print(f"widths first_fm {first_fm}: max abs {diff:.4e} from the plain float32 "
              f"generator, launches {got}, routes "
              + ", ".join(f"{k} {r}" for k, r in fast.taken.items())
              + (f"; the gate warned: {gated}" if gated else "; the gate: every site a kernel"))
        for k, v in launches.items():
            total[k] += v
    return total


def write_training_fold(root: Path, n_subjects: int, size: int, n_slices: int, seed: int) -> Path:
    """A synthetic one-fold training set under ``root``, as the JAX
    package's ``tests/test_drivers.py:16-44`` writes it: every modality of
    ``GAN_TRAIN_MODALITIES`` and ``URESNET_TRAIN_MODALITIES`` of each
    subject as .nii.gz (the sl_cleaned files listed but missing) and the
    manifests. Returns the manifest directory."""
    from depgan_tpu_torch.data import manifest, nifti

    rng = np.random.default_rng(seed)
    mdir = root / "manifests"
    mdir.mkdir()
    modalities = tuple(dict.fromkeys(manifest.GAN_TRAIN_MODALITIES
                                     + manifest.URESNET_TRAIN_MODALITIES))
    lists = {m: [] for m in modalities}
    shape = (size, size, n_slices)
    for s in range(n_subjects):
        sd = root / f"subj{s}"
        sd.mkdir()
        vols = {"flair_1tp": rng.uniform(0, 100, shape), "wmh_prob_1tp": rng.uniform(0, 1, shape),
                "wmh_prob_2tp": rng.uniform(0, 1, shape), "icv_1tp": np.ones(shape),
                "icv_2tp": np.ones(shape),
                "wmh_subtracted_coded_2tp_1tp": rng.integers(0, 4, shape)}
        for m in modalities:
            path = sd / f"{m}.nii.gz"
            if m in vols:
                nifti.save(vols[m].astype(np.float32), np.eye(4), path)
            lists[m].append(str(path))
    for m, paths in lists.items():
        (mdir / f"{m}_fold1.txt").write_text("\n".join(paths) + "\n")
    return mdir


def nonzero(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if v}


def fit_schedule(n_batches: int, cfg) -> list[tuple[int, int]]:
    """(D, n_valid) of each superstep of ``fit_fold`` from generator
    iteration 0: the warm-up schedule (reference :792-797) over
    ``n_epochs`` epochs of ``n_batches`` batches, epoch tails short."""
    out, gi = [], 0
    for _ in range(cfg.n_epochs):
        i = 0
        while i < n_batches:
            warm = gi < cfg.warmup_until or gi % cfg.warmup_every == 0
            d = cfg.warmup_d_iters if warm else cfg.d_iters
            out.append((d, min(d, n_batches - i)))
            i += out[-1][1]
            gi += 1
    return out


def fit_launches(schedule: list[tuple[int, int]], k: int, validations: int) -> dict[str, int]:
    """Kernel launches of a fit: each superstep's, and 7 K8 a validation
    forward (the plain generator's FiLM sites; the plain critic runs none)."""
    total = dict.fromkeys(KERNELS, 0)
    for d, n_valid in schedule:
        for name, count in expected_superstep_launches(d, k, n_valid=n_valid).items():
            total[name] += count
    total["film_residual"] += 7 * validations
    return total


class FitProbe:
    """Records a training run from outside the port, for phase 11: each
    superstep's D, n_valid and ms host to host (the card synchronized at
    both ends), each validation's, flush's and checkpoint save's ms (and
    the MB a save wrote), the (tag, step) of everything given to
    ``Logger``, and, for superstep ``keep`` of the run, its inputs, its
    metrics and the state it left. Patches the classes while active."""

    def __init__(self, keep: int | None = None):
        self.keep = keep
        self.supersteps, self.validations, self.flushes, self.saves = [], [], [], []
        self.logged, self.kept = [], {}

    def __enter__(self):
        from depgan_tpu_torch.io import checkpoint
        from depgan_tpu_torch.io.flax_bridge import gan_trees_from_state
        from depgan_tpu_torch.train import gan_trainer
        from depgan_tpu_torch.utils import logging

        probe = self
        self.patched = {(cls, name): getattr(cls, name) for cls, name in (
            (gan_trainer.GanTrainer, "superstep"), (gan_trainer.GanTrainer, "val_step"),
            (gan_trainer.MetricBuffer, "flush"), (checkpoint.CheckpointManager, "save"),
            (logging.Logger, "log_scalar"), (logging.Logger, "log_images"))}
        orig = {name: fn for (_, name), fn in self.patched.items()}

        def timed(fn, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def superstep(trainer, state, x_all, y_all, idx_block, n_valid, generator=None,
                      draws=None):
            i = len(probe.supersteps)
            if i == probe.keep:
                probe.kept = {"x_all": x_all, "y_all": y_all, "idx": np.array(idx_block),
                              "n_valid": n_valid,
                              "draws": {k: v.clone() for k, v in draws.items()}}
            out, ms = timed(orig["superstep"], trainer, state, x_all, y_all, idx_block, n_valid,
                            generator, draws)
            probe.supersteps.append((idx_block.shape[0], n_valid, ms))
            if i == probe.keep:
                probe.kept["after"] = gan_trees_from_state(out[0])
                probe.kept["metrics"] = out[1]
            return out

        def val_step(trainer, *args):
            out, ms = timed(orig["val_step"], trainer, *args)
            probe.validations.append(ms)
            return out

        def flush(buffer):
            if not buffer.pending:
                return orig["flush"](buffer)
            out, ms = timed(orig["flush"], buffer)
            probe.flushes.append(ms)
            return out

        def save(manager, step, state, counters=None, extra=None):
            _, ms = timed(orig["save"], manager, step, state, counters, extra)
            mb = sum(f.stat().st_size for f in (manager.directory / str(step)).iterdir()) / 1e6
            probe.saves.append((step, ms, mb))

        def log_scalar(logger, tag, value, step):
            probe.logged.append((tag, step))
            orig["log_scalar"](logger, tag, value, step)

        def log_images(logger, tag, images, step, denorm=(0, 255)):
            probe.logged.extend((f"{tag}/{i}", step) for i in range(len(images)))
            orig["log_images"](logger, tag, images, step, denorm)

        for (cls, name), fn in ((k, v) for k, v in zip(self.patched, (
                superstep, val_step, flush, save, log_scalar, log_images))):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in self.patched.items():
            setattr(cls, name, fn)
        return False

    def last_step(self) -> int | None:
        return self.saves[-1][0] if self.saves else None

    def summary(self) -> str:
        warm = [ms for d, _, ms in self.supersteps if d != FIT_CFG["d_iters"]]
        steady = [ms for d, nv, ms in self.supersteps if d == FIT_CFG["d_iters"] == nv]
        tails = [ms for d, nv, ms in self.supersteps if nv < d]
        return (f"ms per superstep host to host: warm-up (D {FIT_CFG['warmup_d_iters']}) "
                f"{', '.join(f'{v:.1f}' for v in warm)}; steady (D {FIT_CFG['d_iters']}) "
                f"{', '.join(f'{v:.1f}' for v in steady)} (least {min(steady):.1f}, median "
                f"{float(np.median(steady)):.1f}); epoch tails "
                f"{', '.join(f'{v:.1f}' for v in tails)}; ms per validation "
                f"{', '.join(f'{v:.1f}' for v in self.validations)}; per flush "
                f"{', '.join(f'{v:.1f}' for v in self.flushes)}; per checkpoint save "
                + ", ".join(f"{v:.1f} ({mb:.1f} MB)" for _, v, mb in self.saves))


def resume_readings(start: dict, got: dict, want: dict, got_m: dict, want_m: dict) -> dict:
    """Phase 6's readings of the resumed superstep against the
    uninterrupted one: each logged loss relative to its size (errG_CY2 and
    errG_DEM to the critic scores'), each network's updates in relative
    L2, its largest parameter difference in units of lr, and Adam's first
    moment (the last gradient, b1 = 0) in relative L2."""
    from depgan_tpu_torch.config import GanTrainConfig
    from depgan_tpu_torch.io.flax_bridge import flatten_tree
    from depgan_tpu_torch.train.gan_trainer import CRIT_KEYS, GEN_KEYS

    def cat(tree):
        return np.concatenate([np.ravel(v) for v in flatten_tree(tree).values()]).astype(np.float64)

    score = max(float(want_m[k].abs().nan_to_num().max()) for k in CRIT_KEYS)
    scores = ("errG_CY2", "errG_DEM")
    loss = {k: abs(float(got_m["gen"][k]) - float(want_m["gen"][k]))
            / max(abs(float(want_m["gen"][k])), score if k in scores else 1e-30) for k in GEN_KEYS}
    r = {"losses": max(v for k, v in loss.items() if k not in scores),
         "updated scores": max(loss[k] for k in scores), "updates": 0.0, "gradient": 0.0,
         "max abs / lr": 0.0}
    lr = {"g": GanTrainConfig().lr_g, "dy2": GanTrainConfig().lr_d, "ddem": GanTrainConfig().lr_d}
    for part in ("g", "dy2", "ddem"):
        a, b, s0 = (cat(t[f"{part}_params"]) for t in (got, want, start))
        r["updates"] = max(r["updates"], float(np.linalg.norm(a - b) / np.linalg.norm(b - s0)))
        r["max abs / lr"] = max(r["max abs / lr"], float(np.abs(a - b).max()) / lr[part])
        ma, mb = cat(got[f"{part}_opt"]["mu"]), cat(want[f"{part}_opt"]["mu"])
        r["gradient"] = max(r["gradient"], float(np.linalg.norm(ma - mb) / np.linalg.norm(mb)))
    return r


def check_resume(trainer, manager, kept: dict, seed: int, dtype: str, smi: str) -> None:
    """Phase 11's resume: checkpoint RESUME_STEP restored into a fresh
    state and the next superstep rerun with the uninterrupted run's inputs
    and draws (``FitProbe``'s ``kept``); the largest difference from the
    uninterrupted run's state, which must be 0 (the path proved
    deterministic) or else within SUPERSTEP_LIMITS. Then that superstep
    from the checkpoint with cuDNN's default algorithm choice (torch's
    defaults: not deterministic, not autotuned) beside the deterministic
    ones the superstep runs, in turns (deterministic, default, default,
    deterministic): how far the two default runs differ, the ms of each,
    and a profile of one deterministic superstep."""
    from depgan_tpu_torch.io.flax_bridge import flatten_tree, gan_trees_from_state

    def restored():
        return manager.restore(trainer.init_state(seed + 1), step=RESUME_STEP)

    state, counters, _ = restored()
    check(counters.gen_iterations == RESUME_STEP, f"restored counters {counters}")
    start = gan_trees_from_state(state)
    args = (kept["x_all"], kept["y_all"], kept["idx"], kept["n_valid"])
    state, metrics = trainer.superstep(state, *args, draws=kept["draws"])
    got, want = gan_trees_from_state(state), kept["after"]
    flat_got, flat_want = flatten_tree(got), flatten_tree(want)
    diff = max(float(np.abs(np.asarray(flat_got[k], np.float64)
                            - np.asarray(flat_want[k], np.float64)).max()) for k in flat_want)
    what = (f"training resume {dtype}: step {RESUME_STEP} restored into a fresh state, the next "
            f"superstep rerun with the same draws: largest difference {diff:.3e} from the "
            f"uninterrupted run's state (parameters, statistics, Adam's counts and moments)")
    if diff == 0:
        print(f"{what}: bit-identical, the path proved deterministic")
    else:
        r = resume_readings(start, got, want, metrics, kept["metrics"])
        print(f"{what}; not bit-identical, so held to SUPERSTEP_LIMITS: " + ", ".join(
            f"{k} {v:.3e} (limit {SUPERSTEP_LIMITS[k]:g})" for k, v in r.items()))
        for k, v in r.items():
            check(v <= SUPERSTEP_LIMITS[k], f"resume {k} {v:.3e} beyond {SUPERSTEP_LIMITS[k]:g}")

    cudnn = torch.backends.cudnn
    reruns, ms = [], {"deterministic": [], "default": []}
    for mode in ("deterministic", "default", "default", "deterministic"):
        state = restored()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "deterministic":
            trainer.superstep(state, *args, draws=kept["draws"])
        else:
            with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                             allow_tf32=cudnn.allow_tf32):
                trainer._superstep(state, *args, None, kept["draws"])
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3)
        if mode == "default":
            reruns.append(flatten_tree(gan_trees_from_state(state)))
    lr = trainer.cfg.lr_d
    spread = {part: max(float(np.abs(np.asarray(reruns[0][k], np.float64)
                                     - np.asarray(reruns[1][k], np.float64)).max())
                        for k in reruns[0] if k.startswith(part + "."))
              for part in ("g_params", "dy2_params", "ddem_params")}
    print(f"training resume {dtype} on {smi}: with cuDNN's default algorithm choice two runs of "
          f"that superstep from the checkpoint differ by, in parameters: "
          + ", ".join(f"{k} {v:.3e} ({v / lr:.2f} lr)" for k, v in spread.items())
          + f"; ms deterministic {', '.join(f'{v:.1f}' for v in ms['deterministic'])}, default "
            f"{', '.join(f'{v:.1f}' for v in ms['default'])} (in turns)")
    state = restored()[0]
    profile_once(lambda: trainer.superstep(state, *args, draws=kept["draws"]),
                 f"one {dtype} superstep of the fit (D {kept['idx'].shape[0]})",
                 min(ms["deterministic"]))


def check_training_path(seed: int, smi: str) -> dict[str, dict[str, int]]:
    """Phase 11: the training path end to end, as ``train-gan --use-pallas``
    and ``train-uresnet --use-pallas`` run it (``drivers.run_*_training``),
    at full width over a synthetic training fold written as .nii.gz, with
    FIT_CFG's cut schedule. Checks, for the float32 GAN fit: each
    superstep's D and n_valid against the schedule; the exact kernel
    launches (``fit_launches``); every logged value finite and the event
    file, parsed back record by record with its CRCs, holding each (tag,
    step) given to the logger; the checkpoints and final counters; resume
    (the second checkpoint restored into a fresh state, the next superstep
    rerun with the uninterrupted run's draws: bit-identical, or within
    SUPERSTEP_LIMITS); and train -> test (the checkpoint directory served
    through ``generator_loader`` and ``EnsemblePredictor(fast=True)``,
    within 0.05 of the plain float32 generator, 8/2/2/1 launches a
    forward). Then the same fit in bf16 (times and launches), the UResNet
    fit (loss histories, a checkpoint an epoch, 7 K8 a step and a
    validation chunk), and the two inference benchmarks. The card's
    machine has no h5py: the drivers' .h5 export is replaced by a recorder
    of the files it would have written. Returns the launches of each run."""
    import tempfile

    from depgan_tpu_torch import benchmarks, drivers
    from depgan_tpu_torch.config import (DataConfig, GanTrainConfig, ModelConfig,
                                         UResNetTrainConfig)
    from depgan_tpu_torch.eval.predict import EnsemblePredictor
    from depgan_tpu_torch.io.checkpoint import CheckpointManager
    from depgan_tpu_torch.io.flax_bridge import flatten_tree, numpy_tree
    from depgan_tpu_torch.ops import conv_s2d as K
    from depgan_tpu_torch.train.gan_trainer import GanTrainer
    from depgan_tpu_torch.utils import tb_writer

    train_cfg = GanTrainConfig(**FIT_CFG)
    print("training: the cuts of train-gan's schedule: " + ", ".join(
        f"{k} {FIT_CFG[k]} (default {v})" for k, v in FIT_DEFAULTS.items())
          + f"; train-uresnet n_epochs {URESNET_EPOCHS} (default 200); a fold of "
            f"{TRAIN_SUBJECTS * TRAIN_SLICES} slices (a real fold holds ~4,800)")
    print("training: the card's machine has no h5py, so for this phase only the drivers' .h5 "
          "export is replaced by a recorder of the (file, gen_iteration or epoch) pairs it "
          "would have written; the CPU tests cover the real export")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="depgan_train_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        mdir = write_training_fold(root, TRAIN_SUBJECTS, IMAGE, TRAIN_SLICES, seed)
        print(f"training: wrote {TRAIN_SUBJECTS} subjects x 6 modalities of "
              f"{IMAGE}x{IMAGE}x{TRAIN_SLICES} .nii.gz in {time.perf_counter() - t0:.2f} s")
        data_cfg = DataConfig(manifest_dir=str(mdir), image_size=IMAGE)
        n_all = TRAIN_SUBJECTS * TRAIN_SLICES
        n_val = math.ceil(data_cfg.val_fraction * n_all)  # train_val_split's
        n_batches = (n_all - n_val) // train_cfg.batch_size
        schedule = fit_schedule(n_batches, train_cfg)
        validations = sum(gi % train_cfg.validate_every == 0 for gi in range(len(schedule)))
        want_launches = fit_launches(schedule, train_cfg.k_noise, validations)
        steps = [gi + 1 for gi in range(len(schedule))
                 if (gi + 1) % train_cfg.checkpoint_every == 0]

        for dtype in ("float32", "bfloat16"):
            run = f"smoke_{dtype}"
            cfg = ModelConfig(image_size=IMAGE, first_fm=32, use_pallas=True,
                              compute_dtype=dtype)
            models, logs = root / "models", root / "logdir"
            written = []
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with FitProbe(keep=RESUME_STEP) as probe:
                states = drivers.run_gan_training(
                    cfg, train_cfg, data_cfg, run_name=run, folds=(1,), log_dir=str(logs),
                    model_dir=str(models), device=DEVICE,
                    export_h5=lambda s, p: written.append((p.name, probe.last_step())))
            run_ms = (time.perf_counter() - t0) * 1e3
            launches = K.launches()
            runs[f"training_fit_{dtype}"] = launches
            got_schedule = [(d, nv) for d, nv, _ in probe.supersteps]
            check(got_schedule == schedule, f"{dtype} fit: supersteps {got_schedule}, "
                                            f"the schedule {schedule}")
            check(launches == want_launches, f"{dtype} fit: launches {launches}, expected "
                                             f"{want_launches}")
            print(f"training {dtype} on {smi}: {len(schedule)} supersteps (D, n_valid) "
                  f"{schedule}, {validations} validations, {len(probe.flushes)} flushes, "
                  f"launches {launches}; the run {run_ms:.0f} ms host to host (data load "
                  f"included); {probe.summary()}")
            manager = CheckpointManager(models / f"{run}_fold1")
            check_resume(GanTrainer(cfg, train_cfg, data_cfg, DEVICE), manager, probe.kept,
                         seed, dtype, smi)
            if dtype != "float32":
                continue

            # The logged values, the event file and the checkpoints.
            (events_file,) = (logs / f"{run}_fold1").glob("events.*")
            events = tb_writer.read_events(events_file)  # every record's CRCs checked
            values = [(v[0], e["step"]) for e in events for v in e["values"]]
            check(values == probe.logged, f"the event file holds {len(values)} values, the "
                                          f"logger was given {len(probe.logged)}")
            scalars = [v[2] for e in events for v in e["values"] if v[1] == "scalar"]
            check(bool(np.isfinite(scalars).all()), "a logged value is not finite")
            check(sum(e["graph"] is not None for e in events) == 1, "no graph record")
            check(manager.all_steps() == steps[-manager.max_to_keep:],
                  f"checkpoint steps {manager.all_steps()}, expected {steps}")
            check([s for s, _, _ in probe.saves] == steps + [len(schedule)],
                  f"saves {[s for s, _, _ in probe.saves]}")
            check(written == [(f"netG_{run}_fold1.h5", s) for s in steps + [len(schedule)]],
                  f"the .h5 export wrote {written}")
            _, counters, _ = manager.restore(states[1])
            consumed = sum(nv for _, nv in schedule)
            check(dataclasses.astuple(counters) == (len(schedule), consumed, consumed),
                  f"final counters {counters}, expected {len(schedule)} generator and "
                  f"{consumed} critic iterations")
            print(f"training: the event file parsed back, {len(events)} records with their "
                  f"CRCs, {len(values)} values ({len(scalars)} scalars, all finite) as "
                  f"logged; checkpoints {manager.all_steps()} kept of {steps} and the "
                  f"final one; .h5 recorded {written}; final counters {counters}")

            # Train -> test: the checkpoint directory served.
            serve_cfg = ModelConfig(image_size=IMAGE, first_fm=32)
            variables = drivers.generator_loader(serve_cfg, str(models / f"{run}_fold{{fold}}"))(1)
            final = {"params": numpy_tree(states[1].g_params),
                     "batch_stats": numpy_tree(states[1].g_stats)}
            check(all(np.array_equal(flatten_tree(variables)[k], v)
                      for k, v in flatten_tree(final).items()),
                  "the checkpoint directory does not serve the trained generator")
            rng = np.random.default_rng(seed)
            x = rng.uniform(size=(BATCH_SERVE, IMAGE, IMAGE, 1)).astype(np.float32)
            mask = np.ones(x.shape[:3], np.float32)
            fast = EnsemblePredictor(serve_cfg, variables, N_REPEAT, seed=seed, fast=True,
                                     device=DEVICE)
            K.reset_launch_counts()
            out = fast.predict(x, mask)
            launches = K.launches()
            runs["train_to_test"] = launches
            ref = plain_predictor(serve_cfg, variables, seed).predict(x, mask)
            want = {k: LAUNCHES_PER_FORWARD.get(k, 0) * N_REPEAT for k in KERNELS}
            check(launches == want, f"train -> test launches {launches}, expected {want}")
            diff = float(np.abs(out - ref).max())
            check(out.shape == ref.shape and bool(np.isfinite(out).all()) and diff < 0.05,
                  f"train -> test: fast vs plain float32 max abs {diff:.4f}")
            print(f"training -> testing: the checkpoint directory through generator_loader, "
                  f"one {BATCH_SERVE}-slice batch x {N_REPEAT} repeats: fast vs plain float32 "
                  f"max abs {diff:.4e}, DEM mean {float(out.mean()):.4f} std "
                  f"{float(out.std()):.4f}, launches {nonzero(launches)}")

        # The UResNet fit.
        ucfg = ModelConfig(image_size=IMAGE, first_fm=32, n_out=4, dropout_mode="uresnet",
                           use_pallas=True)
        utrain = UResNetTrainConfig(batch_size=train_cfg.batch_size, n_epochs=URESNET_EPOCHS)
        written = []
        K.reset_launch_counts()
        t0 = time.perf_counter()
        drivers.run_uresnet_training(ucfg, utrain, data_cfg, run_name="smoke_uresnet",
                                     folds=(1,), log_dir=str(root / "logs"),
                                     model_dir=str(root / "models"), device=DEVICE,
                                     export_h5=lambda s, p: written.append((p.name, s.epoch)))
        run_ms = (time.perf_counter() - t0) * 1e3
        launches = K.launches()
        runs["uresnet_training"] = launches
        chunks = -(-n_val // utrain.batch_size)
        want = {k: 7 * URESNET_EPOCHS * (n_batches + chunks) if k == "film_residual" else 0
                for k in KERNELS}
        check(launches == want, f"uresnet fit launches {launches}, expected {want}")
        for name in ("loss", "val_loss"):
            lines = (root / "logs" / f"{name}_smoke_uresnet_fold1.txt").read_text().split()
            check(len(lines) == URESNET_EPOCHS and np.isfinite(np.array(lines, float)).all(),
                  f"{name} history {lines}")
        steps = CheckpointManager(root / "models" / "smoke_uresnet_fold1").all_steps()
        check(steps == list(range(URESNET_EPOCHS)), f"uresnet checkpoints {steps}")
        check(written == [("trained_smoke_uresnet_fold1.h5", e + 1)
                          for e in range(URESNET_EPOCHS)], f"uresnet .h5 {written}")
        print(f"training uresnet on {smi}: {URESNET_EPOCHS} epochs of {n_batches} steps and "
              f"{chunks} validation chunk, {run_ms:.0f} ms host to host (data load included), "
              f"histories {(root / 'logs' / 'loss_smoke_uresnet_fold1.txt').read_text().split()}"
              f", checkpoints {steps}, .h5 recorded {written}, launches {nonzero(launches)}")

    # The inference benchmarks, JAX's workloads.
    total = dict.fromkeys(KERNELS, 0)
    for bench in (benchmarks.gen_inference_bench, benchmarks.uresnet_inference_bench):
        result = bench()
        want = {k: LAUNCHES_PER_FORWARD.get(k, 0) * result["n_scan"] for k in KERNELS}
        check(result["launches"] == want, f"{result['metric']} launches {result['launches']}, "
                                          f"expected {want}")
        print(f"bench on {smi}: {json.dumps({**result, 'launches': nonzero(result['launches'])})}")
        for k, v in result["launches"].items():
            total[k] += v
    runs["inference_bench"] = total
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from depgan_tpu_torch import benchmarks
    from depgan_tpu_torch.config import ModelConfig
    from depgan_tpu_torch.ops import _cuda
    from depgan_tpu_torch.ops import conv_s2d as K

    start_of = [time.perf_counter()]

    def phase_done(what: str) -> None:
        now = time.perf_counter()
        print(f"phase {what} ({now - start_of[0]:.1f} s)")
        start_of[0] = now

    # Phase 1: environment and build.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, kernels built and loaded in {build_s:.1f} s "
          f"({_cuda.library_path().name})")
    check_engine_build(_cuda)
    phase_done("build: passed")

    # Phase 2: each kernel against its plain version.
    worst = check_kernels()
    n_checks = sum(len(CASE_DTYPES.get(name, (0, 0))) * len(CASE_BATCHES.get(name, (0,)))
                   for name, _, _ in KERNEL_CASES)
    phase_done(f"kernels: {n_checks} checks passed; chains against the sequential kernels: "
               + ", ".join(f"{k} max abs {v:.3e}" for k, v in SEQUENTIAL_DIFF.items())
               + "; against K7, K1 or the engine: "
               + ", ".join(f"{k} max abs {v:.3e}" for k, v in KERNEL_DIFF.items()))

    # Phase 3: the serving path, counting kernel launches.
    gan = ModelConfig(image_size=256, first_fm=32, n_input_channels=1)
    uresnet = ModelConfig(image_size=256, first_fm=32, n_out=4, dropout_mode="uresnet")
    K.reset_launch_counts()
    gan_diff, fast, subjects = serve(gan, seed=0, n_subjects=N_SUBJECTS)
    uresnet_diff, _, _ = serve(uresnet, seed=1, n_subjects=1)
    serving = K.launches()
    forwards = (N_SUBJECTS + 1) * N_REPEAT
    for name in KERNELS:
        want = LAUNCHES_PER_FORWARD.get(name, 0) * forwards
        check(serving[name] == want, f"{name} launched {serving[name]} times in {forwards} "
                                     f"serving forwards, expected {want}")
    print(f"phase serving: {forwards} forwards, max abs diff tanh {gan_diff:.4e}, "
          f"softmax {uresnet_diff:.4e}, launches {serving}")
    options, option_ms = check_serving_options(gan, seed=2, smi=smi)
    phase_done("serving and serving options: passed")
    testing = check_testing_path(seed=5, smi=smi)
    phase_done("testing path: passed")
    widths = check_widths(seed=6)
    phase_done("widths: passed")

    # Phases 4-6: the training path's correctness, float32, on the default
    # path and with CONV5_PACKED.
    check_backward()
    phase_done("backward: passed")
    check_critic()
    K.reset_launch_counts()
    with conv5_packed():
        check_critic(" CONV5_PACKED")
    critic_packed = K.launches()
    check(critic_packed["conv5x5_s2d_fused[packed]"] > 0, "the critic phase ran no K11")
    phase_done("critic: passed")
    check_superstep()
    check_superstep_packed()
    phase_done("superstep: passed")

    # Phases 7-8: the training mode of the generator through K8.
    check_uresnet()
    uresnet_fit = check_uresnet_fit()
    print("phase uresnet: passed")
    batch_bn = check_batch_bn_superstep()
    phase_done("uresnet and batch-BN superstep: passed")

    # Phase 9: timing, for information (TF32 stays off: the float32 weight
    # gradients of the backward run in full float32).
    bench = benchmarks.gan_step_bench(BATCH_TRAIN, D_ITERS, K_NOISE)
    superstep = bench["launches"]
    want = expected_superstep_launches(D_ITERS, K_NOISE)
    check(superstep == want, f"superstep launches {superstep}, expected {want}")
    print(f"time training on {smi}: gan_step_bench batch {BATCH_TRAIN}, D {D_ITERS}, "
          f"k {K_NOISE}: {bench['ms_per_superstep']:.2f} ms per superstep (reps "
          f"{', '.join(f'{r:.2f}' for r in bench['reps_ms'])}), peak memory "
          f"{bench['peak_memory_gib']:.2f} GiB, errG {bench['errG']:.4f}, launches {superstep}")
    bench_packed = bench_packed_beside_default(benchmarks, bench, smi)
    superstep_packed = bench_packed["launches"]
    run = benchmarks.gan_superstep(BATCH_TRAIN, D_ITERS, K_NOISE, seed=1)
    run()
    profile_once(run, "one superstep", bench["ms_per_superstep"])
    training = replay(bench["shapes"], torch.bfloat16, f"superstep batch {BATCH_TRAIN}")
    packed_shapes = {key: count for key, count in bench_packed["shapes"].items()
                     if key[0] == "conv5x5_s2d_fused[packed]"}
    training_packed = replay(packed_shapes, torch.bfloat16,
                             f"superstep CONV5_PACKED batch {BATCH_TRAIN}")
    k7_same = sum(count * SHAPE_TIMES["conv5x5_s2d_fused", problem]["ms"]
                  for (_, problem), count in packed_shapes.items())
    k11 = training_packed["conv5x5_s2d_fused[packed]"]
    print(f"time K11 per superstep on {smi}: {k11['ms']:.3f} ms over "
          f"{sum(packed_shapes.values())} launches (old route window_conv in turns "
          f"{k11.get('old_ms', float('nan')):.3f} ms), K7 at the same shapes and counts "
          f"{k7_same:.3f} ms, bound {k11['bound_ms']:.3f} ms")
    serving_shapes = {}
    for name, label, problem in SERVING_CASES:
        serving_shapes[name, (BATCH_SERVE, *problem)] = (
            2 if problem[-1] == "film" else 1) if name == "conv3x3_s2d_fused" else 1
    per_forward = replay(serving_shapes, torch.bfloat16, f"serving forward batch {BATCH_SERVE}")
    # K9 and K10 as one forward with both options (K10 at all four sites,
    # as fuse_chain alone runs it); K12 at its four site shapes.
    per_option = replay({(name, (BATCH_SERVE, *problem)): 1 for name, _, problem in OPTION_CASES},
                        torch.bfloat16, f"serving options batch {BATCH_SERVE}")

    # The UResNet training step, float32 (train-uresnet's default) and bfloat16.
    uresnet_steps, film = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        b = benchmarks.uresnet_step_bench(BATCH_TRAIN, IMAGE, name)
        want = {k: 7 if k == "film_residual" else 0 for k in b["launches"]}
        check(b["launches"] == want, f"uresnet step launches {b['launches']}, expected {want}")
        print(f"time uresnet on {smi}: uresnet_step_bench batch {BATCH_TRAIN} {name}: "
              f"{b['ms_per_step']:.2f} ms per step (reps "
              f"{', '.join(f'{r:.2f}' for r in b['reps_ms'])}), peak memory "
              f"{b['peak_memory_gib']:.2f} GiB, loss {b['loss']:.4f}")
        uresnet_steps[name] = b
        film[name] = replay(b["shapes"], dtype, f"uresnet step batch {BATCH_TRAIN} {name}")[
            "film_residual"]
        print(f"time uresnet {name}: K8 per training forward (7 launches): kernel "
              f"{film[name]['ms']:.4f} ms, bound {film[name]['bound_ms']:.4f} ms, plain "
              f"{film[name]['plain_ms']:.4f} ms, library none")
    run = benchmarks.uresnet_step(BATCH_TRAIN, IMAGE, "float32", seed=1)
    run()
    profile_once(run, "one uresnet step float32", uresnet_steps["float32"]["ms_per_step"])

    x, mask = subjects[0]
    fast.predict(x, mask)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x, mask in subjects:
        fast.predict(x, mask)
    end.record()
    end.synchronize()
    subject_ms = start.elapsed_time(end) / len(subjects)
    print(f"time serving on {smi}: {subject_ms:.2f} ms per {BATCH_SERVE}-slice subject "
          f"x {N_REPEAT} repeats = {BATCH_SERVE * N_REPEAT / (subject_ms / 1e3):.1f} "
          f"slice-forwards/s, kernels {sum(t['ms'] for t in per_forward.values()):.3f} ms "
          f"per forward; with the options, ms per forward: "
          + ", ".join(f"{o} {t:.3f}" for o, t in option_ms.items()))
    phase_done("timing: done")

    # Phase 10: the probes' entry points.
    probes_launches, probe_timing = run_probes(smi)
    phase_done("probes: passed")

    # Phase 11: the training path, NIfTI fold to checkpoints, resume and serving.
    training_path = check_training_path(seed=7, smi=smi)
    phase_done("training path: passed")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name == "film_residual":
            timing, unit = film["float32"], f"per UResNet training step, batch {BATCH_TRAIN}, float32"
        elif name == "conv3x3_s2d_chain2":
            timing, unit = per_option[name], "4 launches at the generator's site shapes"
        elif name == "conv5x5_s2d_fused[packed]":
            timing = training_packed[name]
            unit = ("per superstep with CONV5_PACKED, bf16 on the wgmma window; old_ms: "
                    "window_conv")
        elif name.startswith("kernel_anatomy["):
            timing = probe_timing[name]
            unit = (f"one launch, reps 1, batch {PROBE_BATCH['kernel_anatomy']}, n 128, 4C = 4Co "
                    f"= 128; marginal_ms: (t(5) - t(1)) / 4, each rep L2-fed, on the wgmma "
                    f"mainloop; old_ms, old_marginal_ms: the engine's phases")
        elif name == "conv3x3_rowblk":
            timing = probe_timing[name]
            unit = (f"4 launches: L1 nb 5 and 10, L2 nb 3 and 6, batch "
                    f"{PROBE_BATCH['rowblk_probe']}, on the wgmma mainloop; old_ms: window_conv")
        elif name.startswith("deint_"):
            timing = probe_timing[name]
            unit = (f"2 launches: the L1/L2 and L2/L3 boundaries, batch "
                    f"{PROBE_BATCH['packed_tap_probe']}")
        elif name in per_option:
            timing, unit = per_option[name], "per serving forward with the option"
            if name == "conv3x3_s2d_chain3":
                unit += ", bf16 on the wgmma chain; old_ms: s2d_chain"
            elif name == "conv3x3_s2d_fused_head":
                unit += ", bf16 on the wgmma mainloop's head epilogue; engine_ms: the engine"
        elif name in training:
            timing, unit = training[name], "per superstep"
        else:
            timing, unit = per_forward[name], "per serving forward"
        runs = {"serving": serving[name], "serving_options": options[name],
                "testing": testing[name], "widths": widths[name],
                "superstep": superstep[name], "superstep_packed": superstep_packed[name],
                "uresnet_fit": uresnet_fit[name], "batch_bn_superstep": batch_bn[name],
                "probes": probes_launches[name],
                **{run: counts[name] for run, counts in training_path.items()}}
        extra = {key: timing[key] for key in
                 ("marginal_ms", "old_marginal_ms", "engine_ms", "old_ms")
                 if key in timing}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(runs.values()), **{f"launches_{k}": v for k, v in runs.items()},
            "max_abs_err": worst[name],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes" if timing["bytes_ms"] >= timing["ops_ms"] else "operations",
            "library_ms": timing["library_ms"], "unit": unit, **extra})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
