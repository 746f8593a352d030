"""Supervised DEP-UResNet training: ``UResNetTrainer.step`` over a fold held
on the device, in the order ``UResNetTrainer.fit`` takes it.

The mix (``"driver": "uresnet_train"``) gives the fold's size in batches,
the trainer's path (``compute_dtype``, ``use_pallas``), the label edges,
the steps that set-up runs and the seconds that ``--trace 1`` profiles.
Slices are uniform in [0, 1), labelled by bucketing the slice at the edges
into the 4 change classes, made on the device from the seed. Each epoch, as
``fit`` does, draws fresh noise for every slice of the fold and takes its
batches in a permutation drawn from the seed; the noise and the dropout
masks come from one generator on the device seeded from the seed.

Set-up drives the trainer through its first steps through the window's own
call and feed; the first three are what ``correct`` compares with the
plain float32 reference (``reference/<config>.py``), which trains the same
weights on the same batches, noise and dropout masks.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.drivers.common import generator_weights, model_config, sync
from portbench.yardstick import compare
from portbench.yardstick.trace import Spans, Trace, profiler


def draw_seed(seed: int) -> int:
    return (seed * 16 + 7) % 2**63


def feed(cell, seed: int, gen: torch.Generator, n: int, dev):
    """``fit``'s order: at each epoch's start the fold's noise, then its
    batches in a permutation. Yields (batch rows, the epoch's noise)."""
    cfg, b = cell.config, cell.config["train"]["batch_size"]
    rng = np.random.default_rng(seed)
    while True:
        noise = torch.randn((n, cfg["noise_size"], 1), generator=gen, device=dev)
        for rows in rng.permutation(n).reshape(-1, b):
            yield rows, noise


def make_inputs(cell, seed: int, dev):
    cfg, tr = cell.config, cell.traffic
    n = tr["fold_batches"] * cfg["train"]["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    side = cfg["image_size"]
    x_all = torch.rand((n, side, side, cfg["n_input_channels"]), generator=gen, device=dev)
    labels = torch.bucketize(x_all[..., 0], torch.tensor(tr["label_edges"], device=dev))
    y_all = torch.nn.functional.one_hot(labels, cfg["train"]["n_classes"]).float()
    g, g_stats = generator_weights(cell, seed, dev, x_all[: tr["calibration_slices"]])
    return x_all, y_all, {"g": g, "g_stats": g_stats}


def program(cell, init, dev):
    from depgan_tpu_torch.config import UResNetTrainConfig
    from depgan_tpu_torch.train.state import UResNetTrainState, make_adam
    from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer

    t = cell.config["train"]
    train_cfg = UResNetTrainConfig(batch_size=t["batch_size"], lr=t["lr"],
                                   n_classes=t["n_classes"])
    trainer = UResNetTrainer(model_config(cell), train_cfg, dev)
    params = {k: v.detach().clone().requires_grad_() for k, v in init["g"].items()}
    state = UResNetTrainState(params=params,
                              batch_stats={k: v.clone() for k, v in init["g_stats"].items()},
                              opt=make_adam(params, t["lr"], t["adam_b1"], t["adam_b2"]))
    return trainer, state


def reference_run(cell, seed, x_all, y_all, init, n_steps=3, precision="float32",
                  half_batch=False) -> dict:
    ref = cell.reference().UResNetReference(cell.config, init["g"], init["g_stats"], precision,
                                            half_batch)
    gen = torch.Generator(device=x_all.device).manual_seed(draw_seed(seed))
    batches = feed(cell, seed, gen, x_all.shape[0], x_all.device)
    snap = {"losses": []}
    for s in range(n_steps):
        rows, noise = next(batches)
        idx = torch.as_tensor(rows, device=x_all.device)
        snap["losses"].append({"loss": ref.step(x_all[idx], y_all[idx], noise[idx], gen)})
        if s == 0:
            snap["m1"] = {k: v.clone() for k, v in ref.opt.m.items()}
    snap["p3"] = {k: v.detach() for k, v in ref.params.items()}
    return snap


def readings(prog: dict, ref: dict, init: dict) -> dict:
    """As ``gan_train.readings``; the first step's loss is the first loss."""
    loss, loss_at = compare.loss_gap(prog["losses"], ref["losses"])
    steps = [compare.loss_gap(prog["losses"][i:i + 1], ref["losses"][i:i + 1])[0]
             for i in range(len(ref["losses"]))]
    grads = compare.leaf_gaps(prog["m1"], ref["m1"])
    changes = compare.leaf_gaps(compare.change(prog["p3"], init["g"]),
                                compare.change(ref["p3"], init["g"]),
                                compare.moving_leaves(ref["m1"]))
    return compare.summary(loss, loss_at, steps, (steps[0], ""), grads, changes)


def first_steps(cell, seed, dev, n_steps):
    from depgan_tpu_torch.train.state import adam_moments

    x_all, y_all, init = make_inputs(cell, seed, dev)
    trainer, state = program(cell, init, dev)
    gen = torch.Generator(device=dev).manual_seed(draw_seed(seed))
    batches = feed(cell, seed, gen, x_all.shape[0], dev)
    snap = {"losses": []}
    for s in range(n_steps):
        rows, noise = next(batches)
        state, loss = trainer.step(state, x_all, y_all, noise, rows, generator=gen)
        if s < 3:
            snap["losses"].append({"loss": float(loss)})
        if s == 0:
            snap["m1"] = {k: v.detach().clone()
                          for k, v in adam_moments(state.opt, state.params)[1].items()}
        if s == 2:
            snap["p3"] = {k: v.detach().clone() for k, v in state.params.items()}
    return dict(x_all=x_all, y_all=y_all, init=init, trainer=trainer, state=state,
                batches=batches, gen=gen, snap=snap)


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    tr, t = cell.traffic, cell.config["train"]
    dev = torch.device(device)
    run_ = first_steps(cell, seed, dev, tr["setup_steps"])
    trainer, state, batches, gen = run_["trainer"], run_["state"], run_["batches"], run_["gen"]
    x_all, y_all = run_["x_all"], run_["y_all"]
    sync(dev)
    setup_s = time.perf_counter() - t_start

    spans = Spans()
    prof = profiler(dev) if trace else None
    traced, steps, traced_steps = None, 0, 0
    if prof is not None:
        prof.start()
    t0, t0_ns = time.perf_counter(), time.time_ns()
    end = t0 + seconds
    while True:
        rows, noise = next(batches)
        with spans.span("bench.step"), record_function("bench.step"):
            state, _ = trainer.step(state, x_all, y_all, noise, rows, generator=gen)
        steps += 1
        now = time.perf_counter()
        if prof is not None and traced is None and now >= t0 + min(tr["trace_seconds"],
                                                                    seconds / 2):
            sync(dev)
            traced = (t0_ns, time.time_ns())
            prof.stop()
            traced_steps = steps
        if now >= end:
            break
    sync(dev)
    window = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = steps * t["batch_size"]
    print(f"uresnet_train: {steps} steps ({slices} slices) in the window of {window:.3f} s",
          flush=True)
    trace_obj, counters = None, {}
    if traced is not None:
        trace_obj = Trace(prof, *traced, spans)
        counters = dict(steps=traced_steps, config=cell.config, train=t,
                        dtype=tr["compute_dtype"])
        print(f"uresnet_train trace: {traced_steps} steps, window {trace_obj.window_s:.3f} s, "
              f"busy {trace_obj.busy_s:.3f} s", flush=True)

    del trainer, state, run_["trainer"], run_["state"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_run(cell, seed, x_all, y_all, run_["init"])
    got = readings(run_["snap"], ref, run_["init"])
    print(f"uresnet_train: worst at {got['where']}", flush=True)
    compared = [(k, got[k], v["limit"]) for k, v in cell.limits.items() if isinstance(v, dict)]
    return {"correct": all(v <= lim for _, v, lim in compared), "attempted": steps, "failed": 0,
            "end_to_end": {"train_slices_per_s": slices / window, "setup_s": setup_s},
            "memory_peak_bytes": memory_peak, "trace": trace_obj, "counters": counters,
            "compared": compared}
