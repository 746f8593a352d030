"""Two-critic WGAN-GP training: ``GanTrainer.superstep`` over a fold held
on the device.

The mix (``"driver": "gan_train"``) gives the fold's size in batches, the
trainer's path (``compute_dtype``, ``use_pallas``), the supersteps that
set-up runs and the seconds that ``--trace 1`` profiles; the configuration
file gives the published training settings (batch, D, k, the penalty's
weight, Adam). The fold's slices are uniform in [0, 1), made on the device
from the seed. Supersteps follow ``fit_fold``'s order at the steady
schedule (D critic rows a superstep after warm-up, fewer at an epoch's
tail), the rows of each epoch a permutation drawn from the seed; each
superstep's draws come from one generator on the device seeded from the
seed, as in ``fit_fold``.

Set-up builds the trainer and its state from the benchmark's weights and
drives it through its first supersteps, through the window's own call and
feed: the first compiles and plans, and the first three are what
``correct`` compares. The same state then trains through the window.
``train_slices_per_s`` is every critic row's batch consumed in the window
over the window's seconds, the card synchronized at its close.

``correct``: after the window, the plain float32 reference
(``reference/<config>.py``) trains the same weights over the same batches
with the same draws for three supersteps, and the step losses, the first
gradient and the change after three steps are compared (``yardstick/
compare.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.drivers.common import generator_weights, model_config, sync
from portbench.reference import nets
from portbench.yardstick import compare, weights
from portbench.yardstick.trace import Spans, Trace, profiler

NETS = ("g", "dy2", "ddem")


def schedule(n_batches: int, d: int, batch: int, seed: int):
    """``fit_fold``'s order: each epoch a permutation of the fold's rows in
    batches, taken D batches a superstep, fewer at the tail. Yields the
    (D, B) index block and its real rows."""
    rng = np.random.default_rng(seed)
    while True:
        epoch = rng.permutation(n_batches * batch).reshape(n_batches, batch)
        for i in range(0, n_batches, d):
            rows = epoch[i:i + d]
            block = np.zeros((d, batch), np.int64)
            block[:len(rows)] = rows
            yield block, len(rows)


def make_inputs(cell, seed: int, dev):
    """The fold and the initial weights (the head calibrated over a few of
    the fold's slices with the reference)."""
    cfg, tr = cell.config, cell.traffic
    n = tr["fold_batches"] * cfg["train"]["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    side = cfg["image_size"]
    x_all = torch.rand((n, side, side, cfg["n_input_channels"]), generator=gen, device=dev)
    y_all = torch.rand((n, side, side, 1), generator=gen, device=dev)
    g, g_stats = generator_weights(cell, seed, dev, x_all[: tr["calibration_slices"]])
    spec = nets.critic_spec(cfg)
    init = {"g": g, "g_stats": g_stats, "dy2": weights.make(spec, seed + 2, dev),
            "ddem": weights.make(spec, seed + 3, dev)}
    return x_all, y_all, init


def draw_seed(seed: int) -> int:
    return (seed * 16 + 5) % 2**63


def program(cell, dev):
    from depgan_tpu_torch.config import DataConfig, GanTrainConfig
    from depgan_tpu_torch.train.gan_trainer import GanTrainer

    t = cell.config["train"]
    train_cfg = GanTrainConfig(batch_size=t["batch_size"], d_iters=t["d_iters"],
                               warmup_d_iters=t["d_iters"], k_noise=t["k_noise"],
                               gp_weight=t["gp_weight"], lr_d=t["lr_d"], lr_g=t["lr_g"],
                               adam_b1=t["adam_b1"], adam_b2=t["adam_b2"],
                               l1_weight=t["l1_weight"], vol_weight=t["vol_weight"],
                               dice_weight=t["dice_weight"], threshold_mode="hard")
    data_cfg = DataConfig(use_probability_map=t["wmh_threshold"] == 0.5)
    trainer = GanTrainer(model_config(cell), train_cfg, data_cfg, dev)
    if trainer.threshold != t["wmh_threshold"]:
        raise ValueError(f"threshold {trainer.threshold} is not the configuration's")
    return trainer


def program_state(cell, init):
    from depgan_tpu_torch.train.state import GanTrainState, make_adam

    t = cell.config["train"]

    def leaves(d):
        return {k: v.detach().clone().requires_grad_() for k, v in d.items()}

    g, dy2, ddem = leaves(init["g"]), leaves(init["dy2"]), leaves(init["ddem"])
    return GanTrainState(
        g_params=g, g_stats={k: v.clone() for k, v in init["g_stats"].items()},
        g_opt=make_adam(g, t["lr_g"], t["adam_b1"], t["adam_b2"]),
        dy2_params=dy2, dy2_opt=make_adam(dy2, t["lr_d"], t["adam_b1"], t["adam_b2"]),
        ddem_params=ddem, ddem_opt=make_adam(ddem, t["lr_d"], t["adam_b1"], t["adam_b2"]))


def _params(state) -> dict:
    out = {}
    for name in NETS:
        out.update({f"{name}.{k}": v.detach().clone()
                    for k, v in getattr(state, f"{name}_params").items()})
    return out


def _moments(state) -> dict:
    from depgan_tpu_torch.train.state import adam_moments

    out = {}
    for name in NETS:
        params = getattr(state, f"{name}_params")
        _, mu, _ = adam_moments(getattr(state, f"{name}_opt"), params)
        out.update({f"{name}.{k}": v.detach().clone() for k, v in mu.items()})
    return out


def _losses(metrics, n_valid: int) -> dict:
    out = {}
    for which in ("y2", "dem"):
        for side in ("real", "fake"):
            row = metrics[f"crit_{which}_{side}"].float().cpu()
            out.update({f"crit_{which}_{side}_{j}": float(row[j]) for j in range(n_valid)})
    out["errG"] = float(metrics["gen"]["errG"])
    out["best"] = int(metrics["best_noise_idx"])
    return out


def reference_run(cell, seed, x_all, y_all, init, blocks, precision="float32",
                  half_batch=False) -> dict:
    """The reference's three supersteps over ``blocks``: their losses,
    Adam's first moments after the first, the parameters after the third."""
    ref_mod = cell.reference()
    cfg, t = cell.config, cell.config["train"]
    ref = ref_mod.GanReference(cfg, t, init["g"], init["g_stats"], init["dy2"], init["ddem"],
                               precision, half_batch)
    gen = torch.Generator(device=x_all.device).manual_seed(draw_seed(seed))
    snap = {"losses": []}
    for s, (block, n_valid) in enumerate(blocks):
        dr = ref_mod.draws(cfg, t, block.shape[0], gen, x_all.device)
        idx = torch.as_tensor(block, device=x_all.device)
        snap["losses"].append(ref.superstep(x_all[idx], y_all[idx], dr, n_valid))
        if s == 0:
            snap["m1"] = {k: v.clone() for k, v in ref.first_moments().items()}
    snap["p3"] = ref.parameters()
    return snap


def readings(prog: dict, ref: dict, init: dict) -> dict:
    """The numbers ``correct`` can compare, and where each is worst: the
    losses of all three steps, of the first, and of each critic's first
    iteration (from the initial weights); the first gradient and the change
    after three steps, by the worst leaf and by the median leaf."""
    start = {}
    for name in NETS:
        start.update({f"{name}.{k}": v for k, v in init[name].items()})
    strip = [{k: v for k, v in d.items() if k != "best"} for d in prog["losses"]]
    want = [{k: v for k, v in d.items() if k != "best"} for d in ref["losses"]]
    loss, loss_at = compare.loss_gap(strip, want)
    steps = [compare.loss_gap(strip[i:i + 1], want[i:i + 1])[0] for i in range(len(want))]
    first = [k for k in want[0] if k.startswith("crit_") and k.endswith("_0")]
    loss0 = compare.loss_gap([{k: strip[0][k] for k in first}], [{k: want[0][k] for k in first}])
    grads, changes = {}, {}
    for name in NETS:
        sub = {k: v for k, v in ref["m1"].items() if k.startswith(f"{name}.")}
        grads.update(compare.leaf_gaps({k: prog["m1"][k] for k in sub}, sub))
        changes.update(compare.leaf_gaps(compare.change({k: prog["p3"][k] for k in sub}, start),
                                         compare.change({k: ref["p3"][k] for k in sub}, start),
                                         compare.moving_leaves(sub)))
    return compare.summary(loss, loss_at, steps, loss0, grads, changes) | {
        "best": ([d["best"] for d in prog["losses"]], [d["best"] for d in ref["losses"]])}


def first_steps(cell, seed, dev, n_steps):
    """Inputs, trainer and state, driven through ``n_steps`` supersteps of
    the window's call and feed; returns them with the program's snapshots,
    the schedule (positioned after those supersteps) and the blocks run."""
    tr, t = cell.traffic, cell.config["train"]
    x_all, y_all, init = make_inputs(cell, seed, dev)
    trainer = program(cell, dev)
    state = program_state(cell, init)
    sched = schedule(tr["fold_batches"], t["d_iters"], t["batch_size"], seed)
    gen = torch.Generator(device=dev).manual_seed(draw_seed(seed))
    snap, blocks = {"losses": []}, []
    for s in range(n_steps):
        block, n_valid = next(sched)
        blocks.append((block, n_valid))
        state, metrics = trainer.superstep(state, x_all, y_all, block, n_valid, generator=gen)
        if s < 3:
            snap["losses"].append(_losses(metrics, n_valid))
        if s == 0:
            snap["m1"] = _moments(state)
        if s == 2:
            snap["p3"] = _params(state)
    return dict(x_all=x_all, y_all=y_all, init=init, trainer=trainer, state=state, sched=sched,
                gen=gen, snap=snap, blocks=blocks[:3])


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    tr, t = cell.traffic, cell.config["train"]
    dev = torch.device(device)
    run_ = first_steps(cell, seed, dev, tr["setup_supersteps"])
    trainer, state, sched, gen = run_["trainer"], run_["state"], run_["sched"], run_["gen"]
    x_all, y_all = run_["x_all"], run_["y_all"]
    sync(dev)
    setup_s = time.perf_counter() - t_start

    spans = Spans()
    prof = profiler(dev) if trace else None
    traced, supersteps, traced_rows = None, [], []
    if prof is not None:
        prof.start()
    t0, t0_ns = time.perf_counter(), time.time_ns()
    end = t0 + seconds
    while True:
        block, n_valid = next(sched)
        with spans.span("bench.superstep"), record_function("bench.superstep"):
            state, _ = trainer.superstep(state, x_all, y_all, block, n_valid, generator=gen)
        supersteps.append(n_valid)
        now = time.perf_counter()
        if prof is not None and traced is None and now >= t0 + min(tr["trace_seconds"],
                                                                    seconds / 2):
            sync(dev)
            traced = (t0_ns, time.time_ns())
            prof.stop()
            traced_rows = list(supersteps)
        if now >= end:
            break
    sync(dev)
    window = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = sum(supersteps) * t["batch_size"]
    print(f"gan_train: {len(supersteps)} supersteps ({slices} slices) in the window of "
          f"{window:.3f} s", flush=True)
    trace_obj, counters = None, {}
    if traced is not None:
        trace_obj = Trace(prof, *traced, spans)
        counters = dict(supersteps=traced_rows, config=cell.config, train=t,
                        dtype=tr["compute_dtype"])
        print(f"gan_train trace: {len(traced_rows)} supersteps, window "
              f"{trace_obj.window_s:.3f} s, busy {trace_obj.busy_s:.3f} s", flush=True)

    del trainer, state, run_["trainer"], run_["state"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_run(cell, seed, x_all, y_all, run_["init"], run_["blocks"])
    got = readings(run_["snap"], ref, run_["init"])
    print(f"gan_train: worst at {got['where']}; best probe noise program {got['best'][0]} "
          f"reference {got['best'][1]}", flush=True)
    compared = [(k, got[k], v["limit"]) for k, v in cell.limits.items() if isinstance(v, dict)]
    return {"correct": all(v <= lim for _, v, lim in compared),
            "attempted": len(supersteps), "failed": 0,
            "end_to_end": {"train_slices_per_s": slices / window, "setup_s": setup_s},
            "memory_peak_bytes": memory_peak, "trace": trace_obj, "counters": counters,
            "compared": compared}
