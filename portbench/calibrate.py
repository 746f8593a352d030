"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <name> --seeds <n> ... \
        --control-seeds <n> ... [--seconds <s>]

For every seed of ``--seeds`` the program runs as the benchmark runs it
(serving: a window of ``--seconds`` at the cell's load; training: set-up's
first three steps) and its numbers are read against the reference: the
lower readings. For every seed of ``--control-seeds`` the reference in the
next precision below the cell's (``limits/<workload>.json`` ``control``)
takes the program's place, and, for a training cell, the faults a run
could carry: half of each batch left out (the mean over the rest) and a
state left unchanged: the upper readings. Prints one JSON line a reading.
Not run by the benchmark's own runs.

``--tf32 on`` turns TF32 on in cuDNN and in matmul for the whole run (the
program's torch products too), and the control becomes the reference with
TF32 in both (precision ``tf32``): what a float32 cell's numbers read when
every product runs on the TF32 tensor cores, which the float32 mixes admit
(``"products": "tf32"``; their control stays bfloat16).

``--look`` (training cells) asks where a gap comes from instead: for each
seed of ``--seeds`` it reads the program against the float32 reference
and against a float64 one, and the float32 reference against the float64
one, each with the leaves whose change is worst. Run it once with
``--tf32 off`` too.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import cell as cells
from portbench.drivers import common


KEYS = ("loss_gap", "loss1_gap", "loss0_gap", "grad_gap", "grad_median_gap", "change_gap",
        "change_median_gap", "loss_steps", "where")


def _print(**row):
    print(json.dumps(row), flush=True)


def serving(cell, seeds, control_seeds, seconds, device, control):
    from portbench.drivers import serve

    for seed in seeds:
        out = serve.run(cell, seed, seconds, False, device, time.perf_counter())
        _print(kind="program", seed=seed, tf32=torch.backends.cudnn.allow_tf32,
               max_abs_gap=out["compared"][0][1],
               slices_per_s=out["end_to_end"]["subject_slices_per_s"])
        if seed in control_seeds:
            _print(kind=f"control {control}", seed=seed, max_abs_gap=out["control"](control))
        del out
        _empty_cache(device)


def training(cell, seeds, control_seeds, device, control):
    from portbench.drivers import gan_train, uresnet_train

    gan = cell.traffic["driver"] == "gan_train"
    mod = gan_train if gan else uresnet_train
    dev = torch.device(device)
    for seed in seeds:
        run_ = mod.first_steps(cell, seed, dev, 3)
        x_all, y_all, init = run_["x_all"], run_["y_all"], run_["init"]
        prog = run_["snap"]
        del run_
        _empty_cache(device)

        def ref(**kw):
            if gan:
                blocks = list(_first_blocks(cell, seed))
                return gan_train.reference_run(cell, seed, x_all, y_all, init, blocks, **kw)
            return uresnet_train.reference_run(cell, seed, x_all, y_all, init, **kw)

        want = ref()
        got = mod.readings(prog, want, init)
        _print(kind="program", seed=seed, tf32=torch.backends.cudnn.allow_tf32,
               **{k: got[k] for k in KEYS})
        if seed in control_seeds:
            for kind, kw in ((f"control {control}", {"precision": control}),
                             ("fault half batch", {"half_batch": True})):
                got = mod.readings(ref(**kw), want, init)
                _print(kind=kind, seed=seed, **{k: got[k] for k in KEYS})
            start = dict(want)
            start["m1"] = {k: torch.zeros_like(v) for k, v in want["m1"].items()}
            start["p3"] = _initial(init, want["p3"], gan)
            got = mod.readings(start, want, init)
            _print(kind="fault state unchanged", seed=seed,
                   **{k: got[k] for k in ("grad_gap", "grad_median_gap", "change_gap",
                                          "change_median_gap")})
        del x_all, y_all, init
        _empty_cache(device)


def look(cell, seeds, device):
    """The program against the float32 and the float64 reference, and the
    float32 reference against the float64 one."""
    from portbench.drivers import gan_train, uresnet_train

    gan = cell.traffic["driver"] == "gan_train"
    mod = gan_train if gan else uresnet_train
    dev = torch.device(device)
    for seed in seeds:
        run_ = mod.first_steps(cell, seed, dev, 3)
        x_all, y_all, init, prog = run_["x_all"], run_["y_all"], run_["init"], run_["snap"]
        del run_
        _empty_cache(device)
        refs = {}
        for precision in ("float32", "float64"):
            if gan:
                refs[precision] = gan_train.reference_run(cell, seed, x_all, y_all, init,
                                                          list(_first_blocks(cell, seed)),
                                                          precision=precision)
            else:
                refs[precision] = uresnet_train.reference_run(cell, seed, x_all, y_all, init,
                                                              precision=precision)
        for kind, got, want in (("program vs float32", prog, refs["float32"]),
                                ("program vs float64", prog, refs["float64"]),
                                ("float32 reference vs float64", refs["float32"],
                                 refs["float64"])):
            rd = mod.readings(got, want, init)
            _print(kind=kind, seed=seed, tf32=torch.backends.cudnn.allow_tf32,
                   **{k: rd[k] for k in KEYS + ("change_top",) + (("best",) if gan else ())})
        del x_all, y_all, init, refs
        _empty_cache(device)


def _empty_cache(device):
    if device == "cuda":
        torch.cuda.empty_cache()


def _first_blocks(cell, seed):
    from portbench.drivers.gan_train import schedule

    t = cell.config["train"]
    sched = schedule(cell.traffic["fold_batches"], t["d_iters"], t["batch_size"], seed)
    for _ in range(3):
        yield next(sched)


def _initial(init, like, gan):
    if not gan:
        return {k: init["g"][k] for k in like}
    return {k: init[k.split(".", 1)[0]][k.split(".", 1)[1]] for k in like}


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal of the tool's paths")
    p.add_argument("--tf32", choices=("default", "off", "on"), default="default",
                   help="off: the program's cuDNN convolutions without TF32 (a look at a cause); "
                        "on: TF32 in cuDNN and matmul, and the TF32 reference as the control")
    p.add_argument("--look", action="store_true",
                   help="training: where the gaps come from (float32 and float64 references)")
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    common.set_products(cell)
    if args.tf32 == "off":
        torch.backends.cudnn.allow_tf32 = False
    elif args.tf32 == "on":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    control = "tf32" if args.tf32 == "on" else cell.limits["control"]
    if args.look:
        look(cell, args.seeds, args.device)
    elif cell.traffic["driver"] == "serve":
        serving(cell, args.seeds, set(args.control_seeds), args.seconds, args.device, control)
    else:
        training(cell, args.seeds, set(args.control_seeds), args.device, control)


if __name__ == "__main__":
    main()
