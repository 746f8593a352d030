"""The comparisons that decide ``correct``.

A served subject is judged by the largest absolute gap between its
ensemble map and the reference's. A training step yields the numbers of
``summary``: the gap of the step losses (all three steps, the first, each
critic's first iteration), relative to the reference's value or the
step's median value, whichever is larger; and, per leaf, the gap between
the program's norm and the reference's norm of the first gradient (Adam's
first moment after one step) and of the parameters' change after three
steps, relative to the reference's norm of that leaf or of the network's
median leaf, whichever is larger, taken at the worst leaf and at the
median leaf. Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by round-off alone and are left out of the
change. A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import statistics

EXCLUDE_BELOW = 1e-3  # of the median leaf's gradient norm


def loss_gap(prog: list[dict], ref: list[dict]) -> tuple[float, str]:
    """Worst relative gap over the steps' losses (each step a dict of
    scalars)."""
    worst, where = 0.0, ""
    for step, (p, r) in enumerate(zip(prog, ref), 1):
        scale = statistics.median(abs(v) for v in r.values())
        for key, rv in r.items():
            gap = abs(p[key] - rv) / max(abs(rv), scale, 1e-30)
            if gap > worst or not where:
                worst, where = gap, f"step {step} {key}"
    return worst, where


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, median leaf's ‖ref‖);
    ``keep`` (optional) names the leaves that count."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    median = statistics.median(rn.values())
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], median, 1e-30)
            for k in names}


def moving_leaves(ref_grads: dict) -> set[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    floor = EXCLUDE_BELOW * statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= floor}


def change(now: dict, start: dict) -> dict:
    return {k: now[k].double() - start[k].double() for k in now}


def summary(loss, loss_at, steps, loss0, grads, changes) -> dict:
    """The numbers a training cell can compare, from the step losses' gaps
    and the per-leaf gaps of the first gradient and of the change."""
    g_at, c_at = max(grads, key=grads.get), max(changes, key=changes.get)
    return {"loss_gap": loss, "loss1_gap": steps[0], "loss0_gap": loss0[0],
            "grad_gap": grads[g_at], "grad_median_gap": statistics.median(grads.values()),
            "change_gap": changes[c_at], "change_median_gap": statistics.median(changes.values()),
            "loss_steps": steps,
            "where": {"loss_gap": loss_at, "grad_gap": g_at, "change_gap": c_at},
            "change_top": sorted(changes.items(), key=lambda kv: -kv[1])[:4]}
