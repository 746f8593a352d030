"""The controls, at a size the CPU holds: the reference in the next
precision below the cell's, put in the program's place, reads above the
cell's limits where the program reads below them (the card's readings at
full size, which set the limits, are in PERF.md)."""

from __future__ import annotations

import pytest
import torch

from portbench.drivers import gan_train, serve, uresnet_train
from portbench.tests.small import small

SEED = 2_147_483_990
DEV = torch.device("cpu")


@pytest.mark.parametrize("workload, module", [("depgan-train-f32", gan_train),
                                              ("depuresnet-train-f32", uresnet_train)])
def test_training_control_fails_a_limit(workload, module):
    cell = small(workload)
    run = module.first_steps(cell, SEED, DEV, 3)
    x_all, y_all, init = run["x_all"], run["y_all"], run["init"]
    if module is gan_train:
        blocks = run["blocks"]
        ref = lambda **kw: gan_train.reference_run(cell, SEED, x_all, y_all, init,  # noqa: E731
                                                   blocks, **kw)
    else:
        ref = lambda **kw: uresnet_train.reference_run(cell, SEED, x_all, y_all,  # noqa: E731
                                                       init, **kw)
    want = ref()
    limits = {k: v["limit"] for k, v in cell.limits.items() if isinstance(v, dict)}
    program = module.readings(run["snap"], want, init)
    control = module.readings(ref(precision=cell.limits["control"]), want, init)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()), control


def test_serving_control_reads_far_above_the_program():
    cell = small("depgan-serve-1c", {"max_abs_gap": {"limit": 0.1}, "control": "fp8"})
    out = serve.run(cell, SEED, 1.0, False, "cpu", 0.0)
    program = out["compared"][0][1]
    control = out["control"](cell.limits["control"])
    assert control > 3 * program and control > cell.limits["max_abs_gap"]["limit"]


def test_tf32_control_turns_tf32_on_in_cudnn_and_matmul_and_restores():
    from portbench.reference import nets

    flags = lambda: (torch.backends.cudnn.allow_tf32,  # noqa: E731
                     torch.backends.cuda.matmul.allow_tf32)
    before = flags()
    assert nets.Precision("tf32").operand(torch.ones(2)).dtype == torch.float32
    with nets.Precision("tf32").products():
        assert flags() == (True, True)
        with nets.Precision().products():
            assert flags() == (False, False)
        assert flags() == (True, True)
    assert flags() == before
