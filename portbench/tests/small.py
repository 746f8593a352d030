"""A cell of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same files, with the sizes overridden."""

from __future__ import annotations

import copy

from portbench import cell as cells

_load = cells.load  # the files' own cell, whatever a caller patches later

SMALL_CONFIG = {"image_size": 32, "first_fm": 8, "noise_size": 4}
SMALL_TRAIN = {"batch_size": 4, "d_iters": 2, "k_noise": 2}
SMALL_TRAFFIC = {"slices": 3, "subjects": 2, "n_repeat": 2, "fold_batches": 4,
                 "sample_span": 2, "sample_per_client": 1, "warmup_requests": 1,
                 "calibration_slices": 2, "trace_seconds": 0.5}


def small(workload: str, limits: dict | None = None) -> cells.Cell:
    cell = copy.deepcopy(_load(workload))
    cell.config.update(SMALL_CONFIG)
    if "train" in cell.config:
        cell.config["train"].update({k: v for k, v in SMALL_TRAIN.items()
                                     if k in cell.config["train"]})
    cell.traffic.update({k: v for k, v in SMALL_TRAFFIC.items() if k in cell.traffic})
    if limits is not None:
        cell.limits = limits
    return cell
