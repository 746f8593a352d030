"""End-to-end statistics, over every request or step of the window."""

from __future__ import annotations

import statistics


def p95(values: list[float]) -> float:
    """The 95th percentile of all ``values`` (linear between order
    statistics, ``statistics.quantiles``' inclusive method)."""
    if len(values) < 2:
        return float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[94]
