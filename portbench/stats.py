"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile, ``statistics.quantiles(method="inclusive")``'s
    cut point (linear between the nearest ranks)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def rate(amount: float, start: float, end: float) -> float:
    """``amount`` over the window [start, end]."""
    if end <= start:
        raise ValueError("an empty window")
    return amount / (end - start)

