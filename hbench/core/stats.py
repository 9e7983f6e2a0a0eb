"""The arithmetic of the end-to-end metrics: a rate over a window, a
percentile of latencies, and the spread of a set of runs."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work done per second of the window."""
    if seconds <= 0:
        raise ValueError(f"rate over a window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of `values`, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (statistics.quantiles' default method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
