"""The benchmark's metric arithmetic: rates over a whole window,
percentiles over all requests, the union of device intervals and the idle
gaps between them, and the run-to-run spread that sets a bound.

Plain Python and NumPy only, so that every reader and test shares one
definition of each quantity.
"""

from __future__ import annotations

import statistics

import numpy as np


def rate(total: float, start: float, end: float) -> float:
    """Work per second over the whole window [start, end)."""
    if end <= start:
        raise ValueError(f"empty window [{start}, {end})")
    return total / (end - start)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linear between the two nearest
    ranks (NumPy's default method)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(v, q))


def merge(intervals, lo: float, hi: float) -> np.ndarray:
    """The union of half-open intervals (rows of start, end) clipped to
    [lo, hi), as sorted disjoint (k, 2) rows."""
    a = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    a = np.clip(a, lo, hi)
    a = a[a[:, 1] > a[:, 0]]
    if a.size == 0:
        return np.zeros((0, 2))
    a = a[np.argsort(a[:, 0], kind="stable")]
    # a new run starts where an interval begins after every earlier end
    ends = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:, 0] > ends[:-1]
    starts = np.flatnonzero(new)
    run_end = np.append(starts[1:], len(a)) - 1
    return np.stack([a[starts, 0], ends[run_end]], axis=1)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi)."""
    m = merge(intervals, lo, hi)
    return float((m[:, 1] - m[:, 0]).sum())


def idle_pct(intervals, lo: float, hi: float) -> float:
    """100 x the share of [lo, hi) that no interval covers."""
    return 100.0 * (1.0 - union_length(intervals, lo, hi) / (hi - lo))


def gaps(intervals, lo: float, hi: float) -> np.ndarray:
    """The stretches of [lo, hi) that no interval covers, as (k, 2) rows."""
    m = merge(intervals, lo, hi)
    edges = np.concatenate([[lo], m.reshape(-1), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
