"""The benchmark's arithmetic: spreads, and unions and gaps of
intervals."""

from __future__ import annotations

import statistics

import numpy as np


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals) -> np.ndarray:
    """Sorted, disjoint (start, end) rows covering the same instants as the
    given (start, end) rows; empty rows are dropped."""
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.empty(len(iv), bool)
    new[0] = True
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:], len(iv)) - 1
    return np.stack([iv[first, 0], reach[last]], axis=1)


def union_length(intervals) -> float:
    """Length covered by (start, end) intervals; overlaps count once."""
    m = merge(intervals)
    return float((m[:, 1] - m[:, 0]).sum()) if len(m) else 0.0


def gaps(busy: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The instants of [lo, hi] that merged ``busy`` rows leave uncovered."""
    b = merge(np.clip(np.asarray(busy, np.float64).reshape(-1, 2), lo, hi))
    edges = np.concatenate([[lo], b.ravel(), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def overlap(a, b) -> float:
    """Length of the instants covered both by rows of ``a`` and of ``b``."""
    return union_length(a) + union_length(b) - union_length(
        np.concatenate([np.asarray(a, np.float64).reshape(-1, 2),
                        np.asarray(b, np.float64).reshape(-1, 2)]))
