"""The statistics the end-to-end and per-layer metrics reduce with."""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default).  ``inf`` sorts above every finite value,
    so a failed or refused request counts as a miss in the tail."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0 or xs[hi] == xs[lo]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def mean(values) -> float:
    xs = [float(v) for v in values]
    if not xs:
        raise ValueError("no values")
    return sum(xs) / len(xs)


def worst(acc: float, value) -> float:
    """The larger of a running worst reading and a new one; NaN reads as
    infinitely wrong."""
    v = float(value)
    return math.inf if math.isnan(v) else max(acc, v)
