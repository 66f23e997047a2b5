"""The one latency-percentile helper every serving report goes through."""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np


def percentiles(samples_s: Sequence[float],
                pcts: Iterable[int] = (50, 95, 99)) -> Dict[str, float]:
    """Latency percentiles in milliseconds from samples in seconds.

    Returns ``{"p50_ms": ..., "p95_ms": ..., "p99_ms": ...}`` (keys follow
    ``pcts``); empty input yields zeros. A tail percentile is the "higher"
    order statistic — index ``min(n-1, ceil(p/100 * (n-1)))`` into the
    sorted samples — never an interpolation, so it is a latency some
    request actually paid.
    """
    if not len(samples_s):
        return {f"p{p}_ms": 0.0 for p in pcts}
    lat_ms = np.sort(np.asarray(samples_s, dtype=np.float64)) * 1e3
    n = lat_ms.shape[0]
    out = {}
    for p in pcts:
        idx = min(n - 1, max(0, int(np.ceil(p / 100.0 * (n - 1)))))
        out[f"p{p}_ms"] = float(lat_ms[idx])
    return out
