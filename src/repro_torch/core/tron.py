"""TRON (trust-region Newton) settings.

Only :class:`TronConfig` so far, so that checkpoint configs round-trip;
the solver itself comes with the training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TronConfig:
    max_iter: int = 200          # outer Newton iterations (paper: N ~ 300)
    grad_rtol: float = 1e-3      # stop when ||g|| <= grad_rtol * ||g0||
    cg_rtol: float = 0.1         # inner CG: ||r|| <= cg_rtol * ||g||
    cg_max_iter: int = 64        # cap on CG steps per outer iteration
    eta0: float = 1e-4           # step acceptance threshold
    eta1: float = 0.25
    eta2: float = 0.75
    sigma1: float = 0.25         # trust-region shrink/grow factors
    sigma2: float = 0.5
    sigma3: float = 4.0
