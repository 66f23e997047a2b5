"""The result type a fit returns (``repro.api.result.FitResult``).

One :class:`FitResult` per ``fit``/``partial_fit`` call, collected on
``KernelMachine.history_``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.tron import TronResult


@dataclasses.dataclass(frozen=True)
class FitResult:
    solver: str
    plan: str
    m: int                    # basis size
    f: float                  # final objective
    gnorm: float
    n_iter: int               # outer iterations
    n_fg: int
    n_hd: int
    converged: bool
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_tron(cls, res: TronResult, *, solver: str, plan: str,
                  m: int) -> "FitResult":
        """A column-batched (one-vs-rest) result carries (K,) per-column
        f/gnorm/converged; the summary here is the separable total
        objective (sum), the worst gradient norm and all-columns
        convergence. The raw per-column result stays in
        ``extras['tron']``."""
        return cls(solver=solver, plan=plan, m=m, f=float(torch.sum(res.f)),
                   gnorm=float(torch.max(res.gnorm)), n_iter=int(res.n_iter),
                   n_fg=int(res.n_fg), n_hd=int(res.n_hd),
                   converged=bool(torch.all(res.converged)),
                   extras={"tron": res})

    @property
    def tron(self) -> Optional[TronResult]:
        return self.extras.get("tron")

    def __repr__(self):  # keep tensor-laden extras out of logs
        f = "nan" if math.isnan(self.f) else f"{self.f:.6g}"
        return (f"FitResult(solver={self.solver!r}, plan={self.plan!r}, "
                f"m={self.m}, f={f}, n_iter={self.n_iter}, "
                f"converged={self.converged})")
