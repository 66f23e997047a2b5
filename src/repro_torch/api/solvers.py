"""Solvers, decide side: how each solver's fitted state realizes o(x).

``tron`` and ``linearized`` both store a point basis and weights,
{"basis": (m, d), "beta": (m,) or (m, K)}, so both serve through
:func:`_spec_nystrom`. Their ``fit`` arms, and the ``rff`` and
``ppacksvm`` solvers, come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.api.infer import DecisionSpec
from repro_torch.api.registry import register_solver


def _spec_nystrom(config, state) -> DecisionSpec:
    """o(x) = k(x, basis)·β over the stored point basis."""
    return DecisionSpec(basis=state["basis"], beta=state["beta"],
                        kernel=config.kernel, policy=config.dtype_policy)


register_solver("tron", decision_spec=_spec_nystrom)
register_solver("linearized", decision_spec=_spec_nystrom)
