"""Solver and execution-plan registries, decide side.

As in the reference (``repro.api.registry``), a solver contributes a
*decision spec* — which points and weights realize the prediction map
o(x) = k(x, basis)·β — and every plan carries a ``decide`` arm that
evaluates that map under its own memory contract. Training arms (a
solver's ``fit``, a plan's ``fit``) come with the training slice; so far
the registries hold the decide side only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

DecisionSpecFn = Callable  # (config, state) -> repro_torch.api.infer.DecisionSpec
DecideFn = Callable        # (config, spec, X) -> margins


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    decision_spec: DecisionSpecFn


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    name: str
    decide: DecideFn


_SOLVERS: Dict[str, SolverEntry] = {}
_PLANS: Dict[str, PlanEntry] = {}


def register_solver(name: str, *, decision_spec: DecisionSpecFn) -> None:
    if name in _SOLVERS:
        raise ValueError(f"solver {name!r} already registered")
    _SOLVERS[name] = SolverEntry(name=name, decision_spec=decision_spec)


def register_plan(name: str, *, decide: DecideFn) -> None:
    if name in _PLANS:
        raise ValueError(f"plan {name!r} already registered")
    _PLANS[name] = PlanEntry(name=name, decide=decide)


def available_solvers():
    return sorted(_SOLVERS)


def available_plans():
    return sorted(_PLANS)


def get_solver(name: str) -> SolverEntry:
    if name not in _SOLVERS:
        raise KeyError(
            f"unknown solver {name!r}; registered: {available_solvers()}")
    return _SOLVERS[name]


def get_plan(name: str) -> PlanEntry:
    if name not in _PLANS:
        raise KeyError(
            f"unknown execution plan {name!r}; registered: {available_plans()}")
    return _PLANS[name]
