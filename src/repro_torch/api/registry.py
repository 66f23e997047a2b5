"""Solver and execution-plan registries.

As in the reference (``repro.api.registry``): a *solver* owns the
optimization strategy and contributes a *decision spec* — which points and
weights realize the prediction map o(x) = k(x, basis)·β; an *execution
plan* owns where the math runs, with a ``fit`` arm (one TRON solve under
its memory contract) and a ``decide`` arm (the prediction map under the
same contract). A solver declares the plans it is valid under; the
composition is checked once, by :func:`validate`. Training validity does
not constrain inference: any fitted machine serves under any plan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet

# (config, X, y, basis, beta0, *, plan, CW) -> (state, FitResult)
SolverFn = Callable
# (config, state) -> repro_torch.api.infer.DecisionSpec
DecisionSpecFn = Callable
# (config, X, y, basis, beta0, *, CW) -> TronResult
PlanFn = Callable
# (config, spec, X) -> margins
DecideFn = Callable


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fit: SolverFn
    decision_spec: DecisionSpecFn
    plans: FrozenSet[str]      # execution plans this solver is valid under
    grows: bool = False        # supports partial_fit basis growth


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    name: str
    fit: PlanFn                # run a TRON solve under this plan
    decide: DecideFn           # evaluate o(x) margins under this plan


_SOLVERS: Dict[str, SolverEntry] = {}
_PLANS: Dict[str, PlanEntry] = {}


def register_solver(name: str, *, fit: SolverFn,
                    decision_spec: DecisionSpecFn, plans,
                    grows: bool = False) -> None:
    if name in _SOLVERS:
        raise ValueError(f"solver {name!r} already registered")
    _SOLVERS[name] = SolverEntry(name=name, fit=fit,
                                 decision_spec=decision_spec,
                                 plans=frozenset(plans), grows=grows)


def register_plan(name: str, *, fit: PlanFn, decide: DecideFn) -> None:
    if name in _PLANS:
        raise ValueError(f"plan {name!r} already registered")
    _PLANS[name] = PlanEntry(name=name, fit=fit, decide=decide)


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
        raise KeyError(f"unknown execution plan {name!r}; registered: "
                       f"{available_plans()}")
    return _PLANS[name]


def validate(solver: str, plan: str) -> SolverEntry:
    """Check the (solver, plan) composition; raise a helpful error if bad."""
    entry = get_solver(solver)
    get_plan(plan)
    if plan not in entry.plans:
        raise ValueError(
            f"solver {solver!r} does not support execution plan {plan!r}; "
            f"valid plans for it: {sorted(entry.plans)}")
    return entry
