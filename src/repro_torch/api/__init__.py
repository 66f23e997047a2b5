"""repro_torch.api — the KernelMachine estimator surface.

A config-driven estimator with two registries: solvers (fit + decision
specs) and execution plans (fit + decide arms). See
repro_torch.api.machine.
"""
from repro_torch.api.config import MachineConfig, StreamConfig
from repro_torch.api.infer import DecisionSpec
from repro_torch.api.machine import KernelMachine
from repro_torch.api.registry import (available_plans, available_solvers,
                                      get_plan, get_solver, validate)
from repro_torch.api.result import FitResult

__all__ = [
    "KernelMachine", "MachineConfig", "StreamConfig", "DecisionSpec",
    "FitResult", "available_plans", "available_solvers", "get_plan",
    "get_solver", "validate",
]
