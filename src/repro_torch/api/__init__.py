"""repro_torch.api — the KernelMachine estimator surface, serving side.

A config-driven estimator with two registries: solvers (decision specs)
and execution plans (decide arms). See repro_torch.api.machine.
"""
from repro_torch.api.config import MachineConfig, StreamConfig
from repro_torch.api.infer import DecisionSpec
from repro_torch.api.machine import KernelMachine
from repro_torch.api.registry import (available_plans, available_solvers,
                                      get_plan, get_solver)

__all__ = [
    "KernelMachine", "MachineConfig", "StreamConfig", "DecisionSpec",
    "available_plans", "available_solvers", "get_plan", "get_solver",
]
