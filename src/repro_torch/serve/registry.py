"""Model registry: several KernelMachine checkpoints served side by side.

Each registered model owns its plan-resolved decide arm and its own
:class:`~repro_torch.api.infer.BucketedDecider`; ``warmup()`` runs every
bucket of every model once before traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.api.infer import BucketedDecider
from repro_torch.api.machine import KernelMachine


def serving_plan(km: KernelMachine, plan: Optional[str]) -> str:
    """Which decide arm serves request batches for ``km``: a ``stream``
    machine serves through the dense ``local`` arm unless overridden."""
    plan = plan or km.config.plan
    if plan == "stream":
        plan = "local"
    return plan


def model_dim(km: KernelMachine) -> int:
    """Feature dimension d a machine's requests must carry."""
    return int(km.state_["basis"].shape[1])


@dataclasses.dataclass(frozen=True)
class ServedModel:
    """One registry entry: the machine, its resolved plan, the request
    feature dimension, the margin class count (0 = binary (n,) margins),
    and the bucketed decider all its traffic runs through."""
    name: str
    km: KernelMachine
    plan: str
    d: int
    n_classes: int
    decider: BucketedDecider


class ModelRegistry:
    """Name -> :class:`ServedModel` routing table."""

    def __init__(self, max_batch: int = 256):
        self.max_batch = int(max_batch)
        self._models: Dict[str, ServedModel] = {}
        self._default: Optional[str] = None

    def add(self, name: str, km: KernelMachine, *,
            plan: Optional[str] = None,
            max_batch: Optional[int] = None) -> ServedModel:
        """Register a fitted machine under ``name``. The first registration
        becomes the default route."""
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        if km.state_ is None:
            raise ValueError(f"model {name!r}: machine is not fitted")
        resolved = serving_plan(km, plan)
        beta = km.state_["beta"]
        entry = ServedModel(
            name=name, km=km, plan=resolved, d=model_dim(km),
            n_classes=int(beta.shape[1]) if beta.dim() == 2 else 0,
            decider=BucketedDecider(
                km.decider(plan=resolved),
                max_batch=self.max_batch if max_batch is None else max_batch))
        self._models[name] = entry
        if self._default is None:
            self._default = name
        return entry

    def load(self, name: str, path: str, *, device=None,
             **kwargs) -> ServedModel:
        """Register a checkpoint written by either package's ``save``."""
        return self.add(name, KernelMachine.load(path, device=device),
                        **kwargs)

    def get(self, name: Optional[str] = None) -> ServedModel:
        if name is None:
            if self._default is None:
                raise KeyError("registry is empty")
            name = self._default
        if name not in self._models:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{self.names()}")
        return self._models[name]

    def names(self) -> List[str]:
        return sorted(self._models)

    def warmup(self) -> Dict[str, int]:
        """Run every bucket of every registered model once; returns
        model -> bucket count."""
        return {name: entry.decider.warmup(entry.d)
                for name, entry in sorted(self._models.items())}
