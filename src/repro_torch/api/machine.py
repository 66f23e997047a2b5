"""`KernelMachine`: the estimator every entry point targets, serving side.

    km = KernelMachine.load("machine.npz")          # on the GPU
    km = KernelMachine.load("machine.npz", device="cpu")
    margins = km.decision_function(Xq, plan="otf_shard")
    km.save("copy.npz")

A machine loads any format-1 checkpoint the reference's
``repro.api.KernelMachine.save`` writes (unquantized), and the reference
loads what :meth:`KernelMachine.save` writes. :meth:`from_reference` takes
a reference machine's config dict and state arrays directly. ``fit`` and
``partial_fit`` come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.config import MachineConfig
from repro_torch.api.registry import get_plan, get_solver
from repro_torch.checkpoint import load_arrays, save_checkpoint

# solver/plan registration happens on import
import repro_torch.api.plans    # noqa: F401
import repro_torch.api.solvers  # noqa: F401

_CKPT_FORMAT = 1


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``device`` if given, else the GPU. Without a
    GPU and without ``device``, raise rather than quietly run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless asked "
            "otherwise; pass device='cpu' to run the kernels' plain "
            "PyTorch versions on the CPU")
    return torch.device("cuda")


def _state_tensors(arrays, device: torch.device) -> dict:
    """State arrays as tensors on ``device``; floating arrays as fp32 (the
    port computes in fp32), integer ones (``classes``) as they are."""
    state = {}
    for k, v in arrays.items():
        t = torch.tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        state[k] = t.to(device).contiguous()
    return state


class KernelMachine:
    """A fitted kernel machine over formulation (4), served on one device.

    ``state_`` is a flat dict of tensors — {"basis": (m, d), "beta": (m,)
    or (m, K)} plus ``classes`` (K,) for a one-vs-rest machine.
    """

    def __init__(self, config: MachineConfig = MachineConfig(), *,
                 device=None):
        get_solver(config.solver)    # fail at construction on unknown names
        get_plan(config.plan)
        self.config = config
        self.device = resolve_device(device)
        self.state_: Optional[dict] = None

    @classmethod
    def from_reference(cls, config_dict: dict, arrays: dict,
                       device=None) -> "KernelMachine":
        """The port's machine for a reference machine: ``config_dict`` is its
        ``MachineConfig.to_dict()``, ``arrays`` its ``state_`` as numpy
        arrays (``basis``, ``beta``, optional ``classes``)."""
        km = cls(MachineConfig.from_dict(config_dict), device=device)
        km.state_ = _state_tensors(arrays, km.device)
        return km

    # --------------------------------------------------------------- predict
    def _require_fitted(self):
        if self.state_ is None:
            raise RuntimeError("KernelMachine is not fitted; call load() or "
                               "from_reference() first")

    def _spec(self):
        return get_solver(self.config.solver).decision_spec(self.config,
                                                            self.state_)

    def decision_function(self, X, *, plan: Optional[str] = None):
        """Raw margin o(x) through the plan registry's decide arm, as a
        tensor on the machine's device: (n,) for a binary machine, (n, K)
        per-class margins for one-vs-rest. ``plan`` overrides the
        machine's own plan for this evaluation."""
        self._require_fitted()
        entry = get_plan(plan or self.config.plan)
        return entry.decide(self.config, self._spec(), X)

    def _labels(self, o):
        if "classes" in self.state_:
            return self.state_["classes"][torch.argmax(o, dim=-1)]
        return torch.sign(o)

    def predict(self, X, *, plan: Optional[str] = None):
        """±1 signs for a binary machine; original integer labels (argmax
        over the one-vs-rest margins) for a multiclass machine."""
        return self._labels(self.decision_function(X, plan=plan))

    def score(self, X, y, *, plan: Optional[str] = None) -> float:
        """Mean accuracy, as an exact count over n (as the reference)."""
        pred = self.predict(X, plan=plan).cpu().numpy()
        return int(np.sum(pred == np.asarray(y))) / pred.shape[0]

    def decider(self, *, plan: Optional[str] = None) -> Callable:
        """A stable ``X -> margins`` callable bound to one plan's decide
        arm — what a serving loop dispatches per batch bucket."""
        self._require_fitted()
        entry = get_plan(plan or self.config.plan)
        config, spec = self.config, self._spec()

        def decide(X):
            return entry.decide(config, spec, X)

        return decide

    # ------------------------------------------------------------- save/load
    def save(self, path: str):
        """Persist state + config as a format-1 checkpoint (one .npz)."""
        self._require_fitted()
        meta = {"format": _CKPT_FORMAT, "config": self.config.to_dict(),
                "history": []}
        save_checkpoint(path, dict(self.state_), metadata=meta)
        return path

    @classmethod
    def load(cls, path: str, device=None, *,
             policy: Optional[str] = None) -> "KernelMachine":
        """Restore a machine from a checkpoint written by either package.
        ``device`` defaults to the GPU (see :func:`resolve_device`);
        ``policy`` overrides the checkpointed ``dtype_policy``."""
        arrays, meta = load_arrays(path)
        if meta.get("format") != _CKPT_FORMAT:
            raise ValueError(f"{path}: not a KernelMachine checkpoint "
                             f"(format={meta.get('format')!r})")
        if meta.get("quantized"):
            raise NotImplementedError(
                f"{path}: quantized checkpoints load with the checkpoint "
                f"and precision slice of the port (ROADMAP.md)")
        config = MachineConfig.from_dict(meta["config"])
        if policy is not None:
            config = config.replace(dtype_policy=policy)
        km = cls(config, device=device)
        km.state_ = _state_tensors(arrays, km.device)
        return km
