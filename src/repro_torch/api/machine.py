"""`KernelMachine`: the estimator every entry point targets.

    km = KernelMachine(MachineConfig(plan="otf_shard")).fit(X, y, basis)
    km.partial_fit(X, y, more_points)               # plan "local"
    margins = km.decision_function(Xq)
    km.save("machine.npz")
    km = KernelMachine.load("machine.npz")          # on the GPU
    km = KernelMachine.load("machine.npz", device="cpu")

Training runs TRON over formulation (4) under the ``local`` and
``otf_shard`` plans (:mod:`repro_torch.api.plans`); binary float targets
fit one β column, integer labels fit all one-vs-rest columns in one pass.
A machine loads any format-1 checkpoint the reference's
``repro.api.KernelMachine.save`` writes (unquantized), and the reference
loads what :meth:`KernelMachine.save` writes. :meth:`from_reference` takes
a reference machine's config dict and state arrays directly.
"""
from __future__ import annotations

import hashlib
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.api.config import MachineConfig
from repro_torch.api.infer import as_f32
from repro_torch.api.registry import get_plan, get_solver, validate
from repro_torch.api.result import FitResult
from repro_torch.checkpoint import load_arrays, save_checkpoint
from repro_torch.core.nystrom import build_C, build_W, gram

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


def _x_fingerprint(X: torch.Tensor) -> tuple:
    """Cheap dataset identity for the ``local`` plan's (C, W) growth cache.

    Shape alone is not identity — two same-shape datasets must not share
    cached kernel columns — so the key adds dtype and a checksum of a
    strided sample (at most ~8k elements, whatever n·d). A swap to other
    data is caught with near certainty; an in-place edit confined to
    unsampled rows is not (the reference's trade-off, kept)."""
    n, d = map(int, X.shape)
    sample = X[:: max(1, n // 64), :: max(1, d // 8)].contiguous()
    return (n, d, str(X.dtype),
            hashlib.sha1(sample.cpu().numpy().tobytes()).hexdigest())


class KernelMachine:
    """A kernel machine over formulation (4), on one device.

    Attributes set by fitting or loading:
      ``state_``   — flat dict of tensors: {"basis": (m, d), "beta": (m,)
                     or (m, K)} plus ``classes`` (K,) for one-vs-rest
      ``history_`` — one :class:`FitResult` per fit/partial_fit call
      ``result_``  — the latest :class:`FitResult`
    """

    def __init__(self, config: MachineConfig = MachineConfig(), *,
                 device=None):
        validate(config.solver, config.plan)   # fail at construction
        self.config = config
        self.device = resolve_device(device)
        self.state_: Optional[dict] = None
        self.history_: List[FitResult] = []
        self._cw = None          # (C, W) cache for local stage-wise growth
        self._cw_key = None      # data fingerprint the cache was built on

    @classmethod
    def from_reference(cls, config_dict: dict, arrays: dict,
                       device=None) -> "KernelMachine":
        """The port's machine for a reference machine: ``config_dict`` is its
        ``MachineConfig.to_dict()``, ``arrays`` its ``state_`` as numpy
        arrays (``basis``, ``beta``, optional ``classes``)."""
        km = cls(MachineConfig.from_dict(config_dict), device=device)
        km.state_ = _state_tensors(arrays, km.device)
        return km

    # ------------------------------------------------------------------- fit
    @property
    def result_(self) -> Optional[FitResult]:
        return self.history_[-1] if self.history_ else None

    def _select_basis(self, X: torch.Tensor) -> torch.Tensor:
        """``config.m`` rows of X, uniformly without replacement, drawn by
        a ``torch.Generator`` seeded from ``config.seed``. The reference
        draws with ``jax.random`` from the same seed, which the port cannot
        reproduce: the two packages pick different rows. Pass the basis to
        get the same machine from both."""
        strategy = self.config.basis_strategy
        if strategy not in ("random", "auto"):
            raise NotImplementedError(
                f"basis_strategy {strategy!r} comes with core/basis.py "
                f"(ROADMAP.md §A item 6); use 'random' or pass a basis")
        n = X.shape[0]
        if self.config.m > n:
            raise ValueError(f"cannot select m={self.config.m} basis points "
                             f"from {n} rows")
        gen = torch.Generator().manual_seed(self.config.seed)
        idx = torch.randperm(n, generator=gen)[:self.config.m]
        return X[idx.to(X.device)].contiguous()

    def fit(self, X, y, basis=None, *, beta0=None, checkpoint=None):
        """Train from scratch on this machine's device.

        ``y`` holds float ±1 targets (binary) or integer labels: the latter
        train one-vs-rest, all K β columns in ONE column-batched TRON pass,
        and :meth:`predict` then argmaxes back to the labels. ``basis``
        defaults to ``config.m`` rows of X picked at random (see
        :meth:`_select_basis`). ``checkpoint`` (in-training step files)
        comes with the checkpoint slice and raises here.
        """
        entry = validate(self.config.solver, self.config.plan)
        if checkpoint is not None:
            raise NotImplementedError(
                "in-training checkpoints (fit(checkpoint=...)) come with the "
                "checkpoint slice, ROADMAP.md §A item 3")
        X = as_f32(X, self.device)
        if basis is None:
            basis = self._select_basis(X)
        basis = as_f32(basis, self.device)
        if beta0 is not None:
            beta0 = as_f32(beta0, self.device)
        state, res = entry.fit(self.config, X, y, basis, beta0,
                               plan=self.config.plan)
        self.state_ = state
        self.history_ = [res]
        self._cw = self._cw_key = None
        return self

    def partial_fit(self, X, y, new_basis):
        """Stage-wise basis growth (paper §3): add ``new_basis`` points,
        warm-start β (old coordinates kept, new ones zero) and re-solve.

        Under ``local`` only the NEW columns of C (and new blocks of W) are
        computed, keyed on a data fingerprint (shape, dtype and a sampled
        checksum), so different data of the same shape rebuilds the kernel
        columns instead of reusing stale ones. Under ``otf_shard`` nothing
        is cached: it is a warm-started re-solve.
        """
        entry = validate(self.config.solver, self.config.plan)
        if not entry.grows:
            raise ValueError(
                f"solver {self.config.solver!r} does not support stage-wise "
                f"basis growth (partial_fit); use solver='tron'")
        X = as_f32(X, self.device)
        new_basis = as_f32(new_basis, self.device)
        kern, pol = self.config.kernel, self.config.dtype_policy
        local = self.config.plan == "local"
        xkey = _x_fingerprint(X) if local else None

        if self.state_ is None:
            basis = new_basis
            beta0 = None      # the solver picks (m,) or (m, K) zeros
            if local:
                self._cw = (build_C(X, basis, kern, pol),
                            build_W(basis, kern, pol))
                self._cw_key = xkey
        else:
            old_basis, old_beta = self.state_["basis"], self.state_["beta"]
            basis = torch.cat([old_basis, new_basis])
            beta0 = torch.cat([old_beta, old_beta.new_zeros(
                (new_basis.shape[0],) + tuple(old_beta.shape[1:]))])
            if local:
                if self._cw is not None and self._cw_key == xkey:
                    C, W = self._cw          # only new columns/blocks below
                else:                        # fit() first, or swapped data
                    C = build_C(X, old_basis, kern, pol)
                    W = build_W(old_basis, kern, pol)
                C_new = gram(X, new_basis, kern, pol)
                W_cross = gram(old_basis, new_basis, kern, pol)
                W_new = gram(new_basis, new_basis, kern, pol)
                C = torch.cat([C, C_new], dim=1)
                W = torch.cat([torch.cat([W, W_cross], dim=1),
                               torch.cat([W_cross.T, W_new], dim=1)])
                self._cw = (C, W)
                self._cw_key = xkey

        state, res = entry.fit(self.config, X, y, basis, beta0,
                               plan=self.config.plan,
                               CW=self._cw if local else None)
        self.state_ = state
        self.history_.append(res)
        return self

    # --------------------------------------------------------------- predict
    def _require_fitted(self):
        if self.state_ is None:
            raise RuntimeError("KernelMachine is not fitted; call fit(), "
                               "load() or from_reference() first")

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
                "history": [
                    {"solver": r.solver, "plan": r.plan, "m": r.m, "f": r.f,
                     "n_iter": r.n_iter, "converged": r.converged}
                    for r in self.history_]}
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
