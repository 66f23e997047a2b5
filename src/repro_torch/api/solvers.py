"""Solvers: each optimization strategy behind one fit contract.

    fit(config, X, y, basis, beta0, *, plan, CW=None) -> (state, FitResult)

``state`` is a flat dict of tensors — what predict needs and what goes
through the checkpoint on save/load: {"basis": (m, d), "beta": (m,) or
(m, K)}, plus ``classes`` (K,) for a one-vs-rest machine. ``tron`` (the
paper's solver) trains under ``local`` and ``otf_shard`` so far; it is
declared valid under every plan, as in the reference, and the plans whose
fit arm is not ported raise. ``linearized`` serves (both store a point
basis, so both serve through :func:`_spec_nystrom`); its fit, and the
``rff`` and ``ppacksvm`` solvers, come with the solvers slice
(ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.infer import DecisionSpec
from repro_torch.api.registry import get_plan, register_solver
from repro_torch.api.result import FitResult


def _host(a) -> np.ndarray:
    """Labels as a host numpy array, whatever device they arrived on."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _zeros_like_beta(X, m, beta0):
    return torch.zeros((m,), dtype=X.dtype, device=X.device) \
        if beta0 is None else beta0


def _ovr_targets(y, classes) -> np.ndarray:
    """One-vs-rest targets: (n,) labels -> (n, K) ±1 fp32 columns; column
    k is "class ``classes[k]`` vs rest" (``repro.data.chunks.ovr_targets``).
    """
    return np.where(y[:, None] == classes[None, :], 1.0, -1.0).astype(
        np.float32)


# ----------------------------------------------------------- one-vs-rest
def ovr_classes(y):
    """Distinct labels when ``y`` poses an integer one-vs-rest problem,
    else None.

    The reference's rule: an integer label vector means multiclass
    one-vs-rest (each class gets a beta column, trained in ONE
    column-batched TRON pass); float targets mean the binary (or
    regression) problem. Integer ±1 labels keep their binary meaning.
    """
    if y is None:
        return None
    yn = _host(y)
    if yn.ndim != 1 or not np.issubdtype(yn.dtype, np.integer):
        return None
    labels = np.unique(yn)
    if set(labels.tolist()) <= {-1, 1}:
        return None                       # integer ±1 is the binary problem
    if labels.size < 2:
        raise ValueError(
            f"integer labels pose a one-vs-rest problem but only one class "
            f"is present: {labels}; pass float ±1 targets for a binary fit")
    return labels


# ------------------------------------------------------------ decision specs
def _spec_nystrom(config, state) -> DecisionSpec:
    """o(x) = k(x, basis)·β over the stored point basis."""
    return DecisionSpec(basis=state["basis"], beta=state["beta"],
                        kernel=config.kernel, policy=config.dtype_policy)


# -------------------------------------------------------------------- solvers
def fit_tron(config, X, y, basis, beta0=None, *, plan=None, CW=None):
    """Formulation (4) + trust-region Newton — the paper's solver.

    ``X`` (n, d) and ``basis`` (m, d) are fp32 tensors on one device; ``y``
    holds labels (numpy or torch, any device). Integer multiclass ``y``
    (see :func:`ovr_classes`) trains all K one-vs-rest columns in ONE
    column-batched TRON pass: beta is (m, K) and, under ``otf_shard``,
    each f/g/Hd call recomputes the gram tiles once for all K classes. The
    fitted state then carries ``classes`` so predict can argmax back to
    labels.
    """
    plan = plan or config.plan
    classes = ovr_classes(y)
    m = int(basis.shape[0])
    if classes is None:
        beta0 = _zeros_like_beta(X, m, beta0)
        y_fit = torch.as_tensor(_host(y), dtype=X.dtype, device=X.device)
        res = get_plan(plan).fit(config, X, y_fit, basis, beta0, CW=CW)
        state = {"basis": basis, "beta": res.beta}
    else:
        K = int(classes.size)
        if beta0 is None:
            beta0 = torch.zeros((m, K), dtype=X.dtype, device=X.device)
        elif tuple(beta0.shape) != (m, K):
            raise ValueError(
                f"one-vs-rest fit over {K} classes needs beta0 of shape "
                f"({m}, {K}); got {tuple(beta0.shape)}")
        y_fit = torch.as_tensor(_ovr_targets(_host(y), classes),
                                device=X.device)
        res = get_plan(plan).fit(config, X, y_fit, basis, beta0, CW=CW)
        # int32, as the reference stores them (jax's default integer)
        state = {"basis": basis, "beta": res.beta,
                 "classes": torch.as_tensor(classes.astype(np.int32),
                                            device=X.device)}
    return state, FitResult.from_tron(res, solver="tron", plan=plan, m=m)


def _fit_not_ported(config, X, y, basis, beta0=None, *, plan=None, CW=None):
    raise NotImplementedError(
        f"solver {config.solver!r} does not train in the port yet: its fit "
        f"comes with §A item 6, the other solvers (ROADMAP.md); train with "
        f"solver 'tron'")


register_solver("tron", fit=fit_tron, decision_spec=_spec_nystrom,
                plans={"local", "shard_map", "auto", "otf", "otf_shard",
                       "stream"},
                grows=True)
register_solver("linearized", fit=_fit_not_ported,
                decision_spec=_spec_nystrom, plans={"local"})
