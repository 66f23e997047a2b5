"""Loss functions for kernel machines (paper §2, §3), in torch.

Each loss provides value / derivative / (pseudo-)Hessian diagonal,
elementwise over the margin vector ``o = C beta``: squared hinge -> SVM
(the paper's main loss), logistic -> kernel logistic regression, squared
-> kernel ridge regression. The registry names match the reference's, so
``MachineConfig.loss`` validates the same strings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    """Differentiable loss l(o, y) with elementwise value/grad/diag."""

    name: str
    value: Callable  # (o, y) -> per-example loss
    grad: Callable   # (o, y) -> dl/do
    diag: Callable   # (o, y) -> d^2 l/do^2  (Gauss-Newton diagonal D)


def _sqhinge_value(o, y):
    return 0.5 * torch.square(torch.clamp_min(1.0 - y * o, 0.0))


def _sqhinge_grad(o, y):
    return torch.where((1.0 - y * o) > 0.0, o - y, torch.zeros_like(o))


def _sqhinge_diag(o, y):
    return ((1.0 - y * o) > 0.0).to(o.dtype)


def _sigmoid_neg_margin(o, y):
    """sigmoid(-y o), computed without overflow on either side."""
    return torch.sigmoid(-y * o)


def _logistic_value(o, y):
    return torch.nn.functional.softplus(-y * o)   # log(1 + exp(-y o))


def _logistic_grad(o, y):
    return -y * _sigmoid_neg_margin(o, y)


def _logistic_diag(o, y):
    s = _sigmoid_neg_margin(o, y)
    return s * (1.0 - s)


def _squared_value(o, y):
    return 0.5 * torch.square(o - y)


def _squared_grad(o, y):
    return o - y


def _squared_diag(o, y):
    return torch.ones_like(o)


SQUARED_HINGE = Loss("squared_hinge", _sqhinge_value, _sqhinge_grad,
                     _sqhinge_diag)
LOGISTIC = Loss("logistic", _logistic_value, _logistic_grad, _logistic_diag)
SQUARED = Loss("squared", _squared_value, _squared_grad, _squared_diag)

LOSSES = {l.name: l for l in (SQUARED_HINGE, LOGISTIC, SQUARED)}


def get_loss(name: str) -> Loss:
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]


def register_loss(loss: Loss) -> str:
    """Add a user-built Loss to the registry so name-keyed configs can refer
    to it. Returns the name."""
    existing = LOSSES.get(loss.name)
    if existing is not None and existing is not loss:
        raise ValueError(
            f"a different loss is already registered as {loss.name!r}; "
            f"pick a distinct Loss.name")
    LOSSES[loss.name] = loss
    return loss.name
