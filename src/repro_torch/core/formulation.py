"""Formulation (4) of the Nystrom-approximated kernel machine, in torch.

    min_beta  f(beta) = lam/2 * beta^T W beta + sum_i l(c_i beta, y_i)

with gradient      grad = lam * W beta + C^T (dL/do)
and Gauss-Newton   H d  = lam * W d    + C^T D C d .

The local math over explicit (C, W) blocks, as in the reference
(``repro.core.formulation``); the ``otf_shard`` plan evaluates the same
three products without C (:mod:`repro_torch.core.distributed`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.losses import Loss


def _colsum(a):
    """Per-column reduction: a scalar for 1-D, (K,) for (n, K) operands."""
    return torch.sum(a, dim=0)


def _cdot(a, b):
    """Per-column dot: the 1-D dot product for vectors, column sums of
    the elementwise product for (m, K) blocks (the reference's split)."""
    if a.dim() == 1:
        return a @ b
    return torch.sum(a * b, dim=0)


def _ct_v(C, v):
    """C^T v without a transposed copy of C (a transposed view: the matrix
    product reads C in place)."""
    if v.dim() == 1:
        return v @ C
    return C.T @ v


@dataclasses.dataclass(frozen=True)
class Formulation4:
    """f / grad / Hd for formulation (4) given materialized C, W.

    ``fgrad`` returns the Gauss-Newton diagonal D as its ``aux``, so Hd
    does not recompute the outputs (one f/g per TRON iteration, several Hd
    sharing D). Rank-generic over a trailing class axis: beta (m, K) with
    y (n, K) evaluates K one-vs-rest objectives through the same two
    products with C; f becomes a (K,) vector, D an (n, K) block.
    """

    lam: float
    loss: Loss

    def outputs(self, C, beta):
        return C @ beta

    def value(self, C, W, y, beta):
        o = C @ beta
        reg = 0.5 * self.lam * _cdot(beta, W @ beta)
        return reg + _colsum(self.loss.value(o, y))

    def fgrad(self, C, W, y, beta) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
        """Returns (f, grad, D). Cost O(nm[k]): two products with C."""
        o = C @ beta
        Wb = W @ beta
        f = 0.5 * self.lam * _cdot(beta, Wb) \
            + _colsum(self.loss.value(o, y))
        g = self.lam * Wb + _ct_v(C, self.loss.grad(o, y))
        D = self.loss.diag(o, y)
        return f, g, D

    def hessd(self, C, W, D, d) -> torch.Tensor:
        """Gauss-Newton product (lam W + C^T D C) d; O(nm[k])."""
        return self.lam * (W @ d) + _ct_v(C, D * (C @ d))
