"""Nystrom kernel-matrix pieces (paper §2.1).

``C[i,k] = k(x_i, xb_k)`` (n x m) and ``W[k,l] = k(xb_k, xb_l)`` (m x m).
:func:`gram` goes through :func:`repro_torch.kernels.ops.gram`: the gram
kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Kernel function spec. Gaussian is the paper's main kernel."""

    kind: str = "gaussian"  # gaussian | linear
    sigma: float = 1.0

    def __post_init__(self):
        if self.kind not in ("gaussian", "linear"):
            raise ValueError(f"unknown kernel kind {self.kind!r}")


def sqdist(x, z):
    """Pairwise squared distances ||x_i - z_k||^2, (n, m), by the expansion
    |x|^2 + |z|^2 - 2 x.z clamped at 0 (the reference's arithmetic)."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)          # (n, 1)
    zz = torch.sum(z * z, dim=-1, keepdim=True).T        # (1, m)
    xz = x @ z.T                                         # (n, m)
    return torch.clamp_min(xx + zz - 2.0 * xz, 0.0)


def gram(x, z, kernel: KernelSpec, policy=None):
    """Kernel block k(x_i, z_k), fp32, on the device of ``x``."""
    return ops.gram(x, z, kind=kernel.kind, sigma=kernel.sigma, policy=policy)


def build_C(x, basis, kernel: KernelSpec, policy=None):
    return gram(x, basis, kernel, policy)


def build_W(basis, kernel: KernelSpec, policy=None):
    return gram(basis, basis, kernel, policy)


def predict(x, basis, beta, kernel: KernelSpec):
    """Classifier output o(x) = sum_k beta_k k(x, xb_k)."""
    return build_C(x, basis, kernel) @ beta
