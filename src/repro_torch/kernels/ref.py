"""Plain-torch oracles for the kernels, in fp32. Ground truth for the tests.

Written out independently of the kernels' plain versions
(:func:`repro_torch.kernels.gram.gram_plain`) so a test can hold one
against the other.
"""
from __future__ import annotations

import torch


def gram_ref(x, z, *, kind: str = "gaussian", sigma: float = 1.0):
    """C[i,k] = k(x_i, z_k); fp32 whatever the input dtype."""
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    if kind == "linear":
        return x @ z.T
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    zz = torch.sum(z * z, dim=-1, keepdim=True).T
    d2 = torch.clamp_min(xx + zz - 2.0 * (x @ z.T), 0.0)
    return torch.exp(-d2 / (2.0 * sigma ** 2))


def kmvp_ref(x, z, beta, *, kind: str = "gaussian", sigma: float = 1.0):
    """o = C(x, z) @ beta, materializing C."""
    return gram_ref(x, z, kind=kind, sigma=sigma) @ beta.to(torch.float32)


def kmvp_t_ref(x, z, v, *, kind: str = "gaussian", sigma: float = 1.0):
    """g = C(x, z)^T @ v, materializing C."""
    return gram_ref(x, z, kind=kind, sigma=sigma).T @ v.to(torch.float32)
