"""Shared helpers of the port's tests (``tests/test_torch_*.py``); no tests.

The port's tests hand the same numpy arrays, made from a seed, to the JAX
reference (``repro``) and to the port (``repro_torch``) and compare the
results on the CPU, where every port wrapper runs its kernel's plain
PyTorch version.
"""
import numpy as np
import torch

# The suite runs several pytest workers side by side on one host; keep the
# port's tests from taking every core.
torch.set_num_threads(2)

#: fp32 tolerance of the reference's kernel parity sweeps
#: (tests/conftest.py ``_DTYPE_TOL["float32"]``), not loosened.
FP32_TOL = 2e-4


def to_np(a) -> np.ndarray:
    """A torch tensor (any device) or a jax/numpy array as numpy."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close_fp32(got, want):
    """allclose at the reference's fp32 bar: rtol 2e-4 and atol 2e-4 *
    max(1, max|want|), so unit-range gaussian values and linear-kernel
    values that grow with d share one helper."""
    want = to_np(want)
    scale = float(np.max(np.abs(want))) if want.size else 1.0
    np.testing.assert_allclose(to_np(got), want, rtol=FP32_TOL,
                               atol=FP32_TOL * max(1.0, scale))


def kernel_inputs(n, m, d, k=None, seed=0):
    """x (n, d), z (m, d) and, if ``k`` is given, b (m, k), as fp32 numpy
    arrays from ``seed``; ``k == 0`` gives a 1-D b (m,)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    z = rng.standard_normal((m, d)).astype(np.float32)
    if k is None:
        return x, z
    b = rng.standard_normal((m,) if k == 0 else (m, k)).astype(np.float32)
    return x, z, b


def sigma_for(d: int) -> float:
    """A bandwidth that keeps gaussian values of unit-normal data O(0.1)."""
    return float(np.sqrt(d))


def t(a) -> torch.Tensor:
    """numpy -> CPU torch tensor (a copy, so the reference's array is
    never aliased)."""
    return torch.tensor(np.asarray(a))
