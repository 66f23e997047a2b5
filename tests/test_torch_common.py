"""Shared helpers of the port's tests (``tests/test_torch_*.py``); no tests.

The port's tests hand the same numpy arrays, made from a seed, to the JAX
reference (``repro``) and to the port (``repro_torch``) and compare the
results on the CPU, where every port wrapper runs its kernel's plain
PyTorch version.
"""
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


def mixture(n, d, n_classes, clusters_per_class, seed, margin=1.0):
    """Gaussian-mixture rows and their cluster's class (cluster index mod
    ``n_classes``), fp32 numpy from ``seed``: the geometry of the
    reference's ``repro.data.make_classification`` / ``make_multiclass``
    (class regions interleave, so the boundary is nonlinear)."""
    rng = np.random.default_rng(seed)
    n_clusters = n_classes * clusters_per_class
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * margin
    cls = rng.integers(0, n_clusters, n)
    noise = rng.standard_normal((n, d)).astype(np.float32)
    x = centers[cls] + noise * np.float32(margin * 0.6 + 0.2)
    return x.astype(np.float32), (cls % n_classes).astype(np.int32)


class LargestTensor(TorchDispatchMode):
    """Records the element count of the largest tensor any op creates."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                self.largest = max(self.largest, leaf.numel())
        return out
