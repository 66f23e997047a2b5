"""Plan-aware inference: the paper's prediction map under each decide arm.

The margin o(x) = k(x, basis)·β is one row of C·β. Each execution plan's
``decide`` arm (registered in :mod:`repro_torch.api.plans`) evaluates it
under its own memory contract, on one device:

* ``local`` — the dense reference: materialize the (n_query, m) gram
  (the gram kernel on a GPU) and contract it with β in fixed-shape
  256-row products, so a row's margin does not depend on its batch.
* fused (``shard_map`` / ``auto`` / ``otf`` / ``otf_shard``) — the fused
  kmvp kernel: no (n_query, m) array ever exists. An (m, K) one-vs-rest β
  rides as K right-hand sides of one pass. Across several GPUs these
  plans shard query rows; the port has one GPU so far.

Queries arrive as host arrays (or tensors) and are moved to the device the
machine's state lives on; margins come back as tensors on that device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.nystrom import KernelSpec, gram
from repro_torch.kernels.gram import BLOCK_ROWS, padded_row_blocks
from repro_torch.kernels.ops import otf_kmvp_fwd


class DecisionSpec(NamedTuple):
    """How a fitted state realizes o(x) = k(x, basis)·β.

    ``basis`` (m, d) and ``beta`` (m,) or (m, K) are tensors on the
    machine's device; ``policy`` names the dtype policy the arms compute
    under (``repro_torch.kernels.policy.POLICIES``).
    """
    basis: Any
    beta: Any
    kernel: KernelSpec
    policy: str = "fp32"


def as_f32(a, device) -> torch.Tensor:
    """An array or tensor as a contiguous fp32 tensor on ``device`` (host
    arrays are copied: a read-only numpy array cannot back a tensor)."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


# ------------------------------------------------------------------- local
def contract_rows(C, beta):
    """C @ beta as products of exactly ``BLOCK_ROWS`` rows each, the last
    block zero-padded (:func:`~repro_torch.kernels.gram.padded_row_blocks`):
    the GPU's matrix products pick their reduction by shape, so a row's
    margin then does not depend on its batch."""
    out = C.new_empty((C.shape[0],) + tuple(beta.shape[1:]))
    for i, rows, c in padded_row_blocks(BLOCK_ROWS, C):
        out[i:i + rows] = (c @ beta)[:rows]
    return out


def decide_local(config, spec: DecisionSpec, X):
    """Dense reference: materialize the query gram, contract it with β in
    fixed-shape row blocks (:func:`contract_rows`)."""
    del config
    C = gram(as_f32(X, spec.basis.device), spec.basis, spec.kernel,
             policy=spec.policy)
    return contract_rows(C, spec.beta)


# ------------------------------------------------------------------ fused
def decide_fused(config, spec: DecisionSpec, X):
    """Margins through the fused kmvp kernel, C never materialized. Any n;
    a row's margin does not depend on the other rows of the batch."""
    del config
    return otf_kmvp_fwd(as_f32(X, spec.basis.device), spec.basis, spec.beta,
                        kind=spec.kernel.kind, sigma=spec.kernel.sigma,
                        policy=spec.policy)


# ------------------------------------------------------- bucketed serving
# Never dispatch a single-row bucket (the reference's rule, kept so both
# packages bucket alike): a one-row product may take another code path
# than multi-row ones and round differently.
MIN_BUCKET = 2


def bucket_rows(n: int, max_batch: int) -> int:
    """Power-of-two batch bucket for ``n`` query rows (floor
    ``MIN_BUCKET``), capped at ``max_batch``."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, max_batch)


def scatter_rows(margins, sizes) -> list:
    """Split a coalesced margin block back into per-request row slices, in
    submission order (the inverse of concatenating the requests' rows)."""
    out, at = [], 0
    for s in sizes:
        out.append(margins[at:at + s])
        at += s
    return out


class BucketedDecider:
    """Bucketed serving over one plan's decide callable.

    ``__call__`` pads a request (or a coalesced multi-request block) with
    zero rows up to its power-of-two bucket, runs the decide arm, and trims
    the padding off, so the device sees at most log2(max_batch)+1 batch
    shapes however many request sizes traffic brings. Oversize inputs split
    into max_batch-row dispatches. PyTorch runs eagerly, so there is
    nothing to compile per bucket; the decider records the bucket shapes it
    has dispatched, and :meth:`warmup` runs each once (first-launch costs
    such as building the kernels and allocator growth are paid there).
    """

    def __init__(self, decide: Callable, max_batch: int = 256):
        self.max_batch = int(max_batch)
        self._decide = decide
        self._buckets = set()

    def __call__(self, X) -> np.ndarray:
        """Margins for ``X`` as a host array, synchronously."""
        X = np.asarray(X)
        n = X.shape[0]
        if n > self.max_batch:          # split oversize (coalesced) blocks
            parts = [self(X[i:i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return np.concatenate(parts)
        b = bucket_rows(n, self.max_batch)
        if b != n:
            Xp = np.zeros((b,) + X.shape[1:], X.dtype)
            Xp[:n] = X
        else:
            Xp = X
        self._buckets.add(b)
        return self._decide(Xp).cpu().numpy()[:n]

    def warmup(self, d: int, dtype=np.float32) -> int:
        """Dispatch every bucket (MIN_BUCKET, 2·MIN_BUCKET, ...,
        max_batch) once for feature dimension ``d``; returns the bucket
        count."""
        b = MIN_BUCKET
        while b < self.max_batch:
            self(np.zeros((b, d), dtype))
            b <<= 1
        self(np.zeros((self.max_batch, d), dtype))
        return self.n_buckets

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)
