"""The fused kernel matvec: O = k(X, Z) B with k(X, Z) never in memory
(``csrc/kmvp.cu``).

Replaces ``repro/kernels/kmvp.py::kmvp_fwd_pallas`` (the TPU kernel behind
``repro.kernels.ops.kmvp_fwd`` / ``otf_kmvp_fwd``). On an H100 it is bound
by operations (2 n m d fp32 flops of gram tiles on the CUDA cores); its
bytes are X, Z, B in and the (n, k) margins out. See the note at the top
of ``csrc/kmvp.cu`` for the design, and why a row's margin does not depend
on the batch it is computed in.

:func:`kmvp_fwd` is the wrapper: a CUDA tensor launches the kernel, a CPU
tensor takes :func:`kmvp_fwd_plain`, its plain PyTorch version. The
right-hand side is 2-D here, (m, k) with 1 <= k <= 16; the 1-D squeeze
lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import (KINDS, check_operands, gram_plain,
                                      launch_args)

#: Kernel launches so far (the CPU path never counts).
launches = 0

#: Right-hand-side columns the kernel carries (KMAX in csrc/kmvp.cu).
MAX_K = 16


def otf_block_rows(m: int, budget_bytes: int = 1 << 20,
                   itemsize: int = 4) -> int:
    """Row chunk of the plain fused matvec: the (rows, m) gram chunk stays
    under ``budget_bytes``, in multiples of 8 from 8 to 128 rows.

    Unlike the reference (``repro.kernels.ops.otf_block_rows``), the chunk
    is keyed on m alone, never on the row count n: the chunk shape must not
    change with the batch, or a row's margin would change with the bucket
    that carries it.
    """
    by_budget = budget_bytes // (itemsize * max(m, 1))
    return int(min(128, max(8, by_budget // 8 * 8)))


def kmvp_fwd_plain(x, z, b, *, kind: str = "gaussian", sigma: float = 1.0,
                   block_rows: int | None = None):
    """O = k(x, z) @ b in plain PyTorch, ``block_rows`` query rows at a time
    (default :func:`otf_block_rows`).

    Peak transient is one (block_rows, m) gram chunk. Every chunk, the last
    one included, is zero-padded to exactly ``block_rows`` rows, so each
    product has one shape whatever n is: on the CPU a row's margin then
    does not depend on the batch that carries it (matrix products of
    different shapes may round differently).
    """
    n, d = x.shape
    block_rows = block_rows or otf_block_rows(z.shape[0])
    out = torch.empty((n, b.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(0, n, block_rows):
        c = x[i:i + block_rows]
        rows = c.shape[0]
        if rows < block_rows:
            c = torch.cat([c, c.new_zeros((block_rows - rows, d))])
        out[i:i + rows] = (gram_plain(c, z, kind=kind, sigma=sigma) @ b)[:rows]
    return out


def kmvp_fwd(x, z, b, *, kind: str = "gaussian", sigma: float = 1.0,
             block_rows: int | None = None):
    """O = k(x, z) @ b for x (n, d), z (m, d), b (m, k): an (n, k) fp32
    tensor. ``block_rows`` is the row chunk of the plain version on a CPU
    tensor; the kernel's own tiles are fixed in csrc/kmvp.cu."""
    global launches
    device = check_operands("kmvp_fwd", kind, x=x, z=z, b=b)
    n, d = x.shape
    m, k = b.shape
    if z.shape != (m, d):
        raise ValueError(f"kmvp_fwd: shapes disagree: x {tuple(x.shape)}, "
                         f"z {tuple(z.shape)}, b {tuple(b.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kmvp_fwd: {k} right-hand sides; the kernel "
                         f"takes 1 to {MAX_K}")
    if device.type == "cpu":
        return kmvp_fwd_plain(x, z, b, kind=kind, sigma=sigma,
                              block_rows=block_rows)
    lib = _build.load("kmvp")
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    partial = torch.empty((lib.kmvp_fwd_spans(m), n, k), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        (px, pz, pb, po, pp), stream = launch_args(x, z, b, out, partial)
        err = lib.kmvp_fwd_launch(px, pz, pb, po, pp, n, m, d, k,
                                  KINDS[kind], 2.0 * sigma ** 2, stream)
    if err:
        raise RuntimeError(f"kmvp_fwd kernel launch failed: cudaError {err} "
                           f"(n={n}, m={m}, d={d}, k={k})")
    launches += 1
    return out
