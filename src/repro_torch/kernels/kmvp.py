"""The fused kernel matvecs, k(X, Z) never in memory: O = k(X, Z) B
(``csrc/kmvp.cu``) and its adjoint G = k(X, Z)^T V (``csrc/kmvp_t.cu``).

:func:`kmvp_fwd` replaces ``repro/kernels/kmvp.py::kmvp_fwd_pallas`` (the
TPU kernel behind ``repro.kernels.ops.kmvp_fwd`` / ``otf_kmvp_fwd``);
:func:`kmvp_t` replaces ``repro/kernels/kmvp.py::kmvp_t_pallas`` (behind
``repro.kernels.ops.kmvp_t`` / ``otf_kmvp_t``). On an H100 both are bound
by operations, not bytes: 2 n m d fp32 flops of gram tiles plus 2 n m k of
contraction on the CUDA cores, while their bytes are X, Z and the
right-hand side in and an (n, k) or (m, k) block out. See the notes at the
top of ``csrc/kmvp.cu`` and ``csrc/kmvp_t.cu`` for the designs: why a
row's margin does not depend on the batch it is computed in, and why the
adjoint is bitwise the same from run to run.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
PyTorch version (:func:`kmvp_fwd_plain`, :func:`kmvp_t_plain`) on a CPU
tensor. The right-hand side is 2-D here, with 1 <= k <= 16 columns; the
1-D squeeze lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import (KINDS, check_operands, gram_rows,
                                      launch_args, padded_row_blocks)

#: Launches of the kmvp_fwd kernel so far (the CPU path never counts).
launches = 0
#: Launches of the kmvp_t kernel so far (the CPU path never counts).
kmvp_t_launches = 0

#: Right-hand-side columns the kernels carry (KMAX in csrc/kmvp.cu and
#: csrc/kmvp_t.cu).
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
    block_rows = block_rows or otf_block_rows(z.shape[0])
    out = torch.empty((x.shape[0], b.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i, rows, c in padded_row_blocks(block_rows, x):
        out[i:i + rows] = (gram_rows(c, z, kind=kind, sigma=sigma) @ b)[:rows]
    return out


def kmvp_fwd(x, z, b, *, kind: str = "gaussian", sigma: float = 1.0):
    """O = k(x, z) @ b for x (n, d), z (m, d), b (m, k): an (n, k) fp32
    tensor. A CPU tensor takes :func:`kmvp_fwd_plain` at its default row
    chunk; the kernel's own tiles and spans are fixed in csrc/kmvp.cu."""
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
        return kmvp_fwd_plain(x, z, b, kind=kind, sigma=sigma)
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


def kmvp_t_plain(x, z, v, *, kind: str = "gaussian", sigma: float = 1.0,
                 block_rows: int | None = None):
    """G = k(x, z)^T @ v in plain PyTorch, ``block_rows`` rows of x at a
    time (default :func:`otf_block_rows`), accumulated in row order.

    Peak transient is one (block_rows, m) gram chunk. Every chunk, the last
    one included, is zero-padded to exactly ``block_rows`` rows; the padded
    rows of v are zero, so the padded gram rows (nonzero for a gaussian
    kernel) add nothing.
    """
    block_rows = block_rows or otf_block_rows(z.shape[0])
    out = torch.zeros((z.shape[0], v.shape[1]), dtype=torch.float32,
                      device=x.device)
    for _, _, c, vc in padded_row_blocks(block_rows, x, v):
        out += gram_rows(c, z, kind=kind, sigma=sigma).T @ vc
    return out


def kmvp_t(x, z, v, *, kind: str = "gaussian", sigma: float = 1.0):
    """G = k(x, z)^T @ v for x (n, d), z (m, d), v (n, k): an (m, k) fp32
    tensor. A CPU tensor takes :func:`kmvp_t_plain` at its default row
    chunk; the kernel's own tiles and spans are fixed in csrc/kmvp_t.cu."""
    global kmvp_t_launches
    device = check_operands("kmvp_t", kind, x=x, z=z, v=v)
    n, d = x.shape
    m = z.shape[0]
    k = v.shape[1]
    if z.shape[1] != d or v.shape[0] != n:
        raise ValueError(f"kmvp_t: shapes disagree: x {tuple(x.shape)}, "
                         f"z {tuple(z.shape)}, v {tuple(v.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kmvp_t: {k} right-hand sides; the kernel "
                         f"takes 1 to {MAX_K}")
    if device.type == "cpu":
        return kmvp_t_plain(x, z, v, kind=kind, sigma=sigma)
    if n == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=device)
    lib = _build.load("kmvp_t")
    out = torch.empty((m, k), dtype=torch.float32, device=device)
    partial = torch.empty((lib.kmvp_t_spans(n), m, k), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        (px, pz, pv, po, pp), stream = launch_args(x, z, v, out, partial)
        err = lib.kmvp_t_launch(px, pz, pv, po, pp, n, m, d, k, KINDS[kind],
                                2.0 * sigma ** 2, stream)
    if err:
        raise RuntimeError(f"kmvp_t kernel launch failed: cudaError {err} "
                           f"(n={n}, m={m}, d={d}, k={k})")
    kmvp_t_launches += 1
    return out
