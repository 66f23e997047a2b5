"""Public entry points for the kernels: what the rest of the port calls.

The counterpart of ``repro.kernels.ops``, without its TPU-only parts
(sublane/lane padding to block multiples and the ``interpret`` switch): a
CUDA kernel masks its own ragged edges. A CUDA tensor runs the
hand-written kernel; a CPU tensor runs its plain PyTorch version. The
reference's ``backend`` ("jnp" | "pallas") selects nothing here.

Only the fp32 dtype policy is served for now (:func:`require_fp32`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gram as _gram
from repro_torch.kernels import kmvp as _kmvp
from repro_torch.kernels.kmvp import otf_block_rows  # noqa: F401
from repro_torch.kernels.policy import get_policy


def require_fp32(policy) -> None:
    """Raise ``NotImplementedError`` for a bf16/fp16 policy."""
    pol = get_policy(policy)
    if pol.compute != "float32" or pol.accum != "float32":
        raise NotImplementedError(
            f"dtype policy {pol}: the port computes in fp32 only so far; "
            f"bf16/fp16 kernels come with the precision slice (ROADMAP.md)")


def _f32(t):
    return t.to(torch.float32).contiguous()


def _as_cols(v):
    """RHS as a (p, k) column block plus the flag to undo a 1-D squeeze."""
    if v.dim() == 1:
        return v.reshape(-1, 1), True
    return v, False


def gram(x, z, *, kind: str = "gaussian", sigma: float = 1.0, policy=None):
    """C[i,k] = k(x_i, z_k) as an (n, m) fp32 tensor, through the gram
    kernel on a CUDA tensor."""
    require_fp32(policy)
    return _gram.gram(_f32(x), _f32(z), kind=kind, sigma=sigma)


def kmvp_fwd(x, z, beta, *, kind: str = "gaussian", sigma: float = 1.0,
             policy=None):
    """o = k(x, z) @ beta with k(x, z) never materialized.

    ``beta`` may be (m,) or an (m, k) block of right-hand sides; returns
    (n,) or (n, k) to match. A CUDA tensor runs the fused kernel; a CPU
    tensor runs its row-chunked plain version at the default chunk
    (:func:`otf_block_rows`).
    """
    require_fp32(policy)
    b2, squeeze = _as_cols(beta)
    out = _kmvp.kmvp_fwd(_f32(x), _f32(z), _f32(b2), kind=kind, sigma=sigma)
    return out[:, 0] if squeeze else out


def kmvp_fwd_chunked(x, z, beta, *, kind: str = "gaussian",
                     sigma: float = 1.0, block_rows: int | None = None,
                     policy=None):
    """The plain row-chunked o = k(x, z) @ beta on any device: the fused
    kernel's plain version, which ``chip_smoke.py`` holds the kernel
    against on the GPU. Peak transient is one (block_rows, m) gram chunk."""
    require_fp32(policy)
    b2, squeeze = _as_cols(beta)
    out = _kmvp.kmvp_fwd_plain(_f32(x), _f32(z), _f32(b2), kind=kind,
                               sigma=sigma, block_rows=block_rows)
    return out[:, 0] if squeeze else out


def kmvp_t(x, z, v, *, kind: str = "gaussian", sigma: float = 1.0,
           policy=None):
    """g = k(x, z)^T @ v with k(x, z) never materialized.

    ``v`` may be (n,) or an (n, k) block; returns (m,) or (m, k) to match.
    A CUDA tensor runs the kmvp_t kernel; a CPU tensor runs its row-chunked
    plain version at the default chunk (:func:`otf_block_rows`).
    """
    require_fp32(policy)
    v2, squeeze = _as_cols(v)
    out = _kmvp.kmvp_t(_f32(x), _f32(z), _f32(v2), kind=kind, sigma=sigma)
    return out[:, 0] if squeeze else out


def kmvp_t_chunked(x, z, v, *, kind: str = "gaussian", sigma: float = 1.0,
                   block_rows: int | None = None, policy=None):
    """The plain row-chunked g = k(x, z)^T @ v on any device: the kmvp_t
    kernel's plain version. Peak transient is one (block_rows, m) gram
    chunk; chunks are summed in row order."""
    require_fp32(policy)
    v2, squeeze = _as_cols(v)
    out = _kmvp.kmvp_t_plain(_f32(x), _f32(z), _f32(v2), kind=kind,
                             sigma=sigma, block_rows=block_rows)
    return out[:, 0] if squeeze else out


#: The reference's dispatcher names (``repro.kernels.ops.otf_kmvp_fwd``,
#: ``otf_kmvp_t``); their ``backend`` choice does not exist in the port, so
#: they are :func:`kmvp_fwd` and :func:`kmvp_t`.
otf_kmvp_fwd = kmvp_fwd
otf_kmvp_t = kmvp_t
