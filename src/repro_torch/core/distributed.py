"""The fused f/g/Hd closures of the ``otf_shard`` plan, on one GPU.

The counterpart of ``repro.core.distributed.DistributedNystrom
.make_fused_closures`` at p = 1: every product with C = k(X, basis) and
W = k(basis, basis) goes through the fused kernels, so no (n, m) array
ever exists:

* ``fgrad(beta)``: o = C beta and W beta (kmvp_fwd, the basis as X for
  W), f = lam/2 beta^T W beta + sum l(o, y), g = lam W beta + C^T r
  (kmvp_t, r = dl/do), and the Gauss-Newton diagonal D.
* ``hessd(D, d)``: lam W d + C^T (D * C d), two kmvp_fwd and one kmvp_t.

Each f/g or Hd call recomputes the gram tiles three times (C, W's rows,
C^T); with beta (m, K) one pass serves all K one-vs-rest columns. With one
device the reference's psums are the identity; several GPUs come with the
multi-GPU slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.core.formulation import _colsum
from repro_torch.core.losses import Loss
from repro_torch.core.nystrom import KernelSpec
from repro_torch.kernels.ops import otf_kmvp_fwd, otf_kmvp_t


def make_fused_closures(X, y, basis, *, lam: float, loss: Loss,
                        kernel: KernelSpec, policy=None
                        ) -> Tuple[Callable, Callable]:
    """(fgrad, hessd) over X (n, d), y (n,) or (n, K) and basis (m, d),
    with C and W never materialized."""
    kw = dict(kind=kernel.kind, sigma=kernel.sigma, policy=policy)

    def fgrad(beta):
        o = otf_kmvp_fwd(X, basis, beta, **kw)                   # C beta
        Wb = otf_kmvp_fwd(basis, basis, beta, **kw)              # W beta
        f = 0.5 * lam * _colsum(beta * Wb) + _colsum(loss.value(o, y))
        g_loss = otf_kmvp_t(X, basis, loss.grad(o, y), **kw)     # C^T r
        return f, lam * Wb + g_loss, loss.diag(o, y)

    def hessd(D, d):
        o = otf_kmvp_fwd(X, basis, d, **kw)                      # C d
        Wd = otf_kmvp_fwd(basis, basis, d, **kw)                 # W d
        return lam * Wd + otf_kmvp_t(X, basis, D * o, **kw)      # C^T(D o)

    return fgrad, hessd
