"""Execution plans: where a TRON solve runs, and which arm serves margins.

Every plan's ``fit`` arm takes the global problem ``(X, y, basis, beta0)``
(tensors on one device; a one-vs-rest y arrives expanded to (n, K) ±1) plus
a :class:`MachineConfig` and returns a ``TronResult``; its ``decide`` arm
(:mod:`repro_torch.api.infer`) serves o(x) = k(x, basis)·β under the same
memory contract:

* ``local``     — materialized C (n, m) and W (m, m) from the gram kernel,
                  :class:`Formulation4` closures whose products with C and
                  W are plain matrix products (the reference leaves them to
                  XLA as well). Accepts a precomputed ``CW`` (stage-wise
                  growth reuses the columns of C already computed).
                  Decide: :func:`~repro_torch.api.infer.decide_local`.
* ``otf_shard`` — fused on-the-fly: every product with C and W runs
                  through the kmvp_fwd and kmvp_t kernels
                  (:mod:`repro_torch.core.distributed`), so no (n, m) array
                  exists; one GPU so far. Decide:
                  :func:`~repro_torch.api.infer.decide_fused`.
* ``shard_map`` / ``auto`` / ``otf`` — the multi-device plans: they serve
  through the fused arm; their fit arms come with the multi-GPU slice.
* ``stream``    — served through the ``local`` arm, as the reference's
  serving registry does; its out-of-core fit arm comes with the stream
  slice.
"""
from __future__ import annotations

from repro_torch.api.infer import decide_fused, decide_local
from repro_torch.api.registry import register_plan
from repro_torch.core.distributed import make_fused_closures
from repro_torch.core.formulation import Formulation4
from repro_torch.core.nystrom import build_C, build_W
from repro_torch.core.tron import TronResult, tron


def local_closures(config, X, y, basis, CW=None):
    """(fgrad, hessd) of the ``local`` plan over materialized (C, W)."""
    C, W = CW if CW is not None else (
        build_C(X, basis, config.kernel, policy=config.dtype_policy),
        build_W(basis, config.kernel, policy=config.dtype_policy))
    form = Formulation4(lam=config.lam, loss=config.get_loss())
    return (lambda b: form.fgrad(C, W, y, b),
            lambda D, d: form.hessd(C, W, D, d))


def otf_shard_closures(config, X, y, basis):
    """(fgrad, hessd) of the ``otf_shard`` plan: fused kernels, no C."""
    if config.model_axis is not None:
        raise ValueError(
            "plan 'otf_shard' shards rows only: the fused kmvp kernels "
            "contract over all basis columns, so a model_axis column "
            "partition does not apply; set model_axis=None")
    return make_fused_closures(X, y, basis, lam=config.lam,
                               loss=config.get_loss(), kernel=config.kernel,
                               policy=config.dtype_policy)


def plan_local(config, X, y, basis, beta0, *, CW=None) -> TronResult:
    return tron(*local_closures(config, X, y, basis, CW), beta0, config.tron)


def plan_otf_shard(config, X, y, basis, beta0, *, CW=None) -> TronResult:
    del CW  # no (n, m) block exists to cache, let alone (C, W)
    return tron(*otf_shard_closures(config, X, y, basis), beta0,
                config.tron)


def _not_ported(plan: str, item: str):
    def fit(config, X, y, basis, beta0, *, CW=None):
        raise NotImplementedError(
            f"plan {plan!r} does not train in the port yet: its fit arm "
            f"comes with {item} (ROADMAP.md); train with plan 'local' or "
            f"'otf_shard'")
    return fit


register_plan("local", fit=plan_local, decide=decide_local)
register_plan("otf_shard", fit=plan_otf_shard, decide=decide_fused)
for _name in ("shard_map", "auto", "otf"):
    register_plan(_name, fit=_not_ported(_name, "§A item 5, multi-GPU"),
                  decide=decide_fused)
register_plan("stream", fit=_not_ported("stream", "§A item 2, the stream "
                                                  "plan"),
              decide=decide_local)
