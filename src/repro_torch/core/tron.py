"""TRON: trust-region Newton with Steihaug-CG inner solves, in torch.

The solver the paper uses (Lin, Weng & Keerthi, ICML'07; the liblinear
tron.cpp update rules), ported from the reference
(``repro.core.tron.tron`` and ``tron_host``) as one eager loop over device
tensors. It keeps the reference's update rules, stopping tests and
per-column masks, and counts ``n_iter``, ``n_fg`` and ``n_hd`` as the
reference does.

The solver is generic over two closures:
    fgrad(beta)  -> (f, g, aux)   # aux = Gauss-Newton diagonal info
    hessd(aux, d) -> H d
so the same loop runs the ``local`` (materialized C, W) and the
``otf_shard`` (fused kernels) problems.

``beta0`` may be an (m,) vector or an (m, K) block of K independent
problems (one-vs-rest multiclass). Every scalar of the update rules (f,
delta, gnorm, the CG dots) is then a (K,) vector, every branch a
per-column mask, and one fgrad/hessd call serves all columns. Columns that
converge early are frozen by the masks, so lockstep iteration never
changes a column's trajectory against a solo run of that column.

All state stays on the device of ``beta0``, in its dtype (fp32), as in the
reference's traced loop. The host reads one flag per outer and per CG
iteration, to decide whether to go on. The in-training checkpoint hooks
of the reference (``TronSnapshot``, ``state0``, ``snapshot_every``,
``on_snapshot``) come with the checkpoint slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class TronConfig:
    max_iter: int = 200          # outer Newton iterations (paper: N ~ 300)
    grad_rtol: float = 1e-3      # stop when ||g|| <= grad_rtol * ||g0||
    cg_rtol: float = 0.1         # inner CG: ||r|| <= cg_rtol * ||g||
    cg_max_iter: int = 64        # cap on CG steps per outer iteration
    eta0: float = 1e-4           # step acceptance threshold
    eta1: float = 0.25
    eta2: float = 0.75
    sigma1: float = 0.25         # trust-region shrink/grow factors
    sigma2: float = 0.5
    sigma3: float = 4.0


class TronResult(NamedTuple):
    beta: torch.Tensor      # (m,) — or (m, K) for a column-batched solve
    f: torch.Tensor         # scalar — or (K,) per-column objectives
    gnorm: torch.Tensor     # scalar — or (K,)
    n_iter: int             # outer iterations performed
    n_fg: int               # function/gradient evaluations
    n_hd: int               # Hessian-vector products (CG steps)
    converged: torch.Tensor  # scalar bool — or (K,) per column


def _cdot(a, b):
    """Per-column dot: a scalar for (m,) operands, (K,) for (m, K)."""
    if a.dim() == 1:
        return a @ b
    return torch.sum(a * b, dim=0)


def _cnorm(a):
    if a.dim() == 1:
        return torch.linalg.norm(a)
    return torch.sqrt(torch.sum(a * a, dim=0))


def _positive_or_one(a):
    """``a`` where it is > 0, else 1 (a safe divisor)."""
    return torch.where(a > 0, a, torch.ones_like(a))


def _steihaug_cg(g, hvp: Callable, delta, tol, max_iter: int, active):
    """Steihaug-Toint CG: approximately minimize g.s + 0.5 s'Hs with
    ||s|| <= delta. Returns (s, r, steps) with r = -g - H s maintained
    through boundary exits (liblinear trcg semantics), so the caller can
    form the predicted reduction as -0.5 (g.s - s.r).

    Column-batched when g is (m, K): delta and tol are (K,), each step makes
    ONE hvp call on the whole (m, K) direction block, and columns that hit
    the boundary or their tolerance are frozen (direction zeroed) while the
    rest go on. ``active`` masks out columns the outer loop already
    finished.
    """
    s = torch.zeros_like(g)
    r = -g
    d = -g
    rtr = _cdot(g, g)
    it = 0
    while it < max_iter:
        run = active & (torch.sqrt(rtr) > tol)
        if not bool(run.any()):
            break
        d_run = torch.where(run, d, torch.zeros_like(d))
        Hd = hvp(d_run)
        dHd = _cdot(d_run, Hd)
        # negative curvature or a step leaving the region: go to the boundary
        alpha = rtr / _positive_or_one(dHd)
        outside = (_cnorm(s + alpha * d_run) >= delta) | (dHd <= 0)

        # tau >= 0 solving ||s + tau d|| = delta
        sd = _cdot(s, d_run)
        dd = _cdot(d_run, d_run)
        ss = _cdot(s, s)
        rad = torch.sqrt(torch.clamp_min(sd * sd + dd * (delta * delta - ss),
                                         0.0))
        tau = (rad - sd) / _positive_or_one(dd)

        step = torch.where(outside, tau, alpha)
        s = torch.where(run, s + step * d_run, s)
        r_new = torch.where(run, r - step * Hd, r)
        rtr_new = _cdot(r_new, r_new)
        beta_cg = rtr_new / _positive_or_one(rtr)
        d = torch.where(run, r_new + beta_cg * d, d)
        r, rtr = r_new, rtr_new
        active = active & ~(run & outside)
        it += 1
    return s, r, it


def tron(fgrad: Callable, hessd: Callable, beta0: torch.Tensor,
         cfg: TronConfig = TronConfig()) -> TronResult:
    """Minimize f by trust-region Newton-CG. See the module docstring.

    ``beta0`` (m,) runs the classic solver; (m, K) runs K independent
    problems in lockstep, each column with its own f, trust radius and
    convergence.
    """
    beta = beta0
    f, g, aux = fgrad(beta)
    gnorm0 = _cnorm(g)
    delta = gnorm0
    active = gnorm0 > 0
    it, n_fg, n_hd = 0, 1, 0
    while it < cfg.max_iter:
        gnorm = _cnorm(g)
        run = active & (gnorm > cfg.grad_rtol * gnorm0)
        if not bool(run.any()):
            break
        s, r, cg_steps = _steihaug_cg(g, lambda d: hessd(aux, d), delta,
                                      cfg.cg_rtol * gnorm, cfg.cg_max_iter,
                                      run)
        n_hd += cg_steps

        snorm = _cnorm(s)
        gs = _cdot(g, s)
        prered = -0.5 * (gs - _cdot(s, r))

        beta_try = beta + s             # finished columns have s = 0
        f_new, g_new, aux_new = fgrad(beta_try)
        n_fg += 1
        actred = f - f_new

        # liblinear delta-update rules
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0, torch.full_like(denom, cfg.sigma3),
            torch.clamp_min(-0.5 * (gs / torch.where(
                denom == 0, torch.ones_like(denom), denom)), cfg.sigma1))
        if it == 0:     # the first step recalibrates delta to its scale
            delta = torch.minimum(delta, snorm)
        delta_new = torch.where(
            actred < cfg.eta0 * prered,
            torch.minimum(torch.clamp_min(alpha, cfg.sigma1) * snorm,
                          cfg.sigma2 * delta),
            torch.where(
                actred < cfg.eta1 * prered,
                torch.maximum(cfg.sigma1 * delta,
                              torch.minimum(alpha * snorm,
                                            cfg.sigma2 * delta)),
                torch.where(
                    actred < cfg.eta2 * prered,
                    torch.maximum(cfg.sigma1 * delta,
                                  torch.minimum(alpha * snorm,
                                                cfg.sigma3 * delta)),
                    torch.maximum(delta,
                                  torch.minimum(alpha * snorm,
                                                cfg.sigma3 * delta)),
                ),
            ),
        )
        delta = torch.where(run, delta_new, delta)

        # numerical stagnation guards (liblinear): stop on a non-positive
        # predicted reduction, or on |actred| and |prered| vanishing
        # against |f| (the f this iteration started from)
        feps = torch.abs(f) * 1e-12

        accept = (actred > cfg.eta0 * prered) & run
        beta = torch.where(accept, beta_try, beta)
        f = torch.where(accept, f_new, f)
        g = torch.where(accept, g_new, g)
        aux = torch.where(accept, aux_new, aux)

        stagnated = (prered <= 0) | (
            (torch.abs(actred) <= feps) & (torch.abs(prered) <= feps))
        active = active & ~(run & stagnated)
        it += 1
    gnorm = _cnorm(g)
    return TronResult(beta=beta, f=f, gnorm=gnorm, n_iter=it, n_fg=n_fg,
                      n_hd=n_hd, converged=gnorm <= cfg.grad_rtol * gnorm0)
