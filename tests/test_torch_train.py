"""The port's training path against the JAX reference, on the CPU.

Formulation (4), the fused ``otf_shard`` closures, TRON, and
``KernelMachine.fit`` / ``partial_fit`` under ``local`` and ``otf_shard``
get the same numpy arrays (made from a seed) as the reference and must
agree with it: kernels and objective pieces at the reference's fp32 bar,
TRON's iterates and counters in float64, fits on the objective value and
the scores.

Why fits are compared in fp32 on f and scores, and beta only loosely: two
fp32 TRON solves that round their sums differently walk different CG
paths (a step count or boundary exit flips) and both stop where f no
longer resolves a decrease, some 1e-5 to 6e-4 (relative L2) apart in beta
on these fixtures, while f agrees to 1e-7 and every prediction agrees.
The reference's own plans miss a 1e-4 beta bar against each other for the
same reason (ROADMAP.md §C). The iterates themselves are held at 1e-4 in
float64, where the two solvers take the same steps: same counts, betas
within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelMachine as RefMachine
from repro.api import MachineConfig as RefConfig
from repro.api import available_plans as ref_available_plans
from repro.core import KernelSpec as RefKernel
from repro.core import TronConfig as RefTron
from repro.core import formulation as r_form
from repro.core import losses as r_losses
from repro.core.nystrom import build_C as r_build_C
from repro.core.nystrom import build_W as r_build_W
from repro.core.tron import tron as r_tron
from repro_torch.api import (FitResult, KernelMachine, MachineConfig,
                             available_plans, get_plan, validate)
from repro_torch.api import machine as p_machine
from repro_torch.api.solvers import ovr_classes
from repro_torch.core import formulation as p_form
from repro_torch.core import losses as p_losses
from repro_torch.core.distributed import make_fused_closures
from repro_torch.core.nystrom import KernelSpec
from repro_torch.core.tron import TronConfig, tron as p_tron
from test_torch_common import (LargestTensor, assert_close_fp32, mixture, t,
                               to_np)
from test_tron import quad_problem

PLANS = ["local", "otf_shard"]
N, D, M = 1024, 12, 64                  # tests/test_api.py's fixture shapes
KCLS = 4
# tests/test_api.py's kernel and lam; tests/test_plans.py's tight solve
CFG = RefConfig(kernel=RefKernel("gaussian", sigma=2.0), lam=0.5,
                tron=RefTron(max_iter=300, grad_rtol=1e-6))
F_RTOL = 1e-6          # objective at convergence (measured <= 2e-7)
BETA_FP32_RTOL = 1e-3  # fp32 plateau spread (measured <= 6e-4, see above)
BETA_RTOL = 1e-4       # float64 iterates (measured <= 1e-6)
# a few iterations, where convergence does not matter (memory, files)
FEW = CFG.replace(tron=RefTron(max_iter=3))


def _rel(a, b) -> float:
    a, b = to_np(a), to_np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_config(plan: str, cfg=CFG) -> MachineConfig:
    return MachineConfig.from_dict(cfg.replace(plan=plan).to_dict())


@pytest.fixture(scope="module")
def problems():
    """{"binary": (X, y, Xt, yt, basis), "multiclass": (...)}: 1024 training
    rows, 256 test rows, a 64-point basis drawn from the training rows."""
    out = {}
    X, lab = mixture(N + 256, D, 2, 4, seed=0)
    y = np.where(lab == 0, 1.0, -1.0).astype(np.float32)
    idx = np.random.default_rng(1).choice(N, M, replace=False)
    out["binary"] = (X[:N], y[:N], X[N:], y[N:], X[idx])
    Xm, ym = mixture(N + 256, D, KCLS, 2, seed=2)
    idx = np.random.default_rng(3).choice(N, M, replace=False)
    out["multiclass"] = (Xm[:N], ym[:N], Xm[N:], ym[N:], Xm[idx])
    return out


@pytest.fixture(scope="module")
def ref_fits(problems):
    """The reference's ``local`` fit of each problem."""
    return {which: RefMachine(CFG).fit(jnp.asarray(X), jnp.asarray(y),
                                       jnp.asarray(basis))
            for which, (X, y, _, _, basis) in problems.items()}


def _targets(y) -> np.ndarray:
    """±1 targets: y itself (binary) or its (n, K) one-vs-rest block."""
    if np.issubdtype(y.dtype, np.integer):
        return np.where(y[:, None] == np.arange(KCLS)[None], 1.0,
                        -1.0).astype(np.float32)
    return y


def _blocks(problems, which):
    """(C, W, Y, beta) as numpy fp32 from the reference's builders."""
    X, y, _, _, basis = problems[which]
    kern = RefKernel("gaussian", sigma=2.0)
    C = np.asarray(r_build_C(jnp.asarray(X), jnp.asarray(basis), kern))
    W = np.asarray(r_build_W(jnp.asarray(basis), kern))
    Y = _targets(y)
    rng = np.random.default_rng(4)
    beta = (rng.standard_normal((M,) + Y.shape[1:]) * 0.3).astype(np.float32)
    return C, W, Y, beta


# --------------------------------------------------------- formulation (4)
@pytest.mark.parametrize("which", ["binary", "multiclass"])
@pytest.mark.parametrize("loss", sorted(r_losses.LOSSES))
def test_formulation4_matches_reference(problems, which, loss):
    C, W, Y, beta = _blocks(problems, which)
    d = np.random.default_rng(5).standard_normal(beta.shape).astype(
        np.float32)
    rf = r_form.Formulation4(lam=0.5, loss=r_losses.get_loss(loss))
    pf = p_form.Formulation4(lam=0.5, loss=p_losses.get_loss(loss))
    Cj, Wj, Yj, bj = map(jnp.asarray, (C, W, Y, beta))
    Ct, Wt, Yt, bt = map(t, (C, W, Y, beta))
    assert_close_fp32(pf.outputs(Ct, bt), rf.outputs(Cj, bj))
    assert_close_fp32(pf.value(Ct, Wt, Yt, bt), rf.value(Cj, Wj, Yj, bj))
    f, g, D_ = pf.fgrad(Ct, Wt, Yt, bt)
    fr, gr, Dr = rf.fgrad(Cj, Wj, Yj, bj)
    assert tuple(f.shape) == np.shape(fr) and tuple(g.shape) == beta.shape
    for got, want in ((f, fr), (g, gr), (D_, Dr)):
        assert_close_fp32(got, want)
    assert_close_fp32(pf.hessd(Ct, Wt, D_, t(d)),
                      rf.hessd(Cj, Wj, Dr, jnp.asarray(d)))


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_fused_closures_match_formulation4(problems, which):
    """The otf_shard closures evaluate formulation (4) without C: the same
    f, g, D and Hd as the materialized objective, port and reference."""
    X, _, _, _, basis = problems[which]
    C, W, Y, beta = _blocks(problems, which)
    d = np.random.default_rng(6).standard_normal(beta.shape).astype(
        np.float32)
    loss = p_losses.get_loss("squared_hinge")
    fgrad, hessd = make_fused_closures(t(X), t(Y), t(basis), lam=0.5,
                                       loss=loss,
                                       kernel=KernelSpec("gaussian", 2.0))
    rf = r_form.Formulation4(lam=0.5, loss=r_losses.get_loss("squared_hinge"))
    fr, gr, Dr = rf.fgrad(*map(jnp.asarray, (C, W, Y, beta)))
    f, g, D_ = fgrad(t(beta))
    for got, want in ((f, fr), (g, gr), (D_, Dr)):
        assert_close_fp32(got, want)
    assert_close_fp32(hessd(D_, t(d)), rf.hessd(jnp.asarray(C),
                                                jnp.asarray(W), Dr,
                                                jnp.asarray(d)))


# --------------------------------------------------------------------- TRON
# tests/test_tron.py's problems: (key, m, cond, beta0 fill, TronConfig)
QUADS = {
    "exact": (0, 32, 100.0, 0.0, dict(max_iter=100, grad_rtol=1e-6,
                                      cg_rtol=1e-3, cg_max_iter=200)),
    "monotone": (1, 16, 100.0, 1.0, dict(max_iter=50)),
    "counts": (2, 8, 10.0, 0.0, dict(max_iter=50)),
}


def _quad_solves(case, dtype):
    """(reference result, port result, x_star) on one test_tron.py
    quadratic f = 0.5 x'Hx - b'x, both solvers in ``dtype``."""
    key, m, cond, fill, cfg = QUADS[case]
    H, b = map(np.asarray, quad_problem(jax.random.PRNGKey(key), m=m,
                                        cond=cond))
    H, b = H.astype(dtype), b.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        Hj, bj = jnp.asarray(H), jnp.asarray(b)
        r = r_tron(
            lambda x: (0.5 * x @ (Hj @ x) - bj @ x, Hj @ x - bj,
                       jnp.zeros((), dtype)),
            lambda a, v: Hj @ v, jnp.full((m,), fill, dtype),
            RefTron(**cfg))
        ref = (np.asarray(r.beta), int(r.n_iter), int(r.n_fg),
               int(r.n_hd), bool(r.converged))
    Ht, bt = torch.tensor(H), torch.tensor(b)
    p = p_tron(
        lambda x: (0.5 * x @ (Ht @ x) - bt @ x, Ht @ x - bt,
                   torch.zeros((), dtype=Ht.dtype)),
        lambda a, v: Ht @ v, torch.full((m,), fill, dtype=Ht.dtype),
        TronConfig(**cfg))
    return ref, p, np.linalg.solve(H.astype(np.float64), b)


@pytest.mark.parametrize("case", sorted(QUADS))
def test_tron_matches_reference_on_quadratics(case):
    """In float64 both solvers take the same steps: equal counters and
    iterates. In fp32 both meet test_tron.py's own checks, with equal
    counters where its default tolerance stops well above the fp32 floor
    ("exact" asks for grad_rtol 1e-6, at that floor: the reference stops
    an iteration earlier there)."""
    ref, p, x_star = _quad_solves(case, np.float64)
    assert (p.n_iter, p.n_fg, p.n_hd, bool(p.converged)) == ref[1:]
    assert _rel(p.beta, ref[0]) < 1e-9
    ref, p, x_star = _quad_solves(case, np.float32)
    assert p.beta.dtype == torch.float32
    assert bool(p.converged) and p.n_fg == p.n_iter + 1
    assert p.n_hd >= p.n_iter
    assert _rel(p.beta, ref[0]) < BETA_FP32_RTOL
    if case == "exact":
        np.testing.assert_allclose(to_np(p.beta), x_star, rtol=1e-3,
                                   atol=1e-4)
    else:
        assert (p.n_iter, p.n_fg, p.n_hd, bool(p.converged)) == ref[1:]


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_tron_float64_iterates_match_reference(problems, which):
    """TRON over formulation (4) on the fit fixtures, both packages in
    float64, solved tight: the same outer iterations and f/g calls, betas
    within 1e-4 relative L2 (measured 3e-7 and below). The column-batched
    multiclass solve runs some 100 CG steps in lockstep; CG amplifies the
    two packages' last-bit differences until one column meets its CG
    tolerance a step earlier in one of them, so its Hd count may differ by
    one there (the binary count is held equal)."""
    C, W, Y, _ = (a.astype(np.float64) for a in _blocks(problems, which))
    cfg = dict(max_iter=300, grad_rtol=1e-8)
    shape = (M,) + Y.shape[1:]
    with jax.enable_x64(True):
        rf = r_form.Formulation4(lam=0.5,
                                 loss=r_losses.get_loss("squared_hinge"))
        Cj, Wj, Yj = map(jnp.asarray, (C, W, Y))
        r = r_tron(lambda b: rf.fgrad(Cj, Wj, Yj, b),
                        lambda D_, v: rf.hessd(Cj, Wj, D_, v),
                        jnp.zeros(shape, jnp.float64),
                        RefTron(**cfg))
        ref = (np.asarray(r.beta), np.asarray(r.f), int(r.n_iter),
               int(r.n_fg), int(r.n_hd))
    pf = p_form.Formulation4(lam=0.5, loss=p_losses.get_loss("squared_hinge"))
    Ct, Wt, Yt = map(torch.tensor, (C, W, Y))
    p = p_tron(lambda b: pf.fgrad(Ct, Wt, Yt, b),
                    lambda D_, v: pf.hessd(Ct, Wt, D_, v),
                    torch.zeros(shape, dtype=torch.float64),
                    TronConfig(**cfg))
    assert (p.n_iter, p.n_fg) == ref[2:4]
    if which == "binary":
        assert p.n_hd == ref[4]
    assert bool(torch.all(p.converged))
    assert _rel(p.beta, ref[0]) < BETA_RTOL
    np.testing.assert_allclose(to_np(p.f), ref[1], rtol=1e-10)


# ---------------------------------------------------------------- fit, both
@pytest.mark.parametrize("which", ["binary", "multiclass"])
@pytest.mark.parametrize("plan", PLANS)
def test_fit_matches_reference_local_fit(problems, ref_fits, which, plan):
    X, y, Xt, yt, basis = problems[which]
    ref = ref_fits[which]
    km = KernelMachine(_port_config(plan), device="cpu").fit(X, y, basis)
    res = km.result_
    assert isinstance(res, FitResult) and len(km.history_) == 1
    assert (res.solver, res.plan, res.m) == ("tron", plan, M)
    assert res.n_fg == res.n_iter + 1
    beta = km.state_["beta"]
    assert beta.shape == ref.state_["beta"].shape
    assert beta.dtype == torch.float32 and beta.device.type == "cpu"
    assert abs(res.f - ref.result_.f) <= F_RTOL * abs(ref.result_.f)
    assert _rel(beta, ref.state_["beta"]) < BETA_FP32_RTOL
    np.testing.assert_array_equal(to_np(km.predict(Xt)),
                                  np.asarray(ref.predict(Xt)))
    assert km.score(Xt, yt) == ref.score(Xt, yt) > 0.85
    if which == "multiclass":
        np.testing.assert_array_equal(to_np(km.state_["classes"]),
                                      np.arange(KCLS))
        assert km.state_["classes"].dtype == torch.int32
        assert tuple(res.tron.f.shape) == (KCLS,)


def test_otf_shard_fit_creates_no_n_by_m_tensor(problems):
    """The fused plan's memory contract: no tensor of an otf_shard fit
    reaches n x m elements; the local fit (C stored) is the positive
    control that the probe sees such a tensor."""
    X, y, _, _, basis = problems["multiclass"]
    with LargestTensor() as probe:
        KernelMachine(_port_config("otf_shard", FEW), device="cpu").fit(
            X, y, basis)
    assert probe.largest < N * M, (probe.largest, N * M)
    with LargestTensor() as probe:
        KernelMachine(_port_config("local", FEW), device="cpu").fit(X, y,
                                                                    basis)
    assert probe.largest >= N * M


# ----------------------------------------------------------- partial_fit
def test_partial_fit_local_matches_reference(problems):
    """Stage-wise growth (24 -> 64 points) lands where the reference's
    does, stage by stage, computing only the new columns."""
    X, y, Xt, yt, basis = problems["binary"]
    stages = (basis[:24], basis[24:])
    ref = RefMachine(CFG)
    for part in stages:
        ref.partial_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(part))
    km = KernelMachine(_port_config("local"), device="cpu")
    calls = []
    build_C = p_machine.build_C
    p_machine.build_C = lambda *a, **k: (calls.append(1), build_C(*a, **k))[1]
    try:
        for part in stages:
            km.partial_fit(X, y, part)
    finally:
        p_machine.build_C = build_C
    assert len(calls) == 1                    # the second stage reuses it
    assert tuple(km._cw[0].shape) == (N, M)   # grown from the cached block
    assert [r.m for r in km.history_] == [r.m for r in ref.history_] \
        == [24, 64]
    for got, want in zip(km.history_, ref.history_):
        assert abs(got.f - want.f) <= F_RTOL * abs(want.f)
    assert _rel(km.state_["beta"], ref.state_["beta"]) < BETA_FP32_RTOL
    assert km.score(Xt, yt) == ref.score(Xt, yt)


def test_partial_fit_rebuilds_on_swapped_data_and_warm_starts(problems):
    """Different data of the same shape rebuilds the kernel columns (the
    cache key is a data fingerprint, not the shape); otf_shard keeps no
    cache and re-solves from the warm start; a multiclass beta grows all
    its columns."""
    X, y, _, _, basis = problems["binary"]
    X2, lab2 = mixture(N, D, 2, 4, seed=7)
    y2 = np.where(lab2 == 0, 1.0, -1.0).astype(np.float32)
    km = KernelMachine(_port_config("local"), device="cpu")
    km.partial_fit(X, y, basis[:32]).partial_fit(X2, y2, basis[32:])
    fresh = KernelMachine(_port_config("local"), device="cpu")
    fresh.partial_fit(X, y, basis[:32])
    fresh._cw = fresh._cw_key = None
    fresh.partial_fit(X2, y2, basis[32:])
    assert torch.equal(km.state_["beta"], fresh.state_["beta"])

    otf = KernelMachine(_port_config("otf_shard"), device="cpu")
    otf.partial_fit(X, y, basis[:32]).partial_fit(X, y, basis[32:])
    local = KernelMachine(_port_config("local"), device="cpu")
    local.partial_fit(X, y, basis[:32]).partial_fit(X, y, basis[32:])
    assert otf._cw is None and len(otf.history_) == 2
    assert abs(otf.result_.f - local.result_.f) <= F_RTOL * local.result_.f

    Xm, ym, _, _, bm = problems["multiclass"]
    mc = KernelMachine(_port_config("local"), device="cpu")
    mc.fit(Xm, ym, bm[:40]).partial_fit(Xm, ym, bm[40:])
    assert tuple(mc.state_["beta"].shape) == (M, KCLS)
    assert [r.m for r in mc.history_] == [40, 64]


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_port_fit_checkpoint_loads_in_reference(problems, which, tmp_path):
    X, y, Xt, _, basis = problems[which]
    km = KernelMachine(_port_config("otf_shard", FEW), device="cpu").fit(
        X, y, basis)
    path = str(tmp_path / "port.npz")
    km.save(path)
    back = RefMachine.load(path)
    assert back.config == FEW.replace(plan="otf_shard")
    assert set(back.state_) == set(km.state_)
    for plan in PLANS:
        assert_close_fp32(km.decision_function(Xt, plan=plan),
                          back.decision_function(Xt, plan=plan))
    np.testing.assert_array_equal(to_np(km.predict(Xt)),
                                  np.asarray(back.predict(Xt)))
    from repro_torch.checkpoint import load_arrays
    _, meta = load_arrays(path)
    assert [h["m"] for h in meta["history"]] == [M]
    assert meta["history"][0]["plan"] == "otf_shard"


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_reference_fit_checkpoint_loads_in_port(problems, ref_fits, which,
                                                tmp_path):
    _, _, Xt, yt, _ = problems[which]
    ref = ref_fits[which]
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    km = KernelMachine.load(path, device="cpu")
    for plan in PLANS:
        assert_close_fp32(km.decision_function(Xt, plan=plan),
                          ref.decision_function(Xt, plan=plan))
    assert km.score(Xt, yt) == ref.score(Xt, yt)


# -------------------------------------------------------- entry contracts
def test_registries_match_reference():
    assert available_plans() == sorted(ref_available_plans())
    for name in available_plans():
        entry = get_plan(name)
        assert callable(entry.fit) and callable(entry.decide)
    assert validate("tron", "otf_shard").grows
    with pytest.raises(ValueError, match="does not support execution plan"):
        validate("linearized", "otf_shard")
    with pytest.raises(KeyError, match="unknown solver"):
        validate("rff", "local")


def test_fit_contracts(problems):
    X, y, _, _, basis = problems["binary"]
    small = FEW
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KernelMachine(_port_config("local", small))
    km = KernelMachine(_port_config("local", small), device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        km.fit(X, y, basis, checkpoint=object())
    for plan in ("shard_map", "auto", "otf", "stream"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            KernelMachine(_port_config(plan, small), device="cpu").fit(
                X, y, basis)
    lin = KernelMachine(MachineConfig(solver="linearized"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        lin.fit(X, y, basis)
    with pytest.raises(ValueError, match="stage-wise"):
        lin.partial_fit(X, y, basis)
    with pytest.raises(ValueError, match="shards rows only"):
        KernelMachine(_port_config("otf_shard", small).replace(
            model_axis="model"), device="cpu").fit(X, y, basis)
    Xm, ym, _, _, bm = problems["multiclass"]
    with pytest.raises(ValueError, match="beta0 of shape"):
        km.fit(Xm, ym, bm, beta0=np.zeros((M,), np.float32))
    with pytest.raises(ValueError, match="only one class"):
        ovr_classes(np.zeros(8, np.int32))
    assert ovr_classes(np.where(y > 0, 1, -1).astype(np.int64)) is None
    assert ovr_classes(y) is None
    np.testing.assert_array_equal(ovr_classes(ym), np.arange(KCLS))


def test_fit_selects_a_seeded_basis_when_none_is_given(problems):
    X, y, _, _, _ = problems["binary"]
    cfg = _port_config("local", FEW)
    a = KernelMachine(cfg.replace(m=32, seed=3), device="cpu").fit(X, y)
    b = KernelMachine(cfg.replace(m=32, seed=3), device="cpu").fit(X, y)
    c = KernelMachine(cfg.replace(m=32, seed=4), device="cpu").fit(X, y)
    assert tuple(a.state_["basis"].shape) == (32, D)
    assert torch.equal(a.state_["basis"], b.state_["basis"])
    assert torch.equal(a.state_["beta"], b.state_["beta"])
    assert not torch.equal(a.state_["basis"], c.state_["basis"])
    rows = {tuple(r) for r in X.tolist()}
    assert all(tuple(r) in rows for r in to_np(a.state_["basis"]).tolist())
    with pytest.raises(NotImplementedError, match="basis_strategy"):
        KernelMachine(cfg.replace(basis_strategy="kmeans"),
                      device="cpu").fit(X, y)
