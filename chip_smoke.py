#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, in order; any failure raises and exits nonzero:

1. device  — require CUDA (there is no CPU path), print the card's name and
             power limit, turn TF32 off (the port's fp32 is IEEE fp32).
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — gram and kmvp_fwd against their plain PyTorch versions on the
             card, at the serving path's shapes and a ragged one (their
             training shapes in phases 6 and 7), at the
             reference's fp32 bar (rtol 2e-4, atol 2e-4 * max(1,
             max|want|)); times of the kernel, its plain version and a
             library yardstick, beside the card's bound for the same work.
4. serve   — an MNIST8m-shaped one-vs-rest machine (d = 784, sigma = 7.0,
             m = 16384 basis points, K = 10 classes; seeded random basis and
             weights) is saved, loaded and served by
             ``repro_torch.launch.kernel_serve``'s serial path under the
             ``local`` (gram kernel) and ``otf_shard`` (fused kmvp kernel)
             plans, and scores a 10,000-row test set under both. A row's
             margin must be bitwise the same alone and in a 256-row bucket
             under both plans.
5. train   — ``KernelMachine.fit`` at the same widths (lam = 8, squared
             hinge, K = 10 one-vs-rest) on n = 65536 MNIST-like rows drawn
             around 10 seeded prototypes and labelled by the nearest, three
             TRON iterations, under ``local`` (gram kernel, C and W stored) and
             ``otf_shard`` (kmvp_fwd and kmvp_t, C never stored). The two
             betas agree within 1e-4 relative (the reference's otf_shard vs
             local bar), a second fit of each is bitwise the same, each
             plan's f matches a float64 re-evaluation on the host within
             1e-4; ms per f/g and per Hd call, wall time and peak bytes.
             The otf_shard machine is then served by ``kernel_serve``.
6. large   — an ``otf_shard`` fit at n = 2,097,152 rows, whose C (137 GB)
             exceeds the card's memory, in under a quarter of C's bytes;
             then kmvp_fwd and kmvp_t at that n against their plain
             versions on the last 5,000 rows (the largest row indices).
7. shapes  — gram at the fits' C (65536, 16384, 784) and W (16384, 16384,
             784), kmvp_fwd at (65536, 16384, 784) with k in {1, 10} and at
             W's rows, against their plain versions; the times of the
             ``local`` plan's C and W builds and of kmvp_fwd there.
8. kmvp_t  — the kmvp_t kernel against its plain version at (256 | 10000 |
             65536, 16384, 784) with k in {1, 10, 16} and at (37, 300, 54),
             the adjoint identity <C b, v> = <b, C^T v>, a run-to-run
             bitwise check, and its times.
9. report  — one JSON line ``{"train": ...}``, one ``{"kernels": [...]}``
             (launches by path: each path's counters are zeroed just before
             it runs and read just after), then the last line
             ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.api import KernelMachine, MachineConfig  # noqa: E402
from repro_torch.api import plans as plans_mod  # noqa: E402
from repro_torch.core import KernelSpec, TronConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gram as gram_mod  # noqa: E402
from repro_torch.kernels import kmvp as kmvp_mod  # noqa: E402
from repro_torch.launch import kernel_serve  # noqa: E402

SEED = 0
D, SIGMA, M, K = 784, 7.0, 16384, 10     # repro/data/synthetic.py mnist8m
LAM = 8.0                                # its lam
N_TEST = 10_000                          # its n_test
N_TRAIN = 65_536                         # training rows of the fits
N_LARGE = 2_097_152                      # rows whose C exceeds the card
LARGE_TAIL = 5_000                       # its last rows, checked
TRAIN_ITERS, LARGE_ITERS = 3, 2          # TRON outer iterations
MAX_BATCH, REQUESTS = 256, 64
FP32_TOL = 2e-4                          # tests/conftest.py _DTYPE_TOL fp32
BETA_RTOL = 1e-4                         # tests/test_plans.py otf_shard bar
F_RTOL = 1e-4                            # f against its float64 re-evaluation
# H100 SXM data sheet: fp32 on the CUDA cores (no tensor cores), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

#: launch counts by path: each path's counters zeroed before it, read after
BY_PATH: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Assert the fp32 bar; return the max absolute error. Compares in
    blocks of rows, so a full training-shape C is checked in place."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    atol = FP32_TOL * max(1.0, float(want.abs().max()))
    worst = excess = float("-inf")
    for i in range(0, got.shape[0], 4096):
        g, w = got[i:i + 4096].double(), want[i:i + 4096].double()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite values")
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        excess = max(excess,
                     float((err - (atol + FP32_TOL * w.abs())).max()))
    log(f"[check] {name}: max_abs_err={worst:.3e} atol={atol:.3e} "
        f"rtol={FP32_TOL:g} {'OK' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        raise AssertionError(f"{name}: outside the fp32 bar by {excess:.3e}")
    return worst


def time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after a warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: flops at the fp32 peak or bytes
    at the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mnist_like(rng: np.random.Generator, n: int) -> np.ndarray:
    """Rows shaped like MNIST digits: about 19% of the 784 pixels inked,
    intensities in [0, 1). At sigma = 7 their gaussian kernel values are
    O(0.4), so the comparisons below are not vacuous."""
    x = rng.random((n, D), dtype=np.float32)
    x *= rng.random((n, D), dtype=np.float32) < 0.19
    return x


def digits_like(gen: torch.Generator, P: torch.Tensor, n: int):
    """n MNIST-like rows drawn around K prototypes (rows of P), on P's
    device: each row keeps about 80% of one prototype's ink and gains stray
    ink on 5% of its pixels, so rows of one prototype sit closer together
    than rows of two. Returns (rows, labels): each row's label is its
    nearest prototype (a planted rule the fits can learn)."""
    dev = P.device
    cls = torch.randint(0, P.shape[0], (n,), generator=gen, device=dev)
    X = P[cls]
    X *= torch.rand((n, D), generator=gen, device=dev) < 0.8
    stray = torch.rand((n, D), generator=gen, device=dev)
    stray *= torch.rand((n, D), generator=gen, device=dev) < 0.05
    X += stray
    del stray
    pp = (P * P).sum(1)
    labels = torch.cat([torch.argmin(pp - 2.0 * X[i:i + (1 << 16)] @ P.T,
                                     dim=1)
                        for i in range(0, n, 1 << 16)])
    return X, labels


def zero_counts() -> None:
    gram_mod.launches = kmvp_mod.launches = kmvp_mod.kmvp_t_launches = 0


def read_counts(path: str) -> dict:
    counts = {"gram": gram_mod.launches, "kmvp_fwd": kmvp_mod.launches,
              "kmvp_t": kmvp_mod.kmvp_t_launches}
    BY_PATH[path] = counts
    log(f"[count] launches on the {path} path: {counts}")
    return counts


def require_launched(path: str, counts: dict, launched, idle=()) -> None:
    """Each kernel in ``launched`` ran on the path; none in ``idle`` did."""
    missing = [k for k in launched if counts[k] < 1]
    extra = [k for k in idle if counts[k] > 0]
    if missing or extra:
        raise AssertionError(f"{path}: kernels never launched {missing}, "
                             f"launched off their path {extra}: {counts}")


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; it has no "
                           "CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    log(f"[device] {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    out = _build.build()
    log(f"[build] {out} in {time.perf_counter() - t0:.2f}s")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    if _build.load("kmvp").kmvp_fwd_max_k() != kmvp_mod.MAX_K:
        raise AssertionError("csrc/kmvp.cu KMAX != kmvp.MAX_K")
    if _build.load("kmvp_t").kmvp_t_max_k() != kmvp_mod.MAX_K:
        raise AssertionError("csrc/kmvp_t.cu KMAX != kmvp.MAX_K")


def phase_kernels(smi: str, X, Z, B) -> dict:
    """Each kernel against its plain version; returns the report entries
    (at the 10,000-row test-set shape, the serving path's largest call;
    phase_train_shapes adds the times at the training shape)."""
    rng = np.random.default_rng(SEED + 1)
    xr = torch.tensor(rng.standard_normal((37, 54)), dtype=torch.float32,
                      device="cuda")
    zr = torch.tensor(rng.standard_normal((300, 54)), dtype=torch.float32,
                      device="cuda")
    br = torch.tensor(rng.standard_normal((300, K)), dtype=torch.float32,
                      device="cuda")
    cases = [(X[:MAX_BATCH], Z, B, SIGMA), (X, Z, B, SIGMA),
             (xr, zr, br, float(np.sqrt(54)))]
    report = {}
    for x, z, b, sigma in cases:
        n, d = x.shape
        m = z.shape[0]
        kw = dict(kind="gaussian", sigma=sigma)
        tag = f"n={n} m={m} d={d}"
        g_err = check_close(f"gram {tag}", gram_mod.gram(x, z, **kw),
                            gram_mod.gram_plain(x, z, **kw))
        check_close(f"gram linear {tag}",
                    gram_mod.gram(x, z, kind="linear"),
                    gram_mod.gram_plain(x, z, kind="linear"))
        k_err = {}
        for k in (1, K):
            bk = b[:, :k].contiguous()
            k_err[k] = check_close(
                f"kmvp_fwd k={k} {tag}",
                kmvp_mod.kmvp_fwd(x, z, bk, **kw),
                kmvp_mod.kmvp_fwd_plain(x, z, bk, **kw))
        if d != D:
            continue                      # the ragged case is checked only
        norms = 2.0 * (n + m) * d
        g_ms = time_ms(lambda: gram_mod.gram(x, z, **kw))
        g_plain = time_ms(lambda: gram_mod.gram_plain(x, z, **kw))
        g_lib = time_ms(lambda: torch.cdist(x, z))
        g_bound, g_by = bound_ms(2.0 * n * m * d + norms,
                                 4.0 * (n * d + m * d + n * m))
        k_ms = time_ms(lambda: kmvp_mod.kmvp_fwd(x, z, b, **kw))
        k_plain = time_ms(lambda: kmvp_mod.kmvp_fwd_plain(x, z, b, **kw))
        k_lib = time_ms(lambda: torch.exp(
            torch.cdist(x, z).square_().div_(-2.0 * sigma ** 2)) @ b)
        k_bound, k_by = bound_ms(2.0 * n * m * d + norms + 2.0 * n * m * K,
                                 4.0 * (n * d + m * d + m * K + n * K))
        for name, ms, plain, lib, bnd in (
                ("gram", g_ms, g_plain, g_lib, g_bound),
                ("kmvp_fwd", k_ms, k_plain, k_lib, k_bound)):
            log(f"[time ] {name} {tag}: kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, library {lib:.3f} ms, bound {bnd:.3f} ms "
                f"({bnd / ms:.1%} of bound) [{smi}]")
        report = {
            "gram": dict(
                name="gram", route="cuda",
                source="src/repro_torch/kernels/csrc/gram.cu",
                replaces="src/repro/kernels/gram.py:60",
                max_abs_err=g_err, tolerance=FP32_TOL, ms=g_ms,
                plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by,
                library_ms=g_lib, library="torch.cdist (distances only)",
                shape=[n, m, d]),
            "kmvp_fwd": dict(
                name="kmvp_fwd", route="cuda",
                source="src/repro_torch/kernels/csrc/kmvp.cu",
                replaces="src/repro/kernels/kmvp.py:141",
                max_abs_err=k_err[K], tolerance=FP32_TOL, ms=k_ms,
                plain_ms=k_plain, bound_ms=k_bound, bound_by=k_by,
                library_ms=k_lib,
                library="exp(-cdist^2/2sigma^2) @ B (materializes C: not "
                        "the same function)",
                shape=[n, m, d, K]),
        }
    return report


def phase_serve(X, basis_np, beta_np, Xq_np) -> dict:
    """Save, load and serve the MNIST8m-shaped machine under both plans,
    with the launch counters zeroed just before and read just after."""
    config = MachineConfig(kernel=KernelSpec("gaussian", sigma=SIGMA),
                           lam=8.0, plan="local")
    km = KernelMachine.from_reference(
        config.to_dict(), {"basis": basis_np, "beta": beta_np,
                           "classes": np.arange(K, dtype=np.int32)})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mnist8m_shaped.npz")
        km.save(path)
        km = KernelMachine.load(path)       # the GPU by default
    torch.cuda.synchronize()

    zero_counts()
    served, scored = {}, {}
    for plan in ("local", "otf_shard"):
        endpoint, stats = kernel_serve.serve_stream(
            km, requests=REQUESTS, max_batch=MAX_BATCH, seed=SEED, plan=plan)
        log(f"[serve] {plan}: {json.dumps(stats)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = km.decision_function(X, plan=plan)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[score] {plan}: {N_TEST} rows in {dt * 1e3:.2f} ms "
            f"({N_TEST / dt:.0f} rows/s)")
        served[plan], scored[plan] = (endpoint, stats), o
    require_launched("serve", read_counts("serve"), ("gram", "kmvp_fwd"),
                     idle=("kmvp_t",))

    # --- checks (launches from here on are not counted) ---
    o_local, o_fused = scored["local"], scored["otf_shard"]
    if o_local.shape != (N_TEST, K):
        raise AssertionError(f"margins shape {tuple(o_local.shape)}")
    check_close("score otf_shard vs local", o_fused, o_local)
    # an independent float64 oracle on the host, for the first MAX_BATCH
    # (256) rows
    x64, z64 = Xq_np.astype(np.float64), basis_np.astype(np.float64)
    d2 = ((x64 * x64).sum(1)[:, None] + (z64 * z64).sum(1)[None, :]
          - 2.0 * x64 @ z64.T)
    want = np.exp(-np.maximum(d2, 0.0) / (2.0 * SIGMA ** 2)) @ beta_np
    for plan in ("local", "otf_shard"):
        check_close(f"score {plan} vs float64 host oracle",
                    scored[plan][:Xq_np.shape[0]].cpu(),
                    torch.tensor(want))
    if not np.isin(km.predict(X).cpu().numpy(), np.arange(K)).all():
        raise AssertionError("predict returned labels outside the classes")

    for plan in ("local", "otf_shard"):
        check_served(km, served[plan][0], Xq_np, plan)
    return {p: s for p, (_, s) in served.items()}


def check_served(km, endpoint, Xq_np, plan: str) -> None:
    """Served margins are bitwise decision_function's, and a row's margin
    is bitwise the same alone and inside a MAX_BATCH-row bucket."""
    for rows in (37, MAX_BATCH):
        got = endpoint(Xq_np[:rows])
        want = km.decision_function(Xq_np[:rows], plan=plan).cpu()
        check_close(f"served vs decision_function {plan} rows={rows}",
                    torch.tensor(got), want)
        if not np.array_equal(got, want.numpy()):
            raise AssertionError(f"{plan}: served margins are not bitwise "
                                 f"decision_function's")
    alone = endpoint(Xq_np[3:4])[0]
    inside = endpoint(Xq_np[:MAX_BATCH])[3]
    same = bool(np.array_equal(alone, inside))
    log(f"[serve] {plan}: row alone == row in a {MAX_BATCH}-row bucket "
        f"bitwise: {same}")
    if not same:
        raise AssertionError(f"{plan}: a row's margin depends on its bucket")


def f_float64(X_np, y_np, basis_np, betas) -> np.ndarray:
    """f of each (m, K) beta in ``betas`` re-evaluated in float64 on the
    host, by its own arithmetic (torch on the CPU, in row blocks): the
    exact distances, the squared hinge and lam/2 beta^T W beta. Returns
    (len(betas), K)."""
    torch.set_num_threads(os.cpu_count() or 1)
    B = torch.tensor(np.concatenate(betas, axis=1), dtype=torch.float64)
    Z = torch.tensor(basis_np, dtype=torch.float64)
    zz = (Z * Z).sum(1)

    def kernel_times_B(rows: torch.Tensor) -> torch.Tensor:
        d2 = (rows * rows).sum(1, keepdim=True) + zz - 2.0 * rows @ Z.T
        return torch.exp(-d2.clamp_min_(0.0) / (2.0 * SIGMA ** 2)) @ B

    reg = torch.zeros(B.shape[1], dtype=torch.float64)
    for i in range(0, Z.shape[0], 4096):
        reg += (B[i:i + 4096] * kernel_times_B(Z[i:i + 4096])).sum(0)
    loss = torch.zeros(B.shape[1], dtype=torch.float64)
    Y = torch.tensor(y_np, dtype=torch.float64).repeat(1, len(betas))
    for i in range(0, X_np.shape[0], 4096):
        o = kernel_times_B(torch.tensor(X_np[i:i + 4096],
                                        dtype=torch.float64))
        loss += (0.5 * (1.0 - Y[i:i + 4096] * o).clamp_min(0.0) ** 2).sum(0)
    return (0.5 * LAM * reg + loss).numpy().reshape(len(betas), -1)


def train_config(plan: str, iters: int) -> MachineConfig:
    """The mnist8m spec's kernel, lam and loss; TRON capped at ``iters``
    outer iterations (grad_rtol far below what three iterations reach, so
    the cap, not convergence, ends both plans' fits alike)."""
    return MachineConfig(kernel=KernelSpec("gaussian", sigma=SIGMA), lam=LAM,
                         loss="squared_hinge", plan=plan,
                         tron=TronConfig(max_iter=iters, grad_rtol=1e-9))


def fit_once(plan: str, iters: int, X, y, basis, path: str):
    """One counted fit: (machine, wall seconds, peak bytes, counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    km = KernelMachine(train_config(plan, iters)).fit(X, y, basis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(path)
    return km, wall, torch.cuda.max_memory_allocated(), counts


def closure_ms(plan: str, X, Y, basis, beta) -> tuple[float, float]:
    """ms per f/g call and per Hd call of ``plan``'s TRON closures at
    ``beta``, by CUDA events (not counted: the fit's counts are read)."""
    config = train_config(plan, TRAIN_ITERS)
    fgrad, hessd = (plans_mod.local_closures(config, X, Y, basis)
                    if plan == "local" else
                    plans_mod.otf_shard_closures(config, X, Y, basis))
    _, _, D = fgrad(beta)
    ms_fg = time_ms(lambda: fgrad(beta), reps=3)
    ms_hd = time_ms(lambda: hessd(D, beta), reps=3)
    del fgrad, hessd, D
    torch.cuda.empty_cache()
    return ms_fg, ms_hd


def phase_train(smi: str, X_np, labels_np, basis_np) -> tuple[dict, dict]:
    """Fit the MNIST8m-shaped machine under both plans; returns (report,
    the otf_shard machine)."""
    X = torch.tensor(X_np, device="cuda")
    basis = torch.tensor(basis_np, device="cuda")
    y_pm = np.where(labels_np[:, None] == np.arange(K)[None, :], 1.0, -1.0)
    Y = torch.tensor(y_pm, dtype=torch.float32, device="cuda")
    launched = {"local": ("gram",), "otf_shard": ("kmvp_fwd", "kmvp_t")}
    idle = {"local": ("kmvp_fwd", "kmvp_t"), "otf_shard": ("gram",)}
    out, machines, betas = {}, {}, {}
    for plan in ("local", "otf_shard"):
        km, wall, peak, counts = fit_once(plan, TRAIN_ITERS, X, labels_np,
                                          basis, f"train_{plan}")
        require_launched(f"train_{plan}", counts, launched[plan],
                         idle[plan])
        again = KernelMachine(train_config(plan, TRAIN_ITERS)).fit(
            X, labels_np, basis)
        bitwise = torch.equal(again.state_["beta"], km.state_["beta"])
        log(f"[train] {plan}: a second fit gives bitwise the same beta: "
            f"{bitwise}")
        if not bitwise:
            raise AssertionError(f"{plan}: two fits of the same data differ")
        del again
        torch.cuda.empty_cache()
        res = km.result_
        beta = km.state_["beta"]
        if tuple(beta.shape) != (M, K) or not bool(torch.isfinite(beta).all()):
            raise AssertionError(f"{plan}: beta {tuple(beta.shape)} is not a "
                                 f"finite ({M}, {K}) block")
        ms_fg, ms_hd = closure_ms(plan, X, Y, basis, beta)
        acc = float((km.predict(X).cpu().numpy() == labels_np).mean())
        out[plan] = {"n": N_TRAIN, "wall_s": wall, "n_iter": res.n_iter,
                     "n_fg": res.n_fg, "n_hd": res.n_hd, "peak_bytes": peak,
                     "ms_per_fg": ms_fg, "ms_per_hd": ms_hd,
                     "train_accuracy": acc, "f": res.tron.f.tolist(),
                     "launches": counts, "device": smi}
        log(f"[train] {plan}: {json.dumps(out[plan])}")
        machines[plan], betas[plan] = km, beta.cpu().numpy()

    b_loc, b_otf = betas["local"], betas["otf_shard"]
    rel = float(np.linalg.norm(b_otf - b_loc) / np.linalg.norm(b_loc))
    log(f"[train] |beta_otf_shard - beta_local| / |beta_local| = {rel:.3e} "
        f"(bar {BETA_RTOL:g})")
    if not rel < BETA_RTOL:
        raise AssertionError(f"otf_shard and local betas differ by {rel:.3e}")
    t0 = time.perf_counter()
    f64 = f_float64(X_np, y_pm, basis_np, [b_loc, b_otf])
    for row, plan in zip(f64, ("local", "otf_shard")):
        f32 = np.asarray(out[plan]["f"])
        err = float(np.max(np.abs(f32 - row) / np.abs(row)))
        out[plan]["f_rel_err_vs_float64"] = err
        log(f"[train] {plan}: reported f vs float64 host re-evaluation: max "
            f"relative {err:.3e} (bar {F_RTOL:g})")
        if not err < F_RTOL:
            raise AssertionError(f"{plan}: f is {err:.3e} off its float64 "
                                 f"re-evaluation")
    log(f"[train] float64 re-evaluation took "
        f"{time.perf_counter() - t0:.1f}s")
    out["beta_rel_otf_shard_vs_local"] = rel
    del machines["local"], X, Y, basis
    torch.cuda.empty_cache()
    return out, machines["otf_shard"]


def phase_serve_trained(km, Xq_np) -> dict:
    """Save, load and serve the trained machine through kernel_serve."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.npz")
        km.save(path)
        km = KernelMachine.load(path)
    torch.cuda.synchronize()
    zero_counts()
    endpoint, stats = kernel_serve.serve_stream(
        km, requests=REQUESTS // 4, max_batch=MAX_BATCH, seed=SEED,
        plan="otf_shard")
    torch.cuda.synchronize()
    require_launched("serve_trained", read_counts("serve_trained"),
                     ("kmvp_fwd",), idle=("gram", "kmvp_t"))
    log(f"[serve] trained machine: {json.dumps(stats)}")
    check_served(km, endpoint, Xq_np, "otf_shard")
    return stats


def phase_large(smi: str, basis_np, P) -> dict:
    """An otf_shard fit at N_LARGE rows: C would not fit on the card; the
    fit stays under a quarter of C's bytes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    X, labels = digits_like(gen, P, N_LARGE)
    labels = labels.cpu().numpy()
    c_bytes = 4 * N_LARGE * M
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[large] C would be {c_bytes} bytes; the card holds {card}")
    if not c_bytes > card:
        raise AssertionError("C fits on this card: the phase shows nothing")
    basis = torch.tensor(basis_np, device="cuda")
    km, wall, peak, counts = fit_once("otf_shard", LARGE_ITERS, X, labels,
                                      basis, "train_large")
    require_launched("train_large", counts, ("kmvp_fwd", "kmvp_t"),
                     idle=("gram",))
    res = km.result_
    beta = km.state_["beta"]
    if not bool(torch.isfinite(beta).all()):
        raise AssertionError("large fit: non-finite beta")
    f0 = 0.5 * N_LARGE * K              # f at beta = 0 (all hinges at 1)
    if not float(res.f) < f0:
        raise AssertionError(f"large fit: f {res.f} did not fall below {f0}")
    out = {"n": N_LARGE, "wall_s": wall, "n_iter": res.n_iter,
           "n_fg": res.n_fg, "n_hd": res.n_hd, "peak_bytes": peak,
           "c_bytes": c_bytes, "card_bytes": card, "f": res.f, "f_at_0": f0,
           "launches": counts, "device": smi}
    log(f"[large] otf_shard: {json.dumps(out)}")
    if not peak < c_bytes / 4:
        raise AssertionError(f"large fit peaked at {peak} bytes, over a "
                             f"quarter of C's {c_bytes}")
    # the kernels at this shape against their plain versions, on the last
    # LARGE_TAIL rows (the largest row indices): kmvp_fwd's rows do not
    # depend on the batch, and kmvp_t over a V that is zero but for those
    # rows is their sum alone
    kw = dict(kind="gaussian", sigma=SIGMA)
    tail = X[N_LARGE - LARGE_TAIL:]
    rng = np.random.default_rng(SEED + 5)
    b = torch.tensor(rng.standard_normal((M, K)), dtype=torch.float32,
                     device="cuda")
    check_close(f"kmvp_fwd k={K} n={N_LARGE} (last {LARGE_TAIL} rows)",
                kmvp_mod.kmvp_fwd(X, basis, b, **kw)[N_LARGE - LARGE_TAIL:],
                kmvp_mod.kmvp_fwd_plain(tail, basis, b, **kw))
    V = torch.zeros((N_LARGE, K), dtype=torch.float32, device="cuda")
    V[N_LARGE - LARGE_TAIL:] = torch.tensor(
        rng.standard_normal((LARGE_TAIL, K)), dtype=torch.float32,
        device="cuda")
    check_close(f"kmvp_t k={K} n={N_LARGE} (V zero but the last "
                f"{LARGE_TAIL} rows)", kmvp_mod.kmvp_t(X, basis, V, **kw),
                kmvp_mod.kmvp_t_plain(tail, basis,
                                      V[N_LARGE - LARGE_TAIL:], **kw))
    del km, X, basis, beta, tail, V
    torch.cuda.empty_cache()
    return out


def phase_train_shapes(smi: str, Xtrain, Z) -> dict:
    """gram and kmvp_fwd at the shapes the fits give them, against their
    plain versions: ``local``'s C (n_train, m) and W (m, m) from gram;
    ``otf_shard``'s C beta (k = 1 for a binary fit, K) and W beta (the
    basis as X) from kmvp_fwd. Times by CUDA events; returns them."""
    n, m = Xtrain.shape[0], Z.shape[0]
    kw = dict(kind="gaussian", sigma=SIGMA)
    rng = np.random.default_rng(SEED + 6)
    b = torch.tensor(rng.standard_normal((m, K)), dtype=torch.float32,
                     device="cuda")
    for name, x in (("C", Xtrain), ("W", Z)):
        check_close(f"gram ({name}) n={x.shape[0]} m={m} d={D}",
                    gram_mod.gram(x, Z, **kw), gram_mod.gram_plain(x, Z, **kw))
        torch.cuda.empty_cache()
    for x, ks in ((Xtrain, (1, K)), (Z, (K,))):
        for k in ks:
            bk = b[:, :k].contiguous()
            check_close(f"kmvp_fwd k={k} n={x.shape[0]} m={m} d={D}",
                        kmvp_mod.kmvp_fwd(x, Z, bk, **kw),
                        kmvp_mod.kmvp_fwd_plain(x, Z, bk, **kw))
    norms = 2.0 * (n + m) * D
    out = {"build_C_ms": time_ms(lambda: gram_mod.gram(Xtrain, Z, **kw)),
           "build_C_plain_ms": time_ms(
               lambda: gram_mod.gram_plain(Xtrain, Z, **kw), reps=3),
           "build_C_bound_ms": bound_ms(2.0 * n * m * D + norms,
                                        4.0 * (n * D + m * D + n * m))[0],
           "build_W_ms": time_ms(lambda: gram_mod.gram(Z, Z, **kw)),
           "kmvp_fwd_ms": time_ms(lambda: kmvp_mod.kmvp_fwd(Xtrain, Z, b,
                                                            **kw)),
           "kmvp_fwd_plain_ms": time_ms(
               lambda: kmvp_mod.kmvp_fwd_plain(Xtrain, Z, b, **kw), reps=3),
           "kmvp_fwd_bound_ms": bound_ms(
               2.0 * n * m * D + norms + 2.0 * n * m * K,
               4.0 * (n * D + m * D + m * K + n * K))[0],
           "kmvp_fwd_W_ms": time_ms(lambda: kmvp_mod.kmvp_fwd(Z, Z, b,
                                                              **kw)),
           "shape": [n, m, D, K], "device": smi}
    torch.cuda.empty_cache()
    log(f"[time ] training shapes: {json.dumps(out)}")
    return out


def phase_kmvp_t(smi: str, Xtest, Xtrain, Z) -> dict:
    """kmvp_t against its plain version, the adjoint identity and
    run-to-run bitwise equality; times at the training shape."""
    rng = np.random.default_rng(SEED + 4)
    xr = torch.tensor(rng.standard_normal((37, 54)), dtype=torch.float32,
                      device="cuda")
    zr = torch.tensor(rng.standard_normal((300, 54)), dtype=torch.float32,
                      device="cuda")
    errs = {}
    for x, z, sigma in ((Xtest[:MAX_BATCH], Z, SIGMA), (Xtest, Z, SIGMA),
                        (Xtrain, Z, SIGMA), (xr, zr, float(np.sqrt(54)))):
        n, d = x.shape
        kw = dict(kind="gaussian", sigma=sigma)
        V = torch.tensor(rng.standard_normal((n, 16)), dtype=torch.float32,
                         device="cuda")
        for k in (1, K, 16):
            v = V[:, :k].contiguous()
            errs[(n, k)] = check_close(
                f"kmvp_t k={k} n={n} m={z.shape[0]} d={d}",
                kmvp_mod.kmvp_t(x, z, v, **kw),
                kmvp_mod.kmvp_t_plain(x, z, v, **kw))
        check_close(f"kmvp_t linear k={K} n={n} m={z.shape[0]} d={d}",
                    kmvp_mod.kmvp_t(x, z, V[:, :K].contiguous(),
                                    kind="linear"),
                    kmvp_mod.kmvp_t_plain(x, z, V[:, :K].contiguous(),
                                          kind="linear"))

    n, m = Xtrain.shape[0], Z.shape[0]
    kw = dict(kind="gaussian", sigma=SIGMA)
    v = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                     device="cuda")
    b = torch.tensor(rng.standard_normal((m, K)), dtype=torch.float32,
                     device="cuda")
    g = kmvp_mod.kmvp_t(Xtrain, Z, v, **kw)
    lhs = float((kmvp_mod.kmvp_fwd(Xtrain, Z, b, **kw).double()
                 * v.double()).sum())
    rhs = float((b.double() * g.double()).sum())
    adj = abs(lhs - rhs) / abs(lhs)
    bitwise = torch.equal(g, kmvp_mod.kmvp_t(Xtrain, Z, v, **kw))
    log(f"[check] kmvp_t adjoint <C b, v> = {lhs:.9e}, <b, C^T v> = "
        f"{rhs:.9e}, relative {adj:.2e} (bar 1e-5); bitwise run to run: "
        f"{bitwise}")
    if not adj < 1e-5 or not bitwise:
        raise AssertionError("kmvp_t: adjoint or run-to-run check failed")

    times = {}
    for x in (Xtest, Xtrain):
        n, d = x.shape
        vk = v[:n]
        ms = time_ms(lambda: kmvp_mod.kmvp_t(x, Z, vk, **kw))
        plain = time_ms(lambda: kmvp_mod.kmvp_t_plain(x, Z, vk, **kw),
                        reps=3)
        lib = time_ms(lambda: torch.exp(torch.cdist(x, Z).square_().div_(
            -2.0 * SIGMA ** 2)).T @ vk, reps=3)
        bnd, by = bound_ms(2.0 * n * m * d + 2.0 * (n + m) * d
                           + 2.0 * n * m * K,
                           4.0 * (n * d + m * d + n * K + m * K))
        times[n] = (ms, plain, lib, bnd, by)
        log(f"[time ] kmvp_t n={n} m={m} d={d} k={K}: kernel {ms:.3f} ms, "
            f"plain {plain:.3f} ms, library {lib:.3f} ms, bound {bnd:.3f} ms "
            f"({bnd / ms:.1%} of bound) [{smi}]")
    ms, plain, lib, bnd, by = times[n]
    return dict(name="kmvp_t", route="cuda",
                source="src/repro_torch/kernels/csrc/kmvp_t.cu",
                replaces="src/repro/kernels/kmvp.py:174",
                max_abs_err=errs[(n, K)], tolerance=FP32_TOL, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                library="exp(-cdist^2/2sigma^2).T @ V (materializes C: not "
                        "the same function)",
                shape=[n, m, D, K], ms_10000_rows=times[N_TEST][0],
                bound_ms_10000_rows=times[N_TEST][3], adjoint_rel=adj)


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    basis_np = mnist_like(rng, M)
    beta_np = (rng.standard_normal((M, K)) / np.sqrt(M)).astype(np.float32)
    X_np = mnist_like(rng, N_TEST)
    X, Z, B = (torch.tensor(a, device="cuda") for a in (X_np, basis_np,
                                                         beta_np))
    report = phase_kernels(smi, X, Z, B)
    del Z, B
    torch.cuda.empty_cache()
    serve = phase_serve(X, basis_np, beta_np, X_np[:MAX_BATCH])
    log(f"[time ] serve and kernels so far: "
        f"{time.perf_counter() - t_start:.1f}s")

    # training data: MNIST-like rows around K seeded prototypes, labelled
    # by the nearest one (digits_like); the basis is M of the training rows
    rng = np.random.default_rng(SEED + 2)
    P = torch.tensor(mnist_like(rng, K), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Xtr, labels = digits_like(gen, P, N_TRAIN)
    Xtr_np, labels_np = Xtr.cpu().numpy(), labels.cpu().numpy()
    del Xtr, labels
    basis_tr = np.ascontiguousarray(
        Xtr_np[np.sort(rng.choice(N_TRAIN, M, replace=False))])
    train, km = phase_train(smi, Xtr_np, labels_np, basis_tr)
    train["serve_trained"] = phase_serve_trained(km, Xtr_np[:MAX_BATCH])
    del km
    torch.cuda.empty_cache()
    train["otf_shard_large"] = phase_large(smi, basis_tr, P)
    Xtr, Ztr = (torch.tensor(a, device="cuda") for a in (Xtr_np, basis_tr))
    shapes = phase_train_shapes(smi, Xtr, Ztr)
    train["kernels_at_training_shapes"] = shapes
    report["gram"]["ms_C_65536_rows"] = shapes["build_C_ms"]
    report["kmvp_fwd"]["ms_65536_rows"] = shapes["kmvp_fwd_ms"]
    report["kmvp_t"] = phase_kmvp_t(smi, X, Xtr, Ztr)
    for name, entry in report.items():
        entry["launches_by_path"] = {p: c[name] for p, c in BY_PATH.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["device"] = smi
    train["serve"] = serve
    log(f"[done ] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": [report["gram"], report["kmvp_fwd"],
                                  report["kmvp_t"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
