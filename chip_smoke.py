#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, in order; any failure raises and exits nonzero:

1. device  — require CUDA (there is no CPU path), print the card's name and
             power limit, turn TF32 off (the port's fp32 is IEEE fp32).
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's shapes and a ragged one, at the reference's
             fp32 bar (rtol 2e-4, atol 2e-4 * max(1, max|want|)); times of
             the kernel, its plain version and a library yardstick, beside
             the card's bound for the same work.
4. serve   — an MNIST8m-shaped one-vs-rest machine (d = 784, sigma = 7.0,
             m = 16384 basis points, K = 10 classes; seeded random basis and
             weights) is saved, loaded and served by
             ``repro_torch.launch.kernel_serve``'s serial path under the
             ``local`` (gram kernel) and ``otf_shard`` (fused kmvp kernel)
             plans, and scores a 10,000-row test set under both. The launch
             counters are zeroed just before and read just after.
5. report  — one JSON line ``{"kernels": [...]}``, then the last line
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
from repro_torch.core import KernelSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gram as gram_mod  # noqa: E402
from repro_torch.kernels import kmvp as kmvp_mod  # noqa: E402
from repro_torch.launch import kernel_serve  # noqa: E402

SEED = 0
D, SIGMA, M, K = 784, 7.0, 16384, 10     # repro/data/synthetic.py mnist8m
N_TEST = 10_000                          # its n_test
MAX_BATCH, REQUESTS = 256, 64
FP32_TOL = 2e-4                          # tests/conftest.py _DTYPE_TOL fp32
# H100 SXM data sheet: fp32 on the CUDA cores (no tensor cores), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Assert the fp32 bar; return the max absolute error."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    atol = FP32_TOL * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    worst = float(err.max())
    excess = float((err - (atol + FP32_TOL * want.abs())).max())
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


# ------------------------------------------------------------------ phases
def phase_device() -> None:
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


def phase_build() -> None:
    t0 = time.perf_counter()
    out = _build.build()
    log(f"[build] {out} in {time.perf_counter() - t0:.2f}s")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    lib = _build.load("kmvp")
    if lib.kmvp_fwd_max_k() != kmvp_mod.MAX_K:
        raise AssertionError("csrc/kmvp.cu KMAX != kmvp.MAX_K")


def phase_kernels(X, Z, B) -> dict:
    """Each kernel against its plain version; returns the report entries
    (at the 10,000-row test-set shape, the main path's largest call)."""
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
                f"({bnd / ms:.1%} of bound)")
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
                library="exp(-cdist^2/2sigma^2) @ B (materialized)",
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

    gram_mod.launches = 0
    kmvp_mod.launches = 0
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
    launches = {"gram": gram_mod.launches, "kmvp_fwd": kmvp_mod.launches}
    log(f"[serve] launches on the serving path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

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

    bitwise_local = None
    for plan in ("local", "otf_shard"):
        endpoint, _ = served[plan]
        for rows in (37, MAX_BATCH):
            got = endpoint(Xq_np[:rows])
            want_t = km.decision_function(Xq_np[:rows], plan=plan)
            check_close(f"served vs decision_function {plan} rows={rows}",
                        torch.tensor(got), want_t.cpu())
            if plan == "otf_shard" and not np.array_equal(
                    got, want_t.cpu().numpy()):
                raise AssertionError("otf_shard: served margins are not "
                                     "bitwise decision_function's")
        alone = endpoint(Xq_np[3:4])[0]
        inside = endpoint(Xq_np[:MAX_BATCH])[3]
        same = bool(np.array_equal(alone, inside))
        log(f"[serve] {plan}: row alone == row in a {MAX_BATCH}-row bucket "
            f"bitwise: {same}")
        if plan == "otf_shard" and not same:
            raise AssertionError("otf_shard: a row's margin depends on its "
                                 "bucket")
        if plan == "local":
            bitwise_local = same
    return {"launches": launches, "bitwise_local": bitwise_local,
            "stats": {p: s for p, (_, s) in served.items()}}


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    basis_np = mnist_like(rng, M)
    beta_np = (rng.standard_normal((M, K)) / np.sqrt(M)).astype(np.float32)
    X_np = mnist_like(rng, N_TEST)
    X, Z, B = (torch.tensor(a, device="cuda") for a in (X_np, basis_np,
                                                         beta_np))
    report = phase_kernels(X, Z, B)
    del Z, B
    torch.cuda.empty_cache()
    serve = phase_serve(X, basis_np, beta_np, X_np[:MAX_BATCH])
    for name, entry in report.items():
        entry["launches"] = serve["launches"][name]
    log(f"[done ] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [report["gram"], report["kmvp_fwd"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
