"""The port's serving path on the CPU: bucketing against the reference,
bitwise batch independence of both decide arms, the serial server, the fused
arm's memory contract, and that the port imports neither jax nor repro."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.api import MachineConfig as RefConfig
from repro.api.infer import bucket_rows as ref_bucket_rows
from repro.api.infer import scatter_rows as ref_scatter_rows
from repro.core import KernelSpec as RefKernel
from repro.serve.metrics import percentiles as ref_percentiles
from repro_torch.api import KernelMachine
from repro_torch.api.infer import (MIN_BUCKET, BucketedDecider, bucket_rows,
                                   scatter_rows)
from repro_torch.launch import kernel_serve
from repro_torch.serve import ModelRegistry, percentiles, serving_plan
from test_torch_common import (LargestTensor, assert_close_fp32,
                               kernel_inputs, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = "otf_shard"


def _machine(m=96, d=54, k=3, plan="local", seed=0) -> KernelMachine:
    """A machine from seeded random state (serving needs no training)."""
    _, basis, beta = kernel_inputs(1, m, d, k, seed=seed)
    cfg = RefConfig(kernel=RefKernel("gaussian", sigma=float(np.sqrt(d))),
                    plan=plan)
    return KernelMachine.from_reference(
        cfg.to_dict(), {"basis": basis, "beta": beta}, device="cpu")


def _queries(n, d=54, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# ----------------------------------------------------- bucketing helpers
def test_bucketing_matches_reference():
    assert MIN_BUCKET == 2
    for max_batch in (64, 256, 300):
        for n in range(1, 700):
            assert bucket_rows(n, max_batch) == ref_bucket_rows(n, max_batch)
    block = np.arange(40.0).reshape(20, 2)
    sizes = [3, 1, 7, 9]
    for a, b in zip(scatter_rows(block, sizes),
                    ref_scatter_rows(block, sizes)):
        np.testing.assert_array_equal(a, b)


def test_percentiles_match_reference():
    rng = np.random.default_rng(0)
    for samples in ([], [0.003], [0.001, 0.5], list(rng.random(101)),
                    list(rng.exponential(0.01, 1000))):
        assert percentiles(samples) == ref_percentiles(samples)
        assert percentiles(samples, (50, 90, 99, 100)) == \
            ref_percentiles(samples, (50, 90, 99, 100))


# --------------------------------------------------- bucketed deciding
@pytest.mark.parametrize("k", [0, 3])
def test_fused_arm_rows_are_batch_independent_bitwise(k):
    """A row served alone equals the same row served inside a bigger
    bucket, bitwise, on the fused arm (what coalescing requests relies on);
    k = 0 is a binary machine's 1-D beta."""
    km = _machine(k=k, plan=FUSED)
    dec = BucketedDecider(km.decider(), max_batch=256)
    X = _queries(200)
    full = dec(X)                                   # one 256-row bucket
    assert full.shape == ((200,) if k == 0 else (200, k))
    for i in (0, 1, 99, 199):
        np.testing.assert_array_equal(dec(X[i:i + 1])[0], full[i])
        np.testing.assert_array_equal(dec(X[[5, i, 7]])[1], full[i])
    np.testing.assert_array_equal(dec(np.concatenate([X, X]))[200:], full)
    assert dec.n_buckets == 3                       # 256, 2 and 4 rows
    assert_close_fp32(full, km.decision_function(X, plan="local"))


@pytest.mark.parametrize("k", [0, 3])
def test_local_arm_rows_are_batch_independent_bitwise(k):
    """The dense arm contracts the query gram with β in fixed-shape
    256-row blocks (the last one zero-padded), so a row's margin is bitwise
    the same alone, at any position, and across block boundaries."""
    km = _machine(k=k, plan="local")
    X = _queries(600)
    full = to_np(km.decision_function(X))
    for i in (0, 3, 255, 256, 599):
        np.testing.assert_array_equal(
            to_np(km.decision_function(X[i:i + 1]))[0], full[i])
        np.testing.assert_array_equal(
            to_np(km.decision_function(X[[7, i]]))[1], full[i])
    dec = BucketedDecider(km.decider(), max_batch=256)
    np.testing.assert_array_equal(dec(X[:200])[:5], dec(X[:5]))
    assert_close_fp32(full, km.decision_function(X, plan=FUSED))


def test_bucketed_decider_warmup_runs_every_bucket():
    km = _machine(plan=FUSED)
    dec = BucketedDecider(km.decider(), max_batch=48)
    assert dec.warmup(54) == 6                      # 2, 4, 8, 16, 32, 48


@pytest.mark.parametrize("plan", ["local", FUSED])
def test_serve_stream_answers_with_decision_function(plan):
    km = _machine(plan=plan)
    endpoint, stats = kernel_serve.serve_stream(km, requests=6,
                                                max_batch=64, seed=3)
    assert stats["requests"] == 6 and stats["plan"] == plan
    assert stats["buckets"] == 6 and stats["rows_per_s"] > 0
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    Xq = _queries(37)
    served = endpoint(Xq)
    direct = to_np(km.decision_function(Xq))
    # both arms: the dense one contracts in fixed-shape row blocks
    np.testing.assert_array_equal(served, direct)


def test_kernel_serve_cli(tmp_path):
    path = str(tmp_path / "m.npz")
    _machine(k=3, plan="stream").save(path)
    stats = kernel_serve.main(["--ckpt", path, "--serial", "--device", "cpu",
                               "--requests", "4", "--max-batch", "16"])
    assert stats["plan"] == "local" and stats["requests"] == 4
    stats = kernel_serve.main(["--ckpt", path, "--serial", "--device", "cpu",
                               "--requests", "3", "--max-batch", "8",
                               "--plan", FUSED, "--seed", "5"])
    assert stats["plan"] == FUSED and stats["buckets"] == 3
    with pytest.raises(SystemExit):                 # only --serial so far
        kernel_serve.main(["--ckpt", path, "--device", "cpu"])
    with pytest.raises(SystemExit):                 # not ported: absent
        kernel_serve.main(["--ckpt", path, "--serial", "--selftest"])


def test_model_registry(tmp_path):
    reg = ModelRegistry(max_batch=16)
    a = reg.add("a", _machine(k=3, plan="stream"))
    b = reg.add("b", _machine(k=0), plan=FUSED)
    assert (a.plan, a.d, a.n_classes) == ("local", 54, 3)
    assert (b.plan, b.n_classes) == (FUSED, 0)
    assert reg.get() is a and reg.get("b") is b
    assert reg.names() == ["a", "b"]
    assert reg.warmup() == {"a": 4, "b": 4}          # 2, 4, 8, 16
    with pytest.raises(ValueError, match="already registered"):
        reg.add("a", _machine())
    with pytest.raises(KeyError, match="unknown model"):
        reg.get("z")
    path = str(tmp_path / "c.npz")
    _machine().save(path)
    assert reg.load("c", path, device="cpu").d == 54
    assert serving_plan(_machine(plan="stream"), None) == "local"


# --------------------------------------------------------- memory contract
def test_fused_arm_never_materializes_the_query_gram():
    n, m = 300, 96
    km = _machine(m=m, k=3)
    X = _queries(n)
    with LargestTensor() as probe:
        km.decision_function(X, plan=FUSED)
    assert probe.largest < n * m, (probe.largest, n * m)
    with LargestTensor() as probe:              # the probe sees the dense
        km.decision_function(X, plan="local")    # arm's (n, m) gram
    assert probe.largest >= n * m


# --------------------------------------------------------------- isolation
def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module, and chip_smoke.py's imports, load without
    pulling in jax or the reference package (checked in a fresh process)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit(f'loaded {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.strip()) >= 20
