"""The port's KernelMachine against the JAX reference, on the CPU.

Reference machines are trained here with the reference (tron on the
``local`` plan, basis passed in, few iterations), carried over with
``KernelMachine.from_reference`` or through a checkpoint, and must give the
reference's margins under the same plan, at the reference's fp32 bar, and
the same predictions and scores.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelMachine as RefMachine
from repro.api import MachineConfig as RefConfig
from repro.api import StreamConfig as RefStream
from repro.core import KernelSpec as RefKernel
from repro.core import TronConfig as RefTron
from repro.core import random_basis
from repro.data import make_classification, make_multiclass
from repro_torch.api import KernelMachine, MachineConfig
from repro_torch.checkpoint import load_arrays
from test_torch_common import assert_close_fp32, to_np

PLANS = ["local", "otf_shard"]
CFG = RefConfig(kernel=RefKernel("gaussian", sigma=2.0), lam=0.5,
                tron=RefTron(max_iter=30))


@pytest.fixture(scope="module")
def ref_machines():
    """{"binary": (machine, Xt, yt), "multiclass": (...)}, trained once."""
    out = {}
    X, y = make_classification(jax.random.PRNGKey(0), 400, 12,
                               clusters_per_class=4)
    basis = random_basis(jax.random.PRNGKey(1), X[:320], 48)
    out["binary"] = (RefMachine(CFG).fit(X[:320], y[:320], basis),
                     np.asarray(X[320:]), np.asarray(y[320:]))
    Xm, ym = make_multiclass(jax.random.PRNGKey(2), 400, 12, 3,
                             clusters_per_class=2)
    basis = random_basis(jax.random.PRNGKey(3), Xm[:320], 48)
    out["multiclass"] = (RefMachine(CFG).fit(Xm[:320], ym[:320], basis),
                         np.asarray(Xm[320:]), np.asarray(ym[320:]))
    return out


def _carry(ref) -> KernelMachine:
    arrays = {k: np.asarray(v) for k, v in ref.state_.items()}
    return KernelMachine.from_reference(ref.config.to_dict(), arrays,
                                        device="cpu")


@pytest.mark.parametrize("which", ["binary", "multiclass"])
@pytest.mark.parametrize("plan", PLANS)
def test_from_reference_margins_match(ref_machines, which, plan):
    ref, Xt, yt = ref_machines[which]
    km = _carry(ref)
    got = km.decision_function(Xt, plan=plan)
    want = np.asarray(ref.decision_function(Xt, plan=plan))
    assert got.shape == want.shape and got.device.type == "cpu"
    assert_close_fp32(got, want)
    np.testing.assert_array_equal(to_np(km.predict(Xt, plan=plan)),
                                  np.asarray(ref.predict(Xt, plan=plan)))
    assert km.score(Xt, yt, plan=plan) == ref.score(Xt, yt, plan=plan)
    assert km.score(Xt, yt, plan=plan) > 0.85


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_reference_checkpoint_loads_in_port(ref_machines, which, tmp_path):
    ref, Xt, _ = ref_machines[which]
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    km = KernelMachine.load(path, device="cpu")
    assert km.config.to_dict() == ref.config.to_dict()
    assert set(km.state_) == set(ref.state_)
    for plan in PLANS:
        assert_close_fp32(km.decision_function(Xt, plan=plan),
                          ref.decision_function(Xt, plan=plan))


@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_port_checkpoint_loads_in_reference(ref_machines, which, tmp_path):
    ref, Xt, _ = ref_machines[which]
    km = _carry(ref)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    km.save(ours)
    ref.save(theirs)
    RefMachine.load(theirs).save(theirs)   # a served machine has no history
    back = RefMachine.load(ours)
    assert back.config == ref.config
    for k, v in ref.state_.items():
        np.testing.assert_array_equal(np.asarray(back.state_[k]),
                                      np.asarray(v))
    assert_close_fp32(back.decision_function(Xt), ref.decision_function(Xt))
    # the same file layout: keys, manifest and array dtypes
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files
        assert json.loads(a["__manifest__"].item()) == \
            json.loads(b["__manifest__"].item())
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
    arrays, meta = load_arrays(ours)
    assert meta["format"] == 1 and meta["history"] == []
    assert set(arrays) == set(ref.state_)


def test_config_to_dict_identical():
    configs = [
        (RefConfig(), MachineConfig()),
        (RefConfig(kernel=RefKernel("linear", sigma=3.0), loss="logistic",
                   lam=0.25, plan="otf_shard", backend="pallas", seed=7,
                   dtype_policy="bf16", m=1024, otf_block_rows=64,
                   stream=RefStream(chunk_rows=512, prefetch=0)), None),
    ]
    for ref_cfg, port_cfg in configs:
        d = ref_cfg.to_dict()
        port_cfg = port_cfg or MachineConfig.from_dict(d)
        assert port_cfg.to_dict() == d
        assert json.dumps(port_cfg.to_dict()) == json.dumps(d)
        assert RefConfig.from_dict(port_cfg.to_dict()) == ref_cfg
    with pytest.raises(KeyError, match="unknown loss"):
        MachineConfig(loss="hinge_cubed")
    with pytest.raises(ValueError, match="unknown dtype policy"):
        MachineConfig(dtype_policy="int4")


def test_backend_selects_nothing(ref_machines):
    """A ``backend="pallas"`` checkpoint serves exactly like a "jnp" one:
    the port's tensors pick the kernel, not the config."""
    ref, Xt, _ = ref_machines["binary"]
    arrays = {k: np.asarray(v) for k, v in ref.state_.items()}
    a = KernelMachine.from_reference(ref.config.to_dict(), arrays,
                                     device="cpu")
    b = KernelMachine.from_reference(
        ref.config.replace(backend="pallas").to_dict(), arrays, device="cpu")
    for plan in PLANS:
        np.testing.assert_array_equal(to_np(a.decision_function(Xt, plan=plan)),
                                      to_np(b.decision_function(Xt, plan=plan)))


def test_load_without_a_device_needs_a_gpu(ref_machines, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    ref, _, _ = ref_machines["binary"]
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelMachine.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelMachine.from_reference(ref.config.to_dict(),
                                     {k: np.asarray(v)
                                      for k, v in ref.state_.items()})


def test_unsupported_checkpoints_raise(ref_machines, tmp_path):
    ref, _, _ = ref_machines["binary"]
    path = str(tmp_path / "q.npz")
    ref.save(path, quantize="int8")
    with pytest.raises(NotImplementedError, match="quantized"):
        KernelMachine.load(path, device="cpu")
    with pytest.raises(KeyError, match="unknown solver"):
        KernelMachine(MachineConfig(solver="rff"), device="cpu")
    km = KernelMachine(MachineConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        km.decision_function(np.zeros((2, 12), np.float32))
