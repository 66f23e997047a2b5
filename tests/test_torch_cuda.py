"""The port's CUDA kernels on a GPU: each against its plain PyTorch version
on the same CUDA tensors, at the reference's fp32 bar.

These tests need a GPU and skip without one (the kernels are CUDA C++ and
have no CPU mode). The file imports neither jax nor the reference, so it
runs on a GPU machine that has no jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelMachine, MachineConfig
from repro_torch.core import KernelSpec
from repro_torch.kernels import gram as p_gram
from repro_torch.kernels import kmvp as p_kmvp
from repro_torch.kernels import ops as p_ops
from test_torch_common import assert_close_fp32, kernel_inputs, sigma_for

# ragged everywhere: n below and across the 64-row tile, m across tiles and
# spans (512), d not a multiple of the 32-wide slice or of 4
SHAPES = [(1, 64, 16), (37, 96, 54), (130, 600, 54), (257, 1100, 785)]
KINDS = ["gaussian", "linear"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(device, *arrays):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_gram_kernel_matches_plain(cuda, shape, kind):
    n, m, d = shape
    x, z = _on(cuda, *kernel_inputs(n, m, d))
    kw = dict(kind=kind, sigma=sigma_for(d))
    before = p_gram.launches
    got = p_gram.gram(x, z, **kw)
    assert p_gram.launches == before + 1 and got.shape == (n, m)
    assert_close_fp32(got, p_gram.gram_plain(x, z, **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_kmvp_kernel_matches_plain(cuda, shape, kind, k):
    n, m, d = shape
    x, z, b = _on(cuda, *kernel_inputs(n, m, d, k))
    kw = dict(kind=kind, sigma=sigma_for(d))
    before = p_kmvp.launches
    got = p_kmvp.kmvp_fwd(x, z, b, **kw)
    assert p_kmvp.launches == before + 1 and got.shape == (n, k)
    assert_close_fp32(got, p_kmvp.kmvp_fwd_plain(x, z, b, block_rows=16,
                                                 **kw))


def test_kmvp_kernel_rows_do_not_depend_on_the_batch(cuda):
    n, m, d = 300, 1100, 54
    x, z, b = _on(cuda, *kernel_inputs(n, m, d, 10))
    kw = dict(kind="gaussian", sigma=sigma_for(d))
    full = p_kmvp.kmvp_fwd(x, z, b, **kw).cpu()
    for i in (0, 63, 64, 299):
        alone = p_kmvp.kmvp_fwd(x[i:i + 1].contiguous(), z, b, **kw).cpu()
        assert torch.equal(alone[0], full[i])
        pair = p_kmvp.kmvp_fwd(x[[5, i]].contiguous(), z, b, **kw).cpu()
        assert torch.equal(pair[1], full[i])


def test_fused_and_dense_kernels_agree_on_the_tile_values(cuda):
    """kmvp contracts exactly the values gram writes (shared tile code), so
    the fused margin equals gram's C contracted in the same order."""
    n, m, d = 64, 64, 54
    x, z, b = _on(cuda, *kernel_inputs(n, m, d, 1))
    kw = dict(kind="gaussian", sigma=sigma_for(d))
    C = p_gram.gram(x, z, **kw).cpu().double()
    want = C @ b.cpu().double()
    assert_close_fp32(p_kmvp.kmvp_fwd(x, z, b, **kw).cpu(),
                      want)


def test_wrappers_reject_on_the_gpu(cuda):
    x, z, b = _on(cuda, *kernel_inputs(8, 16, 4, 2))
    with pytest.raises(ValueError, match="contiguous"):
        p_gram.gram(x.T, z)
    with pytest.raises(ValueError, match="different devices"):
        p_gram.gram(x, z.cpu())
    with pytest.raises(NotImplementedError, match="float32"):
        p_kmvp.kmvp_fwd(x.half(), z.half(), b.half())
    with pytest.raises(NotImplementedError, match="precision slice"):
        p_ops.kmvp_fwd(x, z, b, policy="bf16")


@pytest.mark.parametrize("plan", ["local", "otf_shard"])
def test_decide_arms_on_the_gpu_match_the_cpu(cuda, plan):
    _, basis, beta = kernel_inputs(1, 700, 54, 3, seed=4)
    cfg = MachineConfig(kernel=KernelSpec("gaussian", sigma=sigma_for(54)),
                        plan=plan)
    arrays = {"basis": basis, "beta": beta,
              "classes": np.arange(3, dtype=np.int32)}
    gpu = KernelMachine.from_reference(cfg.to_dict(), arrays)
    cpu = KernelMachine.from_reference(cfg.to_dict(), arrays, device="cpu")
    assert gpu.device.type == "cuda"
    Xq = np.random.default_rng(5).standard_normal((77, 54)).astype(
        np.float32)
    o = gpu.decision_function(Xq)
    assert o.device.type == "cuda"
    assert_close_fp32(o, cpu.decision_function(Xq))
