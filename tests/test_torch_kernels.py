"""The port's kernel layer against the JAX reference, on the CPU.

Oracles (``kernels/ref.py``), the Nystrom pieces, and each kernel module
(gram, kmvp_fwd, kmvp_t) through its plain PyTorch version: ``repro_torch.kernels.ops`` against
``repro.kernels.ops`` (the Pallas kernels in interpret mode, which the
reference picks by itself off-TPU) and the reference's jnp fallback, at
the reference's fp32 bar. A CUDA tensor would launch the hand-written
kernels instead; ``test_torch_cuda.py`` holds those against their plain
versions on a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nystrom as r_nys
from repro.core import losses as r_losses
from repro.kernels import ops as r_ops
from repro.kernels import policy as r_policy
from repro.kernels import ref as r_ref
from repro_torch.core import losses as p_losses
from repro_torch.core import nystrom as p_nys
from repro_torch.kernels import gram as p_gram
from repro_torch.kernels import kmvp as p_kmvp
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import policy as p_policy
from repro_torch.kernels import ref as p_ref
from test_torch_common import (assert_close_fp32, kernel_inputs, sigma_for,
                               t, to_np)

# ragged n, both basis sizes, both feature widths (d = 54 is covtype's)
SHAPES = [(1, 64, 16), (37, 96, 54), (130, 64, 54)]
KINDS = ["gaussian", "linear"]


# ------------------------------------------------------------------ oracles
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_oracles_match_reference(shape, kind):
    n, m, d = shape
    x, z, b = kernel_inputs(n, m, d, 3)
    v = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
    kw = dict(kind=kind, sigma=sigma_for(d))
    assert_close_fp32(p_ref.gram_ref(t(x), t(z), **kw),
                      r_ref.gram_ref(jnp.asarray(x), jnp.asarray(z), **kw))
    assert_close_fp32(p_ref.kmvp_ref(t(x), t(z), t(b), **kw),
                      r_ref.kmvp_ref(jnp.asarray(x), jnp.asarray(z),
                                     jnp.asarray(b), **kw))
    assert_close_fp32(p_ref.kmvp_t_ref(t(x), t(z), t(v), **kw),
                      r_ref.kmvp_t_ref(jnp.asarray(x), jnp.asarray(z),
                                       jnp.asarray(v), **kw))


@pytest.mark.parametrize("kind", KINDS)
def test_nystrom_matches_reference(kind):
    n, m, d = 37, 64, 16
    x, z, beta = kernel_inputs(n, m, d, 0)
    rk = r_nys.KernelSpec(kind, sigma=sigma_for(d))
    pk = p_nys.KernelSpec(kind, sigma=sigma_for(d))
    xj, zj = jnp.asarray(x), jnp.asarray(z)
    assert_close_fp32(p_nys.sqdist(t(x), t(z)), r_nys.sqdist(xj, zj))
    assert_close_fp32(p_nys.gram(t(x), t(z), pk), r_nys.gram(xj, zj, rk))
    assert_close_fp32(p_nys.build_C(t(x), t(z), pk),
                      r_nys.build_C(xj, zj, rk))
    assert_close_fp32(p_nys.build_W(t(z), pk), r_nys.build_W(zj, rk))
    assert_close_fp32(p_nys.predict(t(x), t(z), t(beta), pk),
                      r_nys.predict(xj, zj, jnp.asarray(beta), rk))


def test_kernel_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown kernel kind"):
        p_nys.KernelSpec("laplace")


def test_gram_diagonal_cancellation_matches_reference():
    """The input recorded in .hypothesis/patches/2026-10-17--f897b4f8.patch:
    two identical rows of 4.0961785, d = 10, sigma = 1.5. The exact W is all
    ones; the reference's fp32 expansion |x|^2 + |z|^2 - 2 x.z cancels and
    gives a diagonal of about 1 - 1.4e-5, outside the property test's rtol
    of 1e-5 (a known reference failure). The port keeps the same expansion
    on purpose, so it matches the reference here rather than the exact
    value: its W agrees with the reference's at the fp32 bar, and its
    diagonal also falls short of 1. How far short depends on the order of
    the fp32 sums (about 6.8e-6 with torch's on the CPU), so only the sign
    of the shortfall is asserted for the port."""
    x = np.full((2, 10), 4.0961785, np.float32)
    kern_r = r_nys.KernelSpec("gaussian", sigma=1.5)
    kern_p = p_nys.KernelSpec("gaussian", sigma=1.5)
    want = np.asarray(r_nys.build_W(jnp.asarray(x), kern_r))
    got = to_np(p_nys.build_W(t(x), kern_p))
    assert_close_fp32(got, want)
    assert 1.0 - np.diag(want).min() > 1e-5      # the reference's fault
    assert np.diag(got).max() < 1.0              # inherited, not fixed


# ------------------------------------------- kernels through plain versions
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_ops_gram_matches_reference_kernel(shape, kind):
    n, m, d = shape
    x, z = kernel_inputs(n, m, d)
    kw = dict(kind=kind, sigma=sigma_for(d))
    got = p_ops.gram(t(x), t(z), **kw)
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert_close_fp32(got, r_ops.gram(jnp.asarray(x), jnp.asarray(z), **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 3])
def test_ops_kmvp_fwd_matches_reference_kernel(shape, kind, k):
    n, m, d = shape
    x, z, b = kernel_inputs(n, m, d, k)
    kw = dict(kind=kind, sigma=sigma_for(d))
    xj, zj, bj = jnp.asarray(x), jnp.asarray(z), jnp.asarray(b)
    want = np.asarray(r_ops.kmvp_fwd(xj, zj, bj, **kw))
    want_jnp = np.asarray(r_ops.otf_kmvp_fwd(xj, zj, bj, backend="jnp", **kw))
    for fn in (p_ops.kmvp_fwd, p_ops.kmvp_fwd_chunked, p_ops.otf_kmvp_fwd):
        got = fn(t(x), t(z), t(b), **kw)
        assert got.shape == (n, k)
        assert_close_fp32(got, want)
        assert_close_fp32(got, want_jnp)


@pytest.mark.parametrize("kind", KINDS)
def test_multirhs_column_independence(kind):
    """Each column of a multi-RHS call equals the single-vector call on
    that column (the reference's bar for the same property)."""
    n, m, d = 65, 40, 7
    x, z, B = kernel_inputs(n, m, d, 3)
    kw = dict(kind=kind, sigma=sigma_for(d))
    O = to_np(p_ops.kmvp_fwd(t(x), t(z), t(B), **kw))
    for c in range(3):
        np.testing.assert_allclose(
            O[:, c], to_np(p_ops.kmvp_fwd(t(x), t(z), t(B[:, c]), **kw)),
            rtol=1e-5, atol=1e-5)


def test_one_dimensional_beta_squeezes():
    n, m, d = 37, 64, 16
    x, z, b = kernel_inputs(n, m, d, 0)
    kw = dict(kind="gaussian", sigma=sigma_for(d))
    for fn in (p_ops.kmvp_fwd, p_ops.kmvp_fwd_chunked, p_ops.otf_kmvp_fwd):
        got = fn(t(x), t(z), t(b), **kw)
        assert got.shape == (n,)
        np.testing.assert_array_equal(
            to_np(got), to_np(fn(t(x), t(z), t(b[:, None]), **kw))[:, 0])
        assert_close_fp32(got, r_ops.kmvp_fwd(jnp.asarray(x), jnp.asarray(z),
                                              jnp.asarray(b), **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 4])
def test_ops_kmvp_t_matches_reference_kernel(shape, kind, k):
    """g = C^T v through the port's plain version against the reference's
    Pallas kmvp_t (interpret mode off-TPU) and its materializing oracle."""
    n, m, d = shape
    x, z = kernel_inputs(n, m, d)
    v = np.random.default_rng(2).standard_normal((n, k)).astype(np.float32)
    kw = dict(kind=kind, sigma=sigma_for(d))
    xj, zj, vj = jnp.asarray(x), jnp.asarray(z), jnp.asarray(v)
    want = np.asarray(r_ops.kmvp_t(xj, zj, vj, **kw))
    want_ref = np.asarray(r_ref.kmvp_t_ref(xj, zj, vj, **kw))
    for fn in (p_ops.kmvp_t, p_ops.kmvp_t_chunked, p_ops.otf_kmvp_t,
               p_kmvp.kmvp_t_plain, p_kmvp.kmvp_t):
        got = fn(t(x), t(z), t(v), **kw)
        assert got.shape == (m, k) and got.dtype == torch.float32
        assert_close_fp32(got, want)
        assert_close_fp32(got, want_ref)


@pytest.mark.parametrize("kind", KINDS)
def test_kmvp_t_is_the_adjoint_of_kmvp_fwd(kind):
    """<C b, v> = <b, C^T v> over the same implicit C, in float64 sums of
    the fp32 results (the reference's adjoint check)."""
    n, m, d = 130, 96, 54
    x, z, b = kernel_inputs(n, m, d, 3)
    v = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    kw = dict(kind=kind, sigma=sigma_for(d))
    cb = to_np(p_ops.kmvp_fwd(t(x), t(z), t(b), **kw)).astype(np.float64)
    ctv = to_np(p_ops.kmvp_t(t(x), t(z), t(v), **kw)).astype(np.float64)
    lhs, rhs = np.sum(cb * v), np.sum(b * ctv)
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs)), (lhs, rhs)


def test_kmvp_t_squeezes_and_chunks():
    """A 1-D v gives an (m,) result equal to the (n, 1) column; the plain
    version's row chunk (padded rows included) changes nothing beyond fp32
    rounding, and the default chunk is keyed on m."""
    n, m, d = 37, 64, 16
    x, z = kernel_inputs(n, m, d)
    v = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    kw = dict(kind="gaussian", sigma=sigma_for(d))
    for fn in (p_ops.kmvp_t, p_ops.kmvp_t_chunked, p_ops.otf_kmvp_t):
        got = fn(t(x), t(z), t(v), **kw)
        assert got.shape == (m,)
        np.testing.assert_array_equal(
            to_np(got), to_np(fn(t(x), t(z), t(v[:, None]), **kw))[:, 0])
    want = r_ops.kmvp_t(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v), **kw)
    for rows in (8, 16, 40):
        assert_close_fp32(p_ops.kmvp_t_chunked(t(x), t(z), t(v),
                                               block_rows=rows, **kw), want)
    np.testing.assert_array_equal(
        to_np(p_ops.kmvp_t(t(x), t(z), t(v), **kw)),
        to_np(p_ops.kmvp_t_chunked(t(x), t(z), t(v),
                                   block_rows=p_ops.otf_block_rows(m), **kw)))


def test_plain_fused_rows_do_not_depend_on_the_batch():
    """The plain fused version pads every row chunk to one shape, so a row's
    margin is bitwise the same alone, at any position, in any batch."""
    n, m, d = 300, 96, 54
    x, z, b = kernel_inputs(n, m, d, 3)
    kw = dict(kind="gaussian", sigma=sigma_for(d))
    full = to_np(p_ops.kmvp_fwd(t(x), t(z), t(b), **kw))
    for i in (0, 5, 127, 128, 299):
        alone = to_np(p_ops.kmvp_fwd(t(x[i:i + 1]), t(z), t(b), **kw))
        np.testing.assert_array_equal(alone[0], full[i])
        pair = to_np(p_ops.kmvp_fwd(t(x[[7, i]]), t(z), t(b), **kw))
        np.testing.assert_array_equal(pair[1], full[i])


def test_otf_block_rows_depends_on_m_only():
    assert p_ops.otf_block_rows(16384) == 16       # 1 MiB of fp32 rows
    assert p_ops.otf_block_rows(96) == 128         # capped
    assert p_ops.otf_block_rows(1 << 20) == 8      # floored
    for m in (1, 40, 64, 96, 300, 5000, 16384):
        rows = p_ops.otf_block_rows(m)
        assert rows % 8 == 0 and 8 <= rows <= 128


@pytest.mark.parametrize("n", [0, 5, 8, 21])
def test_padded_row_blocks_cover_every_row_once(n):
    """Every block has exactly ``rows`` rows; the real rows, in order,
    are the input, and the padding is zeros."""
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    v = torch.arange(n, dtype=torch.float32)[:, None] + 1.0
    starts, xs, vs = [], [], []
    for i, count, xb, vb in p_gram.padded_row_blocks(8, x, v):
        assert xb.shape == (8, 3) and vb.shape == (8, 1)
        assert not xb[count:].any() and not vb[count:].any()
        starts.append(i)
        xs.append(xb[:count])
        vs.append(vb[:count])
    assert starts == list(range(0, n, 8))
    if n:
        assert torch.equal(torch.cat(xs), x) and torch.equal(torch.cat(vs), v)


# -------------------------------------------------------- wrapper contracts
def test_wrappers_reject_what_the_kernels_do_not_take():
    x, z, b = kernel_inputs(8, 16, 4, 2)
    X, Z, B = t(x), t(z), t(b)
    with pytest.raises(NotImplementedError, match="float32"):
        p_gram.gram(X.double(), Z.double())
    with pytest.raises(ValueError, match="contiguous"):
        p_gram.gram(t(np.ones((4, 8), np.float32)).T, Z)
    with pytest.raises(ValueError, match="feature dims"):
        p_gram.gram(X, t(np.ones((16, 5), np.float32)))
    with pytest.raises(ValueError, match="2-D"):
        p_gram.gram(X[None], Z)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        p_gram.gram(X, Z, kind="laplace")
    with pytest.raises(ValueError, match="no kernel for device"):
        p_gram.gram(X.to("meta"), Z.to("meta"))
    with pytest.raises(ValueError, match="shapes disagree"):
        p_kmvp.kmvp_fwd(X, Z, B[:8])
    with pytest.raises(ValueError, match="right-hand sides"):
        p_kmvp.kmvp_fwd(X, Z, t(np.ones((16, 17), np.float32)))
    with pytest.raises(NotImplementedError, match="precision slice"):
        p_ops.gram(X, Z, policy="bf16")
    with pytest.raises(NotImplementedError, match="precision slice"):
        p_ops.kmvp_fwd(X, Z, B, policy="fp16")
    V = t(np.ones((8, 2), np.float32))
    with pytest.raises(ValueError, match="shapes disagree"):
        p_kmvp.kmvp_t(X, Z, V[:5])
    with pytest.raises(ValueError, match="right-hand sides"):
        p_kmvp.kmvp_t(X, Z, t(np.ones((8, 17), np.float32)))
    with pytest.raises(NotImplementedError, match="float32"):
        p_kmvp.kmvp_t(X.double(), Z.double(), V.double())
    with pytest.raises(NotImplementedError, match="precision slice"):
        p_ops.kmvp_t(X, Z, V, policy="bf16")


def test_cpu_path_never_counts_a_launch():
    x, z, b = kernel_inputs(8, 16, 4, 2)
    before = (p_gram.launches, p_kmvp.launches, p_kmvp.kmvp_t_launches)
    p_ops.gram(t(x), t(z))
    p_ops.kmvp_fwd(t(x), t(z), t(b))
    p_ops.kmvp_t(t(x), t(z), t(np.ones((8, 2), np.float32)))
    assert (p_gram.launches, p_kmvp.launches,
            p_kmvp.kmvp_t_launches) == before


# ------------------------------------------------------- policies and losses
def test_policies_match_reference():
    assert set(p_policy.POLICIES) == set(r_policy.POLICIES)
    for name, pol in p_policy.POLICIES.items():
        ref = r_policy.POLICIES[name]
        assert (pol.compute, pol.accum, pol.param, pol.store) == \
            (ref.compute, ref.accum, ref.param, ref.store)
        assert pol.is_default == ref.is_default
    assert p_policy.BF16.compute_dtype == torch.bfloat16
    assert p_policy.get_policy(None) is p_policy.FP32
    with pytest.raises(ValueError, match="unknown dtype policy"):
        p_policy.get_policy("int4")
    with pytest.raises(TypeError):
        p_policy.DtypePolicy(compute="float8")


@pytest.mark.parametrize("name", sorted(r_losses.LOSSES))
def test_losses_match_reference(name):
    rng = np.random.default_rng(3)
    o = (rng.standard_normal(200) * 3).astype(np.float32)
    y = np.where(rng.random(200) < 0.5, -1.0, 1.0).astype(np.float32)
    rl, pl = r_losses.get_loss(name), p_losses.get_loss(name)
    for part in ("value", "grad", "diag"):
        assert_close_fp32(getattr(pl, part)(t(o), t(y)),
                          getattr(rl, part)(jnp.asarray(o), jnp.asarray(y)))
    with pytest.raises(KeyError, match="unknown loss"):
        p_losses.get_loss("hinge_cubed")
