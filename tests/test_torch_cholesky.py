"""Port parity: the batched Cholesky factor and its inverse
(``dgp_tpu_torch/ops/cholesky.py``, kernels #7 and #8) against
``jnp.linalg.cholesky`` / ``jsl.solve_triangular`` and against the TPU
kernels of ``benchmarks/chol_probe.py`` run by the Pallas interpreter, in
float64 on CPU; the hand-written Cholesky adjoint against autograd and
``jax.grad``; and a matrix that is not positive definite giving NaN instead
of an exception, in the plain versions and in the model code that calls
them."""

import os
import sys

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from dgp_tpu_torch import _build
from dgp_tpu_torch.layers.svgp import layer_kl, make_svgp_layer
from dgp_tpu_torch.ops import cholesky as tch
from dgp_tpu_torch.ops import conditionals as TC
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spd_stack(G, M, seed=0):
    """[G, M, M] symmetric positive definite, condition number ~10-100."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(G, M, M))
    return B @ np.swapaxes(B, -1, -2) / M + 0.1 * np.eye(M)


def jax_factors(A):
    L = jnp.linalg.cholesky(jnp.asarray(A))
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1]), A.shape)
    return np.asarray(L), np.asarray(jsl.solve_triangular(L, eye, lower=True))


def assert_close(got, want, rtol):
    """Within rtol of each entry and of the array's largest entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("G,M", [(2, 24), (1, 8), (3, 64)])
def test_plain_versions_match_jax(G, M):
    A = spd_stack(G, M, seed=M)
    L_want, W_want = jax_factors(A)
    At = torch.tensor(A, dtype=F64)
    assert_close(tch.cholesky_plain(At), L_want, 1e-12)
    L, W = tch.cholesky_inverse_plain(At)
    assert_close(L, L_want, 1e-12)
    assert_close(W, W_want, 1e-12)
    # the dispatch on CPU tensors is the plain version
    assert torch.equal(tch.cholesky(At), tch.cholesky_plain(At))
    assert all(torch.equal(a, b) for a, b in
               zip(tch.cholesky_inverse(At), (L, W)))


@pytest.fixture(scope="module")
def chol_probe():
    """benchmarks/chol_probe.py with its kernels in interpret mode (the
    module's own switch; the file is not edited)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import chol_probe
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmarks"))
    old = chol_probe._INTERPRET
    chol_probe._INTERPRET = True
    yield chol_probe
    chol_probe._INTERPRET = old


@pytest.mark.parametrize("M", [24, 128])
def test_plain_versions_match_the_probe_kernels(chol_probe, M):
    """The TPU kernels themselves (#7 ``_chol_kernel``, #8
    ``_chol_inv_kernel``) interpreted in float64 agree with LAPACK only to
    ~5e-9 of scale: their rank-1 updates and inverse-row products ask for
    float32 accumulation (``preferred_element_type=jnp.float32``), and the
    M-step chain carries that rounding. So they are held at 1e-7 of scale,
    the plain versions (above) at 1e-12 of LAPACK."""
    A = spd_stack(2, M, seed=M + 1)
    At = torch.tensor(A, dtype=F64)
    L, W = tch.cholesky_inverse_plain(At)
    L7 = np.asarray(chol_probe.chol_pallas(jnp.asarray(A)))
    L8, W8 = (np.asarray(a) for a in chol_probe.chol_inv_pallas(jnp.asarray(A)))
    for got, want in [(L, L7), (L, L8), (W, W8)]:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-7, err


def function_of(inverse):
    """A free [2, 5, 5] matrix X -> the Function's outputs at A = X X^T + I
    (a symmetric input whose every entry X moves)."""
    fn = tch.CholeskyInverse.apply if inverse else tch.Cholesky.apply

    def f(X):
        return fn(X @ X.mT + torch.eye(X.shape[-1], dtype=X.dtype))

    return f


@pytest.mark.parametrize("inverse", [False, True])
def test_function_gradcheck(inverse):
    X = torch.tensor(np.random.default_rng(3).normal(size=(2, 5, 5)),
                     dtype=F64, requires_grad=True)
    assert torch.autograd.gradcheck(function_of(inverse), (X,))


@pytest.mark.parametrize("inverse", [False, True])
def test_function_backward_matches_jax_grad(inverse):
    """The hand-written adjoint (with W standing in for L^{-1} in #8) on CPU
    tensors, against jax.grad of the same scalar of (L, W) through
    jnp.linalg.cholesky and jsl.solve_triangular."""
    rng = np.random.default_rng(4)
    A = spd_stack(2, 12, seed=5)
    C1, C2 = rng.normal(size=A.shape), rng.normal(size=A.shape)

    def scalar_jax(A):
        L = jnp.linalg.cholesky(A)
        s = jnp.sum(jnp.tril(C1) * L)
        if inverse:
            W = jsl.solve_triangular(L, jnp.broadcast_to(jnp.eye(12), A.shape),
                                     lower=True)
            s = s + jnp.sum(jnp.tril(C2) * W)
        return s

    want = np.asarray(jax.grad(scalar_jax)(jnp.asarray(A)))
    At = torch.tensor(A, dtype=F64, requires_grad=True)
    if inverse:
        L, W = tch.CholeskyInverse.apply(At)
        s = (torch.tril(torch.tensor(C1)) * L).sum() + (
            torch.tril(torch.tensor(C2)) * W).sum()
    else:
        s = (torch.tril(torch.tensor(C1)) * tch.Cholesky.apply(At)).sum()
    (got,) = torch.autograd.grad(s, At)
    assert_close(got, want, 1e-8)


def test_function_on_cpu_is_the_plain_version():
    A = torch.tensor(spd_stack(2, 9, seed=6), dtype=F64)
    before = (tch.Cholesky.launches, tch.CholeskyInverse.launches)
    assert torch.equal(tch.Cholesky.apply(A), tch.cholesky_plain(A))
    L, W = tch.CholeskyInverse.apply(A)
    Lp, Wp = tch.cholesky_inverse_plain(A)
    assert torch.equal(L, Lp) and torch.equal(W, Wp)
    empty = tch.CholeskyInverse.apply(A[:0])
    assert [tuple(t.shape) for t in empty] == [(0, 9, 9)] * 2
    assert (tch.Cholesky.launches, tch.CholeskyInverse.launches) == before


def test_gate_refuses_cpu_and_float64_without_building(monkeypatch):
    def no_build(*args):
        raise AssertionError("the gate built a library")

    monkeypatch.setattr(_build, "load", no_build)
    A = torch.tensor(spd_stack(1, 4), dtype=F64)
    assert not tch.applicable(A) and not tch.applicable(A.float(), True)
    tch.cholesky(A.float())
    tch.cholesky_inverse(A)


def not_pd_stack():
    """Three matrices, the middle one indefinite (an eigenvalue of -1)."""
    A = spd_stack(3, 6, seed=7)
    A[1] -= (np.linalg.eigvalsh(A[1]).min() + 1.0) * np.eye(6)
    return A


@pytest.mark.parametrize("inverse", [False, True])
def test_not_positive_definite_gives_nan_not_a_raise(inverse):
    """A stack with one indefinite matrix: NaN in that matrix only, where
    jnp.linalg.cholesky and jsl.solve_triangular put it (L's lower
    triangle, all of W), the others as LAPACK gives them; the backward runs
    too, and the other matrices' gradients stay finite."""
    A = not_pd_stack()
    L_want, W_want = jax_factors(A)
    assert np.isnan(L_want[1][np.tril_indices(6)]).all()
    assert np.isnan(W_want[1]).all()
    At = torch.tensor(A, dtype=F64, requires_grad=True)
    fn = tch.CholeskyInverse.apply if inverse else tch.Cholesky.apply
    for out in (fn(At), tch.cholesky_inverse(At) if inverse else tch.cholesky(At)):
        outs = out if inverse else (out,)
        for got, want in zip(outs, (L_want, W_want)):
            np.testing.assert_array_equal(got[1].detach().numpy(), want[1])
            assert_close(got[[0, 2]], want[[0, 2]], 1e-12)
        (g,) = torch.autograd.grad(sum(o.sum() for o in outs), At)
        assert torch.isfinite(g[[0, 2]]).all()


def test_model_code_gives_nan_for_an_indefinite_kuu():
    """The repaired fault: precompute_projection(s) and the non-whitened
    KL took torch.linalg.cholesky, which raises mid-phase on a Kuu that is
    not positive definite; dgp_tpu gives NaN there and its loops warn after
    the phase. Now the port gives NaN too, for that layer only."""
    rng = np.random.default_rng(8)
    Z = torch.tensor(rng.uniform(size=(5, 2)), dtype=F64)
    good =TK.RBF.create(lengthscales=[0.5, 0.5], dtype=F64)
    q_sqrt = torch.eye(5, dtype=F64)[None]
    items = [(good, Z, q_sqrt, False), (_NegativeKernel(), Z, q_sqrt, False),
             (good, Z, q_sqrt, True)]
    projs = TC.precompute_projections(items)
    lower = np.tril_indices(5)
    for p, finite in zip(projs, (True, False, True)):
        assert bool(torch.isfinite(p.Pinv).all()) == finite
        assert finite or bool(torch.isnan(p.Pinv).all())
        assert bool(torch.isfinite(p.Lu).all()) == finite
        assert finite or bool(torch.isnan(p.Lu[lower]).all())
    single = TC.precompute_projection(_NegativeKernel(), Z, q_sqrt, True)
    assert torch.isnan(single.Lu[lower]).all()
    assert torch.isnan(single.Pinv).all()
    layer = make_svgp_layer(good, Z.numpy(), 1, white=False, dtype=F64)
    assert torch.isfinite(layer_kl(layer, layer.z))
    layer.kernel = _NegativeKernel()
    assert torch.isnan(layer_kl(layer, layer.z))


def test_layer_init_gives_nan_for_an_indefinite_kuu():
    """make_svgp_layer's non-whitened q_sqrt = chol(Kuu) took
    torch.linalg.cholesky, which raised on such a Kuu; dgp_tpu's layer init
    gives NaN. Now the port does too, and a positive-definite Kuu still
    gives its factor."""
    rng = np.random.default_rng(9)
    Z = rng.uniform(size=(5, 2))
    lower = np.tril_indices(5)
    bad = make_svgp_layer(_NegativeKernel(), Z, 2, white=False, dtype=F64)
    assert bad.q_sqrt.shape == (2, 5, 5)
    assert torch.isnan(bad.q_sqrt[:, lower[0], lower[1]]).all()
    good = TK.RBF.create(lengthscales=[0.5, 0.5], dtype=F64)
    layer = make_svgp_layer(good, Z, 2, white=False, dtype=F64)
    Kuu = good.K(torch.tensor(Z)) + 1e-6 * torch.eye(5, dtype=F64)
    want = torch.linalg.cholesky(Kuu).detach()
    assert_close(layer.q_sqrt, want.expand(2, 5, 5).numpy(), 1e-12)


def test_kl_takes_the_projections_factor():
    """The ELBO hands each non-whitened layer's SVGPProjection.Lu to
    layer_kl instead of factoring Kuu a second time: the KL and its
    gradient are those of the layer's own factorization, and the projection
    still gives the JAX package's Kuu^{-1} as Pinv on demand."""
    rng = np.random.default_rng(10)
    Z = rng.uniform(size=(6, 2))
    kern = TK.RBF.create(lengthscales=[0.4, 0.7], dtype=F64)
    layer = make_svgp_layer(kern, Z, 2, white=False, dtype=F64)
    with torch.no_grad():
        layer.q_mu.copy_(torch.tensor(rng.normal(size=(6, 2))))
        layer.q_sqrt.mul_(1.0 + 0.1 * torch.tensor(rng.normal(size=(2, 6, 6))))
    (proj,) = TC.precompute_projections(
        [(layer.kernel, layer.z, layer.q_sqrt, False)])
    shared, own = layer_kl(layer, layer.z, proj.Lu), layer_kl(layer, layer.z)
    params = list(layer.parameters())
    g_shared = torch.autograd.grad(shared, params)
    g_own = torch.autograd.grad(own, params)
    assert_close(shared, own.detach().numpy(), 1e-12)
    for a, b in zip(g_shared, g_own):
        assert_close(a, b.numpy(), 1e-10)
    assert_close(proj.Pinv, torch.linalg.inv(proj.Kuu).detach().numpy(), 1e-10)


class _NegativeKernel(TK.Kernel):
    """K(Z) = -(1 + Z Z^T): negative definite at any Z."""

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        return -(1.0 + X @ X2.T)

    def K_diag(self, X):
        return -(1.0 + torch.sum(X * X, dim=-1))
