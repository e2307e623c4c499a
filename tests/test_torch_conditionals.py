"""Port parity: conditionals and the fused-conditional module of
dgp_tpu_torch against dgp_tpu, in float64 on CPU (and one float32 case
against the JAX Pallas kernel run by its interpreter)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.ops import conditional_fused_rbf as jcfr
from dgp_tpu.ops import conditionals as jcond
from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch.ops import conditional_fused_rbf as tcfr
from dgp_tpu_torch.ops import conditionals as tcond
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


F64 = torch.float64
RTOL = 1e-10
KINDS = {0: "RBF", 1: "Matern32", 2: "Matern52"}


@functools.lru_cache(maxsize=None)
def jitted(fn, **static):
    """One compiled program per shape: much cheaper in the tests than JAX's
    op-by-op compiles."""
    return jax.jit(functools.partial(fn, **static))


def t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def problem(kernel="RBF", M=7, n=11, Din=2, D=3, seed=0):
    """Same kernel and perturbed q in both packages (q_mu ~ N(0,1),
    q_sqrt = tril(0.3 N + 2 I)), from numpy."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(M, Din))
    X = rng.normal(size=(n, Din))
    q_mu = rng.normal(size=(M, D))
    q_sqrt = np.tril(rng.normal(size=(D, M, M)) * 0.3 + 2 * np.eye(M))
    ls = list(rng.uniform(0.6, 1.4, size=Din))
    if kernel == "Sum":
        make = lambda k, kw: (k.RBF.create(variance=1.4, lengthscales=ls, **kw)
                              + k.Linear.create(variance=0.3, **kw))
    else:
        make = lambda k, kw: getattr(k, kernel).create(
            variance=1.4, lengthscales=ls, **kw)
    return (make(JK, {}), make(TK, {"dtype": F64}), Z, X, q_mu, q_sqrt)


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "Sum"])
def test_conditional_diag_matches_reference(kernel, white):
    jk, tk, Z, X, q_mu, q_sqrt = problem(kernel)
    mj, vj = jitted(jcond.conditional_diag, white=white)(
        jk, jnp.asarray(Z), jnp.asarray(q_mu), jnp.asarray(q_sqrt),
        jnp.asarray(X))
    mt, vt = tcond.conditional_diag(tk, t(Z), t(q_mu), t(q_sqrt), t(X),
                                    white=white)
    close(mt, mj)
    close(vt, vj)


@pytest.mark.parametrize("white", [True, False])
def test_conditional_full_matches_reference(white):
    jk, tk, Z, X, q_mu, q_sqrt = problem("Matern32")
    mj, cj = jitted(jcond.conditional_full, white=white)(
        jk, jnp.asarray(Z), jnp.asarray(q_mu), jnp.asarray(q_sqrt),
        jnp.asarray(X))
    mt, ct = tcond.conditional_full(tk, t(Z), t(q_mu), t(q_sqrt), t(X),
                                    white=white)
    close(mt, mj)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), rtol=RTOL,
                               atol=1e-13 * float(np.max(np.abs(cj))))


def test_precompute_projections_matches_reference():
    """Two layers share (M, white) and batch; a third differs in M."""
    items_j, items_t = [], []
    for seed, (M, white) in enumerate([(7, True), (7, True), (5, False)]):
        jk, tk, Z, _, _, q_sqrt = problem("RBF", M=M, seed=seed)
        items_j.append((jk, jnp.asarray(Z), jnp.asarray(q_sqrt), white))
        items_t.append((tk, t(Z), t(q_sqrt), white))
    for pj, pt in zip(jcond.precompute_projections(items_j),
                      tcond.precompute_projections(items_t)):
        for name in ("Lu", "Kuu", "SK", "Pinv"):
            want = np.asarray(getattr(pj, name))
            np.testing.assert_allclose(getattr(pt, name).detach().numpy(), want,
                                       rtol=RTOL,
                                       atol=1e-14 * np.max(np.abs(want)))


@pytest.mark.parametrize("full_cov", [False, True])
def test_reparameterize_matches_reference(full_cov):
    rng = np.random.default_rng(3)
    S, N, D = 2, 5, 3
    mean = rng.normal(size=(S, N, D))
    z = rng.normal(size=(S, N, D))
    if full_cov:
        G = rng.normal(size=(S, D, N, N))
        var = np.moveaxis(G @ np.swapaxes(G, -1, -2) + np.eye(N), 1, -1)
    else:
        var = rng.uniform(0.1, 2.0, size=(S, N, D))
    want = jcond.reparameterize(jnp.asarray(mean), jnp.asarray(var),
                                jnp.asarray(z), full_cov=full_cov)
    close(tcond.reparameterize(t(mean), t(var), t(z), full_cov=full_cov), want)


def fused_inputs(kind, D=3, M=7, n=11, Din=2, dtype=F64, seed=0):
    """Whitened stationary problem in both packages: (JAX kernel, port
    kernel, Z, X, q_mu, q_sqrt), with the perturbed q of
    tests/test_conditional_fused_rbf.py (the default sizes are those of
    :func:`problem`, so JAX reuses its compiled operations)."""
    rng = np.random.default_rng(seed)
    Z = rng.uniform(size=(M, Din))
    X = rng.uniform(size=(n, Din))
    q_mu = rng.normal(size=(M, D))
    q_sqrt = np.tril(rng.normal(size=(D, M, M)) * 0.05 + np.eye(M))
    kw = dict(variance=1.3, lengthscales=[0.5] * Din)
    jk = getattr(JK, KINDS[kind]).create(
        dtype=jnp.float64 if dtype == F64 else jnp.float32, **kw)
    tk = getattr(TK, KINDS[kind]).create(dtype=dtype, **kw)
    return jk, tk, Z, X, q_mu, q_sqrt


def port_fused(tk, kind, Z, X, q_mu, q_sqrt, dtype, fn):
    """fn(kind, Pinv, Xs, Zs, v, q_mu, Sq) on the port's own projection."""
    Zt, Xt = t(Z, dtype), t(X, dtype)
    q_sqrt_t = t(q_sqrt, dtype)
    proj = tcond.precompute_projection(tk, Zt, q_sqrt_t, True)
    ls = tk.lengthscales
    Sq = torch.tril(q_sqrt_t).transpose(-1, -2)
    with torch.no_grad():
        return fn(kind, proj.Pinv, Xt / ls, Zt / ls, tk.variance,
                  t(q_mu, dtype), Sq)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_plain_matches_reference_path(kind):
    """The plain version of the fused kernel, directly and through the
    wrapper on CPU tensors, equals dgp_tpu's jnp conditional in f64."""
    jk, tk, Z, X, q_mu, q_sqrt = fused_inputs(kind)
    mj, vj = jitted(jcond.conditional_diag, white=True)(
        jk, jnp.asarray(Z), jnp.asarray(q_mu), jnp.asarray(q_sqrt),
        jnp.asarray(X))
    before = tcfr.FusedConditional.launches
    for fn in (tcfr.fused_conditional_plain,
               tcfr.fused_conditional_white_stationary):
        mt, vt = port_fused(tk, kind, Z, X, q_mu, q_sqrt, F64, fn)
        close(mt, mj)
        close(vt, vj)
    assert tcfr.FusedConditional.launches == before  # no kernel on the CPU


def test_fused_plain_f32_matches_pallas_interpreter(monkeypatch):
    """One float32 case against the JAX Pallas kernel itself (interpreted);
    n = 1100 is not a tile multiple, so the JAX side pads. Tolerances as in
    tests/test_conditional_fused_rbf.py: the kernel's dots emulate the MXU's
    bf16 passes even when interpreted."""
    monkeypatch.setattr(jcfr, "_INTERPRET", True)
    kind, D, M, n, Din = 2, 2, 64, 1100, 3
    jk, tk, Z, X, q_mu, q_sqrt = fused_inputs(kind, D, M, n, Din, torch.float32)
    captured = {}

    def both(kind, Pinv, Xs, Zs, v, q_mu_t, Sq):
        captured["args"] = [np.asarray(a.numpy(), np.float32)
                            for a in (Pinv, Xs, Zs, v, q_mu_t, Sq)]
        return tcfr.fused_conditional_plain(kind, Pinv, Xs, Zs, v, q_mu_t, Sq)

    mt, vt = port_fused(tk, kind, Z, X, q_mu, q_sqrt, torch.float32, both)
    mj, vj = jcfr.fused_conditional_white_stationary(
        kind, *[jnp.asarray(a) for a in captured["args"]])
    mj, vj = np.asarray(mj), np.asarray(vj)
    assert mj.shape == (n, D) and vj.shape == (n, D)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-3,
                               atol=1e-4 * float(np.max(np.abs(mj))))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-3,
                               atol=1e-3 * float(np.max(vj)))


def test_fused_gate_keeps_cpu_and_f64_on_plain_path():
    """The gate turns CPU tensors, float64 and non-stationary kernels away
    before it asks the CUDA library about sizes (the size gate is tested on
    the card, in test_torch_cuda.py)."""
    _, tk, Z, X, _, q_sqrt = fused_inputs(0, dtype=torch.float32)
    Sq = t(q_sqrt, torch.float32)
    assert tcfr.fused_kind(tk, Sq, t(X, torch.float32)) is None  # CPU
    assert tcfr.fused_kind(tk, t(q_sqrt), t(X)) is None          # float64
    linear = TK.Linear.create(dtype=torch.float32)
    assert tcfr.fused_kind(linear, Sq, t(X, torch.float32)) is None


def test_fused_backward_raises():
    """While the port had no backward this call raised. It now returns the
    plain backward's gradients (CPU tensors) and raises nothing."""
    kind = 0
    _, tk, Z, X, q_mu, q_sqrt = fused_inputs(kind)
    Xs = t(X).requires_grad_(True)
    Zt, q_sqrt_t = t(Z), t(q_sqrt)
    with torch.no_grad():
        proj = tcond.precompute_projection(tk, Zt, q_sqrt_t, True)
        args = (proj.Pinv, Xs, Zt, tk.variance.detach(), t(q_mu),
                torch.tril(q_sqrt_t).transpose(-1, -2))
    mean, var = tcfr.fused_conditional_white_stationary(kind, *args)
    (mean.sum() + var.sum()).backward()
    want = tcfr.fused_conditional_backward_plain(
        kind, *[a.detach() for a in args], torch.ones_like(mean),
        torch.ones_like(var))
    assert torch.equal(Xs.grad, want[1]) and float(Xs.grad.abs().max()) > 0
