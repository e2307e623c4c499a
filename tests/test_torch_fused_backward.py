"""The fused conditional's hand-derived backward (the plain version the
CUDA backward kernel is held to), in float64 on CPU: against autograd of the
plain forward and jax.grad of dgp_tpu's function, each projected as the
backward returns dPinv and dSq (on the patterns of the lower-triangular Pinv
and the upper-triangular Sq), against jax.grad of dgp_tpu's conditional, and
(float32) against the JAX Pallas backward kernel run by its interpreter."""

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
KINDS = {0: "RBF", 1: "Matern32", 2: "Matern52"}
NAMES = ("dPinv", "dXs", "dZs", "dvariance", "dq_mu", "dSq")


def t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def projected(name, g):
    """A full gradient on the backward's pattern: dPinv's lower triangle,
    dSq's upper one; the others as they are."""
    if name == "dPinv":
        return np.tril(np.asarray(g))
    if name == "dSq":
        return np.triu(np.asarray(g))
    return np.asarray(g)


def jax_function(kind, Pinv, Xs, Zs, variance, q_mu, Sq):
    """dgp_tpu's fused stationary conditional in jnp: its Pallas kernel's
    math with dgp_tpu's own k(sq)."""
    xx = jnp.sum(Xs * Xs, axis=1)[None, :]
    zz = jnp.sum(Zs * Zs, axis=1)[:, None]
    sqd = jnp.maximum((xx - 2.0 * (Zs @ Xs.T)) + zz, 0.0)
    A = Pinv @ jcfr._kuf_tile(kind, variance, sqd)
    B = Sq @ A
    var = (variance - jnp.sum(A * A, axis=0)) + jnp.sum(B * B, axis=1)
    return A.T @ q_mu, jnp.maximum(var, 0.0).T


def raw_inputs(D=3, M=7, n=23, Din=2, seed=0):
    """Inputs of the fused function itself. X and Z are separate uniform
    draws, so no point sits on an inducing input and no mask is at a tie."""
    rng = np.random.default_rng(seed)
    return dict(
        Pinv=np.tril(rng.normal(size=(M, M))),
        Xs=2.0 * rng.uniform(size=(n, Din)),
        Zs=2.0 * rng.uniform(size=(M, Din)),
        variance=np.asarray(1.3),
        q_mu=rng.normal(size=(M, D)),
        Sq=np.triu(0.3 * rng.normal(size=(D, M, M)) + np.eye(M)),
        g_mean=rng.normal(size=(n, D)),
        g_var=rng.normal(size=(n, D)),
    )


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_backward_plain_matches_autograd_of_plain_forward(kind):
    a = {k: t(v) for k, v in raw_inputs(seed=kind).items()}
    g_mean, g_var = a.pop("g_mean"), a.pop("g_var")
    leaves = [v.clone().requires_grad_(True) for v in a.values()]
    mean, var = tcfr.fused_conditional_plain(kind, *leaves)
    want = torch.autograd.grad((mean * g_mean).sum() + (var * g_var).sum(),
                               leaves)
    got = tcfr.fused_conditional_backward_plain(kind, *a.values(), g_mean,
                                                g_var)
    for name, g, w, leaf in zip(NAMES, got, want, leaves):
        assert g.shape == leaf.shape and g.dtype == leaf.dtype, name
        w = projected(name, w.numpy())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_backward_plain_matches_projected_jax_grad(kind):
    """The plain backward against jax.grad of dgp_tpu's function in f64,
    projected on the patterns of Pinv and Sq, as the kernel returns them;
    entries off the patterns are exactly 0."""
    a = raw_inputs(seed=20 + kind)
    g_mean, g_var = a.pop("g_mean"), a.pop("g_var")

    def loss(*xs):
        m, v = jax_function(kind, *xs)
        return jnp.sum(m * g_mean) + jnp.sum(v * g_var)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *[jnp.asarray(v) for v in a.values()])
    got = tcfr.fused_conditional_backward_plain(
        kind, *[t(v) for v in a.values()], t(g_mean), t(g_var))
    for name, g, w in zip(NAMES, got, want):
        w = projected(name, w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max(), err_msg=name)
    assert not torch.triu(got[0], 1).any() and not torch.tril(got[5], -1).any()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wrapper_backward_is_the_plain_backward_on_cpu(kind):
    """autograd through FusedConditional on CPU tensors calls the plain
    backward (bit for bit) and launches nothing."""
    a = {k: t(v) for k, v in raw_inputs(seed=10 + kind).items()}
    g_mean, g_var = a.pop("g_mean"), a.pop("g_var")
    leaves = [v.clone().requires_grad_(True) for v in a.values()]
    before = (tcfr.FusedConditional.launches,
              tcfr.FusedConditional.backward_launches)
    out = tcfr.fused_conditional_white_stationary(kind, *leaves)
    got = torch.autograd.grad(out, leaves, grad_outputs=(g_mean, g_var))
    want = tcfr.fused_conditional_backward_plain(kind, *a.values(), g_mean,
                                                 g_var)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert before == (tcfr.FusedConditional.launches,
                      tcfr.FusedConditional.backward_launches)


def test_backward_masks_are_strict():
    """The gradient passes only where (v - t1) + t2 > 0 and sq > 0: a point
    on an inducing input gives sq == 0 there, and q_sqrt = 0 with a scaled
    identity for Pinv drives the variance to its clamp at some points."""
    a = raw_inputs(seed=3)
    a["Xs"][0] = a["Zs"][2]              # sq == 0 exactly at (m=2, n=0)
    a["Sq"] = np.zeros_like(a["Sq"])     # t2 == 0
    a["Pinv"] = 0.55 * np.eye(7)         # t1 > v near the inducing inputs
    a = {k: t(v) for k, v in a.items()}
    for kind in KINDS:
        _, var = tcfr.fused_conditional_plain(kind, *list(a.values())[:6])
        clamped = var[:, 0] == 0
        assert clamped.any() and not clamped.all()
        grads = tcfr.fused_conditional_backward_plain(kind, *a.values())
        assert all(torch.isfinite(g).all() for g in grads)
        # with mean's cotangent zeroed, a clamped point moves nothing
        zero_mean = dict(a, g_mean=torch.zeros_like(a["g_mean"]))
        dXs = tcfr.fused_conditional_backward_plain(kind, *zero_mean.values())[1]
        assert torch.all(dXs[clamped] == 0)
        assert torch.any(dXs[~clamped] != 0)


def stationary_problem(kind, D=3, M=7, n=11, Din=2, dtype=F64, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.uniform(size=(M, Din))
    X = rng.uniform(size=(n, Din))
    q_mu = rng.normal(size=(M, D))
    q_sqrt = np.tril(rng.normal(size=(D, M, M)) * 0.05 + np.eye(M))
    kw = dict(variance=1.3, lengthscales=list(rng.uniform(0.4, 0.7, size=Din)))
    jk = getattr(JK, KINDS[kind]).create(
        dtype=jnp.float64 if dtype == F64 else jnp.float32, **kw)
    tk = getattr(TK, KINDS[kind]).create(dtype=dtype, **kw)
    wm, wv = rng.normal(size=(n, D)), rng.normal(size=(n, D))
    return jk, tk, Z, X, q_mu, q_sqrt, wm, wv


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gradients_match_jax_grad_through_conditional_diag(kind, monkeypatch):
    """The port's conditional_diag, sent through FusedConditional (its gate
    is opened for the CPU here, so the plain forward and the hand-derived
    backward run), against jax.grad of dgp_tpu's conditional_diag (the plain
    jnp path in f64): kernel hyperparameters, Z, X, q_mu, q_sqrt."""
    jk, tk, Z, X, q_mu, q_sqrt, wm, wv = stationary_problem(kind)

    def jloss(kern, Z, X, q_mu, q_sqrt):
        m, v = jcond.conditional_diag(kern, Z, q_mu, q_sqrt, X, white=True)
        return jnp.sum(m * wm) + jnp.sum(v * wv)

    gk, gZ, gX, gm, gL = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        jk, *[jnp.asarray(a) for a in (Z, X, q_mu, q_sqrt)])

    monkeypatch.setattr(tcfr, "fused_kind", lambda kernel, Sq, X: kind)
    called = []
    plain = tcfr.fused_conditional_backward_plain
    monkeypatch.setattr(tcfr, "fused_conditional_backward_plain",
                        lambda *a: called.append(1) or plain(*a))
    leaves = [t(a).requires_grad_(True) for a in (Z, X, q_mu, q_sqrt)]
    Zt, Xt, qm, qs = leaves
    m, v = tcond.conditional_diag(tk, Zt, qm, qs, Xt, white=True)
    loss = (m * t(wm)).sum() + (v * t(wv)).sum()
    got = torch.autograd.grad(
        loss, leaves + [tk.variance_raw, tk.lengthscales_raw])
    assert called == [1]
    want = [gZ, gX, gm, gL, gk.variance_raw, gk.lengthscales_raw]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8,
                                   atol=1e-11 * float(np.abs(w).max()))


def test_backward_plain_f32_matches_pallas_interpreter(monkeypatch):
    """One float32 case against the JAX Pallas backward kernel itself
    (interpreted; n = 1100 is not a tile multiple, so the JAX side pads),
    projected on the patterns of Pinv and Sq as the port's backward returns
    them.
    2e-2 of each gradient's scale is the tolerance of
    tests/test_conditional_fused_rbf.py: the TPU kernel's products emulate
    bf16 passes even when interpreted. It is the TPU kernel's budget, not
    the port's."""
    monkeypatch.setattr(jcfr, "_INTERPRET", True)
    kind = 2
    f32 = torch.float32
    a = {k: t(v, f32) for k, v in raw_inputs(D=2, M=64, n=1100, Din=3,
                                             seed=5).items()}
    # a well-conditioned projector: Pinv of this size from N(0,1) entries
    # would amplify the bf16 rounding past any tolerance
    a["Pinv"] = t(np.tril(0.1 * np.random.default_rng(6).normal(size=(64, 64))
                          + np.eye(64)), f32)
    g_mean, g_var = a.pop("g_mean"), a.pop("g_var")
    got = tcfr.fused_conditional_backward_plain(kind, *a.values(), g_mean,
                                                g_var)
    args = [jnp.asarray(v.numpy()) for v in a.values()]
    _, vjp = jax.vjp(
        lambda *xs: jcfr.fused_conditional_white_stationary(kind, *xs), *args)
    want = vjp((jnp.asarray(g_mean.numpy()), jnp.asarray(g_var.numpy())))
    for name, g, w in zip(NAMES, got, want):
        w = projected(name, w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(w).max()),
                                   err_msg=name)
