"""Port parity: the Kuf-consuming fused whitened conditional of
dgp_tpu_torch (ops/conditional_fused.py) against dgp_tpu's
ops/conditional_fused.py, in float64 on CPU, and in float32 against the
Pallas kernels run by their interpreter."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.ops import conditional_fused as jcf
from dgp_tpu_torch.ops import conditional_fused as tcf
from dgp_tpu_torch.ops import conditional_fused_rbf as tcfr

# the jnp math of the JAX package's own tests of these kernels
from test_conditional_fused import _reference
# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64
# one compiled program per shape: much cheaper than JAX's op-by-op compiles
reference = jax.jit(_reference)
NAMES = ("dPinv", "dKuf", "dq_mu", "dSq", "dKff")


def data(D, M, n, clamp=False, dtype=np.float64, seed=0):
    """Pinv [M, M] (lower-triangular), Kuf [M, n], q_mu [M, D], Sq [D, M, M]
    (upper-triangular), Kff [n] that varies per point, and the cotangents
    g_mean, g_var [n, D]. Kff is set so that every variance is positive, or
    with ``clamp`` so that the clamp zeroes some of them."""
    rng = np.random.default_rng(seed)
    Pinv = np.tril(0.1 * rng.normal(size=(M, M)) + np.eye(M))
    Kuf = 0.5 * rng.normal(size=(M, n)) ** 2
    q_mu = rng.normal(size=(M, D))
    Sq = np.triu(rng.normal(size=(D, M, M))) * 0.3
    A = Pinv @ Kuf
    t1 = np.sum(A * A, axis=0)
    t2 = np.sum((Sq @ A) ** 2, axis=1)                 # [D, n]
    offset = rng.uniform(-1, 1, n) if clamp else rng.uniform(0.5, 1.5, n)
    Kff = t1 - t2.min(axis=0) + offset
    g = [rng.normal(size=(n, D)) for _ in range(2)]
    return [a.astype(dtype) for a in (Pinv, Kuf, q_mu, Sq, Kff, *g)]


def t(a):
    return torch.as_tensor(a)


def projected(name, g):
    """A full gradient on the backward's pattern: dPinv's lower triangle,
    dSq's upper one; the others as they are."""
    if name == "dPinv":
        return np.tril(np.asarray(g))
    if name == "dSq":
        return np.triu(np.asarray(g))
    return np.asarray(g)


@pytest.mark.parametrize("D,M,n,clamp", [(3, 7, 11, False), (1, 5, 1, False),
                                         (2, 6, 13, True), (2, 4, 0, False)])
def test_plain_forward_matches_reference(D, M, n, clamp):
    args = data(D, M, n, clamp)[:5]
    want = reference(*[jnp.asarray(a) for a in args])
    got = tcf.fused_conditional_white_plain(*[t(a) for a in args])
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    if clamp:
        assert (got[1] == 0).any() and (got[1] > 0).any()


@pytest.mark.parametrize("clamp", [False, True])
def test_backward_plain_matches_jax_grad(clamp):
    """The hand-written backward's five outputs against jax.grad of the
    reference, dPinv and dSq projected on the patterns of Pinv and Sq as the
    backward returns them; with ``clamp`` some variances are clamped to 0
    and pass no gradient."""
    *args, wm, wv = data(3, 7, 17, clamp, seed=1)

    def loss(*a):
        m, v = _reference(*a)
        return jnp.sum(m * wm) + jnp.sum(v * wv)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(
        *[jnp.asarray(a) for a in args])
    got = tcf.fused_conditional_white_backward_plain(*[t(a) for a in args],
                                                     t(wm), t(wv))
    for name, g, w in zip(NAMES, got, want):
        w = projected(name, w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max(), err_msg=name)
    if clamp:
        var = tcf.fused_conditional_white_plain(*[t(a) for a in args])[1]
        assert (var == 0).any() and (got[4] != 0).any()


def test_function_f32_matches_pallas_interpreter(monkeypatch):
    """FusedConditionalWhite on float32 CPU tensors, forward and gradients,
    against the TPU kernels themselves (interpreted); n = 300 is one padded
    tile. Tolerances as in tests/test_conditional_fused.py: the interpreted
    kernel emulates the MXU's bf16 passes. dPinv and dSq are compared on
    the patterns of Pinv and Sq, as the port's backward returns them."""
    monkeypatch.setattr(jcf, "_INTERPRET", True)
    *args, wm, wv = data(2, 16, 300, dtype=np.float32, seed=2)

    def jax_loss(*a):
        m, v = jcf.fused_conditional_white(*a)
        return jnp.sum(m * wm) + jnp.sum(v * wv)

    jargs = [jnp.asarray(a) for a in args]
    mj, vj = (np.asarray(x) for x in jcf.fused_conditional_white(*jargs))
    want = jax.grad(jax_loss, argnums=tuple(range(5)))(*jargs)
    leaves = [t(a).requires_grad_(True) for a in args]
    mean, var = tcf.fused_conditional_white(*leaves)
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(mean.detach().numpy(), mj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var.detach().numpy(), vj, rtol=1e-3,
                               atol=1e-3 * float(vj.max()))
    got = torch.autograd.grad((mean, var), leaves, grad_outputs=(t(wm), t(wv)))
    for name, g, w in zip(NAMES, got, want):
        w = projected(name, w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_gram_plain_is_the_direct_sum_on_the_pattern():
    """Phase B's factorised dSq[d] = triu(2 Sq[d] (A diag(gv_d) A^T)) is
    triu(sum_n gb_d a^T) with gb_d = 2 (Sq[d] A) gv_d, and its dPinv is
    tril(dA Kuf^T), in f64."""
    rng = np.random.default_rng(4)
    D, M, n = 3, 7, 23
    A, dA, Kuf = (t(rng.normal(size=(M, n))) for _ in range(3))
    gv = t(rng.normal(size=(D, n)) * (rng.uniform(size=(D, n)) > 0.3))
    Sq = t(np.triu(rng.normal(size=(D, M, M))))
    dPinv, dSq = tcf.gram_backward_plain(A, dA, Kuf, gv, Sq)
    gb = 2.0 * (Sq @ A) * gv[:, None, :]
    np.testing.assert_allclose(dSq.numpy(), np.triu((gb @ A.T).numpy()),
                               rtol=1e-10, atol=1e-12 * float(dSq.abs().max()))
    np.testing.assert_array_equal(dPinv.numpy(), np.tril((dA @ Kuf.T).numpy()))


@pytest.mark.parametrize("n", [13, 0])
def test_function_on_cpu_is_the_plain_version(n):
    """FusedConditionalWhite on CPU tensors: its outputs are the plain
    version's and its gradients the plain backward's, bit for bit, with no
    launch."""
    *args, wm, wv = [t(a) for a in data(3, 7, n, seed=3)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (tcf.FusedConditionalWhite.launches,
              tcf.FusedConditionalWhite.backward_launches)
    out = tcf.fused_conditional_white(*leaves)
    want = tcf.fused_conditional_white_plain(*args)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    grads = torch.autograd.grad(out, leaves, grad_outputs=(wm, wv))
    want = tcf.fused_conditional_white_backward_plain(*args, wm, wv)
    assert all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(grads, want))
    assert (tcf.FusedConditionalWhite.launches,
            tcf.FusedConditionalWhite.backward_launches) == before


def test_gate_keeps_cpu_and_f64_away_without_building(monkeypatch):
    """applicable() turns CPU tensors and float64 away before it asks the
    CUDA library about sizes (the size gates are tested on the card, in
    test_torch_cuda.py), so nothing is built here."""
    def no_library(*args):
        raise AssertionError("the gate asked the CUDA library")
    monkeypatch.setattr(tcf, "supported", no_library)
    monkeypatch.setattr(tcf, "backward_supported", no_library)
    Pinv, Kuf, q_mu, Sq = (t(a) for a in data(2, 5, 9, dtype=np.float32)[:4])
    assert not tcf.applicable(Pinv, Kuf, Sq, q_mu)                  # CPU, f32
    assert not tcf.applicable(Pinv.double(), Kuf.double(), Sq.double(),
                              q_mu.double())
    on_card = lambda a, dtype: types.SimpleNamespace(
        is_cuda=True, dtype=dtype, shape=a.shape, requires_grad=False)
    f32 = torch.float32
    assert not tcf.applicable(on_card(Pinv, F64), on_card(Kuf, F64),
                              on_card(Sq, F64), on_card(q_mu, F64))
    assert not tcf.applicable(on_card(Pinv, f32), on_card(Kuf, f32),
                              on_card(Sq, f32), on_card(q_mu, F64))


@pytest.mark.parametrize("stationary", [False, True])
def test_plain_forwards_read_only_the_triangles(stationary):
    """Both plain forwards read what the CUDA forwards read, Pinv's lower
    and Sq's upper triangle: NaN above Pinv's diagonal and below Sq's gives
    the same bits as the clean triangles."""
    Pinv, Kuf, q_mu, Sq, Kff = (t(a) for a in data(2, 6, 9, seed=5)[:5])
    above = torch.ones((6, 6), dtype=torch.bool).triu(1)
    dirty = (Pinv.masked_fill(above, float("nan")),
             Sq.masked_fill(above.T, float("nan")))
    assert dirty[0].isnan().sum() == 15 and dirty[1].isnan().sum() == 2 * 15
    if stationary:
        rng = np.random.default_rng(6)
        Xs, Zs = t(rng.uniform(size=(9, 3))), t(rng.uniform(size=(6, 3)))
        run = lambda P, S: tcfr.fused_conditional_plain(0, P, Xs, Zs, t(1.3),
                                                        q_mu, S)
    else:
        run = lambda P, S: tcf.fused_conditional_white_plain(P, Kuf, q_mu, S,
                                                             Kff)
    for clean, got in zip(run(Pinv, Sq), run(*dirty)):
        assert torch.isfinite(got).all() and torch.equal(got, clean)
