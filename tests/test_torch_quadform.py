"""Port parity: the variational quadform of dgp_tpu_torch (ops/quadform.py)
against dgp_tpu's ops/quadform_pallas.py, in float64 on CPU, and in float32
against the Pallas kernels run by their interpreter. Sq is upper-triangular,
as tril(q_sqrt)^T is on the conditional's path: the port reads only that
triangle and returns dSq on it, so jax.grad's dSq is projected with triu
before the comparison."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.ops import quadform_pallas as jqp
from dgp_tpu_torch.ops import quadform as tq

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

F64 = torch.float64


def data(D, M, n, dtype=np.float64, seed=0):
    """Sq [D, M, M] (upper-triangular), A [M, n] and the cotangents
    g2 [D, n], g1 [n]."""
    rng = np.random.default_rng(seed)
    Sq, A, g2, g1 = (rng.normal(size=s).astype(dtype)
                     for s in ((D, M, M), (M, n), (D, n), (n,)))
    return [np.triu(Sq), A, g2, g1]


def on_pattern(grads):
    """jax.grad's (dSq, dA), dSq projected on Sq's upper triangle."""
    return np.triu(np.asarray(grads[0])), np.asarray(grads[1])


def t(a):
    return torch.as_tensor(a)


def reference_loss(with_t1, g2, g1):
    """sum(t2 g2) (+ sum(t1 g1)) through dgp_tpu's jnp quadform."""
    def loss(Sq, A):
        out = jnp.sum(jqp.quadform_t2_reference(Sq, A) * g2)
        if with_t1:
            out = out + jnp.sum(jnp.sum(A * A, axis=0) * g1)
        return out
    return loss


@pytest.mark.parametrize("D,M,n", [(3, 7, 11), (1, 5, 1), (2, 4, 0)])
def test_plain_forward_matches_reference(D, M, n):
    Sq, A, _, _ = data(D, M, n)
    want2 = np.asarray(jqp.quadform_t2_reference(jnp.asarray(Sq), jnp.asarray(A)))
    want1 = np.asarray(jnp.sum(jnp.asarray(A) ** 2, axis=0))
    got2 = tq.quadform_t2_reference(t(Sq), t(A))
    pair = tq.quadform_t2_t1_reference(t(Sq), t(A))
    assert got2.shape == want2.shape == (D, n) and pair[1].shape == (n,)
    for got, want in ((got2, want2), (pair[0], want2), (pair[1], want1)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("with_t1", [False, True])
def test_backward_plain_matches_jax_grad(with_t1):
    Sq, A, g2, g1 = data(3, 7, 13, seed=1)
    want = jax.grad(reference_loss(with_t1, g2, g1), argnums=(0, 1))(
        jnp.asarray(Sq), jnp.asarray(A))
    got = tq.quadform_backward_plain(t(Sq), t(A), t(g2),
                                     t(g1) if with_t1 else None)
    for name, g, w in zip(("dSq", "dA"), got, on_pattern(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("with_t1", [False, True])
def test_plain_f32_matches_pallas_interpreter(monkeypatch, with_t1):
    """The plain versions in float32 against the TPU kernels themselves
    (interpreted); n = 700 is not a tile multiple, so the JAX side pads.
    Tolerances as in tests/test_quadform_pallas.py: the interpreted kernel
    emulates the MXU's bf16 passes."""
    monkeypatch.setattr(jqp, "_INTERPRET", True)
    Sq, A, g2, g1 = data(3, 64, 700, np.float32, seed=2)
    Sqj, Aj = jnp.asarray(Sq), jnp.asarray(A)
    if with_t1:
        t2j, t1j = jqp.quadform_t2_t1_pallas(Sqj, Aj)
        t2, t1 = tq.quadform_t2_t1_reference(t(Sq), t(A))
        np.testing.assert_allclose(t1.numpy(), np.asarray(t1j), rtol=1e-5)

        def pallas_loss(s, a):
            t2p, t1p = jqp.quadform_t2_t1_pallas(s, a)
            return jnp.sum(t2p * g2) + jnp.sum(t1p * g1)
    else:
        t2j = jqp.quadform_t2_pallas(Sqj, Aj)
        t2 = tq.quadform_t2_reference(t(Sq), t(A))
        pallas_loss = lambda s, a: jnp.sum(jqp.quadform_t2_pallas(s, a) * g2)
    t2j = np.asarray(t2j)
    assert t2.shape == t2j.shape == (3, 700) and t2.dtype == torch.float32
    np.testing.assert_allclose(t2.numpy(), t2j, rtol=1e-4,
                               atol=1e-4 * float(t2j.max()))
    want = jax.grad(pallas_loss, argnums=(0, 1))(Sqj, Aj)
    got = tq.quadform_backward_plain(t(Sq), t(A), t(g2),
                                     t(g1) if with_t1 else None)
    for name, g, w in zip(("dSq", "dA"), got, on_pattern(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("n", [13, 0])
@pytest.mark.parametrize("with_t1", [False, True])
def test_quadform_function_on_cpu_is_the_plain_version(with_t1, n):
    """QuadForm on CPU tensors: its outputs are the plain versions' and its
    backward is quadform_backward_plain, bit for bit, with no launch."""
    Sq, A, g2, g1 = (t(a) for a in data(3, 7, n, seed=3))
    leaves = [Sq.clone().requires_grad_(True), A.clone().requires_grad_(True)]
    before = (tq.QuadForm.launches, tq.QuadForm.backward_launches)
    out = tq.QuadForm.apply(*leaves, with_t1)
    if with_t1:
        want = tq.quadform_t2_t1_reference(Sq, A)
        cotangents = (g2, g1)
    else:
        out, want, cotangents = (out,), (tq.quadform_t2_reference(Sq, A),), (g2,)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    grads = torch.autograd.grad(out, leaves, grad_outputs=cotangents)
    want = tq.quadform_backward_plain(Sq, A, g2, g1 if with_t1 else None)
    assert all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(grads, want))
    assert (tq.QuadForm.launches, tq.QuadForm.backward_launches) == before


def test_gate_keeps_cpu_and_f64_on_plain_path(monkeypatch):
    """applicable() turns CPU tensors and float64 away before it asks the
    CUDA library about sizes (the size gate is tested on the card, in
    test_torch_cuda.py), so the dispatch takes the plain versions."""
    def no_library(*args):
        raise AssertionError("the gate asked the CUDA library")
    monkeypatch.setattr(tq, "supported", no_library)
    monkeypatch.setattr(tq, "backward_supported", no_library)
    Sq, A, _, _ = (t(a) for a in data(2, 5, 9, np.float32))
    assert not tq.applicable(Sq, A)                       # CPU, float32
    assert not tq.applicable(Sq.double(), A.double())     # CPU, float64
    on_card = lambda a, dtype: types.SimpleNamespace(
        is_cuda=True, dtype=dtype, shape=a.shape, requires_grad=False)
    assert not tq.applicable(on_card(Sq, F64), on_card(A, F64))
    assert not tq.applicable(on_card(Sq, torch.float32), on_card(A, F64))
    before = tq.QuadForm.launches
    assert torch.equal(tq.quadform_t2(Sq, A), tq.quadform_t2_reference(Sq, A))
    for got, want in zip(tq.quadform_t2_t1(Sq, A),
                         tq.quadform_t2_t1_reference(Sq, A)):
        assert torch.equal(got, want)
    assert tq.QuadForm.launches == before


@pytest.mark.parametrize("with_t1", [False, True])
def test_plain_quadform_reads_only_the_triangle(with_t1):
    """NaN below Sq's diagonal (where tril(q_sqrt)^T holds zeros) leaves
    t2, t1, dA and dSq finite and equal to the clean run's, and dSq is
    exactly 0 below the diagonal: the plain versions read what the kernels
    read, and return dSq on the same pattern."""
    Sq, A, g2, g1 = (t(a) for a in data(3, 7, 13, seed=4))
    dirty = Sq.masked_fill(torch.ones(7, 7, dtype=torch.bool).tril(-1),
                           float("nan"))
    assert torch.isnan(dirty).sum() == 3 * 21
    g1 = g1 if with_t1 else None
    clean = (*tq.quadform_t2_t1_reference(Sq, A),
             *tq.quadform_backward_plain(Sq, A, g2, g1))
    got = (*tq.quadform_t2_t1_reference(dirty, A),
           *tq.quadform_backward_plain(dirty, A, g2, g1))
    for name, g, c in zip(("t2", "t1", "dSq", "dA"), got, clean):
        assert torch.isfinite(g).all() and torch.equal(g, c), name
    assert not torch.tril(got[2], -1).any()


def test_plain_backward_dsq_is_the_phase_b_form():
    """quadform_backward_plain's dSq (triu of sum_n gb_d a^T) equals
    triu(2 Sq[d] A diag(g2_d) A^T), the form the kernels' phase B computes
    from the weighted Grams, in float64."""
    Sq, A, g2, _ = (t(a) for a in data(4, 9, 31, seed=5))
    dSq, _ = tq.quadform_backward_plain(Sq, A, g2)
    C = (A[None] * g2[:, None, :]) @ A.T                  # [D, M, M]
    want = torch.triu(2.0 * (Sq @ C))
    torch.testing.assert_close(dSq, want, rtol=1e-12, atol=1e-12)
