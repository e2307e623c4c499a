"""Port parity: natural gradients of dgp_tpu_torch against dgp_tpu, in
float64 on CPU (the constructions of tests/test_natgrad.py, and one joint
step on a 2-layer model with fixed unit normals)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgp_tpu.variational import natgrad as jng
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models import training as ttrain
from dgp_tpu_torch.variational import natgrad as tng
from dgp_tpu_torch.variational.gaussian import gauss_kl

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401

from test_torch_training import (
    S,
    assert_same_parameters,
    port_fixed_loss,
    port_of,
    reference_fixed_loss,
    reference_model,
)


F64 = torch.float64


def rand_ml(rng, D, M):
    m = rng.normal(size=(D, M))
    L = np.tril(rng.normal(size=(D, M, M)) * 0.2 + np.eye(M))
    return m, L


def test_coordinate_maps_round_trip_and_match_reference():
    rng = np.random.default_rng(0)
    D, M = 3, 5
    m, L = rand_ml(rng, D, M)
    mt, Lt = torch.as_tensor(m), torch.as_tensor(L)
    S_ = L @ np.swapaxes(L, -1, -2)
    e1, e2 = tng.meanvarsqrt_to_expectation(mt, Lt)
    m2, L2 = tng.expectation_to_meanvarsqrt(e1, e2)
    np.testing.assert_allclose(m2.numpy(), m, rtol=1e-9)
    np.testing.assert_allclose((L2 @ L2.transpose(-1, -2)).numpy(), S_, rtol=1e-8)
    t1, t2 = tng.meanvarsqrt_to_natural(mt, Lt)
    m3, L3 = tng.natural_to_meanvarsqrt(t1, t2)
    np.testing.assert_allclose(m3.numpy(), m, rtol=1e-7)
    np.testing.assert_allclose((L3 @ L3.transpose(-1, -2)).numpy(), S_, rtol=1e-6)
    # the written-out batch axis against the reference's single-output maps
    for d in range(D):
        md, Ld = jnp.asarray(m[d]), jnp.asarray(L[d])
        for got, want in zip((e1[d], e2[d], t1[d], t2[d]),
                             jng.meanvarsqrt_to_expectation(md, Ld)
                             + jng.meanvarsqrt_to_natural(md, Ld)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-13)


def conjugate(seed, M, noise, D=1):
    """f = u (Z = X), Gaussian noise: the conjugate model whose exact
    posterior one gamma=1 step must reach."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(M, M))
    Kuu = B @ B.T + M * np.eye(M)
    Lu = torch.as_tensor(np.linalg.cholesky(Kuu))
    y = rng.normal(size=(M, D))
    yt = torch.as_tensor(y)

    def neg_elbo(q_mu, q_sqrt):
        S_diag = torch.sum(torch.tril(q_sqrt) ** 2, dim=2).T  # [M, D]
        ll = (-0.5 * M * D * np.log(2 * np.pi * noise)
              - 0.5 * torch.sum((yt - q_mu) ** 2) / noise
              - 0.5 * torch.sum(S_diag) / noise)
        return -(ll - gauss_kl(q_mu, q_sqrt, Lu))

    q_mu0 = torch.as_tensor(rng.normal(size=(M, D)))
    q_sqrt0 = torch.as_tensor(
        np.tril(rng.normal(size=(D, M, M)) * 0.1 + np.eye(M)))
    return Kuu, y, neg_elbo, q_mu0, q_sqrt0


def test_one_step_exact_on_conjugate_model():
    M, noise = 7, 0.3
    Kuu, y, neg_elbo, q_mu0, q_sqrt0 = conjugate(1, M, noise, D=2)
    q_mu1, q_sqrt1 = tng.natgrad_step(q_mu0, q_sqrt0, neg_elbo, gamma=1.0)
    assert not q_mu1.requires_grad and not q_sqrt1.requires_grad
    S_star = np.linalg.inv(np.linalg.inv(Kuu) + np.eye(M) / noise)
    from scipy.stats import multivariate_normal
    log_ml = 0.0
    for d in range(2):
        np.testing.assert_allclose(q_mu1[:, d].numpy(), S_star @ y[:, d] / noise,
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose((q_sqrt1[d] @ q_sqrt1[d].T).numpy(), S_star,
                                   rtol=1e-6, atol=1e-8)
        log_ml += multivariate_normal.logpdf(
            y[:, d], mean=np.zeros(M), cov=Kuu + noise * np.eye(M))
    # the ELBO equals the exact log marginal likelihood at the optimum
    np.testing.assert_allclose(-float(neg_elbo(q_mu1, q_sqrt1)), log_ml,
                               rtol=1e-8)


def test_small_gamma_decreases_loss():
    _, _, neg_elbo, q_mu0, q_sqrt0 = conjugate(2, 5, 1.0, D=2)
    q_mu1, q_sqrt1 = tng.natgrad_step(q_mu0, q_sqrt0, neg_elbo, gamma=0.1)
    assert float(neg_elbo(q_mu1, q_sqrt1)) < float(neg_elbo(q_mu0, q_sqrt0))


@pytest.mark.parametrize("ng_all", [True, False])
def test_natgrad_step_multi_matches_reference_on_a_model(ng_all):
    """One joint step on the 2-layer model with a fixed-zs loss, the q of
    the selected layers swapped into the model as nat_adam_run does."""
    params, X, Y, zs = reference_model()
    sel = (0, 1) if ng_all else (1,)
    jloss = reference_fixed_loss(X, Y, zs)
    key = jax.random.PRNGKey(0)
    new_j = jax.jit(lambda p: jng.natgrad_step_multi(
        jdgp_get(p, sel), lambda qs: jloss(jdgp_set(p, sel, qs), key), 0.1))(params)
    want = jdgp_set(params, sel, new_j)

    port = port_of(params)
    names = [(f"layers.{i}.q_mu", f"layers.{i}.q_sqrt") for i in sel]
    tloss = port_fixed_loss(X, Y, zs)

    def nat_loss(qs):
        overrides = {n: q for pair, q2 in zip(names, qs) for n, q in zip(pair, q2)}
        return torch.func.functional_call(port, overrides, (tloss, None))

    new_t = tng.natgrad_step_multi(tdgp.get_qs(port, sel), nat_loss, 0.1)
    for (m, L), (mj, Lj) in zip(new_t, new_j):
        assert not np.allclose(np.asarray(mj), 0)
        np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-7)
        np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-7,
                                   atol=1e-12)
    tdgp.set_qs(port, sel, new_t)
    assert_same_parameters(port, want, rtol=1e-7)


def jdgp_get(p, sel):
    from dgp_tpu.models.dgp import get_qs
    return get_qs(p, sel)


def jdgp_set(p, sel, qs):
    from dgp_tpu.models.dgp import set_qs
    return set_qs(p, sel, qs)


def test_nat_adam_run_matches_reference():
    """Two Adam+natgrad iterations on the deterministic loss: the model's
    second training phase as a whole."""
    from dgp_tpu.models import training as jtrain
    params, X, Y, zs = reference_model()
    sel = (0, 1)
    frozen = {"frozen_layer_fields": {i: {"q_mu", "q_sqrt"} for i in sel}}
    pj, lj = jtrain.nat_adam_run(
        reference_fixed_loss(X, Y, zs), params,
        jtrain.make_mask(params, **frozen),
        get_qs=lambda p: jdgp_get(p, sel),
        set_qs=lambda p, qs: jdgp_set(p, sel, qs),
        key=jax.random.PRNGKey(0), steps=2, lr_adam=0.01, gamma=0.05)
    port = port_of(params)
    out, lt = ttrain.nat_adam_run(
        port_fixed_loss(X, Y, zs), port, ttrain.make_mask(port, **frozen),
        get_qs=lambda p: tdgp.get_qs(p, sel),
        set_qs=lambda p, qs: tdgp.set_qs(p, sel, qs),
        generator=None, steps=2, lr_adam=0.01, gamma=0.05)
    assert out is port and lt.shape == (2,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-8)
    assert_same_parameters(port, pj, rtol=1e-7)


def test_nat_adam_run_guard_sees_the_same_normals():
    """Under guard_loss every evaluation of one natural-gradient step draws
    the same unit normals: the generator is put back before each."""
    params, X, Y, _ = reference_model()
    port = port_of(params)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    draws = []

    def loss(p, generator):
        state = generator.get_state()  # peek at the next normals
        draws.append(torch.randn(3, generator=generator, dtype=F64))
        generator.set_state(state)
        return -tdgp.elbo(p, Xt, Yt, S, generator)

    gen = torch.Generator().manual_seed(3)
    ttrain.nat_adam_run(
        loss, port, ttrain.make_mask(port), get_qs=lambda p: tdgp.get_qs(p, (1,)),
        set_qs=lambda p, qs: tdgp.set_qs(p, (1,), qs), generator=gen, steps=2,
        gamma=0.01, guard_loss=True)
    # per iteration: the Adam evaluation, then the natgrad evaluation and
    # its guard's re-evaluation on the same draws
    assert len(draws) == 6
    for a, n1, n2 in (draws[:3], draws[3:]):
        assert torch.equal(n1, n2) and not torch.equal(a, n1)
    assert not torch.equal(draws[1], draws[4])


def test_loss_guard_rejects_catastrophic_overshoot():
    """tests/test_natgrad.py::test_loss_guard_rejects_catastrophic_overshoot
    through the port."""
    _, _, neg_elbo, q_mu0, q_sqrt0 = conjugate(3, 6, 1e-5)
    loss0 = float(neg_elbo(q_mu0, q_sqrt0))

    def step(q_mu, q_sqrt, gamma):
        (res,) = tng.natgrad_step_multi(
            [(q_mu, q_sqrt)], lambda qs: neg_elbo(qs[0][0], qs[0][1]), gamma,
            guard_loss=True)
        return res

    q_mu1, q_sqrt1 = step(q_mu0, q_sqrt0, 1.0)
    assert float(neg_elbo(q_mu1, q_sqrt1)) < loss0
    assert not np.allclose(q_mu1.numpy(), q_mu0.numpy())
    q_mu1 = q_mu1 + 0.05  # at the exact optimum the gradient is 0
    q_mu2, q_sqrt2 = step(q_mu1, q_sqrt1, 1e4)  # the gamma/10 retry fails too
    np.testing.assert_allclose(q_mu2.numpy(), q_mu1.numpy())
    np.testing.assert_allclose(q_sqrt2.numpy(), torch.tril(q_sqrt1).numpy())
    q_mu3, _ = step(q_mu1, q_sqrt1, 0.5)
    assert not np.allclose(q_mu3.numpy(), q_mu1.numpy())


def guard_case(mult, gamma=0.1, thresh=1e-8):
    """Synthetic loss of tests/test_natgrad.py::test_loss_guard_margin_and_retry:
    base at the start point, base*mult once q moves farther than thresh."""
    M, base = 4, 50.0
    q_mu0 = torch.full((M, 1), 0.5, dtype=F64)
    q_sqrt0 = torch.eye(M, dtype=F64)[None]

    def loss(qs):
        m, L = qs[0]
        d = torch.sum((m - q_mu0) ** 2) + torch.sum((L - q_sqrt0) ** 2)
        worsen = torch.where(d > thresh, base * (mult - 1.0), 0.0)
        return base + worsen + 0.1 * torch.sum(m)

    (res,) = tng.natgrad_step_multi([(q_mu0, q_sqrt0)], loss, gamma,
                                    guard_loss=True)
    return res, q_mu0, q_sqrt0


# margin 100*|loss_before| + 1e4 with loss_before ~= 50.2 -> ~15020:
# worsen = 50*(mult-1) is 14000 at 281 (accepted) and 16000 at 321 (frozen)
@pytest.mark.parametrize("mult,moves", [(50.0, True), (281.0, True),
                                        (321.0, False), (1e6, False)])
def test_loss_guard_margin(mult, moves):
    (m, L), q_mu0, q_sqrt0 = guard_case(mult)
    assert (not np.allclose(m.numpy(), q_mu0.numpy())) == moves
    if not moves:
        np.testing.assert_allclose(m.numpy(), q_mu0.numpy())
        np.testing.assert_allclose(L.numpy(), q_sqrt0.numpy())


def test_loss_guard_retries_at_a_tenth_of_gamma():
    (full, _), q_mu0, _ = guard_case(50.0)
    d_full = float(torch.sum((full - q_mu0) ** 2))
    # catastrophic only beyond a displacement the gamma/10 step stays under
    (m, _), _, _ = guard_case(1e6, thresh=d_full * 0.25)
    d_retry = float(torch.sum((m - q_mu0) ** 2))
    assert 0 < d_retry < d_full * 0.25


def test_non_positive_definite_step_keeps_the_previous_value():
    """A step that leaves the natural-parameter cone (-theta2 no longer
    positive definite) makes torch's Cholesky fail; the layer keeps its
    previous q (JAX returns NaN there and the guard does the same) and
    nothing raises. A second layer in the same call still moves."""
    rng = np.random.default_rng(4)
    m_a, L_a = (torch.as_tensor(x) for x in rand_ml(rng, 2, 4))
    m_b, L_b = (torch.as_tensor(x) for x in rand_ml(rng, 1, 3))

    def loss(qs):
        (ma, La), (mb, Lb) = qs
        # rewards variance without bound: dL/deta2 = -50 I for layer a
        Sa = La @ La.transpose(-1, -2) + ma.T[..., None] * ma.T[..., None, :]
        return (-50.0 * torch.sum(torch.diagonal(Sa, dim1=-2, dim2=-1))
                + torch.sum((mb - 1.0) ** 2) + torch.sum(Lb ** 2))

    out = tng.natgrad_step_multi([(m_a.T, L_a), (m_b.T, L_b)], loss, gamma=1.0)
    np.testing.assert_array_equal(out[0][0].numpy(), m_a.T.numpy())
    np.testing.assert_array_equal(out[0][1].numpy(), L_a.numpy())
    assert torch.isfinite(out[1][0]).all() and torch.isfinite(out[1][1]).all()
    assert not np.allclose(out[1][0].numpy(), m_b.T.numpy())
    with pytest.raises(torch.linalg.LinAlgError):  # what the guard spares us
        torch.linalg.cholesky(-torch.eye(3, dtype=F64))
    assert torch.isnan(tng._chol(-torch.eye(3, dtype=F64))).all()
    # max_growth: a finite step that grows the norm 1000x is refused too
    big = tng.natgrad_step_multi(
        [(m_b.T, L_b)], lambda qs: -1e9 * torch.sum(qs[0][0]), gamma=1.0)
    np.testing.assert_array_equal(big[0][0].numpy(), m_b.T.numpy())
