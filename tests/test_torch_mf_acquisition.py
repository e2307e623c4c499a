"""The port's acquisition over the four multi-fidelity surrogate kinds
(``dgp_tpu_torch/bo/acquisition.py``): ``ar1``, ``nargp``, ``mf_dgp`` and
``mf_dgp_EM`` dispatch; AR(1)'s EI and WB2 (deterministic, exact moments)
equal ``dgp_tpu``'s on the same converted model and x to 1e-10 in float64;
the sampled kinds' moments equal the moment-matched output of the port's
own model under the same generator (or the same fixed normals); EI
optimizes over each exact surrogate and its loss has a gradient in x over
each deep one; an unknown kind still raises. The sampled kinds' losses are
held to ``dgp_tpu``'s in ``test_torch_sampled_acquisition``."""

import functools

import jax
import numpy as np
import pytest
import torch

from dgp_tpu.bo import acquisition as jacq
from dgp_tpu_torch import convert
from dgp_tpu_torch.bo import acquisition as tacq
from dgp_tpu_torch.models import cokriging as tar1
from dgp_tpu_torch.models import mf_dgp as tmf
from dgp_tpu_torch.models import mf_dgp_em as tem
from dgp_tpu_torch.models import nargp as tnargp
from dgp_tpu_torch.models.dgp import moment_matched
from dgp_tpu_torch.utils.test_functions import (park_high, park_low,
                                                park_vd_high, park_vd_low)

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_cokriging import CONFIGS, data, off_init, reference_model
from test_torch_mf_dgp import recorded
import test_torch_nargp as nargp_case

F64 = torch.float64
Y_MIN = -0.4
S = 7
X_EVAL = np.random.default_rng(4).uniform(0, 1, (6, 2))


@functools.lru_cache(maxsize=None)
def ar1_reference():
    """dgp_tpu's AR(1) model off its init (test_torch_cokriging's 2-fidelity
    configuration), and its EI, WB2 and EI on samples (with the normals it
    draws) at X_EVAL, in one jitted program."""
    ref = reference_model(2, CONFIGS[2][2])
    key = jax.random.PRNGKey(0)

    def program(x):
        params = off_init(ref.params)
        state = (params, ref.train_data)
        ei = jacq._ei_loss("ar1", True, S)(x, (state, Y_MIN, key))
        wb2 = jacq._wb2_loss("ar1", S)(x, (state, Y_MIN, 1.0, key))
        sampled = recorded(jacq._ei_loss("ar1", False, S))(
            x, (state, Y_MIN, key))
        return params, -ei, wb2, sampled

    return jax.jit(program)(X_EVAL)


def ar1_port():
    sizes, d, bucket = CONFIGS[2]
    port = tar1.AR1CoKriging(data(sizes, d), n_bucket=bucket, device="cpu",
                             dtype=F64)
    port.params = convert.ar1_from_numpy(
        convert.numpy_tree_from_reference(ar1_reference()[0]), "cpu", F64)
    return port


def nargp_port():
    """test_torch_nargp's 2-level configuration (9 and 5 rows in 2-D,
    n_bucket 8)."""
    return tnargp.NARGP(nargp_case.data(2), n_bucket=nargp_case.CONFIGS[2][2],
                        num_samples=S, device="cpu", dtype=F64)


def mf_port():
    rng = np.random.default_rng(0)
    X = [rng.uniform(size=(6, 4)), rng.uniform(size=(3, 4))]
    return tmf.MultiFidelityDeepGP(X, [park_low(X[0]), park_high(X[1])],
                                   num_samples=2, device="cpu", dtype=F64)


def em_port():
    rng = np.random.default_rng(0)
    X = [rng.uniform(size=(6, 2)), rng.uniform(size=(3, 4))]
    return tem.MultiFidelityDeepGP_EM(
        X, [park_vd_low(X[0]), park_vd_high(X[1])], [X[1][:, :2]],
        num_samples=2, device="cpu", dtype=F64)


# the highest fidelity's input dimensions of each maker's model
DIMS = {ar1_port: 2, nargp_port: 2, mf_port: 4, em_port: 4}


def points(make):
    return np.random.default_rng(6).uniform(0, 1, (6, DIMS[make]))


def test_the_four_kinds_dispatch_and_an_unknown_one_raises():
    for make, kind in ((ar1_port, "ar1"), (nargp_port, "nargp"),
                       (mf_port, "mf_dgp"), (em_port, "em")):
        model = make()
        got, state = tacq._model_state(model)
        assert got == kind
        if kind in ("ar1", "nargp"):
            assert state[0] is model.params and len(state[1]) == (
                3 if kind == "ar1" else 2)
        else:
            assert state is model.params

    class Unknown:
        name = "nope"

    with pytest.raises(ValueError, match="unsupported surrogate kind 'nope'"):
        tacq._model_state(Unknown())


def test_ar1_ei_and_wb2_match_reference():
    """EI and WB2 over the converted AR(1) model at the same x, to 1e-10
    (the moments are exact, so no draw enters), and EI on samples of its
    predictive normal on the reference's own draw, given as a list key."""
    _, ei_ref, wb2_ref, (sampled_ref, draws) = ar1_reference()
    port = ar1_port()
    ei = -tacq.EI(Y_MIN, 2).run(port, X_EVAL, num_samples=S)
    wb2 = tacq.WB2(Y_MIN, 2).run(port, X_EVAL, num_samples=S)
    state = tacq._model_state(port)[1]
    with torch.no_grad():
        sampled = tacq._ei_loss("ar1", False, S)(
            torch.tensor(X_EVAL), (state, Y_MIN, [np.array(draws[0])]))
    assert len(draws) == 1
    for got, want in ((ei, ei_ref), (wb2, wb2_ref), (sampled, sampled_ref)):
        assert got.shape == want.shape == (6, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10 * float(
                                       np.abs(np.asarray(want)).max()))
    # the f-moments are the model's own top-fidelity posterior
    mean, var = tacq.InfillCriteria._predict_f_moments(port, X_EVAL, 0, S)
    want = port.predict_f(X_EVAL)
    assert torch.equal(mean, want[0][0]) and torch.equal(var, want[1][0])


@pytest.mark.parametrize("make", [nargp_port, mf_port, em_port])
def test_sampled_kinds_moments_are_the_models_moment_matched(make,
                                                             monkeypatch):
    """Each sampled kind's y- and f-moments equal the moment-matched
    predict_y / predict_f of the port's own model under the generator the
    key seeds (bit for bit), and its samples the model's own last-layer
    samples; a list of tensors given as the key goes to the deep models'
    propagate as their fixed normals (``noise``)."""
    model = make()
    kind, state = tacq._model_state(model)
    x = torch.as_tensor(points(make), dtype=F64)
    key = 11
    gen = lambda: tacq._generator(key, "cpu")
    module = {"nargp": tnargp, "mf_dgp": tmf, "em": tem}[kind]
    with torch.no_grad():
        if kind == "nargp":
            params, datas = state
            own_y = module.predict_y(params, datas, x, S, generator=gen())
            own_f = module.predict_f(params, datas, x, S, generator=gen())
        else:
            own_y = module.predict_y(state, x, S, gen())
            own_f = module.predict_f(state, x, S, gen())
        got_y = tacq._y_moments_pure(kind, state, x, key, S)
        got_f = tacq._f_moments_pure(kind, state, x, key, S)
        samples = tacq._samples_pure(kind, state, x, key, S)
    for got, own in ((got_y, own_y), (got_f, own_f)):
        for g, w in zip(got, moment_matched(*own)):
            assert g.shape == (6, 1) and torch.equal(g, w)
    assert samples.shape == (S, 6, 1) and bool(torch.isfinite(samples).all())
    if kind == "nargp":
        return
    with torch.no_grad():
        Fs, _, _ = module.propagate(state, x, S, gen())
    assert torch.equal(samples, Fs[-1])
    seen = {}

    def spy(params, X, num_samples, **kwargs):
        seen.update(kwargs)
        return (Fs[-1],), None, None

    monkeypatch.setattr(module, "propagate", spy)
    zs = [torch.zeros(1)]
    tacq._samples_pure(kind, state, x, zs, S)
    assert seen == {"noise": zs}


@pytest.mark.parametrize("make", [ar1_port, nargp_port])
def test_ei_optimizes_over_the_exact_surrogates(make):
    """EI by DE + Adam over AR(1) and NARGP: an x in the box whose -EI is
    the reported objective."""
    model = make()
    model.optimize(n_starts=2, iterations=5, lr=0.05)
    ei = tacq.EI(Y_MIN, 2)
    bounds = (np.zeros(2), np.ones(2))
    x = ei.optimize(model, bounds, popsize_DE=8, iterations_DE=3,
                    iterations_adam=3, method="DE+Adam", num_samples=S, key=2)
    assert x.shape == (1, 2) and np.all((x >= 0) & (x <= 1))
    with torch.no_grad():
        at_x = float(ei.run(model, x, num_samples=S,
                            key=tacq.split_key(2)[1])[0, 0])
    assert np.isfinite(ei.IC_optimized)
    assert ei.IC_optimized == pytest.approx(at_x, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("make", [mf_port, em_port])
def test_ei_loss_has_a_gradient_in_x_over_the_deep_surrogates(make):
    """The EI loss over an MF-DGP and an MF-DGP-EM surrogate, as Adam
    refinement takes it: finite, with a finite nonzero gradient in x."""
    model = make()
    loss_fn, args = tacq.EI(Y_MIN, DIMS[make])._default_loss_spec(
        model, 3, num_samples=S)
    x = torch.as_tensor(points(make), dtype=F64).requires_grad_(True)
    loss = loss_fn(x, args)
    (g,) = torch.autograd.grad(loss.sum(), x)
    assert loss.shape == (6, 1) and bool(torch.isfinite(loss).all())
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
