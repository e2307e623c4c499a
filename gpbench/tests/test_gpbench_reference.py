"""The plain reference against dgp_tpu_torch in float64 on the CPU, at a
tiny size: the ELBO and its gradient, and the moment-matched predictive,
from the same values and unit normals."""

import pytest
import torch

from gpbench.tests.smallcells import one_thread, small  # noqa: F401
from gpbench import inputs, system
from gpbench.reference import dgp as ref

CPU = torch.device("cpu")


def f64_cell(name):
    return small(name, dtype="float64")


@pytest.fixture(params=["white_rbf.train", "nonwhite_rbf.train"])
def built(request, one_thread):
    from dgp_tpu_torch.config import jitter_scope

    cell = f64_cell(request.param)
    X, Y, values = inputs.model_values(cell.config, 3, CPU)
    with jitter_scope(cell.config["jitter"]):
        yield cell, X, Y, values, system.model(cell.config, X, Y, values, 3, CPU)


def test_elbo_and_gradient_match(built):
    from dgp_tpu_torch.config import jitter_scope
    from dgp_tpu_torch.models.dgp import elbo

    cell, X, Y, values, model = built
    zs = inputs.step_normals(cell.config, 3, CPU, 1)[0]
    with jitter_scope(cell.config["jitter"]):
        got = elbo(model.params, X, Y, cell.config["num_samples"], zs=zs)
        names, params = zip(*model.params.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(got, params)))
    p = {k: v.clone().requires_grad_(True) for k, v in values.items()}
    want = ref.elbo(p, X, Y, zs, cell.config, ref.F64)
    want_grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-11)
    assert set(grads) == set(want_grads)
    for k, g in want_grads.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-8, atol=1e-9 * float(g.abs().max()))


@pytest.mark.parametrize("name", ["white_rbf.serve", "nonwhite_rbf.serve"])
def test_predictive_matches(name, one_thread):
    from dgp_tpu_torch.config import jitter_scope

    cell = f64_cell(name)
    X, Y, values = inputs.model_values(cell.config, 4, CPU)
    rows = inputs.make_request(cell.config, 4, 0, 700, CPU)
    with jitter_scope(cell.config["jitter"]):
        model = system.model(cell.config, X, Y, values, 4, CPU)
        got = system.serve(cell.config, cell.traffic, model, rows, CPU)
    Xr, zs = inputs.split_request(cell.config, rows)
    mean, var = ref.predict(values, Xr, zs, cell.config, ref.F64, 300)
    torch.testing.assert_close(got, torch.cat([mean, var], dim=1),
                               rtol=1e-10, atol=1e-12)


def test_the_control_rounds_its_products_to_tf32():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -(1.0 + 3 * 2.0 ** -12)])
    assert ref.round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                         -(1.0 + 2.0 ** -10)]
