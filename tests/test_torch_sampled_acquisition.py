"""The port's acquisition over the sampled multi-fidelity surrogates
(``nargp``, ``mf_dgp`` and ``em`` in ``dgp_tpu_torch/bo/acquisition.py``)
against ``dgp_tpu``'s, in float64 on CPU: -EI on the latent moments
(``_f_moments_pure``) and on samples (``_samples_pure``), and WB2's loss
on the predictive moments (``_y_moments_pure``), on the same parameters
and x and on the reference's own unit normals. Each reference loss runs
with ``jax.random.normal`` recorded (as ``test_torch_mf_dgp`` records it);
the port takes those draws as a list key. The three reference programs
(one per kind) are traced in turn and compiled in threads."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgp_tpu.bo import acquisition as jacq
from dgp_tpu.models import mf_dgp as jmf
from dgp_tpu.ops import likelihoods as jlik
from dgp_tpu_torch import convert
from dgp_tpu_torch.bo import acquisition as tacq

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_mf_acquisition import (F64, S, Y_MIN, em_port, mf_port,
                                       nargp_port, points)
from test_torch_mf_dgp import recorded
from test_torch_mf_dgp_em import reference_of as em_reference_of
from test_torch_training import path_name
import test_torch_nargp as nargp_case


def mf_reference_of(params, X):
    """dgp_tpu's MFDGPParams holding the port's ``params``: the structure
    from the JAX package's own init (traced for its shapes alone, Z = X as
    the port's constructor has it), every leaf the port's tensor of the
    same path."""
    skeleton = jax.eval_shape(lambda: jmf.MFDGPParams(
        layers=tuple(jmf.init_layers_mf(
            X, jmf.make_mf_kernels(X[0].shape[1], len(X)))),
        likelihood=jlik.Gaussian.create(1.0)))
    values = dict(params.named_parameters())
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    assert {path_name(p) for p, _ in leaves} == values.keys()
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(values[path_name(p)].detach().numpy())
        for p, _ in leaves])


def reference_losses(kind, state, x):
    """dgp_tpu's acquisition losses over ``state`` at ``x`` on one key, each
    (value, the normals it draws): -EI on the latent moments and on
    samples, and WB2's loss on the predictive moments."""
    key = jax.random.PRNGKey(3)
    return {
        "ei": recorded(jacq._ei_loss(kind, True, S))(x, (state, Y_MIN, key)),
        "ei_samples": recorded(jacq._ei_loss(kind, False, S))(
            x, (state, Y_MIN, key)),
        "wb2": recorded(jacq._wb2_loss(kind, S))(
            x, (state, Y_MIN, 1.0, key))}


def nargp_program():
    """test_torch_nargp's 2-level reference off its init, and its losses at
    the NARGP points."""
    ref = nargp_case.reference_model(2)

    def run(x):
        params = nargp_case.off_init(ref.params)
        datas = nargp_case.with_params(ref, params).train_data
        return params, reference_losses("nargp", (params, datas), x)

    return run, (points(nargp_port),)


@functools.lru_cache(maxsize=None)
def sampled_ports():
    """The port's NARGP (holding the reference's parameters), MF-DGP and
    MF-DGP-EM (off the prior), and the reference's losses over each, from
    three programs traced in turn (the recording patch is process-wide)
    and compiled in threads while the next is traced."""
    mf, em = mf_port(), em_port()
    for model in (mf, em):
        model._init_variational()
    calls = {"nargp": nargp_program(),
             "mf_dgp": (lambda p, x: reference_losses("mf_dgp", p, x),
                        (mf_reference_of(mf.params, mf._X), points(mf_port))),
             "em": (lambda p, x: reference_losses("em", p, x),
                    (em_reference_of(em.params), points(em_port)))}
    with ThreadPoolExecutor(3) as pool:
        compiled = {kind: pool.submit(jax.jit(fn).lower(*args).compile)
                    for kind, (fn, args) in calls.items()}
        outs = {kind: c.result()(*calls[kind][1])
                for kind, c in compiled.items()}
    nargp = nargp_port()
    params, outs["nargp"] = outs["nargp"]
    nargp.params = convert.nargp_from_numpy(
        convert.numpy_tree_from_reference(params), "cpu", F64)
    return {"nargp": nargp, "mf_dgp": mf, "em": em}, outs


@pytest.mark.parametrize("kind", ["nargp", "mf_dgp", "em"])
def test_sampled_kinds_match_reference_on_its_normals(kind):
    """-EI on the latent moments (_f_moments_pure) and on samples
    (_samples_pure: NARGP's predictive samples, the deep GPs' last layer)
    and WB2's loss on the predictive moments (_y_moments_pure) equal
    dgp_tpu's on the same parameters and x to 1e-10 of their largest
    magnitude, the port given the reference's draws as a list key."""
    models, outs = sampled_ports()
    state = tacq._model_state(models[kind])[1]
    make = {"nargp": nargp_port, "mf_dgp": mf_port, "em": em_port}[kind]
    losses = {"ei": (tacq._ei_loss(kind, True, S), (state, Y_MIN)),
              "ei_samples": (tacq._ei_loss(kind, False, S), (state, Y_MIN)),
              "wb2": (tacq._wb2_loss(kind, S), (state, Y_MIN, 1.0))}
    for name, (loss, args) in losses.items():
        want, draws = outs[kind][name]
        want = np.asarray(want)
        assert len(draws) >= 1
        with torch.no_grad():
            got = loss(torch.tensor(points(make)),
                       args + ([np.array(d) for d in draws],))
        assert got.shape == want.shape == (6, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(want).max()),
                                   err_msg=f"{kind} {name}")
