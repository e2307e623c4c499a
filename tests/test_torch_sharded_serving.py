"""Port parity: row-sharded serving over ``torch.distributed``
(``parallel/serving.py``'s ``sharded_rowwise`` family, ``pad_rows``,
``run_sharded`` and every wrapper's ``predict_y_sharded``), in float64 on
the CPU.

One module-scoped start of 4 gloo ranks (as in test_torch_parallel.py)
serves the requests; this process meanwhile computes dgp_tpu's sharded
``predict_f`` of a 1-layer DGP (whose moments do not depend on the draws)
and its sharded exact-GPR ``predict_y`` on ``make_mesh(4)``, and its
``pad_rows``. Every request has 42 rows, not a multiple of the 4 ranks.
The multi-layer wrappers' requests are held to their single-device
``predict_y`` within the Monte-Carlo error (each rank draws its own
normals).
"""

import numpy as np
import pytest
import torch

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401
from test_torch_parallel import (
    CPU,
    F64,
    FAST_COMPILE,
    RTOL,
    S,
    WORLD,
    attempt,
    collect,
    em_model,
    mf_model,
    mo_model,
    npy,
    one_layer,
    result,
    start_ranks,
    two_layer,
)

N_REQUEST = 42
MC_SAMPLES = 64   # the multi-layer wrappers' requests
CALLS = 8         # single-device requests that measure their spread


def request(d, seed=21):
    return np.random.default_rng(seed).uniform(0, 1, size=(N_REQUEST, d))


def gpr_model():
    from dgp_tpu_torch.models import gpr as tgpr
    from dgp_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(11)
    X = rng.uniform(0, 1, size=(30, 2))
    Y = np.sin(3 * X[:, :1]) + X[:, 1:] ** 2
    return tgpr.GPR((X, Y), TK.RBF.create(lengthscales=[1.0, 1.0], dtype=F64),
                    noise_variance=1e-4, **CPU)


# -- rank-side checks -------------------------------------------------------------


def check_engines(mesh):
    """sharded_predict_f and sharded_gpr_predict_y on padded rows, and
    pad_rows."""
    from dgp_tpu_torch.parallel import serving

    model = one_layer(off_prior=True)
    Xp, n = serving.pad_rows(mesh, torch.as_tensor(request(1)))
    mean, var = serving.sharded_predict_f(mesh, S)(model.params, Xp,
                                                   model.generator)
    gpr = gpr_model()
    Xg, _ = serving.pad_rows(mesh, torch.as_tensor(request(2)))
    gmean, gvar = serving.sharded_gpr_predict_y(mesh)(
        (gpr.params, gpr.data), Xg, None)
    return {"pad": (tuple(Xp.shape), n), "mean": npy(mean), "var": npy(var),
            "gmean": npy(gmean), "gvar": npy(gvar)}


def check_exact_wrappers(mesh):
    """DGP (1 layer, a mesh model) and GPR requests, whole and chunked,
    beside their single-device predict_y."""
    out = {}
    model, X = one_layer(mesh, off_prior=True), request(1)
    with torch.no_grad():
        out["dgp"] = [npy(a) for a in model.predict_y_sharded(X, S)]
        out["dgp_chunked"] = [npy(a) for a in model.predict_y_sharded(
            X, S, chunk_size=8)]
        out["dgp_single"] = [npy(a) for a in model.predict_y(X, S)]
    gpr, X = gpr_model(), request(2)
    out["gpr"] = [npy(a) for a in gpr.predict_y_sharded(X, mesh)]
    out["gpr_chunked"] = [npy(a) for a in gpr.predict_y_sharded(
        X, mesh, chunk_size=12)]
    out["gpr_single"] = [npy(a) for a in gpr.predict_y(X)]
    return out


def check_sampled_wrappers(mesh):
    """The multi-layer wrappers' requests (2-layer DGP, MF, EM, MO), each
    built on the mesh, whole and chunked, and the moment-matched means of
    CALLS single-device requests."""
    from dgp_tpu_torch.models.dgp import moment_matched

    out = {}
    for name, build, d in (("dgp2", two_layer, 2), ("mf", mf_model, 2),
                           ("em", em_model, 4), ("mo", mo_model, 1)):
        model, X = build(mesh), request(d)
        sharded = model.predict_y_sharded(X, MC_SAMPLES)
        chunked = model.predict_y_sharded(X, MC_SAMPLES, chunk_size=16)
        single = build()
        means = [npy(moment_matched(*single.predict_y(X, MC_SAMPLES))[0])
                 for _ in range(CALLS)]
        out[name] = {k: [npy(a) for a in v] for k, v in (
            ("sharded", sharded), ("chunked", chunked))}
        out[name]["single"] = np.stack(means)
    return out


def check_errors(mesh, mesh2d):
    from dgp_tpu_torch.parallel import serving

    model = one_layer(mesh)
    out = {}
    for name, fn in [
            ("chunk", lambda: model.predict_y_sharded(request(1), S,
                                                      chunk_size=6)),
            ("mesh_2d", lambda: serving.sharded_predict_y(mesh2d, S))]:
        try:
            fn()
            out[name] = None
        except Exception as e:  # the test reads the type and text
            out[name] = (type(e).__name__, str(e))
    return out


def serving_checks():
    from dgp_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(device_type="cpu")
    mesh2d = pm.make_mesh_2d(2, 2, device_type="cpu")
    results = {}
    attempt(results, "engines", check_engines, mesh)
    attempt(results, "exact", check_exact_wrappers, mesh)
    attempt(results, "sampled", check_sampled_wrappers, mesh)
    attempt(results, "errors", check_errors, mesh, mesh2d)
    return results


# -- the reference, and the tests --------------------------------------------------


def reference():
    """dgp_tpu's sharded predict_f (1 layer) and GPR predict_y on
    make_mesh(4), and its pad_rows."""
    import jax
    import jax.numpy as jnp

    from dgp_tpu.parallel import make_mesh
    from dgp_tpu.parallel import serving as jserving
    from test_torch_monitor import reference_params

    mesh = make_mesh(WORLD)
    key = jax.random.PRNGKey(0)
    model = one_layer(off_prior=True)
    Xp, n = jserving.pad_rows(mesh, jnp.asarray(request(1)))
    engine = jserving.sharded_predict_f(mesh, S)
    args = (reference_params(model.params), Xp, key)
    mean, var = engine.lower(*args).compile(FAST_COMPILE)(*args)
    gpr = gpr_model()
    Xg, _ = jserving.pad_rows(mesh, jnp.asarray(request(2)))
    args = ((reference_params(gpr.params),
             tuple(jnp.asarray(npy(a)) for a in gpr.data)), Xg, key)
    gmean, gvar = jserving.sharded_gpr_predict_y(mesh).lower(*args).compile(
        FAST_COMPILE)(*args)
    return {"pad": (tuple(Xp.shape), n), "mean": np.asarray(mean),
            "var": np.asarray(var), "gmean": np.asarray(gmean),
            "gvar": np.asarray(gvar)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ranks")
    procs = start_ranks(serving_checks, folder)
    try:
        want = reference()
    finally:
        out = collect(procs, folder)
    return out, want


def assert_rank_equal(arrays):
    for rank, other in enumerate(arrays[1:], 1):
        for a, b in zip(other, arrays[0]):
            assert np.array_equal(a, b), rank


def test_pad_rows_matches_reference(ranks):
    out, want = ranks
    for got in result(out, "engines"):
        assert got["pad"] == want["pad"] == ((44, 1), 42)


@pytest.mark.parametrize("what", ["mean", "var", "gmean", "gvar"])
def test_sharded_engines_match_reference(ranks, what):
    """sharded_predict_f on the 1-layer DGP and sharded_gpr_predict_y on the
    padded request: every rank returns the full [S, 44, 1] (or [44, 1]),
    within 1e-10 of dgp_tpu's sharded result."""
    out, want = ranks
    got = [g[what] for g in result(out, "engines")]
    for g in got:
        assert g.shape == want[what].shape
        np.testing.assert_allclose(g, want[what], rtol=RTOL,
                                   atol=RTOL * np.abs(want[what]).max())
    assert_rank_equal([[g] for g in got])


@pytest.mark.parametrize("name", ["dgp", "gpr"])
def test_exact_wrappers_match_single_device(ranks, name):
    """The 1-layer DGP's and the GPR's predict_y_sharded, whole and in
    chunks of 8 or 12 rows (the tail chunk padded), equal predict_y on
    one device."""
    out, _ = ranks
    for g in result(out, "exact"):
        single = g[f"{name}_single"]
        for got in (g[name], g[f"{name}_chunked"]):
            for a, b in zip(got, single):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=RTOL,
                                           atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("name", ["dgp2", "mf", "em", "mo"])
def test_sampled_wrappers_serve_every_row(ranks, name):
    """The 2-layer DGP's, MF-DGP's, MF-DGP-EM's and MO-DGP's
    predict_y_sharded: [S, 42, 1], finite, positive variances, the same
    bits on every rank, whole and chunked; each row's moment-matched mean
    within 10 standard deviations of the mean of CALLS single-device
    requests' (their spread measured over the calls: the multi-fidelity and
    multi-objective models redraw their augmented inducing inputs in every
    request, which no one request's samples show; 8 calls give a
    heavy-tailed estimate of it). A row served from another row's block
    would miss by hundreds."""
    out, _ = ranks
    got = [g[name] for g in result(out, "sampled")]
    for kind in ("sharded", "chunked"):
        mean, var = got[0][kind]
        assert mean.shape == var.shape == (MC_SAMPLES, N_REQUEST, 1)
        assert np.all(np.isfinite(mean)) and np.all(var > 0)
        assert_rank_equal([g[kind] for g in got])
        single = got[0]["single"]
        spread = single.std(axis=0, ddof=1) * np.sqrt(1 + 1 / CALLS)
        assert np.all(np.abs(mean.mean(axis=0) - single.mean(axis=0))
                      <= 10 * spread + 1e-9)


def test_serving_errors(ranks):
    out, _ = ranks
    for got in result(out, "errors"):
        assert got["chunk"] == ("ValueError",
                                "chunk_size must be a device multiple")
        assert got["mesh_2d"][0] == "ValueError"
        assert "supports 1-D ('data',) data meshes only" in got["mesh_2d"][1]


@pytest.mark.parametrize("name", ["dgp", "gpr", "mf", "em", "mo"])
def test_predict_y_sharded_needs_a_mesh(name):
    """As in dgp_tpu: with no mesh given and none built in, ValueError."""
    model = {"dgp": one_layer, "gpr": gpr_model, "mf": mf_model,
             "em": em_model, "mo": mo_model}[name]()
    with pytest.raises(ValueError, match="needs a mesh"):
        if name == "gpr":
            model.predict_y_sharded(request(2), None)
        else:
            model.predict_y_sharded(request(1), S)
