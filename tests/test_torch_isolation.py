"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller names another device."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dgp_tpu_torch
from dgp_tpu_torch.config import ieee_fp32
from dgp_tpu_torch.bo.mo_bo import MO_BO
from dgp_tpu_torch.bo.problems import get as get_problem
from dgp_tpu_torch.bo.so_bo import SO_BO, make_single_model
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models import gpr as TGPR
from dgp_tpu_torch.models.cokriging import AR1CoKriging
from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP
from dgp_tpu_torch.models.mf_dgp_em import MultiFidelityDeepGP_EM
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP
from dgp_tpu_torch.models.nargp import NARGP
from dgp_tpu_torch.ops import conditional_fused as TCF
from dgp_tpu_torch.ops import conditionals as TC
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.ops import quadform as TQ
from dgp_tpu_torch.parallel.serving import predict_in_chunks

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(dgp_tpu_torch.__file__))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|dgp_tpu\b(?!_torch))")


def port_sources():
    for base in (PKG, os.path.join(ROOT, "compat_torch"),
                 os.path.join(ROOT, "examples_torch")):
        for base, _, files in os.walk(base):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_imports_in_port():
    sources = list(port_sources())
    assert len(sources) > 10
    rel = {os.path.relpath(p, PKG) for p in sources}
    assert {"models/training.py", "variational/natgrad.py",
            "utils/checkpoint.py", "convert.py", "ops/quadform.py",
            "ops/conditional_fused.py", "ops/cholesky.py", "models/gpr.py",
            "bo/doe.py", "bo/de.py", "bo/acquisition.py",
            "bo/so_bo.py", "models/mf_dgp.py", "utils/test_functions.py",
            "../compat_torch/validate_mf_dgp.py", "models/mf_dgp_em.py",
            "../compat_torch/validate_mf_dgp_em.py", "models/cokriging.py",
            "models/nargp.py",
            "../compat_torch/validate_mf_bo_bakeoff_fit.py", "bo/mf_bo.py",
            "../compat_torch/validate_mf_bo.py", "models/mo_dgp.py",
            "bo/problems.py", "../compat_torch/validate_mo_dgp.py",
            "bo/ehvi.py", "bo/mo_bo.py", "native/__init__.py",
            "../compat_torch/validate_mo_bo_loop.py", "ops/likelihoods.py",
            "utils/monitor.py", "utils/profiling.py",
            "../compat_torch/validate_classification.py",
            "../compat_torch/validate_robust_regression.py",
            "../compat_torch/validate_dgp_regression.py",
            "../compat_torch/validate_bo.py", "parallel/mesh.py",
            "parallel/data_parallel.py", "parallel/serving.py",
            "../compat_torch/benchmark_mf.py",
            *(f"../examples_torch/{name}.py" for name in (
                "quickstart", "serving", "ask_tell", "classification",
                "mf_bo", "mo_bo", "recipes"))} <= rel
    bad = []
    for path in sources:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not bad, "\n".join(bad)


BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dgp_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
from dgp_tpu_torch.models.dgp import DGP
from dgp_tpu_torch.ops import kernels as K
rng = np.random.default_rng(0)
X = rng.uniform(size=(20, 2)); Y = np.sin(X[:, :1])
m = DGP(X, Y, X[:5], [K.RBF.create(lengthscales=[1.0, 1.0]),
                      K.RBF.create(lengthscales=[1.0])], [2],
        white=True, device="cpu")
mean, var = m.predict_y(X, 3)
assert mean.shape == var.shape == (3, 20, 1)
assert bool(torch.isfinite(var).all())
losses = m.optimize_nat_adam(iterations1=1, iterations2=2, messages=0)
assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
from dgp_tpu_torch.utils import checkpoint
from dgp_tpu_torch import convert
assert len(convert.numpy_tree_from_port(m.params)["layers"]) == 2
from dgp_tpu_torch.bo import SO_BO
class P:
    constraint = False
    dim = 1
    def fun(self, x):
        return [(x - 0.3) ** 2]
bo = SO_BO(problem=P(), DoE_size=4, model_Y_dic={"num_layers": 0,
           "kernels": "rbf"}, seed=0, device="cpu")
bo.run(1, train_iterations=5, popsize_DE=8, iterations_DE=3,
       iterations_adam=3, verbose=False)
assert len(bo.Ymin) == 2 and np.isfinite(bo.Ymin[-1])
from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP
from dgp_tpu_torch.utils.test_functions import park_high, park_low
Xm = [rng.uniform(size=(6, 4)), rng.uniform(size=(3, 4))]
mf = MultiFidelityDeepGP(Xm, [park_low(Xm[0]), park_high(Xm[1])],
                         num_samples=2, device="cpu")
losses = mf.optimize_nat_adam(iterations1=1, iterations2=1, iterations3=1,
                              messages=0)
assert losses.shape == (3,) and mf.predict(Xm[1])[0].shape == (3, 1)
from dgp_tpu_torch.models.mf_dgp_em import MultiFidelityDeepGP_EM
from dgp_tpu_torch.utils.test_functions import park_vd_high, park_vd_low
Xe = [rng.uniform(size=(6, 2)), rng.uniform(size=(3, 4))]
em = MultiFidelityDeepGP_EM(Xe, [park_vd_low(Xe[0]), park_vd_high(Xe[1])],
                            [Xe[1][:, :2]], num_samples=2, device="cpu")
losses = em.optimize_nat_adam(iterations1=1, iterations2=1, iterations3=1,
                              messages=0)
assert losses.shape == (3,) and em.predict(Xe[1])[0].shape == (3, 1)
from dgp_tpu_torch import AR1CoKriging, NARGP
Xa = [rng.uniform(size=(7, 2)), rng.uniform(size=(3, 2))]
Ya = [np.sin(4 * x[:, :1]) for x in Xa]
for cls in (AR1CoKriging, NARGP):
    exact = cls((Xa, Ya), n_bucket=4, device="cpu")
    exact.optimize(n_starts=2, iterations=2)
    m_s, v_s = exact.predict_f(Xa[1], S=3)
    assert m_s.shape[1:] == (3, 1) and bool(torch.isfinite(v_s).all())
from dgp_tpu_torch.bo.acquisition import EI
assert EI(0.0, 2).run(exact, Xa[1], num_samples=3).shape == (3, 1)
from dgp_tpu_torch.bo import MF_BO
from dgp_tpu_torch.utils.test_functions import forrester_high, forrester_low
mf_bo = MF_BO(fidelities=[forrester_low, forrester_high], DoE_sizes=(6, 3),
              d=1, model_dic={"type": "ar1", "n_starts": 2, "iterations": 3},
              seed=0, device="cpu")
assert len(mf_bo.run(1, popsize_DE=8, iterations_DE=3, num_samples=3,
                     verbose=False)) == 2
from dgp_tpu_torch import MultiObjDeepGP
from dgp_tpu_torch.bo.problems import multi_obj_1D_4
Xo = rng.uniform(size=(5, 1))
Fo = np.array([np.ravel(multi_obj_1D_4().fun(x)) for x in Xo])
mo = MultiObjDeepGP([Xo, Xo.copy()], [Fo[:, :1], Fo[:, 1:]], loop=1,
                    num_samples=2, device="cpu")
assert bool(torch.isfinite(mo.ELBO()))
from dgp_tpu_torch.bo import MO_BO
from dgp_tpu_torch.bo.problems import get
from dgp_tpu_torch import native
mo_bo = MO_BO(problem=get("multi_obj_1D_4"), DoE_size=6, seed=0,
              model_dic={"type": "independent", "num_layers": 0,
                         "kernels": "rbf", "iterations": 3}, device="cpu")
trace = mo_bo.run(1, S=5, popsize_DE=6, iterations_DE=2, verbose=False)
assert len(trace) == 2 and trace[1] >= trace[0] and native.available()
from dgp_tpu_torch.ops.likelihoods import Bernoulli, StudentT
from dgp_tpu_torch.layers.initializations import init_layers_linear
from dgp_tpu_torch.utils import monitor, profiling
import compat_torch.validate_classification, compat_torch.validate_bo
import compat_torch.validate_robust_regression
import compat_torch.validate_dgp_regression
Yc = (X[:, :1] > 0.5).astype(float)
for lik in (Bernoulli(5), StudentT.create(0.2)):
    layers = init_layers_linear(X, Yc, X[:5], [K.RBF.create(lengthscales=[1.0, 1.0]),
                                K.RBF.create(lengthscales=[1.0])], [1],
                                device="cpu")
    head = DGP.from_layers(X, Yc, layers, likelihood=lik, num_samples=2,
                           device="cpu")
    rate, _ = profiling.steps_per_sec(
        lambda m: (m.optimize_nat_adam(iterations1=1, iterations2=1,
                                       messages=0), m)[1], head, 1, 0)
    assert rate > 0 and monitor.summary(head, print_fn=None)
import tempfile
import torch.distributed as dist
from dgp_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", init_method="file://" + tempfile.mktemp(),
                        rank=0, world_size=1)
sharded = DGP(X, Y, X[:5], [K.RBF.create(lengthscales=[1.0, 1.0]),
                            K.RBF.create(lengthscales=[1.0])], [2],
              white=True, mesh=make_mesh(device_type="cpu"), device="cpu")
assert bool(torch.isfinite(sharded.optimize_adam(iterations=2,
                                                 messages=0)).all())
assert sharded.predict_y_sharded(X, 3, chunk_size=8)[0].shape == (3, 20, 1)
dist.destroy_process_group()
import dgp_tpu_torch as dgp
assert dgp.DGP is DGP and dgp.summary is monitor.summary and dgp.parallel
import examples_torch.quickstart, examples_torch.serving
import examples_torch.ask_tell, examples_torch.classification
import examples_torch.mf_bo, examples_torch.mo_bo, examples_torch.recipes
import compat_torch.benchmark_mf
assert not any(k.split(".")[0] in ("jax", "dgp_tpu") and sys.modules[k]
               for k in list(sys.modules))
print("ok")
"""


def test_port_runs_with_jax_blocked():
    # one intra-op thread, as in this process: the other test workers share
    # the cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(6, 1))
    kern = TK.RBF.create(lengthscales=[1.0], dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgp.DGP(X, X, X[:3], [kern], [], dtype=torch.float64)
    model = tdgp.DGP(X, X, X[:3], [kern], [], dtype=torch.float64,
                     device="cpu")
    predict = lambda p, Xc, g: tdgp.predict_y(p, Xc, 1, g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_in_chunks(predict, model.params, X, model.generator, 4)
    gp = {"num_layers": 0, "kernels": "rbf"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGPR.GPR((X, X), TK.RBF.create(lengthscales=[1.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_single_model(gp, X, X)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SO_BO(problem=_Problem(), DoE_size=4, model_Y_dic=gp)
    bo = SO_BO(problem=_Problem(), DoE_size=4, model_Y_dic=gp, device="cpu")
    assert bo.model_Y.device == torch.device("cpu")
    Xm, Ym = [X, X[:3]], [X, X[:3]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiFidelityDeepGP(Xm, Ym, dtype=torch.float64)
    mf = MultiFidelityDeepGP(Xm, Ym, dtype=torch.float64, device="cpu")
    assert mf.params.layers[1].z_left.device == torch.device("cpu")
    Xe = [X, rng.uniform(size=(3, 2))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiFidelityDeepGP_EM(Xe, Ym, [Xe[1][:, :1]], dtype=torch.float64)
    em = MultiFidelityDeepGP_EM(Xe, Ym, [Xe[1][:, :1]], dtype=torch.float64,
                                device="cpu")
    assert em.params.layers_red[0].z.device == torch.device("cpu")
    Xo, Yo = [X, X.copy()], [X, np.sin(X)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiObjDeepGP(Xo, Yo, dtype=torch.float64)
    mo = MultiObjDeepGP(Xo, Yo, dtype=torch.float64, device="cpu")
    assert mo.params.layers[1].z_left.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MO_BO(problem=get_problem("multi_obj_1D_4"), DoE_size=4)
    mo_bo = MO_BO(problem=get_problem("multi_obj_1D_4"), DoE_size=4,
                  device="cpu")
    assert mo_bo.device == torch.device("cpu")
    for cls in (AR1CoKriging, NARGP):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls((Xm, Ym), dtype=torch.float64)
        exact = cls((Xm, Ym), dtype=torch.float64, device="cpu")
        assert exact.train_data[0][0].device == torch.device("cpu")


class _Problem:
    constraint = False
    dim = 1

    def fun(self, x):
        return [(x - 0.3) ** 2]


@pytest.fixture
def tf32_asked():
    """The process asks for TF32 matrix products; restored afterwards."""
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    matmul.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision("highest")
    matmul.fp32_precision = old


def test_ieee_fp32_scope_restores_the_callers_setting(tf32_asked):
    matmul = torch.backends.cuda.matmul
    with ieee_fp32():
        assert matmul.fp32_precision == "ieee" and not matmul.allow_tf32
    assert matmul.fp32_precision == "tf32" and matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"


def test_port_products_run_ieee_under_tf32(tf32_asked, monkeypatch):
    """A non-white conditional and a whole predict_y compute their t2
    product with TF32 off, though the process asked for it."""
    seen = []
    quadform = TQ.quadform_t2_reference

    def spy(Sq, A):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return quadform(Sq, A)

    monkeypatch.setattr(TQ, "quadform_t2_reference", spy)
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(8, 2))
    f64 = torch.float64
    kern = TK.RBF.create(lengthscales=[1.0, 1.0], dtype=f64)
    TC.conditional_diag(kern, torch.tensor(X[:3]), torch.zeros(3, 1, dtype=f64),
                        torch.eye(3, dtype=f64)[None], torch.tensor(X),
                        white=False)
    model = tdgp.DGP(X, X[:, :1], X[:3], [kern], [], dtype=torch.float64,
                     device="cpu")
    model.predict_y(X, 2)
    assert seen == ["ieee", "ieee"]
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"


def test_fused_white_conditional_runs_ieee_under_tf32(tf32_asked, monkeypatch):
    """A whitened Sum-kernel conditional, with the fused conditional's gate
    forced open, reaches its plain version with TF32 off, though the process
    asked for it."""
    seen = []
    plain = TCF.fused_conditional_white_plain

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return plain(*args)

    monkeypatch.setattr(TCF, "applicable", lambda *args: True)
    monkeypatch.setattr(TCF, "fused_conditional_white_plain", spy)
    f64 = torch.float64
    X = torch.tensor(np.random.default_rng(0).uniform(size=(8, 2)))
    kern = (TK.RBF.create(lengthscales=[1.0, 1.0], dtype=f64)
            + TK.Linear.create(variance=[0.5, 0.7], dtype=f64))
    mean, var = TC.conditional_diag(kern, X[:3], torch.ones(3, 1, dtype=f64),
                                    torch.eye(3, dtype=f64)[None], X,
                                    white=True)
    assert seen == ["ieee"] and mean.shape == var.shape == (8, 1)
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"
