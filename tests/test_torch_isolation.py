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
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import conditionals as TC
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.parallel.serving import predict_in_chunks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(dgp_tpu_torch.__file__))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|dgp_tpu\b(?!_torch))")


def port_sources():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_imports_in_port():
    sources = list(port_sources())
    assert len(sources) > 10
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
assert not any(k.split(".")[0] in ("jax", "dgp_tpu") and sys.modules[k]
               for k in list(sys.modules))
print("ok")
"""


def test_port_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT,
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
    quadform = TC.quadform_t2_reference

    def spy(Sq, A):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return quadform(Sq, A)

    monkeypatch.setattr(TC, "quadform_t2_reference", spy)
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
