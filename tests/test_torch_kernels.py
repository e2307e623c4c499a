"""Port parity: kernels of dgp_tpu_torch against dgp_tpu, in float64 on CPU.

Each case builds the same kernel in both packages from the same arguments
and holds K(X, X2), K(X) and K_diag(X) to rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgp_tpu.ops import kernels as JK
from dgp_tpu_torch.ops import kernels as TK

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


F64 = {"dtype": torch.float64}

CASES = {
    "rbf": lambda k, kw: k.RBF.create(variance=1.3, lengthscales=[0.5, 0.8, 1.1], **kw),
    "matern32": lambda k, kw: k.Matern32.create(variance=0.9, lengthscales=[0.7, 1.2, 0.4], **kw),
    "matern52": lambda k, kw: k.Matern52.create(variance=2.2, lengthscales=0.6, **kw),
    "rbf_active_dims": lambda k, kw: k.RBF.create(
        variance=0.7, lengthscales=[0.6, 0.9], active_dims=[0, 2], **kw),
    "linear": lambda k, kw: k.Linear.create(variance=0.4, **kw),
    "linear_active_dims": lambda k, kw: k.Linear.create(variance=1.5, active_dims=[1], **kw),
    "white": lambda k, kw: k.White.create(variance=0.2, **kw),
    "sum": lambda k, kw: k.Matern52.create(variance=1.1, lengthscales=[0.5] * 3, **kw)
    + k.Linear.create(variance=0.3, **kw),
    "product": lambda k, kw: k.RBF.create(variance=0.8, lengthscales=[1.4] * 3, **kw)
    * k.Matern32.create(variance=1.6, lengthscales=[0.3, 0.5, 0.7], **kw),
    # the multi-fidelity algebra k_corr * (k_prev + Linear) + k_in + White
    "mf_algebra": lambda k, kw: k.RBF.create(variance=1.2, lengthscales=[0.9], active_dims=[0], **kw)
    * (k.Matern52.create(variance=0.7, lengthscales=[0.5, 0.6], active_dims=[1, 2], **kw)
       + k.Linear.create(variance=0.5, active_dims=[2], **kw))
    + k.RBF.create(variance=0.4, lengthscales=[1.1], active_dims=[0], **kw)
    + k.White.create(variance=1e-3, **kw),
    "by_name": lambda k, kw: k.by_name("matern32", 3, **kw),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(9, 3))
    X2 = rng.normal(size=(6, 3))
    ref = CASES[case](JK, {})
    port = CASES[case](TK, F64)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    pairs = [
        (ref.K(jnp.asarray(X), jnp.asarray(X2)), port.K(t(X), t(X2))),
        (ref.K(jnp.asarray(X)), port.K(t(X))),
        (ref.K_diag(jnp.asarray(X)), port.K_diag(t(X))),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-300)
