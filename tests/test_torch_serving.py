"""Port: chunked serving (dgp_tpu_torch.parallel.serving) on CPU."""

import numpy as np
import pytest
import torch

from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import kernels as TK
from dgp_tpu_torch.parallel.serving import predict_in_chunks

# torch on one intra-op thread in this module (the fixture is autouse)
from test_torch_cuda import _one_torch_thread  # noqa: F401


F64 = torch.float64


def build_1layer(N=40, seed=0, S=3):
    """As tests/test_serving.py: a 1-layer model, whose predictive moments
    do not depend on the Monte-Carlo draws."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N, 1))
    Y = np.sin(5 * X)
    model = tdgp.DGP(X, Y, X[:8].copy(),
                     [TK.RBF.create(lengthscales=[1.0], dtype=F64)], [],
                     num_samples=S, device="cpu", dtype=F64)
    return model, X


@pytest.mark.parametrize("chunk_size", [16, 40, 64])
def test_predict_in_chunks_matches_unchunked(chunk_size):
    model, X = build_1layer(N=40)

    def predict(params, Xc, generator):
        return tdgp.predict_y(params, Xc, 2, generator)

    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        mc, vc = predict_in_chunks(predict, model.params, X, gen,
                                   chunk_size=chunk_size, device="cpu")
        m1, v1 = tdgp.predict_y(model.params, torch.as_tensor(X), 2, gen)
    assert mc.shape == m1.shape == (2, 40, 1)
    np.testing.assert_allclose(mc.numpy(), m1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(vc.numpy(), v1.numpy(), rtol=1e-12)
