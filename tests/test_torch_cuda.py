"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
where there is no card). This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dgp_tpu_torch.config import kernels_scope
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import conditional_fused_rbf as cfr
from dgp_tpu_torch.ops import conditionals as C
from dgp_tpu_torch.ops import kernels as K

KINDS = {0: "RBF", 1: "Matern32", 2: "Matern52"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(kind, D, M, Din, n, device, seed=0):
    """Seeded float32 inputs (q_mu ~ N(0,1), q_sqrt = tril(0.05 N + I))."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    Z = torch.tensor(rng.uniform(size=(M, Din)), **f32)
    X = torch.tensor(rng.uniform(size=(n, Din)), **f32)
    q_mu = torch.tensor(rng.normal(size=(M, D)), **f32)
    q_sqrt = torch.tensor(
        np.tril(0.05 * rng.normal(size=(D, M, M)) + np.eye(M)), **f32)
    kern = getattr(K, KINDS[kind]).create(variance=1.3,
                                          lengthscales=[0.7] * Din, **f32)
    with torch.no_grad():
        proj = C.precompute_projection(kern, Z, q_sqrt, True)
        ls = kern.lengthscales
        return (proj.Pinv, X / ls, Z / ls, kern.variance.detach(), q_mu,
                torch.tril(q_sqrt).transpose(-1, -2))


# M = 64 and 128 stage with float4 copies; 50 and 100 take the padded path
@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("D,M,Din,n", [(3, 64, 5, 1037), (8, 128, 8, 4101),
                                       (2, 50, 3, 65), (1, 100, 7, 64)])
def test_kernel_matches_plain(cuda, kind, D, M, Din, n):
    """Kernel vs its plain version in f64 on the same f32 inputs:
    mean within 1e-4 of max|mean|, var within 1e-4 of v."""
    args = inputs(kind, D, M, Din, n, cuda)
    before = cfr.FusedConditional.launches
    with torch.no_grad():
        mk, vk = cfr.fused_conditional_white_stationary(kind, *args)
        torch.cuda.synchronize()
        mp, vp = cfr.fused_conditional_plain(kind, *[a.double() for a in args])
    assert cfr.FusedConditional.launches == before + 1
    assert mk.shape == vk.shape == (n, D) and mk.dtype == torch.float32
    v = float(args[3])
    assert float((mk.double() - mp).abs().max()) <= 1e-4 * float(mp.abs().max())
    assert float((vk.double() - vp).abs().max()) <= 1e-4 * v


@pytest.mark.cuda
def test_kernel_size_gate(cuda):
    """The gate asks the built library, which holds the shared-memory plan;
    a size outside it raises at launch rather than falling back."""
    assert cfr.supported(128, 8, 8) and cfr.supported(64, 5, 3)
    assert cfr.supported(1, 1, 1)
    assert not cfr.supported(129, 8, 8)   # M past the padded 128
    assert not cfr.supported(128, 8, 200)  # outputs past the shared memory
    args = inputs(0, 2, 129, 3, 100, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cfr.fused_conditional_white_stationary(0, *args)


@pytest.mark.cuda
def test_kernel_refuses_float64(cuda):
    """A CUDA tensor reaching the kernel launches it or raises: no fallback."""
    args = [a.double() for a in inputs(0, 2, 64, 3, 100, cuda)]
    with pytest.raises(TypeError, match="float32"):
        cfr.fused_conditional_white_stationary(0, *args)


@pytest.mark.cuda
def test_backward_raises_on_cuda(cuda):
    args = list(inputs(0, 2, 64, 3, 100, cuda))
    args[1] = args[1].clone().requires_grad_(True)
    mean, var = cfr.fused_conditional_white_stationary(0, *args)
    with pytest.raises(NotImplementedError, match="training slice"):
        (mean.sum() + var.sum()).backward()


@pytest.mark.cuda
@pytest.mark.parametrize("precision,device", [("highest", None),
                                              ("high", "cuda")])
def test_dgp_predict_y_goes_through_kernel(cuda, precision, device):
    """predict_y launches the kernel once per layer and matches the same
    request with the kernels off (same unit normals) to 1e-3 of each
    output's scale. Both paths are float32 but sum in other orders, and the
    large entries of Pinv (Kuu is ill-conditioned here) carry that rounding
    to ~1e-4 of the mean's scale, so an absolute tolerance does not fit.
    With precision "high" the process asks for TF32: the port's products
    stay IEEE fp32, and the caller's setting is back afterwards."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        check_predict_y_through_kernel(cuda, device)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(old)


def check_predict_y_through_kernel(cuda, device):
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(300, 4))
    Y = np.sin(X[:, :1])
    f32 = dict(dtype=torch.float32, device=cuda)
    kernels = [K.RBF.create(lengthscales=[1.0] * 4, **f32),
               K.Matern52.create(lengthscales=[1.0] * 4, **f32)]
    model = tdgp.DGP(X, Y, X[:64], kernels, [4], white=True,
                     dtype=torch.float32, device=device)
    assert model.device.type == "cuda"
    with torch.no_grad():
        # perturbed q: at q_sqrt = I the variance is v whatever A and B are
        for layer in model.params.layers:
            M, D = layer.q_mu.shape
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(M, D)), **f32))
            layer.q_sqrt.copy_(torch.tensor(
                np.tril(0.05 * rng.normal(size=(D, M, M)) + np.eye(M)), **f32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    zs = [torch.randn((5, 300, l.num_outputs), generator=gen, **f32)
          for l in model.params.layers]
    before = cfr.FusedConditional.launches
    with torch.no_grad():
        mk, vk = tdgp.predict_y(model.params, X, 5, zs=zs)
        assert cfr.FusedConditional.launches == before + 2
        with kernels_scope(False):
            mp, vp = tdgp.predict_y(model.params, X, 5, zs=zs)
    assert cfr.FusedConditional.launches == before + 2
    for got, want in ((mk, mp), (vk, vp)):
        assert got.shape == want.shape == (5, 300, 1)
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
