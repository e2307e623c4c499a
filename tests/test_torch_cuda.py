"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
where there is no card). This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dgp_tpu_torch.config import kernels_scope
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.ops import _launch
from dgp_tpu_torch.ops import cholesky as tch
from dgp_tpu_torch.ops import conditional_fused as cf
from dgp_tpu_torch.ops import conditional_fused_rbf as cfr
from dgp_tpu_torch.ops import conditionals as C
from dgp_tpu_torch.ops import kernels as K
from dgp_tpu_torch.ops import quadform as qf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's intra-op threads would oversubscribe the cores that the
    other test workers share. Every test_torch_*.py module imports this
    fixture (this one imports no JAX)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


# M = 64, 100 and 128 stage their triangles with 16-byte copies, 50 with
# 4-byte ones; 50 and 100 are padded to 64 and 128
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


# the forwards' edges: the plans pad M to 64 or 128 and take tiles of 128
# points; 262,181 points make more tiles than resident blocks, the last one
# ragged
FORWARD_EDGES = [(m, n) for m in (8, 64, 100, 128)
                 for n in (1, 63, 64, 65, 127, 128, 129, 1_025, 262_181)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["RBF", "Matern32", "Matern52", "#3"])
@pytest.mark.parametrize("M,n", FORWARD_EDGES)
def test_forward_edges_match_plain(cuda, kernel, M, n):
    """Kernels #1 (each kind) and #3 at the edges of their tiles and of the
    padded M against their plain versions in f64 on the same f32 inputs,
    within 1e-4 of each output's scale, with a repeat and a run with NaN
    above Pinv's diagonal and below Sq's giving the same bits
    (chip_smoke.check_kernel and check_fused_white raise otherwise)."""
    seed = M + n % 1000
    if kernel == "#3":
        chip_smoke.check_fused_white(3, M, 8, n, seed)
    else:
        kind = next(k for k, name in KINDS.items() if name == kernel)
        chip_smoke.check_kernel(kind, 3, M, 8, n, seed)


@pytest.mark.cuda
def test_forward_grid_asked_once(cuda):
    """The forwards' persistent grid (the blocks the card holds at once) is
    asked of the library once per device and sizes, not at every launch,
    and a launch on fewer tiles than that still covers every point."""
    args = inputs(0, 3, 64, 5, 300, cuda)
    wargs = composite_inputs(3, 64, 5, 300, cuda)
    with torch.no_grad():
        full = (cfr._launch(0, *args), cf._launch(*wargs))
        before = _launch.grid_blocks.cache_info()
        for n in (1, 129, 300):
            m1, v1 = cfr._launch(0, args[0], args[1][:n], *args[2:])
            Pinv, Kuf, q_mu, Sq, Kff = wargs
            m3, v3 = cf._launch(Pinv, Kuf[:, :n].contiguous(), q_mu, Sq, Kff[:n])
            for (m, v), (mf, vf) in zip(((m1, v1), (m3, v3)), full):
                assert torch.equal(m, mf[:n]) and torch.equal(v, vf[:n])
        after = _launch.grid_blocks.cache_info()
    assert (after.misses, after.hits) == (before.misses, before.hits + 6)


@pytest.mark.cuda
def test_forward_gates_cover_the_backward_gates(cuda):
    """Wherever a whitened backward's plan takes a width, its forward's
    takes it too, and at M = 128 both forwards take every width the repo's
    configurations use (D <= 8, Din <= 8)."""
    for M in (8, 64, 100, 128):
        for D in range(1, 41):
            assert cf.supported(M, D) or not cf.backward_supported(M, D)
            for Din in (1, 5, 8, 16):
                assert (cfr.supported(M, Din, D)
                        or not cfr.backward_supported(M, Din, D))
    assert all(cfr.supported(128, Din, D) and cf.supported(128, D)
               for D in range(1, 9) for Din in range(1, 9))


# the whitened backwards' points per pass
PASS = _launch.BACKWARD_PASS


def off_pattern(dPinv, dSq):
    """Whether a whitened backward's dPinv has a nonzero entry above its
    diagonal or its dSq one below."""
    return bool(torch.triu(dPinv, 1).any() or torch.tril(dSq, -1).any())


def kernel_grads(kind, args, g):
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = cfr.fused_conditional_white_stationary(kind, *leaves)
    grads = torch.autograd.grad(out, leaves, grad_outputs=g)
    torch.cuda.synchronize()
    return grads


# the edges of the padded M (8 and 100 pad to 64 and 128), of phase A's
# 128-point tiles and of the passes of points
@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("D,M,Din,n", [(3, 64, 5, 1037), (8, 128, 8, 4101),
                                       (3, 8, 5, 1), (2, 100, 5, 129),
                                       (3, 128, 5, 65),
                                       (8, 128, 8, PASS + 1)])
def test_backward_kernel_matches_plain(cuda, kind, D, M, Din, n):
    """Backward kernel (both phases) vs its plain version in f64 on the
    same f32 inputs: each gradient within 1e-4 of its own largest magnitude
    (dvariance, a signed sum of n*D terms that cancel, within 1e-4 of
    sum|g_var|); dPinv and dSq exactly 0 off the patterns of Pinv and Sq;
    one launch of each phase per pass of points; and a second run bit for
    bit equal (every sum in a fixed order)."""
    args = inputs(kind, D, M, Din, n, cuda, seed=kind)
    gen = torch.Generator(device=cuda).manual_seed(kind)
    g = [torch.randn((n, D), generator=gen, device=cuda) for _ in range(2)]
    FC = cfr.FusedConditional
    before = (FC.launches, FC.backward_launches, FC.gram_launches)
    got = kernel_grads(kind, args, g)
    passes = -(-n // PASS)
    assert (FC.launches, FC.backward_launches, FC.gram_launches) == (
        before[0] + 1, before[1] + passes, before[2] + passes)
    assert not off_pattern(got[0], got[5])
    again = kernel_grads(kind, args, g)
    want = cfr.fused_conditional_backward_plain(
        kind, *[a.double() for a in args], *[x.double() for x in g])
    names = ("dPinv", "dXs", "dZs", "dvariance", "dq_mu", "dSq")
    for name, a, b, w, leaf in zip(names, got, again, want, args):
        assert a.shape == leaf.shape and a.dtype == torch.float32, name
        assert torch.equal(a, b), name
        scale = (float(g[1].abs().sum()) if name == "dvariance"
                 else float(w.abs().max()))
        assert float((a.double() - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.cuda
def test_backward_kernel_size_gate(cuda):
    """The backward's shared-memory plan is larger than the forward's and
    has its own gate; where a gradient is wanted, fused_kind answers for
    both, so no step launches a forward whose backward cannot follow."""
    assert cfr.backward_supported(128, 8, 8) and cfr.backward_supported(64, 5, 3)
    assert not cfr.backward_supported(129, 8, 8)
    # a width only the forward's plan takes (the backward keeps two tiles of
    # 128 points and a ring of two packed operands beside q_mu and g_mean)
    D = next(D for D in range(8, 200) if cfr.supported(128, 8, D)
             and not cfr.backward_supported(128, 8, D))
    f32 = dict(dtype=torch.float32, device=cuda)
    kern = K.RBF.create(lengthscales=[1.0] * 8, **f32)
    Sq = torch.zeros((D, 128, 128), **f32)
    X = torch.zeros((10, 8), **f32)
    with torch.no_grad():
        assert cfr.fused_kind(kern, Sq, X) == 0
    assert cfr.fused_kind(kern, Sq, X) is None       # kernel parameters want a gradient
    assert cfr.fused_kind(kern, Sq[:8], X) == 0      # within both plans
    args = list(inputs(0, 2, 64, 3, 100, cuda))
    g = torch.ones((100, 2), **f32)
    with pytest.raises(TypeError, match="float32"):
        cfr._launch_backward(0, *args, g, g.double())
    with pytest.raises(ValueError, match="do not form"):
        cfr._launch_backward(0, *args, g, g[:50])


@pytest.mark.cuda
def test_backward_of_no_points(cuda):
    args = list(inputs(0, 2, 64, 3, 100, cuda))
    args[1] = args[1][:0]
    before = cfr.FusedConditional.backward_launches
    grads = kernel_grads(0, args, [torch.zeros((0, 2), device=cuda)] * 2)
    assert cfr.FusedConditional.backward_launches == before
    assert all(g.shape == a.shape and not g.any() for g, a in zip(grads, args))


@pytest.mark.cuda
def test_optimize_adam_goes_through_both_kernels(cuda):
    """Three Adam steps on a 2-layer whitened model: one forward and one
    backward launch per layer per step, finite losses, and the first step's
    gradients equal to the kernels-off path's to 1e-3 of each one's scale."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(300, 4))
    Y = np.sin(3 * X[:, :1])
    f32 = dict(dtype=torch.float32, device=cuda)
    # lengthscale 0.5: with 1.0 the 64 inducing inputs make Kuu so
    # ill-conditioned that Pinv's large entries carry the two fp32 paths'
    # rounding into z's gradient past 1e-3 of its scale
    kernels = [K.RBF.create(lengthscales=[0.5] * 4, **f32),
               K.Matern52.create(lengthscales=[0.5] * 4, **f32)]
    model = tdgp.DGP(X, Y, X[:64], kernels, [4], white=True, num_samples=5,
                     dtype=torch.float32)
    with torch.no_grad():
        for layer in model.params.layers:
            M, D = layer.q_mu.shape
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(M, D)), **f32))
            layer.q_sqrt.copy_(torch.tensor(
                np.tril(0.05 * rng.normal(size=(D, M, M)) + np.eye(M)), **f32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    zs = [torch.randn((5, 300, l.num_outputs), generator=gen, **f32)
          for l in model.params.layers]
    params = list(model.params.parameters())

    def grads():
        loss = -tdgp.elbo(model.params, *model.data, 5, zs=zs)
        return torch.autograd.grad(loss, params)

    before = (cfr.FusedConditional.launches,
              cfr.FusedConditional.backward_launches)
    on = grads()
    assert (cfr.FusedConditional.launches,
            cfr.FusedConditional.backward_launches) == (before[0] + 2,
                                                        before[1] + 2)
    with kernels_scope(False):
        off = grads()
    for (name, _), a, b in zip(model.params.named_parameters(), on, off):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), name

    before = (cfr.FusedConditional.launches,
              cfr.FusedConditional.backward_launches)
    losses = model.optimize_adam(iterations=3, messages=0, shrink_inner=False)
    assert (cfr.FusedConditional.launches,
            cfr.FusedConditional.backward_launches) == (before[0] + 6,
                                                        before[1] + 6)
    assert losses.shape == (3,) and losses.is_cuda
    assert bool(torch.isfinite(losses).all())


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


def quadform_inputs(D, M, n, device, seed=0):
    """Seeded float32 Sq (upper-triangular, as tril(q_sqrt)^T is), A and
    the cotangents g2, g1."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    Sq = torch.tensor(np.triu(rng.normal(size=(D, M, M))) / np.sqrt(M), **f32)
    A = torch.tensor(rng.normal(size=(M, n)), **f32)
    g2 = torch.tensor(rng.normal(size=(D, n)), **f32)
    g1 = torch.tensor(rng.normal(size=(n,)), **f32)
    return Sq, A, g2, g1


# M = 64 and 128 stage with float4 copies, 50 and 100 the padded path; the
# BO surrogate's shapes; and the edges of the tiles of 128 points, of the
# padded M and of #6's passes of points
QUADFORM_SHAPES = list(dict.fromkeys([
    (3, 64, 1037), (8, 128, 4101), (2, 50, 65), (1, 100, 64),
    *chip_smoke.BO_QUADFORM,
    *[(3, m, n) for m in chip_smoke.EDGE_M for n in chip_smoke.QUADFORM_EDGE_N]]))


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", QUADFORM_SHAPES)
def test_quadform_kernels_match_plain(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 (both phases) against their plain versions in f64
    on the same f32 inputs: t2 (and t1), dSq and dA float32 of their
    shapes, t2 (and t1) within 1e-4 of their largest value, dSq and dA
    within 1e-4 of their largest magnitude, dSq exactly 0 below the
    diagonal, one phase-A and one phase-B launch per pass of points, and a
    repeat and a run with NaN below Sq's diagonal bit for bit equal to the
    first (chip_smoke.check_quadform and check_quadform_backward raise
    otherwise)."""
    inputs = quadform_inputs(D, M, n, cuda, seed=D + M)
    chip_smoke.check_quadform(D, M, n, with_t1, D + M, inputs=inputs)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, D + M, inputs=inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
def test_quadform_kernels_at_the_prior(cuda, with_t1):
    """The same holds on a non-whitened layer's own operands at the prior
    (A = Kuu^-1 Kuf, q_sqrt = chol(Kuu)), where its training starts."""
    chip_smoke.check_quadform(2, 100, 1_037, with_t1, 7, prior=True)
    chip_smoke.check_quadform_backward(2, 100, 1_037, with_t1, 7, prior=True)


@pytest.mark.cuda
def test_quadform_size_gate(cuda):
    """The plans take every M <= 128 and every D (the quadform is the route
    of whitened layers wider than the fused plans); a CUDA tensor outside
    them raises at launch rather than falling back, float64 included."""
    assert all(qf.supported(m, D) and qf.backward_supported(m, D)
               for m in (1, 8, 64, 65, 100, 128) for D in (1, 8, 23, 89, 256))
    assert not qf.supported(129, 1) and not qf.backward_supported(256, 8)
    Sq, A, g2, _ = quadform_inputs(2, 129, 100, cuda)
    assert not qf.applicable(Sq, A)
    with pytest.raises(RuntimeError, match="CUDA error"):
        qf.QuadForm.apply(Sq, A, False)
    with pytest.raises(TypeError, match="float32"):
        qf.QuadForm.apply(Sq[:, :64, :64].double(), A[:64].double(), False)
    with pytest.raises(ValueError, match="do not form"):
        qf._launch_backward(Sq, A, g2[:, :50], None)


@pytest.mark.cuda
def test_quadform_of_no_points(cuda):
    Sq, A, g2, g1 = quadform_inputs(2, 64, 0, cuda)
    leaves = [Sq.clone().requires_grad_(True), A.clone().requires_grad_(True)]
    before = (qf.QuadForm.launches, qf.QuadForm.backward_launches)
    t2, t1 = qf.QuadForm.apply(*leaves, True)
    grads = torch.autograd.grad((t2, t1), leaves, grad_outputs=(g2, g1))
    assert (qf.QuadForm.launches, qf.QuadForm.backward_launches) == before
    assert t2.shape == (2, 0) and t1.shape == (0,)
    assert all(g.shape == a.shape and not g.any() for g, a in zip(grads, leaves))


@pytest.mark.cuda
def test_nonwhite_dgp_goes_through_the_quadform_kernels(cuda):
    """A 2-layer non-whitened model (the constructor's default): one request
    launches the quadform kernel once per layer and kernel #1 never; one
    Adam step launches it and its backward (phase A and phase B) once per
    layer; the request and
    the first step's gradients equal the kernels-off path's to 1e-3 of each
    one's scale, both arms factoring Kuu through kernels #7/#8 (two float32
    factorizations of this Kuu differ by more than that once a non-whitened
    mean carries Kuu^-1 q_mu; test_cholesky_kernels_match_plain holds #7/#8
    to float64)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(300, 4))
    Y = np.sin(3 * X[:, :1])
    f32 = dict(dtype=torch.float32, device=cuda)
    kernels = [K.RBF.create(lengthscales=[0.5] * 4, **f32),
               K.Matern52.create(lengthscales=[0.5] * 4, **f32)]
    model = tdgp.DGP(X, Y, X[:64], kernels, [4], num_samples=5,
                     dtype=torch.float32)
    assert not any(l.white for l in model.params.layers)
    with torch.no_grad():
        # off the prior q_sqrt = chol(Kuu), where z's gradient is ~0 and
        # holds only rounding
        for layer in model.params.layers:
            M, D = layer.q_mu.shape
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(M, D)), **f32))
            layer.q_sqrt.mul_(1.0 + 0.05 * torch.tensor(
                rng.normal(size=(D, M, M)), **f32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    zs = [torch.randn((5, 300, l.num_outputs), generator=gen, **f32)
          for l in model.params.layers]
    QF = qf.QuadForm
    counts = lambda: (QF.launches, QF.backward_launches, QF.gram_launches,
                      cfr.FusedConditional.launches)
    before = counts()
    with torch.no_grad(), chip_smoke.cholesky_route("kernels"):
        on = tdgp.predict_y(model.params, X, 5, zs=zs)
        assert counts() == (before[0] + 2, *before[1:])
        with kernels_scope(False):
            off = tdgp.predict_y(model.params, X, 5, zs=zs)
    for got, want in zip(on, off):
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())

    params = list(model.params.parameters())

    def grads():
        loss = -tdgp.elbo(model.params, *model.data, 5, zs=zs)
        return torch.autograd.grad(loss, params)

    before = counts()
    with chip_smoke.cholesky_route("kernels"):
        on = grads()
        assert counts() == (before[0] + 2, before[1] + 2, before[2] + 2,
                            before[3])
        with kernels_scope(False):
            off = grads()
    for (name, _), a, b in zip(model.params.named_parameters(), on, off):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), name
    before = counts()
    losses = model.optimize_adam(iterations=1, messages=0)
    assert counts() == (before[0] + 2, before[1] + 2, before[2] + 2,
                        before[3])
    assert bool(torch.isfinite(losses).all())


def composite_inputs(D, M, Din, n, device, seed=0, clamp=False):
    """Seeded float32 operands of the Kuf-consuming fused conditional for an
    RBF + Linear kernel (Kff varies per point, or with ``clamp`` is set so
    that the clamp zeroes some variances): Pinv, Kuf, q_mu, Sq, Kff."""
    f32 = dict(dtype=torch.float32, device=device)
    kern = (K.RBF.create(variance=1.3, lengthscales=[0.7] * Din, **f32)
            + K.Linear.create(variance=[0.5] * Din, **f32))
    return chip_smoke.composite_inputs(D, M, Din, n, seed, device, kern, clamp)


def composite_grads(args, g):
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = cf.fused_conditional_white(*leaves)
    grads = torch.autograd.grad(out, leaves, grad_outputs=g)
    torch.cuda.synchronize()
    return out, grads


# M = 64 and 128 stage with float4 copies; 50 and 100 take the padded path
@pytest.mark.cuda
@pytest.mark.parametrize("D,M,Din,n,clamp", [
    (3, 64, 5, 1037, False), (8, 128, 8, 4101, False), (2, 50, 3, 65, False),
    (1, 100, 7, 64, False), (8, 128, 8, 4101, True), (2, 100, 8, 1037, True),
    (3, 8, 5, 1, False), (3, 128, 5, 129, False), (8, 128, 8, PASS + 1, False)])
def test_conditional_fused_kernels_match_plain(cuda, D, M, Din, n, clamp):
    """Kernels #3 and #4 against their plain versions in f64 on the same
    f32 inputs: mean within 1e-4 of max|mean|, var within 1e-4 of max Kff
    (the variance cancels against Kff); each gradient within 1e-4 of its
    own largest magnitude (dKff per point too), dPinv and dSq exactly 0
    off the patterns of Pinv and Sq; and a second backward bit for bit
    equal. With ``clamp`` some variances are clamped to 0 and the
    mask zeroes their g_var; where a pre-clamp variance lies within the
    variance's tolerance of 0 the two may take the mask on opposite sides,
    so g_var is 0 there."""
    args = composite_inputs(D, M, Din, n, cuda, seed=D + M, clamp=clamp)
    assert args[1].is_contiguous()  # K(Z, X) of a Sum: the wrapper copies nothing
    gen = torch.Generator(device=cuda).manual_seed(D)
    g = [torch.randn((n, D), generator=gen, device=cuda) for _ in range(2)]
    lin, band = chip_smoke.clamp_band(args)
    g[1] = g[1].masked_fill(lin.T.abs() <= band, 0.0)
    assert not clamp or 0 < int((lin <= 0).sum()) < n * D
    FW = cf.FusedConditionalWhite
    before = (FW.launches, FW.backward_launches, FW.gram_launches)
    (mk, vk), got = composite_grads(args, g)
    _, again = composite_grads(args, g)
    passes = -(-n // PASS)
    assert (FW.launches, FW.backward_launches, FW.gram_launches) == (
        before[0] + 2, before[1] + 2 * passes, before[2] + 2 * passes)
    assert not off_pattern(got[0], got[3])
    d = [a.double() for a in args]
    mp, vp = cf.fused_conditional_white_plain(*d)
    assert mk.shape == vk.shape == (n, D) and mk.dtype == torch.float32
    assert float((mk.double() - mp).abs().max()) <= 1e-4 * float(mp.abs().max())
    assert float((vk.double() - vp).abs().max()) <= 1e-4 * float(d[4].max())
    want = cf.fused_conditional_white_backward_plain(*d, *[x.double() for x in g])
    names = ("dPinv", "dKuf", "dq_mu", "dSq", "dKff")
    for name, a, b, w, leaf in zip(names, got, again, want, args):
        assert a.shape == leaf.shape and a.dtype == torch.float32, name
        assert torch.equal(a, b), name
        assert (float((a.double() - w).abs().max())
                <= 1e-4 * float(w.abs().max())), name


@pytest.mark.cuda
@pytest.mark.parametrize("module", [cfr, cf])
@pytest.mark.parametrize("D,M,n", [(8, 128, 100_000), (1, 128, 1_025),
                                   (3, 50, 63)])
def test_gram_kernels_match_plain(cuda, module, D, M, n):
    """Phase B of each whitened backward alone (split-K Grams, their
    reduction, dSq = triu(2 Sq C)) against its plain version in f64 on the
    same f32 inputs: dPinv and dSq within 1e-4 of their largest magnitude,
    exact zeros off the patterns, a repeat bit for bit equal."""
    args = chip_smoke.gram_inputs(D, M, n, seed=D + M)
    with torch.no_grad():
        got = module.gram_backward(*args)
        again = module.gram_backward(*args)
        torch.cuda.synchronize()
        want = module.gram_backward_plain(*[a.double() for a in args])
    assert not off_pattern(*got)
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and torch.equal(a, b)
        assert float((a.double() - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_conditional_fused_size_gate(cuda):
    """The plans take M <= 128; the backward's is the smaller in D. A CUDA
    tensor outside them raises at launch rather than falling back, float64
    included."""
    assert cf.supported(128, 8) and cf.backward_supported(128, 8)
    assert cf.supported(1, 1) and cf.backward_supported(64, 3)
    assert not cf.supported(129, 1) and not cf.backward_supported(256, 8)
    D = next(D for D in range(8, 200) if cf.supported(128, D)
             and not cf.backward_supported(128, D))
    f32 = dict(dtype=torch.float32, device=cuda)
    Sq = torch.zeros((D, 128, 128), **f32, requires_grad=True)
    Pinv, Kuf = torch.eye(128, **f32), torch.ones((128, 10), **f32)
    q_mu = torch.zeros((128, D), **f32)
    with torch.no_grad():
        assert cf.applicable(Pinv, Kuf, Sq, q_mu)
    assert not cf.applicable(Pinv, Kuf, Sq, q_mu)   # a gradient is wanted
    args = list(composite_inputs(2, 129, 3, 100, cuda))
    assert not cf.applicable(args[0], args[1], args[3], args[2])
    with pytest.raises(RuntimeError, match="CUDA error"):
        cf.fused_conditional_white(*args)
    args = list(composite_inputs(2, 64, 3, 100, cuda))
    with pytest.raises(TypeError, match="float32"):
        cf.fused_conditional_white(*[a.double() for a in args])
    g = torch.ones((100, 2), **f32)
    with pytest.raises(ValueError, match="do not form"):
        cf._launch_backward(*args, g, g[:50])


@pytest.mark.cuda
def test_conditional_fused_of_no_points(cuda):
    args = list(composite_inputs(2, 64, 3, 1, cuda))
    args[1], args[4] = args[1][:, :0], args[4][:0]
    before = (cf.FusedConditionalWhite.launches,
              cf.FusedConditionalWhite.backward_launches)
    (mean, var), grads = composite_grads(args, [torch.zeros((0, 2), device=cuda)] * 2)
    assert (cf.FusedConditionalWhite.launches,
            cf.FusedConditionalWhite.backward_launches) == before
    assert mean.shape == var.shape == (0, 2)
    assert all(g.shape == a.shape and not g.any() for g, a in zip(grads, args))


@pytest.mark.cuda
def test_composite_dgp_goes_through_the_fused_white_kernels(cuda):
    """A 2-layer whitened model of RBF + Linear kernels (layer 1 on one
    active dimension): one request launches kernel #3 once per layer and
    neither #1 nor #5; one loss gradient and one Adam step launch #3 and #4
    once per layer; the request and the gradients equal the kernels-off
    path's to 1e-3 of each one's scale."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(300, 4))
    Y = np.sin(3 * X[:, :1])
    f32 = dict(dtype=torch.float32, device=cuda)
    kernels = [K.RBF.create(lengthscales=[0.5] * 4, **f32)
               + K.Linear.create(variance=[1.0] * 4, **f32),
               K.RBF.create(lengthscales=[0.5] * 4, **f32)
               + K.Linear.create(variance=0.5, active_dims=[0], **f32)]
    model = tdgp.DGP(X, Y, X[:64], kernels, [4], white=True, num_samples=5,
                     dtype=torch.float32)
    with torch.no_grad():
        for layer in model.params.layers:
            M, D = layer.q_mu.shape
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(M, D)), **f32))
            layer.q_sqrt.copy_(torch.tensor(
                np.tril(0.05 * rng.normal(size=(D, M, M)) + np.eye(M)), **f32))
    gen = torch.Generator(device=cuda).manual_seed(1)
    zs = [torch.randn((5, 300, l.num_outputs), generator=gen, **f32)
          for l in model.params.layers]
    counts = lambda: (cf.FusedConditionalWhite.launches,
                      cf.FusedConditionalWhite.backward_launches,
                      cfr.FusedConditional.launches, qf.QuadForm.launches)
    before = counts()
    with torch.no_grad():
        on = tdgp.predict_y(model.params, X, 5, zs=zs)
        assert counts() == (before[0] + 2, *before[1:])
        with kernels_scope(False):
            off = tdgp.predict_y(model.params, X, 5, zs=zs)
    for got, want in zip(on, off):
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())

    params = list(model.params.parameters())

    def grads():
        loss = -tdgp.elbo(model.params, *model.data, 5, zs=zs)
        return torch.autograd.grad(loss, params)

    before = counts()
    on = grads()
    assert counts() == (before[0] + 2, before[1] + 2, *before[2:])
    with kernels_scope(False):
        off = grads()
    for (name, _), a, b in zip(model.params.named_parameters(), on, off):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), name
    before = counts()
    losses = model.optimize_adam(iterations=1, messages=0)
    assert counts() == (before[0] + 2, before[1] + 2, *before[2:])
    assert bool(torch.isfinite(losses).all())


# the largest M of each plan, 240 for #7 and 169 for #8 (test_cholesky_size_gate
# holds the plans), taken by #7 at both and by #8 at its own
_CHOLESKY_CASES = [(2, 128, None), (3, 24, None), (1, 8, None), (1, 100, None),
                   (2, 128, "model"), (3, 8, "bo"),
                   *[(1, m, None) for m in chip_smoke.CHOLESKY_EDGES],
                   (40, 64, None), (1, 240, None), (1, 169, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,kuu,inverse", [
    (*case, inverse) for inverse in (False, True) for case in _CHOLESKY_CASES
    if not (inverse and case[1] > 169)])
def test_cholesky_kernels_match_plain(cuda, inverse, G, M, kuu):
    """Kernel #7 (#8) against its plain version in float64 (L within 1e-4
    of scale, W also within twice the float32 library pair's own error), a
    repeat and a stack with NaN above the diagonal bit for bit equal, NaN
    in place for an indefinite matrix and for one whose pivot fails past
    the first panel, and the Function's gradient against autograd in
    float64 (on the well-conditioned stacks): chip_smoke's check, which
    raises on any miss. The M either side of each panel edge, a stack of
    40 and the largest M of each plan are the blocked plan's edges."""
    assert chip_smoke.check_cholesky(G, M, 60 + M, inverse, kuu) < 1.0


@pytest.mark.cuda
def test_cholesky_size_gate(cuda):
    """The plans: M <= 240 for #7 and M <= 169 for #8 (the matrix, or both,
    in shared memory); outside them the gate says no, a launch raises, and
    the dispatch takes the plain version; float64 is refused likewise."""
    assert tch.supported(240) and not tch.supported(241)
    assert tch.supported(169, True) and not tch.supported(170, True)
    big = chip_smoke.spd_stack(1, 170, 0)
    assert tch.applicable(big) and not tch.applicable(big, inverse=True)
    with pytest.raises(RuntimeError, match="does not take M=170"):
        tch._launch(big, True)
    before = tch.CholeskyInverse.launches
    L, W = tch.cholesky_inverse(big)
    assert tch.CholeskyInverse.launches == before and torch.isfinite(W).all()
    assert not tch.applicable(big.double())
    with pytest.raises(TypeError, match="float32"):
        tch.Cholesky.apply(big.double())
    empty = tch._launch(big[:0], True)
    assert [tuple(t.shape) for t in empty] == [(0, 170, 170)] * 2


@pytest.mark.cuda
def test_bo_surrogates_go_through_the_cholesky_kernels(cuda):
    """The BO surrogates on the card: a GPR likelihood launches #7 once; a
    non-whitened DGP (num_layers=2: three SVGP layers) launches #7 once per
    layer when it is built (q_sqrt = chol(Kuu)), its ELBO #8 once (one
    (M, white) group, whose factor the KL takes too), its prediction #8
    once; a bad Kuu gives NaN without an exception or a host sync."""
    from dgp_tpu_torch.bo.so_bo import make_single_model

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(6, 1))
    Y = np.where(X > 0.25, 1.0, 0.0)
    counts = lambda: (tch.Cholesky.launches, tch.CholeskyInverse.launches)
    gpr = make_single_model({"num_layers": 0, "kernels": "rbf"}, X, Y,
                            n_bucket=8)
    before = counts()
    loss = gpr.training_loss()
    assert counts() == (before[0] + 1, before[1]) and torch.isfinite(loss)
    before = counts()
    dgp = make_single_model({"num_layers": 2, "num_units": 1,
                             "kernels": "rbf", "num_samples": 10}, X, Y,
                            n_bucket=8)
    assert counts() == (before[0] + 3, before[1])
    before = counts()
    elbo = dgp.ELBO()
    assert counts() == (before[0], before[1] + 1) and torch.isfinite(elbo)
    before = counts()
    mean, var = dgp.predict_y(X, 10)
    assert counts() == (before[0], before[1] + 1)
    with torch.no_grad():
        dgp.params.layers[0].z[2, 0] = float("nan")
    assert torch.isnan(dgp.ELBO())


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", chip_smoke.MF_QUADFORM)
def test_quadform_kernels_at_the_mf_shapes(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 at the multi-fidelity model's shapes (D = 1,
    M = 30 and 5, n from 50 to 250,000), held as in
    test_quadform_kernels_match_plain."""
    chip_smoke.check_quadform(D, M, n, with_t1, M + n % 97)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, M + n % 97)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cholesky_kernels_on_the_park_kuu(cuda, inverse):
    """Kernels #7 and #8 on the Park MF model's own Kuu stacks ([1, 30, 30]
    and [1, 5, 5], the second at the recomputed augmented Z), held to their
    float64 twins under the float32 jitter."""
    for name, stack in chip_smoke.park_kuu():
        assert chip_smoke.check_cholesky(1, stack[0].shape[-1], 0, inverse,
                                         kuu=name, stack=stack) < 1.0


@pytest.mark.cuda
def test_mf_dgp_goes_through_the_kernels(cuda):
    """The Park MF model on the card: built with #7 per layer and one
    Z_right (#8, #5); each loss evaluation of optimize_adam launches #5,
    #6 and its phase B four times and #8 three times; a request and a loss
    gradient on fixed normals with the quadform kernels on equal the
    kernels-off path's to 1e-3 of scale, z_left's gradient nonzero, and the
    request holds to its float64 twin (chip_smoke.compare_mf)."""
    chip_smoke.zero_counts()
    model = chip_smoke.mf_model()
    assert chip_smoke.counts() == chip_smoke.mf_expected_counts(built=1)
    losses = model.optimize_adam(iterations1=1, iterations2=1, iterations3=1,
                                 messages=0)
    assert bool(torch.isfinite(losses).all())
    assert chip_smoke.counts() == chip_smoke.mf_expected_counts(built=1,
                                                                losses=3)
    chip_smoke.compare_mf(model)


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", chip_smoke.EM_QUADFORM)
def test_quadform_kernels_at_the_em_shapes(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 at the Embedded Mapping model's shapes (the
    reduction layer's D = 2 at M = 6; D = 1 at M = 30 and 6; n from 300 to
    250,000), held as in test_quadform_kernels_match_plain."""
    chip_smoke.check_quadform(D, M, n, with_t1, D + M + n % 97)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, D + M + n % 97)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cholesky_kernels_on_the_em_kuu(cuda, inverse):
    """Kernels #7 and #8 on the Park_VD model's own Kuu stacks ([1, 30, 30],
    [1, 6, 6] and [2, 6, 6], layer 1's at the recomputed 5-D augmented Z),
    held to their float64 twins under the float32 jitter."""
    for name, stack in chip_smoke.em_kuu():
        assert chip_smoke.check_cholesky(stack[0].shape[0],
                                         stack[0].shape[-1], 0, inverse,
                                         kuu=name, stack=stack) < 1.0


@pytest.mark.cuda
def test_em_dgp_goes_through_the_kernels(cuda):
    """The Park_VD model on the card through the smoke run's em phase
    (chip_smoke.run_em: built with #7 per layer and one Z_right, then
    optimize_nat_adam and optimize_adam with each phase's frozen tensors
    unchanged, and a predict; the launches of #5-#8 as em_expected_counts
    reckons them), then a request and a loss gradient on fixed normals
    with the quadform kernels on and off, the gradients of z_left, the
    reduction layer's z and q_mu and the projection likelihood nonzero, and
    the request held to its float64 twin (chip_smoke.compare_em). The
    comparison is made at the trained state, where the smoke run makes it:
    at the initial state layer 0's kernel-variance gradient is beyond
    float32's resolution (the plain float32 arm itself 17 % off its float64
    twin; PERF.md section 7)."""
    launched, model = chip_smoke.run_em(chip_smoke.gpu_line())
    assert launched[4] > 0 and launched[7] > 0
    chip_smoke.compare_em(model)


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", chip_smoke.MO_QUADFORM)
def test_quadform_kernels_at_the_mo_shapes(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 at the multi-objective model's shapes (D = 1,
    M = 10, n from 100 to 250,000), held as in
    test_quadform_kernels_match_plain."""
    chip_smoke.check_quadform(D, M, n, with_t1, M + n % 97)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, M + n % 97)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cholesky_kernels_on_the_mo_kuu(cuda, inverse):
    """Kernels #7 and #8 on the MO model's own Kuu stacks ([1, 10, 10] and
    [2, 10, 10], layer 1's at the recomputed augmented Z), held to their
    float64 twins under the float32 jitter."""
    for name, stack in chip_smoke.mo_kuu():
        assert chip_smoke.check_cholesky(stack[0].shape[0],
                                         stack[0].shape[-1], 0, inverse,
                                         kuu=name, stack=stack) < 1.0


@pytest.mark.cuda
def test_mo_dgp_loss_and_gradient_kernels_on_vs_off(cuda):
    """The MO model (multi_obj_1D_4, loop 2) on the card: built with #7 per
    layer and one Z_right; one loss and its gradient on fixed normals
    launches #5 fifteen times, #6 fourteen, #8 six (mo_expected_counts)
    and equals the kernels-off loss and gradient under the witness rule;
    a request likewise, held to float64 (chip_smoke.compare_mo), off the
    prior (_init_variational, as training starts)."""
    chip_smoke.zero_counts()
    model = chip_smoke.mo_model()
    assert chip_smoke.counts() == chip_smoke.mo_expected_counts(built=1)
    model._init_variational()
    chip_smoke.compare_mo(model)


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", chip_smoke.MOBO_QUADFORM)
def test_quadform_kernels_at_the_mo_bo_shapes(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 at MO_BO's shapes (D = 1, M = 16: the padded
    inducing rows; n from a training loss's 80 to an uncut DE generation's
    300,000), held as in test_quadform_kernels_match_plain."""
    chip_smoke.check_quadform(D, M, n, with_t1, M + n % 97)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, M + n % 97)


@pytest.mark.cuda
def test_cholesky_kernels_on_the_mo_bo_stacks(cuda):
    """Kernels #7 and #8 on MO_BO's stacks: the coupled model's Kuu
    [1, 16, 16] and [2, 16, 16], a DGP's [2, 16, 16] and a GPR's padded
    Gram [1, 16, 16], held to their float64 twins under the float32 jitter
    (chip_smoke.mo_bo_stacks)."""
    for name, stack, inverses in chip_smoke.mo_bo_stacks():
        for inverse in inverses:
            assert chip_smoke.check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["MOBO_GPR", "MOBO_COUPLED", "MOBO_DGP"])
def test_mo_bo_ehvi_kernels_on_vs_off(cuda, spec):
    """A trained MO_BO batch state of each surrogate form (the mo_bo
    phase's cut specs): EHVI of 1,000 fixed rows on fixed normals by each
    estimator with the kernels on (launched as reckoned) and off, and
    against float64 (chip_smoke.compare_mo_bo, the GPR pair's plain term
    capped at MOBO_GPR_CAP, the others' at WITNESS_CAP)."""
    from dgp_tpu_torch.bo.mo_bo import MO_BO
    from dgp_tpu_torch.bo.problems import get

    bo = MO_BO(problem=get("multi_obj_1D_4"), DoE_size=chip_smoke.MOBO_N,
               model_dic=getattr(chip_smoke, spec), seed=chip_smoke.MOBO_SEED,
               device="cuda")
    chip_smoke.compare_mo_bo(
        f"card test {spec}", bo, bo._fresh_batch_state(0),
        chip_smoke.MOBO_GPR_CAP if spec == "MOBO_GPR"
        else chip_smoke.WITNESS_CAP)


@pytest.mark.cuda
def test_cholesky_kernel_on_the_exact_mf_grams(cuda):
    """Kernel #7 on the Gram stacks the exact surrogates' multi-start engine
    factors at its first step (8 starts: the borehole pair's AR(1) joint
    Gram [8, 56, 56] and NARGP level Grams [8, 40, 40], [8, 16, 16]; the
    nonlinear pair's [8, 48, 48], [8, 32, 32], [8, 16, 16]; padding rows
    with a unit diagonal), held to their float64 twins under the float32
    jitter (chip_smoke.exact_grams, the witness rule for L on the
    nonlinear pair's)."""
    for name, stack, witness in chip_smoke.exact_grams():
        assert chip_smoke.check_cholesky(stack[0].shape[0],
                                         stack[0].shape[-1], 0, False,
                                         kuu=name, stack=stack,
                                         witness=witness) < 1.0


@pytest.mark.parametrize("kind", ["ar1", "nargp"])
@pytest.mark.cuda
def test_exact_surrogates_go_through_the_cholesky_kernel(cuda, kind):
    """The borehole pair's AR(1) and NARGP on the card, 20 engine steps of
    8 starts: one #7 launch per step for all the starts (per level for
    NARGP, and one for its mean chain), the winner the least final NLL;
    the loss and gradient at the trained parameters with #7 on and off
    and against float64; 1,000-row predictions, one #7 per Gram each
    (chip_smoke.train_exact, compare_exact, exact_predictions)."""
    model, _ = chip_smoke.train_exact(f"card test {kind}", kind,
                                      chip_smoke.borehole_data(), 20,
                                      "card test")
    chip_smoke.compare_exact(f"card test {kind}", model)
    rows = np.random.default_rng(2).uniform(size=(1_000, chip_smoke.XMF_D))
    chip_smoke.exact_predictions(f"card test {kind}", model, rows,
                                 chip_smoke.XMF_S, "card test")


@pytest.mark.cuda
@pytest.mark.parametrize("with_t1", [False, True])
@pytest.mark.parametrize("D,M,n", chip_smoke.CLS_QUADFORM)
def test_quadform_kernels_at_the_cls_shapes(cuda, with_t1, D, M, n):
    """Kernels #5 and #6 at the classifier's (D = 2 and 1, M = 30), the
    Student-t model's (D = 1, M = 20) and the nb_DGP_regression model's
    (D = 1, M = 25) shapes, held as in test_quadform_kernels_match_plain."""
    chip_smoke.check_quadform(D, M, n, with_t1, M + n % 97)
    chip_smoke.check_quadform_backward(D, M, n, with_t1, M + n % 97)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cholesky_kernels_on_the_cls_kuu(cuda, inverse):
    """Kernels #7 and #8 on the classifier's [2, 30, 30], the Student-t
    model's [2, 20, 20] and the nb_DGP_regression model's [3, 25, 25] Kuu
    stacks, held to their float64 twins under the float32 jitter, L by the
    witness rule (chip_smoke.check_cls_kernels)."""
    for name, stack in chip_smoke.cls_kuu():
        assert chip_smoke.check_cholesky(stack[0].shape[0],
                                         stack[0].shape[-1], 0, inverse,
                                         kuu=name, stack=stack,
                                         witness=True) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Bernoulli", "StudentT"])
def test_quadrature_likelihoods_on_the_card(cuda, name):
    """The quadrature heads on float32 CUDA tensors against the same
    functions on the CPU in float64, within float32 rounding of scale."""
    from dgp_tpu_torch.ops import likelihoods as L

    rng = np.random.default_rng(5)
    Fmu = rng.normal(size=(4, 30, 2))
    Fvar = rng.uniform(0.0, 2.0, size=(4, 30, 2))
    Y = rng.normal(size=(30, 2))
    if name == "Bernoulli":
        liks = [L.Bernoulli(), L.Bernoulli()]
        Y = (Y > 0).astype(float)
    else:
        liks = [L.StudentT.create(0.3, df=4.0, dtype=dtype, device=device)
                for dtype, device in ((torch.float32, cuda),
                                      (torch.float64, "cpu"))]
    outs = []
    for lik, dtype, device in zip(liks, (torch.float32, torch.float64),
                                  (cuda, "cpu")):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        outs.append([lik.variational_expectations(t(Fmu), t(Fvar), t(Y)),
                     lik.predict_density(t(Fmu), t(Fvar), t(Y)),
                     *lik.predict_mean_and_var(t(Fmu), t(Fvar))])
    for got, want in zip(*outs):
        assert got.is_cuda and got.dtype == torch.float32
        err = float((got.detach().double().cpu() - want.detach()).abs().max())
        assert err <= 1e-5 * float(want.detach().abs().max()), (name, err)


@pytest.mark.cuda
def test_cls_heads_go_through_the_kernels(cuda):
    """The smoke run's cls phase: the classifier trained by Adam and served
    (#5-#8 as reckoned), a fresh one by natural gradients, the whitened
    classifier through #1/#2 and the Student-t model by Adam + natural
    gradients (chip_smoke.run_cls); then each trained model's request and
    loss gradient with the kernels on and off and against float64
    (chip_smoke.compare_cls)."""
    launched, models = chip_smoke.run_cls("card test")
    assert min(launched[:2] + launched[4:8]) > 0
    chip_smoke.compare_cls(*models)


@pytest.fixture
def nccl_mesh(cuda):
    """A world-size-1 NCCL process group and its 1-D mesh on the card."""
    from examples_torch.serving import process_group

    with process_group("cuda") as mesh:
        yield mesh


@pytest.mark.cuda
@pytest.mark.parametrize("white", [True, False])
def test_sharded_loss_at_world_size_1(nccl_mesh, white):
    """bench.py's model on a world-size-1 NCCL mesh: the sharded
    loss-and-gradient through #1/#2 (whitened) or #5/#6, on one draw,
    within chip_smoke.PAR_TOL of the unsharded one, with the launches of
    one unsharded evaluation."""
    single = chip_smoke.training_model(white=white)
    sharded = chip_smoke.training_model(white=white, mesh=nccl_mesh)
    for m in (single, sharded):
        chip_smoke.perturb(m, np.random.default_rng(3))
    path = "stationary" if white else "nonwhite"
    worst, _, _ = chip_smoke.hold_sharded(
        path, "dgp", single, sharded,
        chip_smoke.expected_counts(path, 1, 2, loss=True))
    assert worst <= chip_smoke.PAR_TOL


@pytest.mark.cuda
def test_sharded_request_at_world_size_1(nccl_mesh):
    """A 1-layer whitened request (its moments do not depend on the draws)
    through predict_y_sharded, whole and in chunks, equals predict_y within
    chip_smoke.PAR_TOL; one #1 launch (and one #8) per chunk."""
    one = chip_smoke.one_layer_model()
    one_mesh = chip_smoke.one_layer_model(nccl_mesh)
    X = np.random.default_rng(6).uniform(0, 1, size=(20_000, chip_smoke.DIN))
    with torch.no_grad():
        want = one.predict_y(X, chip_smoke.S)
        for chunk in (None, 5_000):
            chip_smoke.zero_counts()
            got = one_mesh.predict_y_sharded(X, chip_smoke.S, chunk_size=chunk)
            n = 1 if chunk is None else 4
            assert chip_smoke.counts() == chip_smoke.expected_counts(
                "stationary", n, 1)
            chip_smoke.hold_request("1-layer request", got, want)


@pytest.mark.cuda
def test_safe_cholesky_goes_through_the_cholesky_kernel(cuda):
    """ops.linalg.safe_cholesky on a [4, 128, 128] stack: one launch of #7,
    L within chip_smoke.TOL of scale of the float64 factor of the same
    jittered stack, and NaN (no exception) for an indefinite matrix."""
    from dgp_tpu_torch.ops import linalg

    A = chip_smoke.spd_stack(4, 128, 3)
    before = tch.Cholesky.launches
    L = linalg.safe_cholesky(A)
    assert tch.Cholesky.launches == before + 1 and L.dtype == torch.float32
    want = torch.linalg.cholesky(linalg.add_jitter(A.double(), 1e-4))
    assert float((L.double() - want).abs().max()) <= (
        chip_smoke.TOL * float(want.abs().max()))
    bad = A.clone()
    bad[2] -= 1e3 * torch.eye(128, device=A.device)
    L = linalg.safe_cholesky(bad)
    assert torch.isnan(L[2].diagonal()).any() and torch.isfinite(L[0]).all()


@pytest.mark.cuda
def test_top_level_entry_points_build_on_the_card(cuda):
    """The top-level exports of dgp_tpu_torch build on the card when no
    device is given, in float32 unless set_default_float says otherwise."""
    import dgp_tpu_torch as dgp
    from dgp_tpu_torch.bo.problems import get

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(8, 1))
    Y = np.sin(4 * X)
    kern = dgp.kernels.RBF.create(lengthscales=[1.0])
    models = [dgp.DGP(X, Y, X[:4], [kern, kern], [1]),
              dgp.GPR((X, Y), kern),
              dgp.MultiFidelityDeepGP([X, X[:4]], [Y, Y[:4]]),
              dgp.MultiObjDeepGP([X, X.copy()], [Y, np.cos(4 * X)], loop=1),
              dgp.AR1CoKriging(([X, X[:4]], [Y, Y[:4]]))]
    for model in models:
        tensors = list(model.params.parameters())
        assert tensors and all(t.is_cuda and t.dtype == torch.float32
                               for t in tensors), type(model).__name__
    mo_bo = dgp.MO_BO(problem=get("multi_obj_1D_4"), DoE_size=4)
    assert mo_bo.device.type == "cuda"
    saved = dict(dgp.config._STATE)
    try:
        dgp.set_default_float(torch.float64)
        model = dgp.DGP(X, Y, X[:4], [kern, kern], [1])
        assert {(p.is_cuda, p.dtype) for p in model.params.parameters()} == {
            (True, torch.float64)}
    finally:
        dgp.config._STATE.update(saved)
