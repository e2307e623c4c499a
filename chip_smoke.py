#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dgp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on any fault:

1. build   — compile every CUDA source of the port with nvcc (sm_90a);
             print the build time, ptxas's register and spill report, and
             the card's name and power limit.
2. kernels — hold the fused-conditional kernel to its plain PyTorch version
             in float64 on the same float32 inputs, for RBF, Matern-3/2 and
             Matern-5/2, at the serving model's layer shapes (D=8 and D=1,
             M=128, Din=8, n=262,181, a ragged last tile) and at a small odd
             shape (D=3, M=64, Din=5).
3. serving — build the 2-layer whitened RBF DGP of
             benchmarks/predict_throughput.py (DIN=8, HIDDEN=8, M=128, f32,
             S=10) from seeded data with perturbed variational parameters;
             answer 3 predict_y requests of N=100,000 rows plus
             moment_matched, and one request of N=1,000,000 rows through
             predict_in_chunks in chunks of 125,000. The kernels' launch
             counts are zeroed just before and read just after: each request
             must launch the kernel once per layer. Then one request is held
             to the same request with use_kernels off (same unit normals),
             in a process that asks for TF32: the port stays IEEE fp32.
4. timing  — CUDA-event times of the kernel and of its plain version at the
             layers' shapes with n = 1,000,000, beside the fp32 bound of the
             work these inputs need; then the device time by kernel over one
             request (torch.profiler).

The line before the last is one JSON object listing every ported kernel;
the last line is {"ok": true, "device": {...}}. Without a card, or without
the rest of the repository beside it, the script fails before printing
either.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KINDS = {0: "RBF", 1: "Matern32", 2: "Matern52"}
DIN, HIDDEN, M, S = 8, 8, 128, 10
N_REQUEST, N_CHUNKED, CHUNK = 100_000, 1_000_000, 125_000
TOL = 1e-4          # kernel vs f64 plain: mean err / max|mean|, var err / v
# kernel on vs off at the request level: both paths are float32 but sum in
# other orders (cuBLAS vs the kernel's sequential FMA); layer 1's rounding
# reaches layer 2 through the sampled inputs and the v - ||A||^2
# cancellation, so the request is held at 1e-3 of its scale
TOL_REQUEST = 1e-3
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 1 --------------------------------------------------------------------


def build():
    from dgp_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in (text or "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")


# -- phase 2 --------------------------------------------------------------------


def fused_inputs(kind, D, Mi, Din, n, seed, device):
    """Seeded float32 inputs of the fused conditional, with non-trivial
    variational parameters (q_mu ~ N(0,1), q_sqrt = tril(0.05 N + I))."""
    from dgp_tpu_torch.ops import conditionals as C
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    pool = rng.uniform(size=(2000, Din))
    Z = torch.tensor(pool[rng.choice(2000, Mi, replace=False)], **f32)
    X = torch.tensor(rng.uniform(size=(n, Din)), **f32)
    q_mu = torch.tensor(rng.normal(size=(Mi, D)), **f32)
    q_sqrt = torch.tensor(
        np.tril(0.05 * rng.normal(size=(D, Mi, Mi)) + np.eye(Mi)), **f32)
    kern = getattr(K, KINDS[kind]).create(variance=1.3, lengthscales=[1.0] * Din,
                                          **f32)
    with torch.no_grad():
        proj = C.precompute_projection(kern, Z, q_sqrt, True)
        ls = kern.lengthscales
        return (proj.Pinv, X / ls, Z / ls, kern.variance.detach(), q_mu,
                torch.tril(q_sqrt).transpose(-1, -2))


def check_kernel(kind, D, Mi, Din, n, seed):
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, Mi, Din, n, seed, DEVICE)
    with torch.no_grad():
        mk, vk = cfr.fused_conditional_white_stationary(kind, *args)
        sync()
        mp, vp = cfr.fused_conditional_plain(kind, *[a.double() for a in args])
    if not (torch.isfinite(mk).all() and torch.isfinite(vk).all()):
        raise AssertionError(f"{KINDS[kind]}: non-finite kernel output")
    v = float(args[3])
    em = float((mk.double() - mp).abs().max())
    ev = float((vk.double() - vp).abs().max())
    scale_m = float(mp.abs().max())
    ok = em <= TOL * scale_m and ev <= TOL * v
    log(f"[kernels] {KINDS[kind]:8s} D={D} M={Mi} Din={Din} n={n}: "
        f"max|dmean| {em:.3e} (tol {TOL * scale_m:.3e} = {TOL}*max|mean|), "
        f"max|dvar| {ev:.3e} (tol {TOL * v:.3e} = {TOL}*v) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{KINDS[kind]} kernel disagrees with its plain version")
    return max(em, ev)


# -- phase 3 --------------------------------------------------------------------


def serving_model(seed=0, N_train=2_000):
    """benchmarks/predict_throughput.py's model, on the card, with the
    variational parameters of both layers perturbed (at the reference init,
    whitened q_sqrt = I makes t2 == t1, so var == v and mean == 0 would hide
    any error in A or B)."""
    from dgp_tpu_torch.models.dgp import DGP
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N_train, DIN))
    Y = np.sin(3 * X[:, :1]) + 0.05 * rng.normal(size=(N_train, 1))
    Z = X[rng.choice(N_train, M, replace=False)].copy()
    f32 = dict(dtype=torch.float32, device=DEVICE)
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * DIN, **f32),
               K.RBF.create(variance=1.0, lengthscales=[1.0] * HIDDEN, **f32)]
    model = DGP(X, Y, Z, kernels, [HIDDEN], num_samples=S, white=True,
                device=DEVICE, dtype=torch.float32)
    with torch.no_grad():
        for layer in model.params.layers:
            D = layer.num_outputs
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(M, D)), **f32))
            layer.q_sqrt.copy_(torch.tensor(
                np.tril(0.05 * rng.normal(size=(D, M, M)) + np.eye(M)), **f32))
    return model


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def serve(model, gpu):
    """The main path: requests through the entry points a user calls."""
    from dgp_tpu_torch.models.dgp import moment_matched, predict_y
    from dgp_tpu_torch.ops.conditional_fused_rbf import FusedConditional
    from dgp_tpu_torch.parallel.serving import predict_in_chunks

    rng = np.random.default_rng(1)
    requests = [rng.uniform(0, 1, size=(N_REQUEST, DIN)) for _ in range(3)]
    X_big = rng.uniform(0, 1, size=(N_CHUNKED, DIN))
    n_layers = len(model.params.layers)

    FusedConditional.launches = 0
    for i, Xr in enumerate(requests):
        before = FusedConditional.launches
        (mean, var), dt = timed(lambda: model.predict_y(Xr, S))
        mm, mv = moment_matched(mean, var)
        launched = FusedConditional.launches - before
        if launched != n_layers:
            raise AssertionError(f"request {i}: {launched} kernel launches, "
                                 f"expected {n_layers}")
        if mean.shape != (S, N_REQUEST, 1) or mm.shape != (N_REQUEST, 1):
            raise AssertionError(f"request {i}: shapes {tuple(mean.shape)}, {tuple(mm.shape)}")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()
                and (var > 0).all() and (mv > 0).all()):
            raise AssertionError(f"request {i}: non-finite or non-positive output")
        log(f"[serving] request {i}: N={N_REQUEST} S={S}: {1e3 * dt:.2f} ms, "
            f"{N_REQUEST / dt:,.0f} points/s, {launched} kernel launches ({gpu})")

    before = FusedConditional.launches
    predict = lambda p, Xc, g: predict_y(p, Xc, S, g)
    with torch.no_grad():
        (cm, cv), dt = timed(lambda: predict_in_chunks(
            predict, model.params, X_big, model.generator, CHUNK,
            device=DEVICE))
    expect = n_layers * (N_CHUNKED // CHUNK)
    launched = FusedConditional.launches - before
    if launched != expect:
        raise AssertionError(f"chunked: {launched} kernel launches, "
                             f"expected {expect}")
    if cm.shape != (S, N_CHUNKED, 1) or not (torch.isfinite(cm).all()
                                             and (cv > 0).all()):
        raise AssertionError("chunked request: bad output")
    log(f"[serving] chunked request: N={N_CHUNKED} in {CHUNK} chunks, S={S}: "
        f"{1e3 * dt:.2f} ms, {N_CHUNKED / dt:,.0f} points/s, {launched} kernel "
        f"launches ({gpu})")
    return FusedConditional.launches


def compare_paths(model):
    """One request with the kernels on and off, on the same unit normals,
    while the process asks for TF32 matrix products (as many training
    scripts do): the port's own products must stay IEEE fp32 all the same."""
    from dgp_tpu_torch.config import kernels_scope
    from dgp_tpu_torch.models.dgp import predict_y

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    X = torch.rand((N_REQUEST, DIN), generator=gen, device=DEVICE)
    zs = [torch.randn((S, N_REQUEST, l.num_outputs), generator=gen,
                      device=DEVICE) for l in model.params.layers]
    torch.set_float32_matmul_precision("high")
    try:
        with torch.no_grad():
            mk, vk = predict_y(model.params, X, S, zs=zs)
            with kernels_scope(False):
                mp, vp = predict_y(model.params, X, S, zs=zs)
    finally:
        torch.set_float32_matmul_precision("highest")
    em = float((mk - mp).abs().max()) / float(mp.abs().max())
    ev = float((vk - vp).abs().max()) / float(vp.abs().max())
    log(f"[serving] kernels on vs off, one request, TF32 asked for: "
        f"mean err {em:.3e}, "
        f"var err {ev:.3e} of scale (tol {TOL_REQUEST})")
    if not (em <= TOL_REQUEST and ev <= TOL_REQUEST):
        raise AssertionError("the request differs with the kernels off")


# -- phase 4 --------------------------------------------------------------------


def event_ms(fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_bound_ms(Pinv, Xs, q_mu, Sq):
    """Least time for the fused conditional on these inputs: its FLOP over
    the fp32 peak or its bytes (each input read once, each output written
    once) over the memory rate, whichever is larger. The two M x M products
    count only the nonzeros of Pinv and Sq: on the whitened path these are
    triangular, so the function needs M(M+1) FLOP per point for each, where
    the kernel spends 2M^2 on the full square."""
    n, Din = Xs.shape
    Mi, D = q_mu.shape
    nnz = int(torch.count_nonzero(Pinv)) + int(torch.count_nonzero(Sq))
    # cross term z.x, the Pinv and Sq products, mean, t1 = ||A||^2, t2
    per_point = 2 * Mi * Din + 2 * nnz + 2 * Mi * D + 2 * Mi + 2 * Mi * D
    flops = float(n) * per_point
    nbytes = 4.0 * (n * Din + Mi * Mi + Mi * Din + 1 + Mi * D + D * Mi * Mi
                    + 2 * n * D)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_kernel(kind, D, Din, n, gpu):
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, M, Din, n, 11, "cuda")
    with torch.no_grad():
        ms = event_ms(lambda: cfr.fused_conditional_white_stationary(kind, *args), 10)
        plain_ms = event_ms(lambda: cfr.fused_conditional_plain(kind, *args), 5)
    Pinv, Xs, _, _, q_mu, Sq = args
    bound, by = fused_bound_ms(Pinv, Xs, q_mu, Sq)
    log(f"[timing] fused conditional {KINDS[kind]} D={D} M={M} Din={Din} n={n}: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
        f"({by}), {bound / ms:.1%} of the bound ({gpu})")
    return ms, plain_ms, bound, by


def profile_request(model, gpu):
    """Device time by kernel over one warm request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    Xr = np.random.default_rng(2).uniform(0, 1, size=(N_REQUEST, DIN))
    timed(lambda: model.predict_y(Xr, S))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: model.predict_y(Xr, S))
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    if not kernels:
        log("[profile] the profiler saw no device time: not measured")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] one request under the profiler: wall {1e3 * wall:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / (1e3 * wall):.1%}) ({gpu})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:100]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(gpu)
    build()

    err = 0.0
    for kind in KINDS:
        for seed, (D, Mi, Din, n) in enumerate([
                (HIDDEN, M, DIN, 262_144 + 37),   # layer 1 of the model
                (1, M, HIDDEN, 262_144 + 37),     # layer 2
                (3, 64, 5, 10_007)]):             # small odd shape
            err = max(err, check_kernel(kind, D, Mi, Din, n, 10 * kind + seed))

    model = serving_model()
    launches = serve(model, gpu)
    log(f"[serving] fused conditional launches on the main path: {launches}")
    compare_paths(model)

    ms, plain_ms, bound, by = time_kernel(0, HIDDEN, DIN, S * N_REQUEST, gpu)
    time_kernel(0, 1, HIDDEN, S * N_REQUEST, gpu)  # layer 2's shape
    profile_request(model, gpu)

    kernels = [{
        "name": "conditional_fused_rbf",
        "route": "cuda",
        "source": "dgp_tpu_torch/csrc/conditional_fused_rbf.cu",
        "replaces": "dgp_tpu/ops/conditional_fused_rbf.py:131",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
