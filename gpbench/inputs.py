"""The inputs of a run, made from ``--seed`` on the device: the data, the
parameter values that the program and the reference both start from, the
requests and their unit normals. Each stream has its own seed, derived from
the run's seed and the stream's name, so any whole seed (a large one too)
gives the same inputs every time.
"""

from __future__ import annotations

import hashlib

import torch

from .counts.dgp import shapes


def derive(seed, *names) -> int:
    """A 60-bit seed for the stream ``names`` of run ``seed``."""
    text = "/".join([str(int(seed)), *names]).encode()
    return int(hashlib.sha256(text).hexdigest()[:15], 16)


def generator(device, seed, *names):
    return torch.Generator(device=device).manual_seed(derive(seed, *names))


def inv_softplus(y):
    return y + torch.log(-torch.expm1(-y))


def dtype_of(config):
    return getattr(torch, config["dtype"])


def model_values(config, seed, device):
    """(X [N, Din], Y [N, 1], values): bench.py's data (X uniform on the
    unit cube, Y = sin(3 x0) + 0.5 cos(5 x1) + 0.05 N(0, 1), Z = M
    distinct rows of X shared by every layer) and every trained tensor by
    name, with q moved off the prior: q_mu ~ N(0, 1); q_sqrt = tril(I +
    0.05 N(0, 1)) whitened, chol(Kuu + jitter I) with each entry moved by 5 %
    otherwise (at the prior, mean = 0 and var = k(x, x) hide errors)."""
    g = generator(device, seed, "model")
    dtype = dtype_of(config)
    N, M = config["num_data"], config["num_inducing"]
    Din, init = config["input_dim"], config["init"]
    f = dict(dtype=dtype, device=device)
    X = torch.rand((N, Din), generator=g, **f)
    noise = torch.randn((N, 1), generator=g, **f)
    Y = torch.sin(3 * X[:, :1]) + 0.5 * torch.cos(5 * X[:, 1:2]) + 0.05 * noise
    Z = X[torch.randperm(N, generator=g, device=device)[:M]]
    layers = shapes(config)
    q_mu = torch.randn((sum(D for _, D in layers) * M,), generator=g, **f)
    q_noise = torch.randn((sum(D for _, D in layers) * M * M,), generator=g, **f)
    values, at_mu, at_sq = {}, 0, 0
    for i, (d_in, D) in enumerate(layers):
        pre = f"layers.{i}."
        variance = torch.tensor(init["kernel_variance"], **f)
        ls = torch.full((d_in,), init["lengthscale"], **f)
        values[pre + "kernel.variance_raw"] = inv_softplus(variance)
        values[pre + "kernel.lengthscales_raw"] = inv_softplus(ls)
        values[pre + "z"] = Z.clone()
        values[pre + "q_mu"] = init["q_mu_std"] * q_mu[at_mu:at_mu + M * D].view(M, D)
        noise = q_noise[at_sq:at_sq + D * M * M].view(D, M, M)
        at_mu, at_sq = at_mu + M * D, at_sq + D * M * M
        eye = torch.eye(M, **f)
        if config["white"]:
            q_sqrt = torch.tril(eye + init["q_sqrt_noise"] * noise)
        else:
            Zs = (Z / ls).double()
            sq = ((Zs * Zs).sum(1)[:, None] + (Zs * Zs).sum(1)[None, :]
                  - 2 * Zs @ Zs.T).clamp_min(0)
            Kuu = float(variance) * torch.exp(-0.5 * sq)
            Kuu += config["jitter"] * torch.eye(M, dtype=Kuu.dtype, device=device)
            q_sqrt = torch.linalg.cholesky(Kuu).to(dtype)[None] * (
                1.0 + init["q_sqrt_noise"] * noise)
        values[pre + "q_sqrt"] = q_sqrt.contiguous()
    values["likelihood.variance_raw"] = inv_softplus(
        torch.tensor(init["likelihood_variance"], **f))
    return X, Y, values


def step_normals(config, seed, device, steps):
    """The unit normals of the first ``steps`` training steps, drawn as the
    program's model draws them from its generator (seeded with
    ``model_seed``): per step, per layer, one [S, N, D] draw."""
    g = torch.Generator(device=device).manual_seed(model_seed(seed))
    S, N = config["num_samples"], config["num_data"]
    return [[torch.randn((S, N, D), generator=g, dtype=dtype_of(config),
                         device=device) for _, D in shapes(config)]
            for _ in range(steps)]


def model_seed(seed) -> int:
    """The seed of the model's own generator (its Monte-Carlo draws)."""
    return derive(seed, "draws")


def request_sizes(traffic, seed, count):
    """Rows of the first ``count`` requests: each block of
    ``sizes_per_block`` requests holds the same sizes, the block's quantile
    midpoints of the uniform law on [rows_min, rows_max], in an order drawn
    from the seed (every seed sends the same work)."""
    K, lo, hi = (traffic["sizes_per_block"], traffic["rows_min"],
                 traffic["rows_max"])
    base = [round(lo + (hi - lo) * (i + 0.5) / K) for i in range(K)]
    out = []
    block = 0
    while len(out) < count:
        g = torch.Generator().manual_seed(derive(seed, "sizes", str(block)))
        out += [base[i] for i in torch.randperm(K, generator=g).tolist()]
        block += 1
    return out[:count]


def request_sample(traffic, seed):
    """Indices of the requests a run compares with the reference: the
    longest of the first ``check_span``, and more drawn from the seed among
    them, ``check_requests`` in all."""
    span = request_sizes(traffic, seed, traffic["check_span"])
    longest = max(range(len(span)), key=span.__getitem__)
    g = torch.Generator().manual_seed(derive(seed, "sample"))
    others = [i for i in torch.randperm(len(span), generator=g).tolist()
              if i != longest]
    return {longest, *others[:traffic["check_requests"] - 1]}


def request_width(config):
    """Columns of a request row: the point, then its unit normals of every
    layer for each of the S samples."""
    S = config["num_samples"]
    return config["input_dim"] + S * sum(D for _, D in shapes(config))


def make_request(config, seed, index, rows, device, gen=None):
    """Request ``index``: rows [R, request_width] of the point, uniform on
    the unit cube, and its unit normals."""
    gen = gen or torch.Generator(device=device)
    gen.manual_seed(derive(seed, "request", str(index)))
    Din = config["input_dim"]
    out = torch.empty((rows, request_width(config)), dtype=dtype_of(config),
                      device=device)
    out[:, :Din].uniform_(0.0, 1.0, generator=gen)
    out[:, Din:].normal_(0.0, 1.0, generator=gen)
    return out


def split_request(config, rows):
    """(X [R, Din], normals [[S, R, D] per layer]) of request rows: views,
    no copy."""
    S, Din = config["num_samples"], config["input_dim"]
    R = rows.shape[0]
    zs, at = [], Din
    for _, D in shapes(config):
        zs.append(rows[:, at:at + S * D].view(R, S, D).transpose(0, 1))
        at += S * D
    return rows[:, :Din], zs
