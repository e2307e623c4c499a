"""The model's own work for ``mfu``: one training step or one request of a
deep GP whose layers are SVGP layers with RBF kernels (the configuration's
``layers``), counted as the least work the inputs need (``counts``'s
rules), whatever implements it.

Layer 1's conditional and its gradient count at the distinct input rows:
``propagate`` hands layer 1 the same rows S times, and those copies need no
work of their own. Its samples, and every later layer, count at S times the
rows. A training step counts the forward pass, the ELBO, its gradient with
respect to every trained tensor (without recomputation) and the Adam
update.
"""

from __future__ import annotations

from . import F32, Work, k8, tri


def _conditional(n, M, Din, D, white):
    """Forward of one layer's marginal conditional at n points."""
    t = tri(M)
    a = 2 * t if white else 2 * M * M      # Lu^{-1} kuf, or Kuu^{-1} kuf
    products = n * (2 * M * Din + a + 2 * D * t + 2 * M * D)
    other = n * (2 * Din + 7 * M + 2 * M * D + 2 * D)
    return Work(products, other)


def _conditional_grad(n, M, Din, D, white, wants_dx):
    """Backward of :func:`_conditional` at n points, given its forward's
    intermediates: through t2 (dA and dSq), the mean (dA and dq_mu), A's
    projection (dkuf and the projector's or Kuu's cotangent) and the cross
    term (dZ, and dX where the layer's input needs a gradient)."""
    t = tri(M)
    proj = 4 * t if white else 2 * M * M + 2 * t
    products = n * (4 * D * t + 4 * M * D + proj
                    + 2 * M * Din * (2 if wants_dx else 1))
    other = n * (2 * M * D + 8 * M + (2 * Din if wants_dx else 0))
    return Work(products, other)


def _layer_fixed(M, Din, grad):
    """Per layer and per evaluation: Kuu and its factor (#8's work), and
    with ``grad`` their backward, counted as one more factorization."""
    t = tri(M)
    w = Work(2 * t * Din, 5 * t) + k8.work(1, M)._replace(bytes=0.0)
    return w.scaled(2) if grad else w


def shapes(config):
    """[(Din, D)] of each layer, from the configuration."""
    dims = [config["input_dim"], *config["hidden_dims"], config["output_dim"]]
    return list(zip(dims[:-1], dims[1:]))


def _forward(config, n):
    """Work of the layers' moments at n input rows, and the samples
    passed between layers."""
    M, S, white = config["num_inducing"], config["num_samples"], config["white"]
    work = Work()
    for i, (Din, D) in enumerate(shapes(config)):
        rows = n if i == 0 else S * n
        work += _conditional(rows, M, Din, D, white) + _layer_fixed(M, Din, False)
        if i == 0 and config["mean_functions"][0] == "identity":
            work += Work(0, n * D)
        if i + 1 < len(shapes(config)):
            work += Work(0, 4 * S * n * D)   # mean + z sqrt(var + jitter)
    return work


def request(config, R):
    """One request of R rows: the moments of every layer, the likelihood's
    predictive and the moment matching over the S samples. Bytes: the rows
    read, the moment-matched mean and variance written."""
    S = config["num_samples"]
    Din, Dout = config["input_dim"], config["output_dim"]
    work = _forward(config, R)
    work += Work(0, S * R * Dout + 5 * S * R * Dout + 2 * R * Dout)
    return work + Work(0, 0, F32 * (R * Din + 2 * R * Dout))


def num_parameters(config):
    """Trained scalars: per layer the variance, the lengthscales, Z, q_mu
    and q_sqrt; the likelihood's variance."""
    M = config["num_inducing"]
    total = 1
    for Din, D in shapes(config):
        total += 1 + Din + M * Din + M * D + D * M * M
    return total


def train_step(config, N):
    """One full-batch Adam step on N rows: the forward pass, the Gaussian
    expected log-likelihood, each layer's KL, the gradient of all of it and
    the update of every trained scalar. Bytes: X and Y read, the
    parameters read and written."""
    M, S, white = config["num_inducing"], config["num_samples"], config["white"]
    Din0, Dout = config["input_dim"], config["output_dim"]
    work = _forward(config, N)
    work += Work(0, 8 * S * N * Dout)                    # E log p(y | f), mean over S
    for i, (Din, D) in enumerate(shapes(config)):
        rows = N if i == 0 else S * N
        work += _conditional_grad(rows, M, Din, D, white, wants_dx=i > 0)
        work += _layer_fixed(M, Din, True)
        if i > 0:
            work += Work(0, 6 * S * N * Din)             # back through the samples
        if i == 0:
            work += Work(0, S * N * D)                   # sum the S copies' cotangents
        t = tri(M)
        kl = Work(0, 4 * D * t + 4 * M * D) if white else Work(
            2 * D * M ** 3 / 3 + 4 * M * M * D, 4 * D * t)
        work += kl.scaled(2)                              # the KL and its gradient
    P = num_parameters(config)
    work += Work(0, 12 * P)                               # Adam
    return work + Work(0, 0, F32 * (N * (Din0 + Dout) + 2 * P))
