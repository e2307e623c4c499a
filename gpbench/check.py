"""The comparison that decides ``correct``: the numbers a run compares
with the plain reference, and their limits (``limits/<cell>.json``).

Training: set-up drives the model through its first steps by the window's
own call; the reference follows the first ``check_steps`` from the same
values and unit normals in float64. Compared: the first step's loss, the
worst of the later steps' losses, the first gradient as Adam got it (its
first moment after one step over 1 - beta1), and the parameters' change
after the last followed step, each leaf's norm against the reference's,
relative to that norm or to the median leaf's, whichever is larger. Leaves whose reference gradient is under a thousandth
of the median leaf's (the variance of a layer that the ELBO hardly sees)
move by round-off alone and are left out of the change.

Serving: a sample of the window's requests, drawn from the seed with the
longest of them in it; the reference computes each request's
moment-matched mean and variance in float64 from its rows and normals.
Compared: the widest gap of the mean in units of the reference's predictive
standard deviation, and the widest relative gap of the variance.
"""

from __future__ import annotations

import math
import statistics

import torch


def worst(values):
    """The largest of ``values``; NaN where any is NaN (Python's max
    would drop it) or where there is none."""
    values = list(values)
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _leaf_gaps(got, want, keys):
    """Per leaf: the gap of the norms over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}


def train_gaps(program, reference, start):
    """Each step's relative loss gap, and per leaf the gap of the first
    gradient's norm and of the change's norm (the change over the leaves
    that the rule keeps). ``program`` and ``reference`` are (losses, first
    gradients, values after the followed steps); ``start`` the values both
    started from."""
    losses, grads, after = program
    r_losses, r_grads, r_after = reference
    g, rg = _norms(grads), _norms(r_grads)
    med = statistics.median(rg.values())
    moved = [k for k in rg if rg[k] >= 1e-3 * med]
    d = _norms({k: after[k].double() - start[k].double() for k in moved})
    rd = _norms({k: r_after[k].double() - start[k].double() for k in moved})
    return {"loss": [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)],
            "grad": _leaf_gaps(g, rg, list(rg)),
            "step": _leaf_gaps(d, rd, moved)}


def train_numbers(program, reference, start):
    """The first step's relative loss gap, the worst of the later steps'
    (a gradient element at round-off gets a whole Adam step of either sign
    at step 1, so the later losses swing from seed to seed), and the worst
    leaf's gradient and change gaps."""
    gaps = train_gaps(program, reference, start)
    return {"first_loss_gap": worst(gaps["loss"][:1]),
            "later_loss_gap": worst(gaps["loss"][1:]),
            "grad_gap": worst(gaps["grad"].values()),
            "step_gap": worst(gaps["step"].values())}


def serve_numbers(pairs):
    """``pairs``: (program [R, 2D], reference (mean [R, D], var [R, D]))
    per compared request."""
    mean_gaps, var_gaps = [], []
    for got, (mean, var) in pairs:
        D = mean.shape[1]
        got = got.double()
        mean, var = mean.double().cpu(), var.double().cpu()
        mean_gaps.append(float(((got[:, :D] - mean).abs() / var.sqrt()).max()))
        var_gaps.append(float(((got[:, D:] - var).abs() / var).max()))
    return {"mean_gap": worst(mean_gaps), "var_gap": worst(var_gaps)}


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number finite and
    within its limit."""
    shown = {k: {"value": v if math.isfinite(v) else repr(v),
                 "limit": limits[k]["limit"]}
             for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k]["limit"]
             for k, v in numbers.items())
    return ok, shown
