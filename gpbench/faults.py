"""Faults planted in the program under a run, to show that the check
catches them (``calibrate.py --fault``, ``tests/test_gpbench_faults.py``):

* ``frozen_step``: every optimizer step leaves the parameters as they were;
* ``half_batch``: the ELBO's data term sums half of the rows and scales the
  sum to the whole count (the mean taken over the rest);
* ``altered_answer``: the moment-matched mean of a request's first row is
  moved by half its predictive standard deviation where it is produced.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def frozen_step():
    step = torch.optim.Adam.step

    def frozen(self, *args, **kwargs):
        kept = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups for p in g["params"]), kept):
                p.copy_(k)
        return out

    torch.optim.Adam.step = frozen
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def half_batch():
    from dgp_tpu_torch.models import dgp

    term = dgp.weighted_data_term

    def half(var_exp, w):
        n = var_exp.shape[1]
        total, _ = term(var_exp[:, : n // 2], None)
        return total * n / (n // 2), n

    dgp.weighted_data_term = half
    try:
        yield
    finally:
        dgp.weighted_data_term = term


@contextlib.contextmanager
def altered_answer():
    from dgp_tpu_torch.models import dgp

    matched = dgp.moment_matched

    def altered(y_means, y_vars):
        mean, var = matched(y_means, y_vars)
        mean = mean.clone()
        mean[0] += 0.5 * var[0].sqrt()
        return mean, var

    dgp.moment_matched = altered
    try:
        yield
    finally:
        dgp.moment_matched = matched


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch,
          "altered_answer": altered_answer}
