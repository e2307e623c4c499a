"""The quickstart's multi-objective section (``examples/quickstart.py``'s
``multi_objective``: the MO-DGP on ``multi_obj_1D_4`` at 10 LHS rows,
optimize_nat_adam(steps, 0, 0) with restarts="auto", then EHVI at x = 0
and 0.5 with S = 500) in float64 on the CPU, at each seed, three ways:

- dgp_tpu, with every ``jax.random.normal`` draw recorded in order (an
  ordered ``jax.debug.callback`` on each draw, so the jitted engines run
  as they do in the example);
- the port on those draws: ``torch.randn`` returns the reference's next
  draw, its shape checked, from the constructor to the EHVI;
- the port on its own stream (``examples_torch/quickstart.py``'s run).

Prints, per seed, each run's restart scores (worst train r2 per
candidate), kept candidate and EHVI, and the port's largest relative
error against dgp_tpu on the same draws; exits 1 if on the same draws
the port keeps another candidate or its EHVI differs by more than 1e-6
of scale.

    python tests/replay_quickstart_mo.py [--seeds 0,1,2,3,4] [--steps 100]

Not a test module (pytest collects ``test_*.py``): a seed takes about
a minute and a half on 4 CPU threads, the first also XLA's compiles.
"""

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgp_tpu.bo import ehvi as jehvi  # noqa: E402
from dgp_tpu.bo.doe import lhs  # noqa: E402
from dgp_tpu.bo.problems import multi_obj_1D_4  # noqa: E402
from dgp_tpu.models.mo_dgp import MultiObjDeepGP as JMO  # noqa: E402
from dgp_tpu_torch.bo import ehvi as tehvi  # noqa: E402
from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP as TMO  # noqa: E402
from examples_torch import quickstart  # noqa: E402

XCAND = np.array([[0.0], [0.5]])
DRAWS = []  # the reference's draws, appended by the compiled callbacks


def data():
    """The example's normalized inputs and objectives and its front (as
    examples/quickstart.py computes them), held equal to the port's."""
    problem = multi_obj_1D_4()
    X_ = lhs(1, 10, seed=0)
    F = [np.concatenate([problem.fun(x)[i] for x in X_]).reshape(-1, 1)
         for i in (0, 1)]
    Xn = (X_ - X_.mean(0)) / X_.std(0)
    Yn = [(f - f.mean(0)) / f.std(0) for f in F]
    Xt, Yt, Ft = quickstart.mo_data()
    assert np.array_equal(Xn, Xt) and all(
        np.array_equal(a, b) for a, b in zip(Yn + F, Yt + Ft))
    return Xn, Yn, F


@contextlib.contextmanager
def candidates(cls, convert):
    """Record each restart's score and losses while the scope lasts."""
    out = {"scores": [], "losses": []}
    score, run = cls._restart_score, cls._nat_adam_guarded

    def scoring(self, *args):
        out["scores"].append(score(self, *args))
        return out["scores"][-1]

    def running(self, *args):
        losses = run(self, *args)
        out["losses"].append(convert(losses))
        return losses

    cls._restart_score, cls._nat_adam_guarded = scoring, running
    try:
        yield out
    finally:
        cls._restart_score, cls._nat_adam_guarded = score, run


@contextlib.contextmanager
def recorded_normals():
    normal = jax.random.normal

    def recording(key, shape=(), dtype=float):
        z = normal(key, shape, dtype)
        jax.debug.callback(lambda v: DRAWS.append(np.array(v)), z,
                           ordered=True)
        return z

    jax.random.normal = recording
    try:
        yield
    finally:
        jax.random.normal = normal


@contextlib.contextmanager
def replayed(draws):
    """torch.randn returns ``draws`` in order; counts them in the yielded
    one-element list."""
    real, used = torch.randn, [0]

    def randn(*args, generator=None, dtype=None, device=None, **kwargs):
        shape = (tuple(args[0]) if len(args) == 1
                 and not isinstance(args[0], int) else tuple(args))
        z = draws[used[0]]
        if tuple(z.shape) != shape:
            raise AssertionError(f"draw {used[0]}: the reference drew "
                                 f"{z.shape}, the port asks {shape}")
        used[0] += 1
        return torch.as_tensor(z, dtype=dtype, device=device)

    torch.randn = randn
    try:
        yield used
    finally:
        torch.randn = real


def reference(seed, steps, Xn, Yn, F):
    ynd = jehvi.Y_ND(Yn, jehvi.NDC(F, -np.ones((10, 1)),
                                   obj1_ascending=False),
                     nadir=(4.0, 4.0), ideal=(-4.0, -4.0))
    DRAWS.clear()
    with candidates(JMO, np.asarray) as out, recorded_normals():
        model = JMO([Xn, Xn.copy()], Yn, loop=2, num_samples=5, seed=seed)
        model.optimize_nat_adam(iterations1=steps, iterations2=0,
                                iterations3=0, messages=0)
        out["ehvi"] = np.asarray(jehvi.EHVI(model, XCAND, ynd, corr=False,
                                            S=500)).ravel()
        jax.effects_barrier()
    out["draws"] = list(DRAWS)
    return out


def port(seed, steps, Xn, Yn, F, draws=None):
    ynd = tehvi.Y_ND(Yn, tehvi.NDC(F, -np.ones((10, 1)),
                                   obj1_ascending=False),
                     nadir=(4.0, 4.0), ideal=(-4.0, -4.0))
    scope = replayed(draws) if draws is not None else contextlib.nullcontext()
    with candidates(TMO, lambda t: t.numpy()) as out, scope as used:
        model = TMO([Xn, Xn.copy()], Yn, loop=2, num_samples=5, seed=seed,
                    device="cpu", dtype=torch.float64)
        model.optimize_nat_adam(iterations1=steps, iterations2=0,
                                iterations3=0, messages=0)
        out["ehvi"] = tehvi.EHVI(model, XCAND, ynd, corr=False,
                                 S=500).numpy().ravel()
    if draws is not None and used[0] != len(draws):
        raise AssertionError(f"the port took {used[0]} of the reference's "
                             f"{len(draws)} draws")
    return out


def kept(scores):
    return int(np.argmax([s if np.isfinite(s) else -np.inf for s in scores]))


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def line(name, out):
    return (f"  {name}: scores {np.round(out['scores'], 4).tolist()}, kept "
            f"{kept(out['scores'])}, EHVI {np.round(out['ehvi'], 6).tolist()}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", default="0,1,2,3,4")
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args()
    torch.set_num_threads(4)
    Xn, Yn, F = data()
    ok = True
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        ref = reference(seed, args.steps, Xn, Yn, F)
        same = port(seed, args.steps, Xn, Yn, F, ref["draws"])
        own = port(seed, args.steps, Xn, Yn, F)
        loss_err = max(rel(a, b) for a, b in zip(same["losses"],
                                                  ref["losses"]))
        agree = (kept(same["scores"]) == kept(ref["scores"])
                 and rel(same["ehvi"], ref["ehvi"]) <= 1e-6)
        ok &= agree
        print(f"seed {seed}, {args.steps} steps, {len(ref['draws'])} draws "
              f"({time.perf_counter() - t0:.1f} s):")
        print(line("dgp_tpu", ref))
        print(line("port on dgp_tpu's draws", same)
              + f"; largest rel err: scores "
              f"{max(abs(a - b) / abs(b) for a, b in zip(same['scores'], ref['scores'])):.3g}, "
              f"losses {loss_err:.3g}, EHVI "
              f"{rel(same['ehvi'], ref['ehvi']):.3g}"
              + ("" if agree else "  DISAGREES"))
        print(line("port on its own stream", own), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
