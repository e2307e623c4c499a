"""Differential evolution and Adam refinement of an acquisition, in PyTorch
(counterpart of ``dgp_tpu/bo/de.py``).

DE/rand/1/bin with tfp's defaults (differential weight 0.5, crossover
probability 0.9); the initial population is the seed point plus
Normal(0, stddev) perturbations. Each generation evaluates the whole
population in one batched call of the objective, on the device the tensors
live on. The JAX package compiles each optimizer once and caches the
program; PyTorch runs eagerly and compiles nothing, so these are plain loops
and there is no engine cache. The random draws come from an explicit
``torch.Generator`` (the JAX package's PRNG key); they are not JAX's draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class DEResult(NamedTuple):
    position: torch.Tensor          # [d] best member
    objective: torch.Tensor         # scalar best fitness
    final_population: torch.Tensor
    final_fitness: torch.Tensor


def _bind(fn, fn_args):
    return fn if fn_args is None else (lambda p: fn(p, fn_args))


@torch.no_grad()
def minimize(
    fn: Callable,
    initial_position,
    generator: torch.Generator,
    population_size: int = 300,
    population_stddev: float = 1.5,
    max_iterations: int = 400,
    differential_weight: float = 0.5,
    crossover_prob: float = 0.9,
    fn_args=None,
) -> DEResult:
    """Minimize ``fn`` over R^d.

    :param fn: batched objective [P, d] -> [P] (or [P, 1]); with ``fn_args``
        given it is called as ``fn(p, fn_args)``.
    :param initial_position: [d] seed point; the population lives on its
        device, in its dtype.
    :param generator: ``torch.Generator`` on that device for every draw.
    """
    x0 = torch.as_tensor(initial_position)
    evaluate = _bind(fn, fn_args)
    P, d = population_size, x0.shape[0]
    draw = dict(generator=generator, device=x0.device)
    noise = torch.randn((P, d), dtype=x0.dtype, **draw) * population_stddev
    noise[0] = 0.0
    pop = x0[None] + noise
    fit = evaluate(pop).reshape(P)
    for _ in range(max_iterations):
        # rand/1: three random donors per member (tfp-style sampling; the
        # rare self/duplicate draw only weakens one mutant for one round)
        r = torch.randint(0, P, (3, P), **draw)
        mutant = pop[r[0]] + differential_weight * (pop[r[1]] - pop[r[2]])
        cross = torch.rand((P, d), dtype=x0.dtype, **draw) < crossover_prob
        jrand = torch.randint(0, d, (P,), **draw)
        force = torch.nn.functional.one_hot(jrand, d).bool()
        trial = torch.where(cross | force, mutant, pop)
        tfit = evaluate(trial).reshape(P)
        better = tfit < fit
        pop = torch.where(better[:, None], trial, pop)
        fit = torch.where(better, tfit, fit)
    best = torch.argmin(fit)
    return DEResult(pop[best], fit[best], pop, fit)


def adam_refine(
    fn: Callable,
    v0,
    iterations: int = 1000,
    lr: float = 0.01,
    fn_args=None,
):
    """Adam refinement of a single point in the unconstrained space (the
    reference's post-DE Adam loop), with ``optax.adam``'s defaults
    (b1 0.9, b2 0.999, eps 1e-8), as ``torch.optim.Adam`` has them. Returns
    (v, objective at v): the objective is evaluated again at the final
    position, not taken from the last step before the update."""
    evaluate = _bind(fn, fn_args)

    def scalar(v):
        return evaluate(v[None]).reshape(())

    v = torch.as_tensor(v0).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=lr)
    with torch.enable_grad():
        for _ in range(iterations):
            (v.grad,) = torch.autograd.grad(scalar(v), [v])
            opt.step()
    v = v.detach()
    with torch.no_grad():
        return v, scalar(v)
