"""Training engines: masked Adam and Adam+NaturalGradient loops (counterpart
of ``dgp_tpu/models/training.py``).

Phase freezing is a boolean mask over the model's named tensors, with the
JAX package's path rules; Adam is built over the mask-True parameters only,
so a frozen parameter gets no update by construction. The JAX package runs
each phase as one compiled ``lax.scan`` and caches the compiled engines;
PyTorch runs eagerly and compiles nothing, so the phases here are plain
Python loops and there is no engine cache. The loss trace stays on the
device and is read back once per phase (a read per step would be a device
sync per step).

A loss is ``loss_fn(params, generator)`` or, with ``data`` given,
``loss_fn(params, generator, data)``; ``params`` is the model's
``nn.Module`` and is updated in place. A sharded loss
(``parallel.data_parallel``) carries ``reduce_grads``: every gradient the
loops take of it goes through that all-reduce before it is used, so every
rank steps with the same bits.

:func:`multistart_adam` is the counterpart of ``multistart_adam_engine``,
the exact multi-fidelity models' multi-start training: the JAX package
vmaps one Adam run over a leading starts axis of the parameter pytree; here
the parameters carry that axis themselves (:func:`stack_starts`), and every
step advances all starts in one batched loss and one Adam step.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import ieee_fp32
from ..variational.natgrad import natgrad_step_multi


# -- trainability masks -----------------------------------------------------------

def named_tensors(params):
    """(name, tensor) over the model's parameters, then its buffers (frozen
    mean-function weights are buffers): the leaves a mask speaks about."""
    yield from params.named_parameters()
    yield from params.named_buffers()


def _path_names(name):
    return [p for p in name.split(".") if not p.isdigit()]


def _path_layer_index(name):
    """Index into a ``layers``/``layers_red`` list if the path crosses one."""
    parts = name.split(".")
    for part, nxt in zip(parts[:-1], parts[1:]):
        if part in ("layers", "layers_red") and nxt.isdigit():
            return part, int(nxt)
    return None, None


def mask_from_predicate(params, predicate: Callable) -> dict:
    """Boolean mask {tensor name: bool}:
    predicate(field_names, (group, layer_idx)) -> bool.

    ``field_names`` is the list of attribute names along the tensor's path;
    ``group``/``layer_idx`` identify which layer list (if any) it sits in.
    """
    return {name: bool(predicate(_path_names(name), _path_layer_index(name)))
            for name, _ in named_tensors(params)}


def default_frozen_fields() -> set:
    """Fields that are never trained (the reference always freezes
    mean-function weights)."""
    return {"mean_function"}


def make_mask(params, frozen_fields: Sequence[str] = (),
              frozen_layer_fields=None) -> dict:
    """Build a mask from the names of the frozen fields.

    :param frozen_fields: a tensor is frozen if any path name is in this set.
    :param frozen_layer_fields: optional dict {(group, layer_idx): set(fields)}
        or {layer_idx: set(fields)} applying within a specific layer; use the
        key "all" for every layer of a group.
    """
    frozen = set(frozen_fields) | default_frozen_fields()
    frozen_layer_fields = frozen_layer_fields or {}

    def predicate(names, group_idx):
        if any(n in frozen for n in names):
            return False
        group, idx = group_idx
        if idx is not None:
            for key, fields in frozen_layer_fields.items():
                if key in (idx, (group, idx), "all", (group, "all")):
                    if any(n in fields for n in names):
                        return False
        return True

    return mask_from_predicate(params, predicate)


# -- optimizers -------------------------------------------------------------------

def trainable_parameters(params, mask) -> list:
    return [p for name, p in params.named_parameters() if mask[name]]


def masked_adam(params, mask, lr, b1=0.9, b2=0.999, eps=1e-7):
    """Adam over the mask-True parameters. A mask-False tensor is not in
    the optimizer at all, so it cannot receive an update (in optax a masked
    transform alone passes the frozen leaves' raw gradients through).

    ``torch.optim.Adam`` steps by ``lr * m_hat / (sqrt(v_hat) + eps)``, as
    ``optax.adam`` does (``eps_root = 0``). The default eps 1e-7 is the one
    the JAX package's DGP and GPR loops pass (gpflow's Adam default, which
    the reference's training runs used); ``optax.adam``'s own default,
    1e-8, is the one of the JAX package's multi-start engine, and
    :func:`multistart_adam` takes it."""
    return torch.optim.Adam(trainable_parameters(params, mask), lr=lr,
                            betas=(b1, b2), eps=eps)


def _grad_norm(grads):
    return torch.sqrt(sum(torch.sum(g.detach() ** 2) for g in grads))


def _surface_nonfinite(trace, label):
    """Post-phase NaN/Inf surfacing: one read of the loss trace on the host;
    warns with the first bad step index so a diverged phase is visible even
    when messages=0."""
    loss = trace["loss"] if isinstance(trace, dict) else trace
    arr = loss.detach().cpu().numpy()
    bad = np.flatnonzero(~np.isfinite(arr))
    if bad.size:
        warnings.warn(
            f"{label}: non-finite loss at step {int(bad[0])} "
            f"({bad.size}/{arr.size} steps non-finite)",
            RuntimeWarning,
            stacklevel=3,
        )
    return trace


def make_checkpoint_fn(path: str):
    """Host callback for adam_run/nat_adam_run's ``checkpoint_fn``: saves the
    current parameters atomically to ``path`` (utils.checkpoint.save);
    restore with utils.checkpoint.load(path, like=model.params)."""
    from ..utils import checkpoint as _ckpt

    def fn(params, steps_done):
        _ckpt.save(path, params)

    return fn


def checkpoint_fn_of(model, path):
    """A wrapper's checkpoint callback: :func:`make_checkpoint_fn`, or None
    without a path, and on a mesh on every rank but its first (the ranks
    hold the same parameters; one file has one writer)."""
    if not path:
        return None
    if model.mesh is not None:
        from ..parallel.data_parallel import is_first_rank

        if not is_first_rank(model.mesh):
            return None
    return make_checkpoint_fn(path)


def on_mesh(model, mesh):
    """Put a wrapper on ``mesh`` (a ``DeviceMesh``, or None for one
    device): every rank takes the mesh's first rank's parameters
    (``parallel.mesh.replicate``) and draws from its own generator, seeded
    from ``model.seed`` and its mesh coordinates
    (``parallel.data_parallel.rank_generator``). Returns the mesh."""
    if mesh is not None:
        from ..parallel.data_parallel import mesh_row_axes, rank_generator
        from ..parallel.mesh import replicate

        mesh_row_axes(mesh)
        replicate(mesh, model.params)
        model.generator = rank_generator(mesh, model.seed, model.device)
    return mesh


def bucket_rows(n: int, bucket: int) -> int:
    """Round n up to the next multiple of ``bucket``."""
    return -(-n // bucket) * bucket


def pad_to_bucket(X, Y, bucket: int):
    """Pad (X [N,d], Y [N,p]) to the next row bucket; returns (Xp, Yp, w)
    with w a 0/1 row-weight vector. Pad X rows repeat row 0 (finite kernel
    inputs), pad Y rows are zero. (The JAX package buckets N to keep its
    compiled shapes stable; here it keeps allocation sizes stable while a
    BO loop grows N.)"""
    n = X.shape[0]
    n_pad = bucket_rows(n, bucket)
    w = torch.zeros((n_pad,), dtype=X.dtype, device=X.device)
    w[:n] = 1.0
    if n_pad == n:
        return X, Y, w
    pad = n_pad - n
    Xp = torch.cat([X, X[:1].expand(pad, -1)], dim=0)
    Yp = torch.cat([Y, torch.zeros((pad, Y.shape[1]), dtype=Y.dtype,
                                   device=Y.device)], dim=0)
    return Xp, Yp, w


# -- multi-start Adam on an exact NLL --------------------------------------------

def _set_parameter(module, name, value):
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf,
            torch.nn.Parameter(value))


def stack_starts(modules):
    """One module whose every parameter stacks, over a new leading axis,
    that parameter of each of ``modules`` (alike but for their values): the
    counterpart of ``jax.tree.map(jnp.stack, *pytrees)``."""
    stacked = copy.deepcopy(modules[0])
    values = [dict(m.named_parameters()) for m in modules]
    for name, _ in list(stacked.named_parameters()):
        _set_parameter(stacked, name,
                       torch.stack([v[name].detach() for v in values]))
    return stacked


def select_start(stacked, i):
    """A copy of ``stacked`` (:func:`stack_starts`) holding start i's
    parameters."""
    out = copy.deepcopy(stacked)
    for name, p in list(out.named_parameters()):
        _set_parameter(out, name, p.detach()[i].clone())
    return out


def multistart_adam(loss_fn, stacked, batch, iterations: int, lr: float):
    """Multi-start Adam on an exact NLL: ``loss_fn(stacked, *batch)`` gives
    one loss per start, [n_starts], for parameters stacked over a leading
    axis (:func:`stack_starts`), so each step evaluates every start at once
    (their Grams factored by one launch of #7). One ``torch.optim.Adam``
    steps on the sum: Adam is elementwise and start i's loss reaches only
    start i's slice, so each start takes exactly its own Adam step, with
    optax's constants (eps 1e-8, eps_root 0), as the JAX package's vmapped
    runs do. A start whose Gram is not positive definite goes NaN and stays
    so, as in the JAX package, and touches no other start.

    :return: (the winning start's parameters as an unstacked copy, its
        final loss, its losses [iterations]). The winner is the first
        argmin of the final losses, non-finite ones counted as +inf; the
        loss trace stays on the device until then (one read at the end).
    """
    params = list(stacked.parameters())
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    trace = []
    with torch.enable_grad(), ieee_fp32():
        for _ in range(iterations):
            losses = loss_fn(stacked, *batch)
            grads = torch.autograd.grad(torch.sum(losses), params)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            trace.append(losses.detach())
    for p in params:
        p.grad = None
    with torch.no_grad(), ieee_fp32():
        finals = loss_fn(stacked, *batch)
    finals = torch.where(torch.isfinite(finals), finals, torch.inf)
    i = int(torch.argmin(finals))
    trace = (torch.stack(trace) if trace
             else finals.new_zeros((0, finals.shape[0])))
    return select_start(stacked, i), finals[i], trace[:, i]


def _empty_trace(params):
    ref = next(params.parameters())
    return torch.zeros((0,), dtype=ref.dtype, device=ref.device)


def _evaluator(loss_fn, data):
    if data is None:
        return loss_fn
    return lambda params, generator: loss_fn(params, generator, data)


def _report(messages, label, i, loss):
    if messages and i % messages == 0:
        print(f"{label}: {-float(loss.detach())}")


def _checkpoint(checkpoint_fn, every, params, done, steps):
    """Run the host callback after every ``every`` steps, except after the
    phase's last step (the caller has the final parameters anyway)."""
    if (checkpoint_fn is not None and every > 0 and done % every == 0
            and done < steps):
        checkpoint_fn(params, done)


def _adam_step(opt, train, loss, inputs=None, reduce_grads=None):
    """One optimizer step on ``train`` from ``loss``. Gradients are taken
    for ``inputs`` (a superset of ``train``; by default ``train`` itself),
    reduced over the ranks where ``reduce_grads`` is given, and
    returned."""
    inputs = train if inputs is None else inputs
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    if reduce_grads is not None:
        grads = reduce_grads(grads)
    grads = dict(zip(map(id, inputs), grads))
    for p in train:
        p.grad = grads[id(p)]
    opt.step()
    return [g for g in grads.values() if g is not None]


def adam_run(
    loss_fn,
    params,
    mask,
    generator,
    steps: int,
    lr=0.01,
    b1=0.9,
    b2=0.999,
    eps=1e-7,
    messages: int = 0,
    label: str = "ELBO",
    metrics_fn=None,
    data=None,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
):
    """Run ``steps`` Adam iterations on ``params`` (in place).

    Returns (params, losses [steps]) — or (params, metrics-dict) when
    ``metrics_fn(params) -> dict`` is given; the dict then carries per-step
    tensors for 'loss', 'grad_norm' (over every parameter, frozen ones
    included, as in the JAX package; buffers have no gradient) and every
    metrics_fn entry.

    :param generator: ``torch.Generator`` handed to the loss for its draws
        (the JAX package's PRNG key).
    :param data: optional batch; when given the loss is
        ``loss_fn(params, generator, data)``.
    :param checkpoint_every: after every this many steps (but not after the
        last) ``checkpoint_fn(params, steps_done)`` runs on the host. The
        optimizer state lives across the whole phase, so the trajectory is
        the unchunked one. 0 = never.
    """
    if steps <= 0:
        empty = _empty_trace(params)
        return params, ({"loss": empty} if metrics_fn else empty)

    evaluate = _evaluator(loss_fn, data)
    reduce = getattr(loss_fn, "reduce_grads", None)
    train = trainable_parameters(params, mask)
    everything = list(params.parameters()) if metrics_fn else None
    opt = masked_adam(params, mask, lr, b1, b2, eps)
    trace = []
    with torch.enable_grad(), ieee_fp32():
        for i in range(steps):
            loss = evaluate(params, generator)
            grads = _adam_step(opt, train, loss, everything, reduce)
            _report(messages, label, i, loss)
            if metrics_fn is None:
                trace.append(loss.detach())
            else:
                out = {"loss": loss.detach(), "grad_norm": _grad_norm(grads)}
                with torch.no_grad():
                    out.update(metrics_fn(params))
                trace.append(out)
            _checkpoint(checkpoint_fn, checkpoint_every, params, i + 1, steps)
    for p in train:
        p.grad = None
    if metrics_fn is None:
        trace = torch.stack(trace)
    else:
        trace = {k: torch.stack([torch.as_tensor(t[k]) for t in trace])
                 for k in trace[0]}
    return params, _surface_nonfinite(trace, label)


def nat_adam_run(
    loss_fn,
    params,
    euclid_mask,
    get_qs,
    set_qs,
    generator,
    steps: int,
    lr_adam=0.01,
    gamma=0.01,
    b1=0.9,
    b2=0.999,
    eps=1e-7,
    messages: int = 0,
    label: str = "ELBO",
    data=None,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
    guard_loss: bool = False,
):
    """Interleaved Adam + NaturalGradient phase on ``params`` (in place).

    Per iteration: (1) masked-Adam step on the Euclidean parameters from one
    ELBO evaluation; (2) joint natural-gradient step on the variational
    pairs selected by ``get_qs`` from a second evaluation with fresh normals
    — the reference's two evaluations per iteration.

    :param get_qs: params -> list of (q_mu, q_sqrt) parameters receiving
        natural gradients.
    :param set_qs: (params, list of (q_mu, q_sqrt) tensors) -> writes them.
    :param guard_loss: same-normals loss guard on each natural-gradient step
        (variational.natgrad.natgrad_step_multi): the generator is put back
        to where the step's first evaluation found it before each
        re-evaluation, so all of them see the same unit normals.
    :return: (params, losses [steps]); the loss is the Adam evaluation's.
    """
    if steps <= 0:
        return params, _empty_trace(params)

    evaluate = _evaluator(loss_fn, data)
    reduce = getattr(loss_fn, "reduce_grads", None)
    train = trainable_parameters(params, euclid_mask)
    opt = masked_adam(params, euclid_mask, lr_adam, b1, b2, eps)
    names = {id(p): name for name, p in params.named_parameters()}
    q_names = [(names[id(m)], names[id(L)]) for m, L in get_qs(params)]
    trace = []
    with torch.enable_grad(), ieee_fp32():
        for i in range(steps):
            loss = evaluate(params, generator)
            _adam_step(opt, train, loss, reduce_grads=reduce)

            state = (generator.get_state()
                     if guard_loss and generator is not None else None)

            def nat_loss(qs):
                if state is not None:
                    generator.set_state(state)
                overrides = {}
                for (n_mu, n_sqrt), (m, L) in zip(q_names, qs):
                    overrides[n_mu], overrides[n_sqrt] = m, L
                # params.forward(fn, *args) is fn(params, *args): the loss
                # with the candidate q tensors in the parameters' places
                return torch.func.functional_call(
                    params, overrides, (evaluate, generator))

            new_qs = natgrad_step_multi(get_qs(params), nat_loss, gamma,
                                        guard_loss=guard_loss,
                                        reduce_grads=reduce)
            set_qs(params, new_qs)
            _report(messages, label, i, loss)
            trace.append(loss.detach())
            _checkpoint(checkpoint_fn, checkpoint_every, params, i + 1, steps)
    for p in train:
        p.grad = None
    return params, _surface_nonfinite(torch.stack(trace), label)
