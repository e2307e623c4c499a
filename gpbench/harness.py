"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the comparison with the plain reference, and the result.

Set-up makes the data and parameter values on the device from the seed,
builds the port's model with them, and runs the cell's own shapes once:
for training one block of steps, whose first steps the reference follows;
for serving one one-chunk and one two-chunk request of the largest sizes.
``setup_s`` runs from the process's start to the window's opening. Where
an end-to-end metric of the cell is read from the device (its ``source``
is ``device_trace``), the untraced run records the device's operations
over the whole window; the traced run leaves its window unrecorded, so
that its host-clock readings carry no profiler.
"""

from __future__ import annotations

import contextlib
import sys
import time
import types

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from . import check, devicetrace, inputs, loops, system
from .counts import dgp as model_counts
from .reference import dgp as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "dgp_tpu")


def foreign_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def followed(model, steps):
    """Watch the first ``steps`` optimizer steps in the scope: after the
    first, the gradient each leaf got (Adam's first moment over 1 - beta1);
    after the last, the leaves' values."""
    names = {id(p): n for n, p in model.params.named_parameters()}
    seen = types.SimpleNamespace(count=0, grads={}, after=None)

    def hook(opt, args, kwargs):
        seen.count += 1
        if seen.count == 1:
            for group in opt.param_groups:
                b1 = group["betas"][0]
                for p in group["params"]:
                    state = opt.state.get(p, {})
                    if "exp_avg" in state:
                        seen.grads[names[id(p)]] = state["exp_avg"].detach() / (1 - b1)
        if seen.count == steps:
            seen.after = {n: p.detach().clone()
                          for n, p in model.params.named_parameters()}

    handle = register_optimizer_step_post_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


class TrainCell:
    """Full-batch Adam on the configuration's data, in blocks of
    ``steps_per_block`` steps through ``DGP.optimize_adam``."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        config, traffic = cell.config, cell.traffic
        self.X, self.Y, self.values = inputs.model_values(config, seed, device)
        self.model = system.model(config, self.X, self.Y, self.values, seed,
                                  device)
        k = traffic["check_steps"]
        with followed(self.model, k) as seen:
            losses = system.train_block(traffic, self.model,
                                        traffic["steps_per_block"])
        grads = {n: seen.grads.get(n, torch.zeros_like(v))
                 for n, v in self.values.items()}
        after = seen.after if seen.after is not None else dict(self.values)
        self.program = (losses[:k].tolist(), grads, after)
        self.steps, self.failed = 0, 0

    def prepare(self, _):
        return None

    def send(self, _):
        losses = system.train_block(self.cell.traffic, self.model,
                                    self.cell.traffic["steps_per_block"])
        self.steps += len(losses)
        self.failed += int((~torch.isfinite(losses)).sum())

    def end_to_end(self, window_s, taken, busy_s):
        """The device's busy time a step over every step of the window,
        where the window was recorded (``busy_s``; not in a traced run)."""
        if busy_s is None:
            return {}
        return {"train_device_ms_per_step": 1e3 * busy_s / self.steps}

    @property
    def attempted(self):
        return self.steps

    def sizes(self):
        return [self.cell.config["num_data"]] * self.steps

    def traced_block(self):
        before = self.steps
        self.send(None)
        return self.steps - before

    def model_seconds(self, sizes):
        """The least time of the steps' model work at the peaks."""
        return len(sizes) * model_counts.train_step(
            self.cell.config, self.cell.config["num_data"]).seconds()

    def release(self):
        del self.model

    def numbers(self):
        """The compared numbers of the run against the float64 reference."""
        return check.train_numbers(self.program, self.followed(), self.values)

    def gaps(self):
        """Each step's and each leaf's gap (``check.train_gaps``)."""
        return check.train_gaps(self.program, self.followed(), self.values)

    def followed(self):
        return follow(self.cell, self.seed, self.device, self.X, self.Y,
                      self.values, ref.F64)


class ServeCell:
    """A closed loop of one client: requests of seed-drawn sizes through
    ``predict_in_chunks(predict_y)`` and ``moment_matched``."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        config, traffic = cell.config, cell.traffic
        self.X, self.Y, self.values = inputs.model_values(config, seed, device)
        self.model = system.model(config, self.X, self.Y, self.values, seed,
                                  device)
        self.gen = torch.Generator(device=device)
        K = traffic["sizes_per_block"]
        self.sizes_ = inputs.request_sizes(traffic, seed, K)
        self.sample = inputs.request_sample(traffic, seed)
        self.kept = {}
        self.done = []
        for rows in (traffic["chunk_size"], traffic["rows_max"]):
            warm = inputs.make_request(config, seed, -1, rows, device, self.gen)
            system.serve(config, traffic, self.model, warm, device)

    def _size(self, i):
        if i >= len(self.sizes_):
            self.sizes_ = inputs.request_sizes(self.cell.traffic, self.seed,
                                               2 * i + 1)
        return self.sizes_[i]

    def prepare(self, _):
        i = len(self.done)
        rows = self._size(i)
        return i, inputs.make_request(self.cell.config, self.seed, i, rows,
                                      self.device, self.gen)

    def send(self, item):
        i, rows = item
        out = system.serve(self.cell.config, self.cell.traffic, self.model,
                           rows, self.device)
        self.done.append(rows.shape[0])
        if i in self.sample:
            self.kept[i] = out

    def end_to_end(self, window_s, taken, busy_s):
        return {"serve_points_per_s": loops.rate(sum(self.done), window_s),
                "serve_p95_ms": 1e3 * loops.p95(taken)}

    @property
    def attempted(self):
        return len(self.done)

    failed = 0

    def sizes(self):
        return list(self.done)

    def traced_block(self):
        before = len(self.done)
        for _ in range(self.cell.traffic["sizes_per_block"]):
            self.send(self.prepare(None))
        return len(self.done) - before

    def model_seconds(self, sizes):
        """The least time of the requests' model work at the peaks."""
        return sum(model_counts.request(self.cell.config, R).seconds()
                   for R in sizes)

    def release(self):
        del self.model

    def numbers(self):
        """The compared numbers of the kept requests against the float64
        reference."""
        return check.serve_numbers([
            (out, predict_request(self.cell, self.seed, self.device,
                                  self.values, i, self._size(i), ref.F64))
            for i, out in sorted(self.kept.items())])


KINDS = {"train": TrainCell, "serve": ServeCell}


def follow(cell, seed, device, X, Y, values, prec):
    """The reference's first ``check_steps`` Adam steps in precision
    ``prec``, from the run's values and the model's unit normals."""
    t = cell.traffic
    normals = inputs.step_normals(cell.config, seed, device, t["check_steps"])
    return ref.adam_follow(values, X, Y, normals, cell.config, prec, t["lr"],
                           *t["betas"], t["eps"])


def predict_request(cell, seed, device, values, i, rows, prec):
    """Request i's moment-matched (mean, variance) by the reference in
    precision ``prec``, from its rows and unit normals."""
    config = cell.config
    X, zs = inputs.split_request(
        config, inputs.make_request(config, seed, i, rows, device))
    return ref.predict(values, X, zs, config, prec,
                       cell.traffic["reference_block"])


def control_numbers(cell, seed, device, gaps=False):
    """The lower-precision control's numbers: the reference computed in
    TF32 put in the program's place, against the float64 reference. With
    ``gaps``, a training cell's gaps of each step and leaf instead
    (``check.train_gaps``)."""
    config, traffic = cell.config, cell.traffic
    X, Y, values = inputs.model_values(config, seed, device)
    if traffic["kind"] == "train":
        args = (cell, seed, device, X, Y, values)
        compare = check.train_gaps if gaps else check.train_numbers
        return compare(follow(*args, ref.TF32), follow(*args, ref.F64), values)
    sizes = inputs.request_sizes(traffic, seed, traffic["check_span"])
    pairs = []
    for i in sorted(inputs.request_sample(traffic, seed)):
        got = predict_request(cell, seed, device, values, i, sizes[i], ref.TF32)
        pairs.append((torch.cat(got, dim=1).cpu(),
                      predict_request(cell, seed, device, values, i, sizes[i],
                                      ref.F64)))
    return check.serve_numbers(pairs)


class Reading(types.SimpleNamespace):
    """What a per-layer metric's reader is given: ``on_card`` (whether
    the run measured a card), ``kind``, ``config``,
    ``traffic``; the measured window's ``window_s``, ``units`` (steps or
    requests) and ``model_s`` (the least time of its model work at the
    peaks); the traced window's ``trace`` (``devicetrace.Summary``),
    ``trace_units`` and ``launches`` (``devicetrace.Launch`` list)."""


def traced(drive, device):
    """One traced block: (Summary, units, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with devicetrace.recorded_launches() as launches:
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            sync(device)
            start = time.perf_counter()
            units = sum(drive.traced_block()
                        for _ in range(drive.cell.traffic["trace_blocks"]))
            sync(device)
            window_s = time.perf_counter() - start
    summary = devicetrace.summarize(devicetrace.device_ops(prof.events()),
                                    window_s)
    return summary, units, list(launches)


def run(cell, seed, seconds, trace, device, started, log=sys.stderr):
    """One run of ``cell``; returns the result object (the contract's keys,
    ``check`` last). ``started`` is the process's start on
    ``time.perf_counter``'s clock."""
    system.build_kernels(device)
    drive = KINDS[cell.traffic["kind"]](cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - started
    recorded = (not trace and any(m["source"] == "device_trace"
                                  for m in cell.end_to_end))
    with (devicetrace.device_window(device) if recorded
          else contextlib.nullcontext()) as seen:
        window_s, taken = loops.closed_loop(drive.prepare, drive.send, seconds)
    busy_s = seen.busy_s if recorded else None
    if recorded and seen.span_s < 0.9 * window_s:
        raise RuntimeError(
            f"the record of the device's operations spans {seen.span_s!r} s "
            f"of the {window_s!r} s window ({seen.count} operations): the "
            "profiler dropped some, so the busy time would read low")
    values = dict(drive.end_to_end(window_s, taken, busy_s), setup_s=setup_s)
    units, sizes = drive.attempted, drive.sizes()
    summary = None
    if trace:
        summary, trace_units, launches = traced(drive, device)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    drive.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drive.numbers()
    correct, shown = check.verdict(numbers, cell.limits)
    if trace:
        reading = Reading(on_card=device.type == "cuda",
                          kind=cell.traffic["kind"], config=cell.config,
                          traffic=cell.traffic, window_s=window_s, units=units,
                          model_s=drive.model_seconds(sizes),
                          trace=summary, trace_units=trace_units,
                          launches=launches)
        metrics = {}
        for entry, read in cell.per_layer:
            value = read(reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": units, "failed": drive.failed,
              "metrics": metrics, "device": device_info(device, peak, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_top,
                               "idle_gaps": summary.gaps_top}
    result["check"] = shown
    for name, v in shown.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=log)
    return result


def device_info(device, peak, summary):
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info
