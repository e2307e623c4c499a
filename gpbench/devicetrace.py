"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time, its operations by the port's kernel they
belong to, the device time outside those kernels, the breakdown of the
operations that took most time and of the longest idle gaps, and the
calls of the port's kernels with their shapes (:func:`recorded_launches`).

The port's kernels are found by the name of their CUDA function:

    fused_fwd #1, fused_bwd_a #2 (phase A), conditional_fused_fwd #3,
    conditional_fused_bwd_a #4, quadform_fwd #5, quadform_bwd_a #6,
    cholesky_kernel<false, ...> #7, cholesky_kernel<true, ...> #8,
    gram_bwd, reduce_parts, gram_finish: phase B of the phase A before it.
"""

from __future__ import annotations

import contextlib
import re
import types
from collections import defaultdict
from typing import NamedTuple, Optional

PORT_KERNELS = {
    "fused_fwd": "k1", "fused_bwd_a": "k2",
    "conditional_fused_fwd": "k3", "conditional_fused_bwd_a": "k4",
    "quadform_fwd": "k5", "quadform_bwd_a": "k6",
    "gram_bwd": "B", "reduce_parts": "B", "gram_finish": "B",
    "cholesky_kernel": "k7",
}
PHASE_A = ("k2", "k4", "k6")


def identifier(name: str) -> str:
    """The function's name in a device operation's (demangled) name: no
    return type, namespace, template arguments or parameters."""
    text = name[5:] if name.startswith("void ") else name
    text = text.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", text, maxsplit=1)[0].strip()
    return head.split("::")[-1] or text


def kernel_of(name: str) -> Optional[str]:
    """The port's kernel that a device operation belongs to ("k1" ... "k8",
    "B" for phase B), or None."""
    kid = PORT_KERNELS.get(identifier(name))
    if kid == "k7" and "cholesky_kernel<true" in name.replace(" ", ""):
        return "k8"
    return kid


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float
    kernel: Optional[str]    # after phase B is given to its phase A
    host: str                # the host operation during the idle gap before it


# the profiler's own bookkeeping on the host, not the program's work
PROFILER_EVENTS = ("Buffer Flush", "Activity Buffer Request")


def device_ops(events):
    """The device operations of profiler events (``prof.events()``), in
    device order, each with its kernel and the host operation that was
    running when the device went idle before it (the innermost host
    operation, on any thread, covering the middle of that gap; "none"
    where the host ran no operation the profiler saw). Annotations that
    the profiler copies onto the device's timeline are not operations."""
    host, ops = [], []
    for e in events:
        if str(e.device_type).endswith("CPU"):
            if e.name not in PROFILER_EVENTS and not getattr(e, "is_async", False):
                host.append((e.time_range.start, e.time_range.end, e.name))
        elif (str(e.device_type).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)):
            ops.append(e)
    ops.sort(key=lambda e: e.time_range.start)
    host.sort()
    out, phase_a, end = [], None, None
    at, open_ = 0, []
    for e in ops:
        kid = kernel_of(e.name)
        if kid in PHASE_A:
            phase_a = kid
        elif kid == "B":
            kid = phase_a or "B"
        start = e.time_range.start
        name = "none"
        if end is not None and start > end:
            t = 0.5 * (start + end)
            while at < len(host) and host[at][0] <= t:
                open_.append(host[at])
                at += 1
            open_ = [h for h in open_ if h[1] > t]
            if open_:
                name = max(open_)[2]
        out.append(DeviceOp(e.name, start, e.time_range.end, kid, name))
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    return out


def _label(op):
    ident = identifier(op.name)
    if op.kernel is not None:
        return f"{ident} (#{op.kernel[1:]})" if op.kernel[1:].isdigit() else ident
    return ident


class Summary(NamedTuple):
    busy_s: float
    window_s: float
    count: int
    seconds_by_kernel: dict      # "k1" ... "k8" -> device seconds
    other_s: float               # device seconds outside the port's kernels
    device_top: list             # [[label, seconds]], at most 10
    gaps_top: list               # [[host operation, seconds]], at most 10


def summarize(ops, window_s):
    """Busy time (the union of the operations' intervals), device time by
    kernel and outside the kernels, and the breakdown: the ten labels of
    most device time, and the ten host operations that the device waited
    on longest (each idle gap is given to the host operation that
    :func:`device_ops` found running in it)."""
    by_kernel, by_label, gaps = defaultdict(float), defaultdict(float), defaultdict(float)
    busy = other = 0.0
    end = None
    for op in ops:
        dt = (op.end_us - op.start_us) * 1e-6
        by_label[_label(op)] += dt
        if op.kernel is None:
            other += dt
        else:
            by_kernel[op.kernel] += dt
        if end is not None and op.start_us > end:
            gaps[op.host] += (op.start_us - end) * 1e-6
        if end is None or op.start_us >= end:
            busy += dt
            end = op.end_us
        elif op.end_us > end:
            busy += (op.end_us - end) * 1e-6
            end = op.end_us

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return Summary(busy, window_s, len(ops), dict(by_kernel), other,
                   top(by_label), top(gaps))


def union_s(spans_ns):
    """Seconds covered by the union of (start, end) intervals in ns."""
    busy, end = 0, None
    for start, stop in sorted(spans_ns):
        if end is None or start >= end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy * 1e-9


@contextlib.contextmanager
def device_window(device):
    """Record every operation of ``device`` for the length of the scope
    (the profiler's device activity alone on a card, so the host pays only
    for recording its launches; the CPU's operators on the CPU). Yields a
    namespace whose ``busy_s`` (the union of the operations' intervals),
    ``span_s`` (from the first operation's start to the last one's end)
    and ``count`` are set once the scope has closed. It reads the raw
    events, not the profiler's tree of events, which takes some 80 us an
    event to build: a minute for a window of some hundred thousand."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    seen = types.SimpleNamespace(busy_s=None, span_s=0.0, count=0)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        yield seen
    wanted = "CUDA" if on_card else "CPU"
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith(wanted)
             and not e.is_user_annotation()
             and e.name() not in PROFILER_EVENTS]
    seen.busy_s, seen.count = union_s(spans), len(spans)
    if spans:
        seen.span_s = 1e-9 * (max(e for _, e in spans) - min(s for s, _ in spans))


class Launch(NamedTuple):
    kernel: str     # "k1", "k2", "k5", "k6"
    n: int
    M: int
    Din: int
    D: int
    with_t1: bool


@contextlib.contextmanager
def recorded_launches():
    """Record every call of the port's kernel classes (the whitened
    stationary conditional, the quadform) on CUDA tensors, with the shapes
    it was given: a list of :class:`Launch` in call order. It wraps the
    classes' ``forward`` and ``backward`` for the length of the scope."""
    from dgp_tpu_torch.ops.conditional_fused_rbf import FusedConditional
    from dgp_tpu_torch.ops.quadform import QuadForm

    records = []

    def k1(ctx, kind, Pinv, Xs, Zs, variance, q_mu, Sq):
        if Xs.is_cuda:
            records.append(Launch("k1", Xs.shape[0], Zs.shape[0], Xs.shape[1],
                                  q_mu.shape[1], True))

    def k2(ctx, g_mean, g_var):
        Zs = ctx.saved_tensors[2]
        if g_mean.is_cuda:
            records.append(Launch("k2", g_mean.shape[0], Zs.shape[0],
                                  Zs.shape[1], g_mean.shape[1], True))

    def k5(ctx, Sq, A, with_t1):
        if A.is_cuda:
            records.append(Launch("k5", A.shape[1], A.shape[0], 0, Sq.shape[0],
                                  bool(with_t1)))

    def k6(ctx, g2, g1=None):
        A = ctx.saved_tensors[1]
        if g2.is_cuda:
            records.append(Launch("k6", g2.shape[1], A.shape[0], 0, g2.shape[0],
                                  g1 is not None))

    originals = []
    for cls, attr, note in ((FusedConditional, "forward", k1),
                            (FusedConditional, "backward", k2),
                            (QuadForm, "forward", k5), (QuadForm, "backward", k6)):
        fn = cls.__dict__[attr].__func__
        originals.append((cls, attr, cls.__dict__[attr]))

        def wrapped(ctx, *args, _fn=fn, _note=note):
            _note(ctx, *args)
            return _fn(ctx, *args)

        setattr(cls, attr, staticmethod(wrapped))
    try:
        yield records
    finally:
        for cls, attr, original in originals:
            setattr(cls, attr, original)
