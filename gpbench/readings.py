"""What the per-layer metrics' readers share: each reads a
``harness.Reading`` and returns its number, or None where the run has
nothing for it to read (no trace, another kind of traffic, no launch of
its kernels)."""

from __future__ import annotations

from .counts import k1, k2, k5, k6

WORK = {
    "k1": lambda l: k1.work(l.n, l.M, l.Din, l.D),
    "k2": lambda l: k2.work(l.n, l.M, l.Din, l.D),
    "k5": lambda l: k5.work(l.n, l.M, l.D, l.with_t1),
    "k6": lambda l: k6.work(l.n, l.M, l.D, l.with_t1),
}


def traced(reading, kind):
    """Whether the run traced the card under this kind of traffic."""
    return (reading.on_card and reading.kind == kind
            and reading.trace is not None and reading.trace.count > 0
            and reading.trace_units > 0)


def device_idle(reading, kind):
    """Percent of the traced window in which no operation ran on the
    device."""
    if not traced(reading, kind) or reading.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)


def launches(reading, kind):
    """Device operations (kernels, copies, fills) per unit of work."""
    if not traced(reading, kind):
        return None
    return reading.trace.count / reading.trace_units


def eager_ms(reading, kind):
    """Device ms per unit of work outside the port's kernels #1-#8."""
    if not traced(reading, kind):
        return None
    return 1e3 * reading.trace.other_s / reading.trace_units


def rate(reading, kind):
    """Units of work per second over the measured window, on the host's
    clock."""
    if not reading.on_card or reading.kind != kind or reading.window_s <= 0:
        return None
    return reading.units / reading.window_s


def mfu(reading, kind):
    """Percent: the least time of the measured window's model work at the
    card's peaks over the window's length."""
    if not reading.on_card or reading.kind != kind or reading.model_s <= 0:
        return None
    return 100.0 * reading.model_s / reading.window_s


def roofline(reading, kind, kernels):
    """Percent: the sum of the bounds of every launch of ``kernels`` in the
    traced window, each at the shapes it was given, over those kernels'
    device time there."""
    if not traced(reading, kind):
        return None
    bound = sum(WORK[l.kernel](l).seconds() for l in reading.launches
                if l.kernel in kernels)
    spent = sum(reading.trace.seconds_by_kernel.get(k, 0.0) for k in kernels)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
