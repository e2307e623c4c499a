"""The measured window's loop and its statistics, kept apart from the
system so that their arithmetic can be tested with a fake clock."""

from __future__ import annotations

import statistics
import time


def closed_loop(prepare, send, seconds, clock=time.perf_counter):
    """One client that sends unit i (``send(prepare(i))``) once unit i - 1
    has come back, until ``seconds`` have passed since the window opened.

    :return: (the window's length: from its opening until the last unit
        came back, [seconds from each unit's send until it came back])
    """
    opened = clock()
    taken = []
    i = 0
    while True:
        item = prepare(i)
        sent = clock()
        send(item)
        back = clock()
        taken.append(back - sent)
        i += 1
        if back - opened >= seconds:
            return back - opened, taken


def rate(done, window_s):
    """Work per second over the whole window."""
    return done / window_s


def p95(latencies):
    """The 95th percentile of every latency (linear between order
    statistics)."""
    if len(latencies) == 1:
        return latencies[0]
    return statistics.quantiles(latencies, n=20, method="inclusive")[-1]
