"""The window's rate and tail arithmetic on a fake clock."""

import pytest

from gpbench import loops


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def window(costs, seconds):
    clock = Clock()
    sent = []

    def send(i):
        clock.t += costs[i]
        sent.append(i)

    length, taken = loops.closed_loop(lambda i: i, send, seconds, clock)
    return length, taken, sent


def test_the_window_ends_on_the_first_unit_back_after_its_length():
    length, taken, sent = window([0.125] * 100, 1.0)
    assert len(sent) == 8
    assert length == pytest.approx(1.0)
    assert loops.rate(len(sent) * 50, length) == pytest.approx(400)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = window([0.01] * 200, 1.0)
    costs = [0.01] * 200
    for i in range(20, 30):
        costs[i] = 0.05
    stalled = window(costs, 1.0)
    assert loops.rate(len(stalled[2]), stalled[0]) < loops.rate(
        len(steady[2]), steady[0])
    assert loops.p95(stalled[1]) > loops.p95(steady[1])
    assert loops.p95(steady[1]) == pytest.approx(0.01)


def test_p95_interpolates_between_order_statistics():
    assert loops.p95([float(i) for i in range(1, 101)]) == pytest.approx(95.05)
    assert loops.p95([3.0]) == 3.0
