"""The reduction of a device trace, on hand-made profiler events."""

import sys
import types

import pytest

from gpbench import devicetrace, harness


def event(name, start, end, device="DeviceType.CUDA", annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_async=False,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_identifier_and_kernel():
    assert devicetrace.identifier(
        "void fused_fwd<0, 128>(float const*, float*)") == "fused_fwd"
    assert devicetrace.kernel_of("void fused_fwd<0>(float const*)") == "k1"
    assert devicetrace.kernel_of("conditional_fused_fwd(float const*)") == "k3"
    assert devicetrace.kernel_of("void cholesky_kernel<true, 128>(float const*)") == "k8"
    assert devicetrace.kernel_of("void cholesky_kernel<false, 128>(float const*)") == "k7"
    assert devicetrace.kernel_of(
        "void at::native::vectorized_elementwise_kernel<4, at::native::Mul>(int)") is None
    assert devicetrace.identifier("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert devicetrace.kernel_of(
        "void (anonymous namespace)::fused_bwd_a<0, 128>(float const*, long long)") == "k2"


def test_summary():
    cpu = "DeviceType.CPU"
    events = [
        event("FusedConditionalBackward", 0, 500, cpu),
        event("aten::mul", 150, 205, cpu),
        event("Buffer Flush", 0, 1000, cpu),
        event("Optimizer.step#Adam.step", 0, 300, annotation=True),
        event("void (anonymous namespace)::fused_bwd_a<0>(float const*)", 10, 30),
        event("void gram_bwd<8>(float const*)", 30, 40),
        event("void reduce_parts(float const*)", 35, 45),   # overlaps
        event("void quadform_bwd_a<128>(float const*)", 100, 110),
        event("gram_finish(float const*)", 110, 115),
        event("void at::native::elementwise_kernel<4>(int)", 200, 210),
    ]
    ops = devicetrace.device_ops(events)
    assert [op.kernel for op in ops] == ["k2", "k2", "k2", "k6", "k6", None]
    s = devicetrace.summarize(ops, window_s=1e-3)
    # union: [10, 45], [100, 115], [200, 210]
    assert s.busy_s == pytest.approx(60e-6)
    assert s.count == 6
    assert s.seconds_by_kernel["k2"] == pytest.approx(40e-6)
    assert s.seconds_by_kernel["k6"] == pytest.approx(15e-6)
    assert s.other_s == pytest.approx(10e-6)
    # the gap 45-100 falls in the backward alone, 115-200 in aten::mul
    gaps = dict(s.gaps_top)
    assert gaps == pytest.approx({"FusedConditionalBackward": 55e-6,
                                  "aten::mul": 85e-6})
    assert s.device_top[0][0] == "fused_bwd_a (#2)"
    assert dict(s.device_top)["elementwise_kernel"] == pytest.approx(10e-6)


def test_foreign_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "dgp_tpu_torchlike", types.ModuleType("x"))
    assert harness.foreign_modules() == ["jax.numpy"] + [
        m for m in harness.foreign_modules() if m != "jax.numpy"]
    assert "dgp_tpu_torchlike" not in harness.foreign_modules()
    assert not [m for m in harness.foreign_modules()
                if m.split(".")[0] == "dgp_tpu_torch"]


def test_union_of_intervals():
    assert devicetrace.union_s([]) == 0.0
    # [0, 10] and [5, 20] overlap, [8, 9] lies inside, [30, 31] stands apart
    spans = [(30, 31), (5, 20), (0, 10), (8, 9)]
    assert devicetrace.union_s(spans) == pytest.approx(21e-9)


def test_device_window_on_the_cpu():
    import time

    import torch

    x = torch.ones(256, 256)
    start = time.perf_counter()
    with devicetrace.device_window(torch.device("cpu")) as seen:
        for _ in range(20):
            x = (x @ x) * 1e-3
    scope_s = time.perf_counter() - start
    assert seen.count >= 40
    assert 0.0 < seen.busy_s <= seen.span_s <= scope_s
