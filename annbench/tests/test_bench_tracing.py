"""The reduction of a profiler trace, on a hand-made Chrome trace:
device time under a span by correlation, busy and idle time, and idle
gaps named by the host event open at their middle."""

import pytest

from annbench import tracing


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    _x("user_annotation", tracing.WINDOW, 0, 100),
    _x("user_annotation", "mod.route", 5, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=2),
    _x("cpu_op", "aten::nonzero", 40, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=3),
    _x("kernel", "void cub::DeviceSegmentedRadixSortKernel<int, 4>(int*)",
       10, 10, tid=7, corr=1),
    _x("kernel", "scan_mma_kernel<__nv_bfloat16, 10>", 20, 20, tid=7,
       corr=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80, 10, tid=7,
       corr=3),
]


def test_spans_busy_and_gaps():
    r = tracing.Reading(EVENTS, requests=2, setup={})
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(40e-6)
    assert r.span_device_s("mod.route") == [pytest.approx(30e-6)]
    assert r.span_device_s("mod.route", r"^scan_") == [pytest.approx(20e-6)]
    assert r.device_s(r"^scan_\w*kernel$") == pytest.approx(20e-6)
    ops = dict(r.top_device_ops())
    assert set(ops) == {"DeviceSegmentedRadixSortKernel", "scan_mma_kernel",
                        "DtoH"}
    gaps = dict(r.idle_gaps())
    # 0-10: inside the route span; 40-80: inside aten::nonzero (40-70
    # holds the middle, 60); 90-100: nothing open
    assert gaps["mod.route"] == pytest.approx(10e-6)
    assert gaps["aten::nonzero"] == pytest.approx(40e-6)
    assert gaps["host_outside_any_range"] == pytest.approx(10e-6)


def test_short_names():
    assert tracing.short_name("Memset (Device)") == "Memset"
    assert tracing.short_name(
        "void at::native::(anonymous namespace)::elementwise_kernel<128, 4>"
        "(int)") == "elementwise_kernel"
    assert tracing.short_name(
        "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
        "float>(float const*)") == "gemvx::kernel"
    assert tracing.short_name(
        "void (anonymous namespace)::scan_mma_kernel<__nv_bfloat16, true, "
        "true, false>(float*, int)") == "scan_mma_kernel"


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        tracing.Reading(EVENTS[1:], requests=1, setup={})
