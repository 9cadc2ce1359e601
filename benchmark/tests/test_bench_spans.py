"""benchmark/spans.py and the metrics that read the program's spans, on
hand-built traces (times in us), and in a traced CPU run of a cell."""
from __future__ import annotations

import types

import pytest

from bench_helpers import (ROOT, StepClock, run_cell,  # noqa: F401
                           small_root)
from benchmark import spans
from benchmark.devtrace import Trace
from benchmark.harness import load_module

T = 7          # the window's thread


def host(s, e, name, dev=0.0, thread=T):
    return (s, e, name, thread, dev)


def trace(hosts, device=(), window=(0.0, 1000.0), units=1):
    return Trace(window=window, device=list(device), host=list(hosts),
                 units=units, thread=T)


def read(metric, tr):
    mod = load_module(ROOT / "benchmark" / "metrics" / f"{metric}.py",
                      "test_metric_" + metric.replace(".", "_"))
    return mod.read(types.SimpleNamespace(trace_data=tr))


def test_device_time_counts_each_operation_once_under_nested_ops():
    tr = trace([
        host(10, 500, "rtm.postpass", dev=2),      # a launch of its own
        host(20, 400, "rtm.postpass"),             # nested: merged
        host(30, 100, "aten::stack", dev=1),
        host(31, 90, "aten::cat", dev=5),          # inside the stack
        host(35, 40, "cudaLaunchKernel"),
        host(200, 300, "aten::mul", dev=3),
        host(100, 150, "aten::add", dev=50, thread=8),   # another thread
        host(600, 700, "aten::div", dev=40),       # after the span
    ])
    assert spans.device_s(tr, "rtm.postpass") == pytest.approx(11e-6)
    assert spans.device_s(tr, "rtm.dispatch") is None


def test_spans_the_window_cuts_are_dropped():
    tr = trace([host(50, 150, "rtm.step_async"),
                host(200, 300, "rtm.step_async"),
                host(900, 1100, "rtm.step_async"),
                host(400, 450, "rtm.step_async", thread=8)],
               window=(100.0, 1000.0), units=2)
    assert spans.complete(tr, "rtm.step_async") == [(200, 300)]
    assert spans.host_s(tr, "rtm.step_async") == pytest.approx(100e-6)
    assert read("traced_enqueue_ms.spp4", tr) == pytest.approx(0.05)


def test_host_time_less_a_child():
    tr = trace([host(0, 100, "rtm.dispatch"), host(60, 90, "rtm.postpass"),
                host(200, 260, "rtm.dispatch"),
                host(210, 230, "rtm.postpass"),
                host(300, 310, "rtm.postpass")], units=2)
    assert spans.host_s(tr, "rtm.dispatch", less="rtm.postpass") == \
        pytest.approx(110e-6)
    assert read("traced_dispatch_host_ms.interactive", tr) == \
        pytest.approx(0.055)
    assert read("traced_postpass_host_ms.interactive", tr) == \
        pytest.approx(0.03)


def test_each_idle_gap_goes_to_the_innermost_span_open_at_its_start():
    tr = trace([host(0, 100, "rtm.fit.step"),
                host(10, 40, "rtm.fit.forward"),
                host(15, 25, "aten::mm"),
                host(40, 80, "rtm.fit.backward"),
                host(100, 200, "rtm.fit.step"),
                host(110, 150, "rtm.fit.forward"),
                host(150, 190, "rtm.fit.backward")],
               device=[(0, 5, "k"), (8, 20, "k"), (30, 45, "k"),
                       (50, 84, "k"), (95, 120, "k"), (125, 200, "k")],
               window=(0.0, 230.0), units=2)
    assert spans.idle_gaps(tr) == [(5, 8), (20, 30), (45, 50), (84, 95),
                                   (120, 125), (200, 230)]
    by = spans.idle_by_span(tr)
    assert by == pytest.approx({"rtm.fit.step": 14e-6,
                                "rtm.fit.forward": 15e-6,
                                "rtm.fit.backward": 5e-6, None: 30e-6})
    assert read("traced_loop_idle_ms.fit", tr) == pytest.approx(0.007)


def test_readers_find_nothing_in_a_program_without_spans():
    tr = trace([host(0, 100, "aten::add", dev=5)],
               device=[(0, 10, "k")], units=3)
    assert spans.idle_by_span(tr) == {}
    for metric in ("postpass_device_ms.spp4", "traced_enqueue_ms.spp4",
                   "traced_postpass_host_ms.interactive",
                   "traced_dispatch_host_ms.interactive",
                   "traced_loop_idle_ms.fit"):
        assert read(metric, tr) is None
        assert read(metric, None) is None


def test_device_reader_per_dispatch():
    tr = trace([host(0, 100, "rtm.postpass"),
                host(10, 20, "aten::cat", dev=3000),
                host(200, 300, "rtm.postpass"),
                host(210, 220, "aten::cat", dev=5000)], units=2)
    assert read("postpass_device_ms.spp4", tr) == pytest.approx(4.0)


def test_a_traced_cpu_run_reads_the_host_spans(small_root):
    """On the CPU the profiler sees the program's spans but no device: the
    host readings are there."""
    res, _ = run_cell(small_root, "cornell512.interactive", seconds=0.5,
                      trace=1, clock=StepClock(0.01))
    for m in ("traced_postpass_host_ms.interactive",
              "traced_dispatch_host_ms.interactive"):
        assert res["metrics"][m]["value"] > 0
