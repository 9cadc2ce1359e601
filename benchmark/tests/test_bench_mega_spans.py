"""The metrics of the megakernel route (`mega_device_ms.rtiow`,
`mega_roofline.rtiow`, `traced_pack_host_ms.rtiow`) on hand-built traces
(times in us): what they read from the program's `rtm.mega.*` spans and
the trace's kernel events, and nothing from a program without them."""
from __future__ import annotations

import json
import types

import pytest

from bench_helpers import ROOT, config
from benchmark import roofline
from benchmark.devtrace import Trace
from benchmark.harness import load_module
from benchmark.reference.scene import build_tables, describe

T = 7          # the window's thread
KERNEL = "_anonymous_namespace_::mega_trace_kernel<true>"


def host(s, e, name, dev=0.0, thread=T):
    return (s, e, name, thread, dev)


def trace(hosts, device=(), units=2):
    return Trace(window=(0.0, 1e6), device=list(device), host=list(hosts),
                 units=units, thread=T)


@pytest.fixture(scope="module")
def cell():
    desc = describe(config("rtiow1200"))
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "still4.json")
                         .read_text())
    return desc, build_tables(desc), traffic


def read(metric, tr, cell=None):
    mod = load_module(ROOT / "benchmark" / "metrics" / f"{metric}.py",
                      "test_metric_" + metric.replace(".", "_"))
    desc, tables, traffic = cell or (None, None, None)
    return mod.read(types.SimpleNamespace(trace_data=tr, desc=desc,
                                          tables=tables, traffic=traffic,
                                          work={}))


def dispatches(with_spans: bool = True):
    """Two megakernel dispatches: each packs (two ops of its own), then
    launches the kernel (81 ms on the device) and the post-pass.  Without
    the spans the kernel hangs on the output's `aten::empty`."""
    hosts, device = [], []
    for t0 in (0, 200_000):
        hosts += [host(t0, t0 + 150, "rtm.dispatch"),
                  host(t0 + 20, t0 + 30, "aten::index", dev=4),
                  host(t0 + 40, t0 + 50, "aten::cat", dev=2),
                  host(t0 + 70, t0 + 90, "rtm.mega.trace" if with_spans
                       else "aten::empty", dev=81_000),
                  host(t0 + 100, t0 + 120, "rtm.postpass", dev=50)]
        if with_spans:
            hosts.append(host(t0 + 10, t0 + 60, "rtm.mega.pack"))
        device += [(t0 + 100, t0 + 81_100, KERNEL),
                   (t0 + 81_100, t0 + 81_150, "postpass_dense_kernel")]
    return trace(hosts, device)


def test_device_ms_of_the_megakernel_span():
    assert read("mega_device_ms.rtiow", dispatches()) == pytest.approx(81.0)


def test_host_ms_of_the_pack_span():
    assert read("traced_pack_host_ms.rtiow", dispatches()) == \
        pytest.approx(0.05)


def test_roofline_share_of_the_kernel_events(cell):
    desc, tables, traffic = cell
    r = desc.render
    b = roofline.dispatch_bound(tables, r["width"], r["height"],
                                traffic["spp"], r["max_bounces"])
    assert b["binds"] == "operations"
    assert b["ops"] == 1200 * 675 * 4 * 50 * roofline.RAY_TRIANGLE_OPS
    got = read("mega_roofline.rtiow", dispatches(), cell)
    assert got == pytest.approx(100.0 * b["bound_s"] / 0.081)
    assert 0.1 < got < 0.2


def test_readers_find_nothing_in_a_program_without_the_spans(cell):
    tr = dispatches(with_spans=False)
    assert read("mega_device_ms.rtiow", tr) is None
    assert read("traced_pack_host_ms.rtiow", tr) is None
    for metric in ("mega_device_ms.rtiow", "traced_pack_host_ms.rtiow",
                   "mega_roofline.rtiow"):
        assert read(metric, None, cell) is None
    # the kernel's events are the trace's, so the roofline reads them all
    # the same
    assert read("mega_roofline.rtiow", tr, cell) is not None
