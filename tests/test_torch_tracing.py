"""The port's spans (`rtm_tpu_torch/utils/tracing.py`) in the profiler's
timeline.

Under a CPU `torch.profiler` a progressive frame through the mxu route's
plain version gives `rtm.step_async` around `rtm.dispatch` around
`rtm.postpass` (on the megakernel route `rtm.mega.pack` and
`rtm.mega.trace` beside the post-pass inside the dispatch), and each
`inverse_render` step one `rtm.fit.step` around
one `rtm.fit.forward` and one `rtm.fit.backward`, the caller's callback
outside it.  With no profiler running a span calls nothing in torch, and
frames and losses are bitwise the same with the profiler on or off.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtm_tpu_torch import (Camera, InverseRenderConfig, RenderConfig,
                           build_tracer_scene, extract_params,
                           inverse_render, load_scene, loss_and_grad,
                           render_dispatch)
from rtm_tpu_torch.bench.profile import trace
from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
from rtm_tpu_torch.utils import tracing
from rtm_tpu_torch.utils.tracing import span

CFG = RenderConfig(width=16, height=16, max_bounces=2)


@pytest.fixture(scope="module")
def scene():
    return build_tracer_scene(load_scene(3), device="cpu")


def spans_of(prof, prefix: str = "rtm.") -> list:
    """(name, start, end) of the trace's events whose name starts with
    `prefix`, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda s: s[1])


def inside(a, b) -> bool:
    """Whether span a lies within span b."""
    return b[1] <= a[1] and a[2] <= b[2]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def fit(scene, steps: int, callback=None):
    target = render_dispatch(scene, Camera().spec(16, 16, device="cpu"), 7,
                             CFG, backend="mxu")
    p0 = extract_params(scene)
    p0 = dataclasses.replace(p0, albedo=p0.albedo * 0.8)
    return inverse_render(scene, Camera().spec(16, 16, device="cpu"),
                          target, CFG,
                          InverseRenderConfig(steps=steps, backend="mxu",
                                              remat=False),
                          init_params=p0, callback=callback)


def test_step_async_nests_dispatch_and_postpass(scene):
    pr = ProgressiveRenderer(scene, cfg=CFG, backend="mxu")
    pr.step_async()
    with cpu_profile() as prof:
        pr.step_async()
    got = spans_of(prof)
    assert [s[0] for s in got] == ["rtm.step_async", "rtm.dispatch",
                                   "rtm.postpass"]
    step, dispatch, post = got
    assert inside(dispatch, step) and inside(post, dispatch)
    parents = {e.name: e.cpu_parent.name for e in prof.events()
               if e.name in ("rtm.dispatch", "rtm.postpass")}
    assert parents == {"rtm.dispatch": "rtm.step_async",
                       "rtm.postpass": "rtm.dispatch"}


def test_megakernel_dispatch_nests_pack_and_trace(scene):
    pr = ProgressiveRenderer(scene, cfg=CFG, backend="megakernel")
    pr.step_async()
    with cpu_profile() as prof:
        pr.step_async()
    got = spans_of(prof)
    assert [s[0] for s in got] == ["rtm.step_async", "rtm.dispatch",
                                   "rtm.mega.pack", "rtm.mega.trace",
                                   "rtm.postpass"]
    dispatch = got[1]
    assert all(inside(s, dispatch) for s in got[2:])
    parents = {e.name: e.cpu_parent.name for e in prof.events()
               if e.name.startswith("rtm.mega.")}
    assert parents == {"rtm.mega.pack": "rtm.dispatch",
                       "rtm.mega.trace": "rtm.dispatch"}


def test_fit_step_holds_forward_and_backward_not_the_callback(scene):
    def callback(i, loss, params):
        with span("test.callback"):
            pass

    with cpu_profile() as prof:
        fit(scene, 2, callback)
    got = spans_of(prof, "rtm.fit.")
    steps = [s for s in got if s[0] == "rtm.fit.step"]
    assert len(steps) == 2
    for st in steps:
        inner = [s[0] for s in got if s is not st and inside(s, st)]
        assert inner == ["rtm.fit.forward", "rtm.fit.backward"]
    calls = spans_of(prof, "test.callback")
    assert len(calls) == 2
    assert not any(c[1] < st[2] and st[1] < c[2]
                   for c in calls for st in steps)


def test_banded_fit_spans_each_band(scene):
    cam = Camera().spec(16, 16, device="cpu")
    target = torch.zeros((16, 16, 3))
    with cpu_profile() as prof:
        loss_and_grad(extract_params(scene), scene, cam, target, 1, CFG,
                      backend="wavefront2", bands=2)
    assert [s[0] for s in spans_of(prof, "rtm.fit.")] == [
        "rtm.fit.forward", "rtm.fit.backward"] * 2


def test_span_without_a_profiler_calls_nothing_in_torch(scene, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span called into the profiler")

    monkeypatch.setattr(tracing, "_RECORD", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("rtm.test") is span("rtm.test")

    @span("rtm.test.fn")
    def twice(x):
        return 2 * x

    calls = []

    def watch(frame, event, arg):
        if event == "call":
            calls.append(frame.f_code.co_filename)
        elif event == "c_call":
            calls.append(getattr(arg, "__module__", None) or "")

    sys.setprofile(watch)
    try:
        with span("rtm.test"):
            pass
    finally:
        sys.setprofile(None)
    assert calls and all(c == tracing.__file__ or "torch" not in c
                         for c in calls), calls
    assert twice(3) == 6
    ProgressiveRenderer(scene, cfg=CFG, backend="mxu").step_async()


def test_span_as_context_and_decorator_under_the_profiler():
    @span("rtm.test.before")
    def before():
        return 1

    with cpu_profile() as prof:
        @span("rtm.test.during")
        def during():
            return 2

        with span("rtm.test.block"):
            assert before() + during() == 3
    got = spans_of(prof, "rtm.test.")
    assert [s[0] for s in got] == ["rtm.test.block", "rtm.test.before",
                                   "rtm.test.during"]
    assert inside(got[1], got[0]) and inside(got[2], got[0])


def test_frames_and_losses_bitwise_with_and_without_the_profiler(scene):
    def frames():
        pr = ProgressiveRenderer(scene, cfg=CFG, backend="mxu")
        return [pr.step_async().clone() for _ in range(2)]

    off_frames, (off_fit, off_losses) = frames(), fit(scene, 2)
    with cpu_profile():
        on_frames, (on_fit, on_losses) = frames(), fit(scene, 2)
    assert all(torch.equal(a, b) for a, b in zip(off_frames, on_frames))
    assert off_losses == on_losses
    assert all(torch.equal(a, b) for a, b in zip(off_fit.tensors(),
                                                 on_fit.tensors()))


def test_profile_trace_writes_the_spans(scene, tmp_path):
    pr = ProgressiveRenderer(scene, cfg=CFG, backend="mxu")
    with trace(tmp_path):
        pr.step_async()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"rtm.step_async", "rtm.dispatch", "rtm.postpass"} <= names
