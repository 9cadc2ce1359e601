"""rtm_tpu_torch's browser viewer (viewer/server.py), `view` command and
profiling helpers (bench/profile.py) on the CPU (`device="cpu"`,
`port=0`), following tests/test_viewer.py and tests/test_editor.py.

The camera controller is held to rtm_tpu's on the same events (camera
state equal to 1e-12); the endpoints, settings panel, editor endpoint and
AppClose as in rtm_tpu's tests; the render thread started and stopped
cleanly; `megakernel_roofline`'s pair count equals rtm_tpu's exactly and
its time is those pairs at the H100's FP32 rate.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.runtime.events import KeyPressed as JKey
from rtm_tpu.runtime.events import MouseMove as JMove
from rtm_tpu.runtime.events import ScrollMoved as JScroll
from rtm_tpu.viewer import CameraController as JController
from rtm_tpu_torch import Camera, RenderConfig, build_tracer_scene, load_scene
from rtm_tpu_torch.io.image import decode_png, encode_png
from rtm_tpu_torch.runtime.events import KeyPressed, MouseMove, ScrollMoved
from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
from rtm_tpu_torch.viewer import CameraController, ViewerServer

CFG = RenderConfig(width=16, height=16, max_bounces=2, max_frames=1,
                   draw_environment=True, accumulate=True)


def _get(s, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{s.port}{path}",
                                  timeout=30)


def _post(s, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{s.port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _state(s):
    return json.loads(_get(s, "/state").read())


def test_camera_controller_matches_rtm_tpu():
    cams = Camera(), rtm_tpu.Camera()
    resets = [], []
    ctl = CameraController(cams[0], lambda: resets[0].append(1))
    jctl = JController(cams[1], lambda: resets[1].append(1))
    p0 = np.array(cams[0].position, float)
    for ev, jev, kind in ((KeyPressed("w"), JKey("w"), "key"),
                          (KeyPressed("q"), JKey("q"), "key"),
                          (KeyPressed("x"), JKey("x"), "key"),
                          (MouseMove(0, 0, 50.0, -20.0),
                           JMove(0, 0, 50.0, -20.0), "look"),
                          (ScrollMoved(5.0), JScroll(5.0), "scroll")):
        getattr(ctl, kind)(ev)
        getattr(jctl, kind)(jev)
        for attr in ("position", "direction"):
            np.testing.assert_allclose(getattr(cams[0], attr),
                                       getattr(cams[1], attr), atol=1e-12)
        assert cams[0].fov == cams[1].fov
    assert cams[0].position[2] < p0[2]           # forward = -z
    assert len(resets[0]) == len(resets[1]) == 4  # "x" is not a key
    np.testing.assert_allclose(np.linalg.norm(cams[0].direction), 1.0,
                               atol=1e-6)
    assert cams[0].fov == 40.0


@pytest.fixture
def server():
    scene = build_tracer_scene(load_scene(1), device="cpu")
    s = ViewerServer(ProgressiveRenderer(scene, Camera(), CFG), port=0)
    s.serve()
    yield s
    s.stop()


def test_viewer_endpoints(server):
    s = server
    s.step()   # one manual frame (no render thread)
    assert b"rtm_tpu_torch" in _get(s, "/").read()
    img = decode_png(_get(s, "/frame.png").read())
    assert img.shape == (16, 16, 3) and img.std() > 0
    state = _state(s)
    assert state["frame_index"] == 1 and state["width"] == CFG.width
    assert state["device"] == "cpu" and state["backend"] == "auto"
    s.step()
    assert _state(s)["frame_index"] == 2
    # movement input resets accumulation (reference RayTracing.cpp:625)
    assert _post(s, "/input", {"keys": ["w"]}) == {}
    s.step()   # drains the event, then renders frame 1 of the new view
    assert _state(s)["frame_index"] == 1


def test_scene_endpoint_without_editor(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/scene")
    assert e.value.code == 404


def test_viewer_settings_parity(server):
    """Settings-panel round trip (ref RayTracing.cpp:73-150): slider edits
    apply without resetting accumulation; Reset and camera edits reset."""
    s = server
    s.step()
    s.step()
    assert _post(s, "/settings", {"max_bounces": 3})["ok"]
    assert s.renderer.cfg.max_bounces == 3
    s.step()
    st = _state(s)
    assert st["frame_index"] == 3 and st["max_bounces"] == 3
    assert _post(s, "/settings", {"accumulate": False})["ok"]
    s.step()
    assert _state(s)["frame_index"] == 1
    assert _post(s, "/settings", {"accumulate": True})["ok"]
    s.step()
    s.step()
    assert _post(s, "/settings", {"reset": True})["ok"]
    s.step()
    assert _state(s)["frame_index"] == 1
    assert _post(s, "/settings", {"fov": 60.0})["ok"]
    s.step()
    st = _state(s)
    assert st["fov"] == 60.0 and st["frame_index"] == 1


def test_viewer_edit_endpoint():
    from test_torch_editor import small_scene

    scene = small_scene(rtm_tpu_torch)
    r = ProgressiveRenderer(scene, Camera(), CFG, device="cpu")
    s = ViewerServer(r, host_scene=scene)
    s.serve()
    try:
        s.step()
        before = decode_png(_get(s, "/frame.png").read())
        snap = json.loads(_get(s, "/scene").read())
        assert len(snap["materials"]) == 2 and len(snap["spheres"]) == 2
        resp = _post(s, "/edit", {"op": "set_sphere", "index": 0,
                                  "radius": 0.9})
        assert resp["ok"] and scene.spheres[0].radius == 0.9
        assert r.frame_index == 0 and r.scene.device.type == "cpu"
        s.step()
        assert not np.array_equal(decode_png(_get(s, "/frame.png").read()),
                                  before)
        # a bad op is a 400 and leaves the scene as it was
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(s, "/edit", {"op": "nope"})
        assert e.value.code == 400 and len(scene.spheres) == 2
    finally:
        s.stop()


def test_render_thread_runs_resets_and_stops():
    """start(): the render thread steps the renderer and publishes frames;
    input resets the accumulation; {"close": true} (AppClose) stops the
    viewer from its own render thread, and stop() then joins both
    threads."""
    scene = build_tracer_scene(load_scene(1), device="cpu")
    s = ViewerServer(ProgressiveRenderer(scene, Camera(), CFG), port=0)
    s.start()
    try:
        deadline = time.monotonic() + 120
        while s.frames_encoded < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert s.frames_encoded >= 3
        img = decode_png(_get(s, "/frame.png").read())
        assert img.shape == (16, 16, 3)
        high = _state(s)["frame_index"]
        assert high >= 3
        # the frame index when the key event has been handled, on the
        # render thread, after the controller's handler
        after_key = []
        s.bus.register(KeyPressed,
                       lambda e: after_key.append(s.renderer.frame_index))
        p0 = _state(s)["position"]
        _post(s, "/input", {"keys": ["w"]})
        while not after_key and time.monotonic() < deadline:
            time.sleep(0.05)
        assert after_key == [0]                  # accumulation reset
        assert _state(s)["position"] != p0
        _post(s, "/input", {"close": True})
        while s._running and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not s._running
    finally:
        s.stop()
    assert not s._threads


def test_roofline_estimate_matches_rtm_tpu_pairs():
    from rtm_tpu.bench.profile import megakernel_roofline as j_roof
    from rtm_tpu_torch.bench.profile import (FP32_OPS_PER_S, SWEEP_PAIR_OPS,
                                             megakernel_roofline)

    for w, h, b, spp, t, s in ((512, 512, 8, 1, 1756, 0),
                               (64, 48, 3, 2, 129, 9), (8, 8, 1, 1, 0, 3)):
        kw = dict(width=w, height=h, max_bounces=b, max_frames=spp)
        got = megakernel_roofline(RenderConfig(**kw), t, s)
        want = j_roof(rtm_tpu.RenderConfig(**kw), t, s)
        assert got["pairs"] == want["pairs"] > 0
        assert got["expected_ms_per_frame"] == pytest.approx(
            got["pairs"] * SWEEP_PAIR_OPS / FP32_OPS_PER_S * 1e3, rel=1e-12)
        assert got["ceiling_grays_per_sec"] > 0


def test_profile_trace_and_time_fn(tmp_path):
    from rtm_tpu_torch.bench.profile import time_fn, trace

    x = torch.rand(64, 64)
    with trace(tmp_path / "tr") as prof:
        (x @ x).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert prof.key_averages()
    assert time_fn(torch.matmul, x, x, iters=3) > 0.0


def test_cli_view_serves(monkeypatch, capsys):
    """`view --device cpu` builds the renderer and the editor and serves;
    here start() is replaced by one manual frame and a stop."""
    from rtm_tpu_torch.__main__ import main

    served = {}

    def start(self, block=False):
        self.step()
        served.update(block=block, png=self._frame_png[:8],
                      backend=self.renderer.backend,
                      editor=self.editor is not None,
                      accumulate=self.renderer.cfg.accumulate)
        self.stop()

    monkeypatch.setattr(ViewerServer, "start", start)
    assert main(["view", "--device", "cpu", "--scene", "1", "--width", "16",
                 "--height", "16", "--bounces", "2", "--port", "0"]) == 0
    assert served == dict(block=True, png=b"\x89PNG\r\n\x1a\n",
                          backend="auto", editor=True, accumulate=True)
    assert "viewer: http://127.0.0.1:" in capsys.readouterr().out


def test_decode_png_reads_encode_png():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
