"""rtm_tpu_torch's event bus, application loop (runtime/events.py,
runtime/frame.py) and checkpoints (runtime/checkpoint.py) on the CPU.

The bus and Application follow tests/test_frame.py's and
tests/test_viewer.py's cases.  Checkpoints: round trips are exact (leaves
bitwise, dtypes and devices kept); an Adam `state_dict()` restored into a
fresh optimizer gives bitwise the same next steps; rtm_tpu's on-disk form
is kept, so a render state written by rtm_tpu loads in the port and one
written by the port loads in rtm_tpu, leaves bitwise.
"""
from __future__ import annotations

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu.diff.params import SceneParams as JParams
from rtm_tpu.runtime import checkpoint as jck
from rtm_tpu_torch.diff.params import SceneParams
from rtm_tpu_torch.runtime import checkpoint as ck
from rtm_tpu_torch.runtime.events import (AppClose, EventBus, KeyPressed,
                                          MouseMove)
from rtm_tpu_torch.runtime.frame import Application, Frame, RenderFrame


def test_event_bus_order_and_types():
    bus = EventBus()
    seen = []
    bus.register(KeyPressed, lambda e: seen.append(("k", e.key)))
    bus.register(MouseMove, lambda e: seen.append(("m", e.dx)))
    bus.emit(KeyPressed(key="w"))
    bus.emit(MouseMove(x=0, y=0, dx=3.0))
    bus.emit(KeyPressed(key="a"))
    assert bus.process() == 3
    assert seen == [("k", "w"), ("m", 3.0), ("k", "a")]
    assert bus.process() == 0


def test_app_close_event():
    bus = EventBus()
    closed = []
    bus.register(AppClose, lambda e: closed.append(1))
    bus.emit(AppClose())
    bus.process()
    assert closed == [1]


def test_custom_frame_lifecycle_and_close():
    calls = []

    class MyFrame(Frame):
        def on_init(self, app):
            calls.append("init")

        def layout(self, app):
            calls.append("layout")
            if calls.count("update") >= 2:
                app.close()

        def update(self, dt_ms):
            calls.append("update")
            assert dt_ms >= 0.0

        def on_shutdown(self):
            calls.append("shutdown")

    app = Application(MyFrame, max_iterations=50)
    # close() during layout of iteration 3 is drained at iteration 4
    assert app.run() == 3
    assert calls[0] == "init" and calls[-1] == "shutdown"
    assert calls.count("update") == 3


def test_app_close_event_stops_loop():
    class Idle(Frame):
        pass

    app = Application(Idle, max_iterations=100)
    app.bus.emit(AppClose())
    assert app.run() == 0


def test_render_frame_produces_image():
    """RenderFrame on the CPU: auto resolves to the kernels (their plain
    versions here), as the port's ProgressiveRenderer does; two
    iterations accumulate two frames."""
    cfg = rtm_tpu_torch.RenderConfig(width=24, height=16, max_bounces=3,
                                     accumulate=True)
    app = Application(lambda: RenderFrame(scene_id=5, cfg=cfg,
                                           device="cpu"), max_iterations=2)
    assert app.run() == 2
    img = app.frame.image
    assert img.shape == (16, 24, 3) and torch.isfinite(img).all()
    assert app.frame.renderer.backend == "auto"
    assert app.frame.renderer.frame_index == 2
    assert RenderFrame(backend="xla").backend == "xla"


def test_render_frame_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = Application(lambda: RenderFrame(scene_id=5), max_iterations=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.run()


# ---------------------------------------------------------------- checkpoint

def _params(pkg_params, arr, seed=0):
    rng = np.random.default_rng(seed)
    shapes = dict(albedo=(2, 3), emission_color=(2, 3), emission_power=(2,),
                  roughness=(2,), metallic=(2,), sph_pos=(3, 3),
                  sph_radius=(3,), tri_verts=(1, 3, 3))
    return pkg_params(**{k: arr(rng.standard_normal(s).astype(np.float32))
                         for k, s in shapes.items()})


def test_round_trip_nested_tree(tmp_path):
    Pt = collections.namedtuple("Pt", "a b")
    tree = {"z": [torch.arange(5), (np.float32(2.5), None)],
            "a": Pt(torch.ones(2, 3, dtype=torch.bfloat16), 7),
            "m": {"flag": True, "x": np.arange(4, dtype=np.int16)},
            "p": _params(SceneParams, torch.from_numpy)}
    path = tmp_path / "t.npz"
    ck.save_pytree(str(path), tree, extra={"note": "x"})
    like = {"z": [torch.zeros(5, dtype=torch.int64), (np.float32(0), None)],
            "a": Pt(torch.zeros(2, 3, dtype=torch.bfloat16), 0),
            "m": {"flag": False, "x": np.zeros(4, np.int16)},
            "p": _params(SceneParams, torch.from_numpy, seed=1)}
    got, extra = ck.load_pytree(str(path), like)
    assert extra == {"note": "x"}
    assert list(got) == list(like)                # key order of `like`
    assert torch.equal(got["z"][0], tree["z"][0])
    assert got["z"][1] == (np.float32(2.5), None)
    assert isinstance(got["a"], Pt) and got["a"].b == 7
    assert got["a"].a.dtype == torch.bfloat16
    assert torch.equal(got["a"].a, tree["a"].a)
    assert got["m"]["flag"] is True
    np.testing.assert_array_equal(got["m"]["x"], tree["m"]["x"])
    assert got["m"]["x"].dtype == np.int16
    for a, b in zip(got["p"].tensors(), tree["p"].tensors()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        ck.load_pytree(str(path), {"z": like["z"]})


def _adam(steps):
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(4, 3))
    q = torch.nn.Parameter(torch.randn(5))
    opt = torch.optim.Adam([p, q], lr=2e-2)
    for _ in range(steps):
        opt.zero_grad()
        ((p ** 2).sum() + (q ** 3).sum()).backward()
        opt.step()
    return p, q, opt


def test_adam_state_dict_round_trip(tmp_path):
    """save_render_state with an Adam state_dict; the restored optimizer
    continues bitwise as the original."""
    p, q, opt = _adam(3)
    accum = torch.rand(8, 8, 3)
    path = tmp_path / "run.npz"
    ck.save_render_state(str(path), accum, 3,
                         scene=[p.detach(), q.detach()],
                         opt_state=opt.state_dict())
    p2, q2, opt2 = _adam(1)                       # same structure
    like = {"accum": torch.zeros(8, 8, 3),
            "scene": [torch.zeros_like(p), torch.zeros_like(q)],
            "opt": opt2.state_dict()}
    state, fi = ck.load_render_state(str(path), like)
    assert fi == 3 and torch.equal(state["accum"], accum)
    with torch.no_grad():
        p2.copy_(state["scene"][0])
        q2.copy_(state["scene"][1])
    opt2.load_state_dict(state["opt"])
    for params, o in (((p, q), opt), ((p2, q2), opt2)):
        for _ in range(2):
            o.zero_grad()
            ((params[0] ** 2).sum() + (params[1] ** 3).sum()).backward()
            o.step()
    assert torch.equal(p, p2) and torch.equal(q, q2)


def test_render_state_interop_with_rtm_tpu(tmp_path):
    """A render state (accumulation buffer + SceneParams + an RNG key)
    written by rtm_tpu loads in the port, and the port's loads in
    rtm_tpu, leaves bitwise."""
    accum = np.random.default_rng(3).random((6, 5, 3)).astype(np.float32)
    key = np.array([0, 42], np.uint32)
    jpath = tmp_path / "jax.npz"
    jck.save_render_state(str(jpath), jnp.asarray(accum), 9,
                          scene=_params(JParams, jnp.asarray),
                          rng_key=jnp.asarray(key))
    like = {"accum": torch.zeros(6, 5, 3),
            "scene": _params(SceneParams, torch.from_numpy, seed=5),
            "key": np.zeros(2, np.uint32)}
    state, fi = ck.load_render_state(str(jpath), like)
    assert fi == 9
    np.testing.assert_array_equal(state["accum"].numpy(), accum)
    np.testing.assert_array_equal(state["key"], key)
    want = _params(SceneParams, torch.from_numpy)
    for a, b in zip(state["scene"].tensors(), want.tensors()):
        assert torch.equal(a, b)

    tpath = tmp_path / "port.npz"
    ck.save_render_state(str(tpath), state["accum"], fi,
                         scene=state["scene"], rng_key=state["key"])
    jlike = {"accum": jnp.zeros((6, 5, 3)),
             "scene": _params(JParams, jnp.asarray, seed=5),
             "key": jnp.zeros(2, jnp.uint32)}
    back, jfi = jck.load_render_state(str(tpath), jlike)
    assert jfi == 9
    np.testing.assert_array_equal(np.asarray(back["accum"]), accum)
    np.testing.assert_array_equal(np.asarray(back["key"]), key)
    for f in dataclasses.fields(JParams):
        np.testing.assert_array_equal(
            np.asarray(getattr(back["scene"], f.name)),
            getattr(want, f.name).numpy())
