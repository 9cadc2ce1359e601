"""rtm_tpu_torch's full-frame entry points vs rtm_tpu's, and the port's
rules: entry points on the card unless the caller asks for the CPU, loud
errors where rtm_tpu raises, and no import of JAX.  (The xla,
pallas and wavefront2 frames are held against rtm_tpu in
test_torch_intersect.py and test_torch_wavefront2.py.)

The port's `render_dispatch(backend="auto")` and `render_progressive` run
on a CPU scene (the kernel's plain version plus the post-pass) against
rtm_tpu's `backend="mxu_interpret"`, image against image with
`images_close` (tests/conftest.py).  The JAX side orders candidate hits
with the TPU kernel's approximate reciprocal, which flips about one record
in a thousand on scene 3's shared wall edges (test_torch_mxu.py); the
image criteria absorb those paths.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.trace_ref import render_dispatch as j_render_dispatch
from rtm_tpu.runtime.renderer import render_progressive as j_progressive
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.ops.kernels import mxu_kernel as tmk
from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
from rtm_tpu_torch.ops.trace_ref import auto_backend
from test_torch_parity import carry, host_scene, jax_scene

ROOT = Path(__file__).resolve().parents[1]

# name: (scene, width, height, bounces, samples per dispatch, frame_index)
DISPATCH = {
    "scene3": (3, 32, 32, 4, 1, 1),
    "scene1": (1, 32, 32, 4, 1, 2),
    "scene2_tail_2spp": (2, 24, 20, 3, 2, 5),
}
PROGRESSIVE = (3, 32, 32, 4, 3)     # scene, width, height, bounces, frames


def _cfgs(w, h, bounces, spp=1):
    kw = dict(width=w, height=h, max_bounces=bounces, max_frames=spp,
              draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _port_scene(sid):
    return rtm_tpu_torch.build_tracer_scene(host_scene(tscenes, sid),
                                            device="cpu")


@pytest.mark.parametrize("name", list(DISPATCH))
def test_render_dispatch_auto_matches_mxu_interpret(name, image_compare):
    sid, w, h, bounces, spp, fi = DISPATCH[name]
    jcfg, tcfg = _cfgs(w, h, bounces, spp)
    want = np.asarray(j_render_dispatch(
        jax_scene(sid), rtm_tpu.Camera().spec(w, h), jnp.uint32(fi), jcfg,
        backend="mxu_interpret"))
    st = _port_scene(sid)
    before = tmk.mxu_trace.launches
    got = rtm_tpu_torch.render_dispatch(st, rtm_tpu_torch.Camera().spec(w, h),
                                        fi, tcfg)
    assert tmk.mxu_trace.launches == before      # CPU: the plain version
    assert got.device.type == "cpu" and got.shape == (h, w, 3)
    assert torch.isfinite(got).all()
    image_compare(got.numpy(), want)


@pytest.fixture(scope="module")
def progressive_pair():
    sid, w, h, bounces, frames = PROGRESSIVE
    jcfg, tcfg = _cfgs(w, h, bounces)
    want = np.asarray(j_progressive(jax_scene(sid),
                                    rtm_tpu.Camera().spec(w, h), jcfg,
                                    frames, backend="mxu_interpret"))
    got = rtm_tpu_torch.render_progressive(
        _port_scene(sid), rtm_tpu_torch.Camera().spec(w, h), tcfg, frames)
    return want, got


def test_render_progressive_matches_jax(progressive_pair, image_compare):
    want, got = progressive_pair
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float(got.mean()) > 0.0
    image_compare(got.numpy(), want)


def test_progressive_renderer_steps_equal_render_progressive(
        progressive_pair):
    """ProgressiveRenderer / accumulate_step frame by frame give
    render_progressive's image; the accumulation buffer is updated in
    place."""
    sid, w, h, bounces, frames = PROGRESSIVE
    _, tcfg = _cfgs(w, h, bounces)
    r = rtm_tpu_torch.ProgressiveRenderer(host_scene(tscenes, sid),
                                          cfg=tcfg.replace(accumulate=True),
                                          device="cpu")
    assert r.scene.device.type == "cpu"
    buf = r.accum
    out = r.render(frames)
    assert r.accum is buf and r.frame_index == frames
    np.testing.assert_allclose(out.numpy(), progressive_pair[1].numpy(),
                               rtol=1e-6, atol=1e-7)
    r.reset()
    assert r.frame_index == 0 and not r.accum.any()


# rtm_tpu's accumulate_step renders through its default backend, "xla"
XLA_STEPS = (3, 16, 16, 4, 3)       # scene, width, height, bounces, frames


def test_accumulate_step_xla_matches_rtm_tpu_default_path(image_compare):
    """The port's accumulate_step(backend="xla") against rtm_tpu's
    accumulate_step (its default path), frame by frame: the accumulated
    display image of frames 1-3 within images_close."""
    from rtm_tpu.runtime.renderer import accumulate_step as j_step
    from rtm_tpu_torch.runtime.renderer import accumulate_step

    sid, w, h, bounces, frames = XLA_STEPS
    jcfg, tcfg = _cfgs(w, h, bounces)
    js, jcam = jax_scene(sid), rtm_tpu.Camera().spec(w, h)
    st, tcam = _port_scene(sid), rtm_tpu_torch.Camera().spec(w, h)
    jacc = jnp.zeros((h, w, 3), jnp.float32)
    tacc = torch.zeros((h, w, 3))
    for fi in range(1, frames + 1):
        jacc, want = j_step(js, jcam, jacc, fi, jcfg)
        tacc, got = accumulate_step(st, tcam, tacc, fi, tcfg, backend="xla")
        assert got.shape == (h, w, 3) and torch.isfinite(got).all()
        assert float(got.mean()) > 0.0
        image_compare(got.numpy(), np.asarray(want))


def test_progressive_renderer_takes_a_backend():
    """ProgressiveRenderer(backend="xla").step() is accumulate_step(
    backend="xla") frame by frame."""
    from rtm_tpu_torch.runtime.renderer import accumulate_step

    sid, w, h, bounces, frames = XLA_STEPS
    _, tcfg = _cfgs(w, h, bounces)
    tcfg = tcfg.replace(accumulate=True)
    r = rtm_tpu_torch.ProgressiveRenderer(_port_scene(sid), cfg=tcfg,
                                          backend="xla")
    assert r.backend == "xla"
    acc = torch.zeros((h, w, 3))
    tcam = rtm_tpu_torch.Camera().spec(w, h)
    for fi in range(1, frames + 1):
        got = r.step()
        acc, want = accumulate_step(r.scene, tcam, acc, fi, tcfg,
                                    backend="xla")
        assert torch.equal(got, want)
    assert rtm_tpu_torch.ProgressiveRenderer(r.scene).backend == "auto"


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = rtm_tpu_torch.load_scene(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rtm_tpu_torch.build_tracer_scene(host)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rtm_tpu_torch.ProgressiveRenderer(host)
    assert rtm_tpu_torch.build_tracer_scene(
        host, device="cpu").device.type == "cpu"


def test_auto_backend_resolution():
    st = _port_scene(3)
    for platform in ("cuda", "cpu", "tpu"):
        assert auto_backend(st, platform) == "mxu"
    assert auto_backend(st, "rocm") == "xla"
    big = dataclasses.replace(
        st, mxu_meta=st.mxu_meta._replace(supported=False))
    assert auto_backend(big, "cuda") == "trav"


def _soft_loss_pair(bounces, backend):
    """render_loss(soft_tau=0.05) on scene 2 at 16x16: rtm_tpu's (its xla
    route, op by op) and the port's on `backend`, against a grey target."""
    from rtm_tpu.diff import extract_params as j_extract
    from rtm_tpu.diff import render_loss as j_render_loss

    sj = jax_scene(2)
    st = carry(sj)
    jcfg, cfg = _cfgs(16, 16, bounces)
    want = j_render_loss.__wrapped__(
        j_extract(sj), sj, rtm_tpu.Camera().spec(16, 16),
        jnp.full((16, 16, 3), 0.5, jnp.float32), jnp.uint32(1), jcfg,
        backend="xla", soft_tau=0.05)
    got = rtm_tpu_torch.render_loss(
        rtm_tpu_torch.extract_params(st), st,
        rtm_tpu_torch.Camera().spec(16, 16), torch.full((16, 16, 3), 0.5), 1,
        cfg, backend=backend, soft_tau=0.05)
    return float(got), float(want)


@pytest.mark.parametrize("backend", ["xla", "pallas", "megakernel",
                                     "wavefront2"])
def test_unported_backends_raise(backend):
    """The soft primary visibility loss (soft_tau > 0) on each backend:
    xla and pallas (the intersect kernel's plain version here) give
    rtm_tpu's loss within rtol 1e-5; megakernel and wavefront2 raise
    ValueError from the per-bounce sweep, as rtm_tpu's do."""
    if backend in ("megakernel", "wavefront2"):
        with pytest.raises(ValueError, match="bounce_payload backend"):
            _soft_loss_pair(3, backend)
        return
    got, want = _soft_loss_pair(3, backend)
    assert np.isfinite(got) and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_unported_configurations_raise():
    """soft_tau on the flat preview renders and gives rtm_tpu's loss, an
    unknown backend raises, and a scene beyond both the mxu and the trav
    tables no longer raises: it renders through the megakernel (its
    plain version on the CPU)."""
    st = _port_scene(2)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    got, want = _soft_loss_pair(1, "xla")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, cfg = _cfgs(16, 16, 3)
    beyond = dataclasses.replace(
        st, mxu_meta=st.mxu_meta._replace(supported=False),
        trav_meta=st.trav_meta._replace(supported=False))
    want = rtm_tpu_torch.render_dispatch(beyond, cam, 1, cfg,
                                         backend="megakernel")
    for backend in ("auto", "mxu", "trav"):
        got = rtm_tpu_torch.render_dispatch(beyond, cam, 1, cfg,
                                            backend=backend)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        rtm_tpu_torch.render_dispatch(st, cam, 1, cfg, backend="mxu2")


@pytest.mark.parametrize("backend", ["auto", "mxu", "trav"])
def test_mxu_unsupported_scene_renders_through_trav(backend):
    """A scene beyond the mxu tables goes to the trav path, as in
    rtm_tpu; on the CPU that is the kernel's plain version."""
    st = _port_scene(2)
    big = dataclasses.replace(
        st, mxu_meta=st.mxu_meta._replace(supported=False))
    assert auto_backend(big, "cpu") == "trav"
    _, cfg = _cfgs(16, 16, 3)
    mxu_before, trav_before = tmk.mxu_trace.launches, ttk.trav_trace.launches
    got = rtm_tpu_torch.render_dispatch(
        big, rtm_tpu_torch.Camera().spec(16, 16), 1, cfg, backend=backend)
    assert (tmk.mxu_trace.launches, ttk.trav_trace.launches) == (
        mxu_before, trav_before)
    assert got.shape == (16, 16, 3) and torch.isfinite(got).all()
    assert float(got.mean()) > 0.0


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """Static: the interpreter here imports jax at start, so sys.modules
    cannot tell.  Every module of the package and chip_smoke.py."""
    files = sorted((ROOT / "rtm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"rtm_tpu_torch/accel/trav.py",
            "rtm_tpu_torch/ops/kernels/trav_kernel.py",
            "rtm_tpu_torch/ops/kernels/sweep_kernel.py",
            "rtm_tpu_torch/ops/wavefront2.py",
            "rtm_tpu_torch/diff/inverse.py",
            "rtm_tpu_torch/diff/silhouette.py",
            "rtm_tpu_torch/accel/native/bvh_native.py",
            "rtm_tpu_torch/ops/bvh_traverse.py",
            "rtm_tpu_torch/runtime/checkpoint.py",
            "rtm_tpu_torch/runtime/editor.py",
            "rtm_tpu_torch/runtime/events.py",
            "rtm_tpu_torch/runtime/frame.py",
            "rtm_tpu_torch/bench/profile.py",
            "rtm_tpu_torch/viewer/server.py",
            "rtm_tpu_torch/parallel/distributed.py",
            "rtm_tpu_torch/parallel/sharding.py",
            "rtm_tpu_torch/parallel/smoke.py",
            "rtm_tpu_torch/bench/scaling.py"} <= names
    banned = ("jax", "jaxlib", "ml_dtypes", "rtm_tpu")
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in banned]
    assert not bad, bad
