"""A frame of the fused routes (mxu, trav, megakernel) makes no host wait.

On the card a host wait is a `cudaStreamSynchronize`, a pageable
host-to-device copy or a device-to-host read; chip_smoke.py's [host-waits]
counts them there.  Here, on the CPU, the same frames run through the
kernels' plain versions, and these tests hold the code around the kernels
to what makes such waits: reads of a tensor's value on the host, tensors
made from host data inside a frame, and ops whose output size depends on
the data.  Each frame stays bitwise equal to the frame the port rendered
before (a spec of separate CPU tensors, and for textured scenes the
compacted post-pass at capacity n), and the post-pass stays within
rtm_tpu's tolerance.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.pallas import megakernel as jmk
from rtm_tpu_torch.models.camera import CameraSpec
from rtm_tpu_torch.ops.kernels import megakernel as tmk
from rtm_tpu_torch.ops.kernels import mxu_kernel as tmx
from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
from rtm_tpu_torch.runtime.editor import SceneEditor
from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
from test_torch_parity import carry, jax_scene

ROOT = Path(__file__).resolve().parents[1]
FUSED = ("mxu", "trav", "megakernel")
RES = 16
BOUNCES = 4

# ops whose result size depends on the data: on a card each reads a count
# back to the host
_SIZE_FROM_DATA = {"aten.nonzero.default", "aten.repeat_interleave.Tensor",
                   "aten.masked_select.default", "aten._unique2.default",
                   "aten.unique_consecutive.default"}


class HostWaitScan(TorchDispatchMode):
    """Records, outside the kernel calls, every op that would make the host
    wait on a card: a tensor's value read on the host
    (`_local_scalar_dense`: item, int, float, bool), an op whose output
    size depends on the data, and any use of a tensor made from host data
    (`torch.tensor`, `torch.from_numpy`, `t[i] = x` lift it; on a card
    each such tensor is a pageable copy), except a fill, which reads it on
    the host only."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()
        self.inside_kernel = 0
        self._lifted = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        lifted = [a for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor) and id(a) in self._lifted]
        if not self.inside_kernel and (
                name == "aten._local_scalar_dense.default"
                or name in _SIZE_FROM_DATA
                or (lifted and name != "aten.fill_.Tensor")):
            self.hits[name] += 1
        out = func(*args, **kwargs)
        if name == "aten.lift_fresh.default":
            self._lifted[id(out)] = out
        return out

    @contextlib.contextmanager
    def around_kernels(self, monkeypatch, *also):
        """Exempt the kernel calls (on the card each is one launch) and the
        (owner, name) functions in `also`."""
        for owner, name in ((tmx, "mxu_trace"), (ttk, "trav_trace"),
                            (tmk, "mega_trace")) + also:
            monkeypatch.setattr(owner, name,
                                self._exempt(getattr(owner, name)))
        yield self

    def _exempt(self, fn):
        def call(*a, **kw):
            self.inside_kernel += 1
            try:
                return fn(*a, **kw)
            finally:
                self.inside_kernel -= 1
        return call


def _scene(sid=3):
    return rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(sid),
                                            device="cpu")


def _cfg(res=RES, bounces=BOUNCES, frames=1):
    return rtm_tpu_torch.RenderConfig(width=res, height=res,
                                      max_bounces=bounces, max_frames=frames,
                                      draw_environment=True)


def _field_spec(cam, w, h):
    """The spec as the port built it before it carried the kernels' row:
    each field its own CPU tensor, so `_pack_camera` packs the row from
    the fields."""
    def f32(v):
        return torch.from_numpy(np.asarray(v, np.float32))

    return CameraSpec(f32(cam.inv_projection(w, h)), f32(cam.inv_view()),
                      f32(cam.position), f32(cam.focus_distance),
                      f32(cam.defocus_strength), f32(cam.blur_strength))


def _cameras():
    orbit = rtm_tpu_torch.Camera()
    orbit.orbit(37.0, radius=3.5)
    moved = rtm_tpu_torch.Camera(fov=60.0, defocus_strength=0.3,
                                 blur_strength=0.7, focus_distance=2.5)
    moved.move(forward=0.4, right=-1.25, up=0.3, dt=0.5)
    return {"default": rtm_tpu_torch.Camera(), "orbit": orbit,
            "move": moved}


# ---------------------------------------------------------------------------
# The post-pass reads no count on the host
# ---------------------------------------------------------------------------

N = RES * RES
PP_BOUNCES = 8
PP_FRAMES = 2


def _textured_records(seed: int, p_sig: float):
    """(color, miss, rec) as the kernels emit them over scene 3 (no
    spheres): each (frame, bounce, ray) slot significant with probability
    p_sig, emissive, textured or both."""
    rng = np.random.default_rng(seed)
    fb = PP_FRAMES * PP_BOUNCES
    sig = rng.random((fb, N)) < p_sig
    kind = rng.integers(0, 3, (fb, N))
    rec = np.zeros((fb, 8, N), np.float32)
    rec[:, 6] = -1.0
    emis = sig & (kind != 1)
    tex = sig & (kind != 0)
    rec[:, 0:3] = rng.uniform(0.01, 2.0, (fb, 3, N)) * emis[:, None]
    rec[:, 3:5] = np.where(tex[:, None], rng.uniform(-3, 10, (fb, 2, N)),
                           0.0)
    rec[:, 6] = np.where(tex, 0.0, -1.0)
    miss = np.zeros((PP_FRAMES, 8, N), np.float32)
    valid = rng.random((PP_FRAMES, N)) < 0.6
    d = rng.normal(size=(PP_FRAMES, 3, N))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss[:, 0:3] = d * valid[:, None]
    miss[:, 3:6] = rng.uniform(0, 1, (PP_FRAMES, 3, N))
    miss[:, 6] = valid
    color = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    per_frame = sig.reshape(PP_FRAMES, PP_BOUNCES * N).sum(axis=1)
    return (color, miss.reshape(8 * PP_FRAMES, N),
            rec.reshape(8 * fb, N), per_frame)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a tensor's value was read on the host")

    for name in ("item", "__int__", "__float__", "__bool__", "tolist",
                 "numpy", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    yield


_FORMS = {
    "mega_postpass": lambda *a: tmk.mega_postpass(*a),
    "compact_cap_n": lambda *a: tmk.mega_postpass_compact(*a, cap=N),
    "compact_cap_nB": lambda *a: tmk.mega_postpass_compact(
        *a, cap=N * PP_BOUNCES),
}


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("regime,p_sig,seed", [("fits", 0.08, 21),
                                               ("overflows", 0.6, 22)])
def test_postpass_reads_nothing_on_the_host(monkeypatch, form, regime,
                                            p_sig, seed):
    """Textured records where each frame's significant count fits the
    compact capacity n, and where it overflows it (many textured
    bounces): every form runs with host reads refused, equals the dense
    form bitwise, and stays within rtm_tpu's tolerance of rtm_tpu's
    `mega_postpass` (its compact form with `lax.cond`)."""
    sj = jax_scene(3)
    st = carry(sj)
    color, miss, rec, per_frame = _textured_records(seed, p_sig)
    assert (per_frame <= N).all() if regime == "fits" else (
        per_frame > N).all()
    kw = dict(width=RES, height=RES, max_bounces=PP_BOUNCES,
              max_frames=PP_FRAMES, draw_environment=True)
    jc, tc = rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)
    args = [torch.from_numpy(a) for a in (color, miss, rec)]
    dense = tmk.mega_postpass_dense(*args, st, tc, N)
    with _no_host_reads(monkeypatch):
        got = _FORMS[form](*args, st, tc, N)
    monkeypatch.undo()
    assert got.shape == (N, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    want = np.asarray(jmk.mega_postpass(
        jnp.asarray(color), jnp.asarray(miss), jnp.asarray(rec), sj, jc, N))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-6)


# ---------------------------------------------------------------------------
# The camera row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_cameras()))
def test_camera_row_is_the_packed_spec(name):
    """Camera.row, the spec's row and _pack_camera of any spec hold the
    same 64 floats, bitwise: those the port packed from a spec of
    separate field tensors, and those rtm_tpu packs (its `_pack_camera`);
    the new spec's fields equal the old ones bitwise."""
    cam = _cameras()[name]
    w, h = 24, 16
    old = _field_spec(cam, w, h)
    want = tmk._pack_camera(old).numpy()
    spec = cam.spec(w, h, device="cpu")
    jcam = rtm_tpu.Camera(**{f.name: getattr(cam, f.name)
                             for f in dataclasses.fields(cam)})
    jrow = np.asarray(jmk._pack_camera(jcam.spec(w, h)))[0]
    for got in (cam.row(w, h), spec.row.numpy(),
                tmk._pack_camera(spec).numpy(),
                tmk._pack_camera(spec, torch.device("cpu")).numpy(),
                tmk._pack_camera(dataclasses.replace(spec)).numpy(), jrow):
        np.testing.assert_array_equal(got, want)
    for f in dataclasses.fields(CameraSpec):
        if f.name != "row":
            np.testing.assert_array_equal(getattr(spec, f.name).numpy(),
                                          getattr(old, f.name).numpy())
    assert dataclasses.replace(spec).row is None


@contextlib.contextmanager
def _count_host_uploads(monkeypatch):
    """Counts torch.tensor / torch.as_tensor calls and Tensor.to calls
    that name a device: each moves host data to the scene's device."""
    counts = collections.Counter()

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    to = torch.Tensor.to

    def to_counted(self, *a, **kw):
        if "device" in kw or any(isinstance(x, (str, torch.device))
                                 for x in a):
            counts["Tensor.to"] += 1
        return to(self, *a, **kw)

    monkeypatch.setattr(torch, "tensor", counted("torch.tensor",
                                                 torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", counted("torch.as_tensor",
                                                    torch.as_tensor))
    monkeypatch.setattr(torch.Tensor, "to", to_counted)
    yield counts


@pytest.mark.parametrize("backend", FUSED)
def test_step_async_uploads_nothing(monkeypatch, backend):
    """ProgressiveRenderer.step_async rebuilds the camera's spec every
    frame; frames 2 and 3, with the camera moved between them, call
    neither torch.tensor nor Tensor.to with a device, and make no op that
    would wait on a card outside Camera.spec (whose one upload is a copy
    from pinned memory there)."""
    r = ProgressiveRenderer(_scene(3), cfg=_cfg(), backend=backend)
    r.step_async()
    with _count_host_uploads(monkeypatch) as counts, \
            HostWaitScan().around_kernels(
                monkeypatch, (rtm_tpu_torch.Camera, "spec")) as scan:
        with scan:
            r.step_async()
            r.camera.move(right=0.25)
            out = r.step_async()
    assert dict(counts) == {} and dict(scan.hits) == {}
    assert out.shape == (RES, RES, 3) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# The megakernel's index tables, once per scene
# ---------------------------------------------------------------------------

def _pack_arrays(pack):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in pack._asdict().items()}


def _assert_packs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_mega_pack_uploads_its_index_once(monkeypatch):
    """A second build_mega_pack of one scene uploads nothing and gives the
    same tables bitwise; its kernel arguments are the first call's."""
    st = rtm_tpu_torch.build_tracer_scene(
        rtm_tpu_torch.models.scenes.dragon_grid(4), device="cpu")
    first = tmk.build_mega_pack(st)
    with _count_host_uploads(monkeypatch) as counts:
        monkeypatch.setattr(torch, "from_numpy", lambda *_: pytest.fail(
            "build_mega_pack uploaded host data again"))
        second = tmk.build_mega_pack(st)
    monkeypatch.undo()
    assert dict(counts) == {}
    assert first.n_clusters == len(st.cluster_slices) > 1
    _assert_packs_equal(_pack_arrays(first), _pack_arrays(second))
    assert second.offsets_dev is first.offsets_dev


def test_mega_pack_follows_an_editor_rebuild():
    """A SceneEditor edit makes a new TracerScene; its pack is that of
    the new host scene built afresh, not the old scene's."""
    host = rtm_tpu_torch.load_scene(3)
    r = ProgressiveRenderer(_scene(3), cfg=_cfg(), backend="megakernel")
    ed = SceneEditor(host, r)
    old_scene = r.scene
    old = _pack_arrays(tmk.build_mega_pack(old_scene))
    r.step_async()
    ed.add_instance(mesh_id=0, material_id=0,
                    translation=(0.3, 0.2, -0.4))
    assert r.scene is not old_scene
    new = _pack_arrays(tmk.build_mega_pack(r.scene))
    fresh = _pack_arrays(tmk.build_mega_pack(
        rtm_tpu_torch.build_tracer_scene(host, device="cpu")))
    _assert_packs_equal(new, fresh)
    assert (new["cluster_widths"] != old["cluster_widths"]
            or not torch.equal(new["tri_feats"], old["tri_feats"]))
    assert r.step_async().shape == (RES, RES, 3)


# ---------------------------------------------------------------------------
# Every spec names its device
# ---------------------------------------------------------------------------

def test_every_spec_call_names_its_device():
    """Static: every `.spec(` call in the package and in chip_smoke.py
    passes device=, so no caller leaves the camera on the host by
    default."""
    files = sorted((ROOT / "rtm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    seen, bad = 0, []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "spec"):
                seen += 1
                if not any(k.arg == "device" for k in node.keywords):
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno}")
    assert seen > 20 and not bad, bad


# ---------------------------------------------------------------------------
# The whole frame
# ---------------------------------------------------------------------------

def _compact_at_n(color, miss, rec, scene, cfg, n):
    return tmk.mega_postpass_compact(color, miss, rec, scene, cfg, n, cap=n)


@pytest.mark.parametrize("backend", FUSED)
def test_frames_equal_the_earlier_frames(monkeypatch, backend):
    """render_progressive on scene 3 (textured) through each fused route's
    plain version: the frames with the spec on the scene's device and the
    dense post-pass equal bitwise those with a spec of separate CPU field
    tensors and the compacted post-pass at capacity n, the port's frame
    before this change; and a steady frame makes no op that would wait on
    a card."""
    st = _scene(3)
    cfg = _cfg(res=32, bounces=BOUNCES, frames=2)
    cam = rtm_tpu_torch.Camera()
    got = rtm_tpu_torch.render_progressive(
        st, cam.spec(32, 32, device=st.device), cfg, 2, backend=backend)
    with monkeypatch.context() as mp:
        for mod in (tmk, tmx, ttk):
            mp.setattr(mod, "mega_postpass", _compact_at_n)
        want = rtm_tpu_torch.render_progressive(
            st, _field_spec(cam, 32, 32), cfg, 2, backend=backend)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    spec = cam.spec(32, 32, device=st.device)
    with HostWaitScan().around_kernels(monkeypatch) as scan, scan:
        rtm_tpu_torch.render_dispatch(st, spec, 3, cfg, backend=backend)
    assert dict(scan.hits) == {}


def test_scan_sees_what_waits():
    """The scan flags each kind of op it looks for."""
    x = torch.arange(6.0)
    with HostWaitScan() as scan:
        int(x.sum())
        torch.nonzero(x > 2)
        x[torch.tensor([1, 2])]
        y = torch.zeros(3)
        y[1:].fill_(2.0)
    assert scan.hits == {"aten._local_scalar_dense.default": 1,
                         "aten.nonzero.default": 1,
                         "aten.index.Tensor": 1}
