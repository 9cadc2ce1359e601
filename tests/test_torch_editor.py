"""rtm_tpu_torch's scene editor (runtime/editor.py) against rtm_tpu's.

The same op sequence applied in both packages gives equal `snapshot()`s
and, after every op, the same scene tables: rtm_tpu's editor scene (built
with its NumPy SAH builder, which the port's builders match bitwise) is
carried into the port and compared with the port's own build field by
field, tensors bitwise (`models.scene.scene_diff`).  The
editor rebuilds on its renderer's device, resets the accumulation, and
moves `auto` from the mxu kernel to trav once an edit takes the scene
past the mxu tables.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.accel.native import bvh_native as j_native
from rtm_tpu.runtime.editor import SceneEditor as JEditor
from rtm_tpu_torch.ops.trace_ref import auto_backend
from rtm_tpu_torch.runtime.editor import SceneEditor
from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer
from rtm_tpu_torch.models.scene import scene_diff
from test_torch_parity import carry

CFG = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3,
                                 draw_environment=True, accumulate=True)
TRI = np.array([[[-1, -1, -3], [1, -1, -3], [0, 1, -3]]], np.float32)

OPS = [
    {"op": "set_material", "index": 0, "albedo": [0.1, 0.9, 0.1]},
    {"op": "add_material", "albedo": [0.2, 0.3, 0.9], "roughness": 0.4},
    {"op": "add_sphere", "position": [1, 0, -2], "radius": 0.3,
     "material_id": 1},
    {"op": "set_sphere", "index": 2, "radius": 0.6},
    ("add_mesh", TRI),
    {"op": "add_instance", "mesh_id": 0, "material_id": 2,
     "position": [0, 0, 0]},
    {"op": "set_instance", "index": 0, "position": [0, 0, -1],
     "rotation": [0, 45, 0], "scale": [1.5, 1.0, 1.0]},
    {"op": "remove_sphere", "index": 0},
    {"op": "remove_material", "index": 0},
    {"op": "set_material", "index": 1, "emission_power": 3.0,
     "emission_color": [1, 0.5, 0.2]},
]


def small_scene(pkg):
    """tests/test_editor.py's small_scene in either package."""
    s = pkg.Scene(sky=np.full((4, 8, 3), 0.5, np.float32))
    s.add_material(pkg.Material((0.8, 0.2, 0.2)))
    s.add_material(pkg.Material((1, 1, 1), (1, 1, 1), 0, 0, 2.0))
    s.add_sphere(pkg.SphereDef((0.0, 0.0, -2.0), 0.7, 0))
    s.add_sphere(pkg.SphereDef((0.0, 2.0, -2.0), 0.5, 1))
    return s


def _apply(ed, op):
    if isinstance(op, tuple):
        return getattr(ed, op[0])(*op[1:])
    return ed.apply(dict(op))


def _jax_tables(ed):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "build", lambda mesh: None)
    try:
        return carry(ed.tracer_scene())
    finally:
        mp.undo()


def test_op_sequence_matches_rtm_tpu():
    jed = JEditor(small_scene(rtm_tpu))
    ted = SceneEditor(small_scene(rtm_tpu_torch))
    for op in OPS:
        assert _apply(ted, op) == _apply(jed, op), op
        assert ted.snapshot() == jed.snapshot(), op
        got = ted.tracer_scene(device="cpu")
        assert scene_diff(got, _jax_tables(jed)) == [], op
    assert len(ted.scene.objects) == 1 and len(ted.scene.spheres) == 2


def test_rebuild_on_the_renderers_device_resets_and_reroutes():
    from rtm_tpu_torch.models.scenes import dragon_grid

    scene = small_scene(rtm_tpu_torch)
    r = ProgressiveRenderer(scene, cfg=CFG, device="cpu")
    r.step()
    r.step()
    ed = SceneEditor(scene, r)
    before = r.step().clone()
    ed.apply({"op": "set_material", "index": 0, "albedo": [0.1, 0.9, 0.1]})
    assert r.frame_index == 0 and r.scene.device.type == "cpu"
    assert ed.last_rebuild_s > 0.0
    assert not torch.equal(r.step(), before)
    assert auto_backend(r.scene, "cpu") == "mxu"
    # a mesh beyond the mxu tables' 2047 triangles (dragon_grid(11)'s
    # world soup, 2420): auto takes trav
    soup = rtm_tpu_torch.build_tracer_scene(dragon_grid(11), order="buffer",
                                            device="cpu")
    verts = torch.stack([soup.tri_wa, soup.tri_wb, soup.tri_wc], 1).numpy()
    mid = ed.add_mesh(verts)
    ed.apply({"op": "add_instance", "mesh_id": mid, "material_id": 1,
              "position": [0, 0, -30]})
    assert r.scene.num_triangles == len(verts) == 2420
    assert auto_backend(r.scene, "cpu") == "trav"
    img = r.step()
    assert r.frame_index == 1 and torch.isfinite(img).all()


def test_editor_rejects_unknown_op_and_fields():
    ed = SceneEditor(small_scene(rtm_tpu_torch))
    with pytest.raises(KeyError):
        ed.apply({"op": "drop_tables"})
    with pytest.raises(KeyError):
        ed.apply({"op": "set_material", "index": 0, "shininess": 3})
    with pytest.raises(TypeError, match="host Scene"):
        SceneEditor(rtm_tpu_torch.build_tracer_scene(
            small_scene(rtm_tpu_torch), device="cpu"))


def test_tracer_scene_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ed = SceneEditor(small_scene(rtm_tpu_torch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ed.tracer_scene()
    assert ed.tracer_scene(device="cpu").device.type == "cpu"
