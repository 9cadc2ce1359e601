"""Scene editor — runtime CRUD over materials/spheres/meshes/instances.

Port of rtm_tpu/runtime/editor.py: the headless realization of the
reference's ImGui scene editor
(RayTracing/src/RayTracing.cpp:164-463): the panels there mutate the host
scene and then either

  * partially update a GPU uniform in place when shapes are unchanged
    (Uniform::setData with offsetof — RayTracing.cpp:175-399), or
  * reallocate buffers + rewrite descriptor sets when an entity count
    changes (RayTracing.cpp:403-447),

and any visible edit resets progressive accumulation (frameIndex = 0).

Here the analogue of both paths is `_rebuild()`: re-flatten the host scene
into a fresh TracerScene on the renderer's device: one host build (the
native SAH builder) and one upload of the tables.  The dispatch then picks
its route from the new scene (an edit that takes the scene past the mxu
tables moves `auto` from the mxu kernel to trav).  Every edit resets
accumulation, matching the reference; `last_rebuild_s` holds the host
seconds of the last rebuild, the upload included.

Ops are plain dicts so they can arrive over the viewer's HTTP endpoint or be
scripted; `apply()` is the single entry point.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..io.scene_io import (instance_from_dict, instance_to_dict,
                           material_from_dict, material_to_dict,
                           sphere_from_dict, sphere_to_dict)
from ..models.mesh import Mesh
from ..models.scene import Scene, build_tracer_scene

_MAT_FIELDS = ("albedo", "emission_color", "roughness", "metallic",
               "emission_power", "refraction_ratio", "texture_id")
_SPH_FIELDS = ("position", "radius", "material_id")
_OBJ_FIELDS = ("mesh_id", "position", "scale", "rotation", "material_id")


class SceneEditor:
    """CRUD facade over a host Scene, attached to a ProgressiveRenderer (or
    anything with ``set_scene(TracerScene)`` and a ``scene``).  Maintains
    the host scene as the source of truth and pushes flattened rebuilds,
    built on the renderer's device, to the renderer."""

    def __init__(self, scene: Scene, renderer=None) -> None:
        if not isinstance(scene, Scene):
            raise TypeError("SceneEditor needs the host Scene (the mutable "
                            "editor model), not a flattened TracerScene")
        self.scene = scene
        self.renderer = renderer
        self._dirty = False
        self.last_rebuild_s = 0.0

    # ------------------------------------------------------------------ core
    def _rebuild(self) -> None:
        self._dirty = True
        if self.renderer is not None:
            t0 = time.perf_counter()
            dev = self.renderer.scene.device
            self.renderer.set_scene(build_tracer_scene(self.scene,
                                                       device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.last_rebuild_s = time.perf_counter() - t0

    def tracer_scene(self, device=None):
        """The host scene flattened on `device` (None: the renderer's
        device, or the card when there is no renderer)."""
        if device is None and self.renderer is not None:
            device = self.renderer.scene.device
        return build_tracer_scene(self.scene, device=device)

    # ------------------------------------------------------------- materials
    def add_material(self, **fields) -> int:
        i = self.scene.add_material(material_from_dict(fields))
        self._rebuild()
        return i

    def set_material(self, index: int, **fields) -> None:
        m = self.scene.materials[index]
        bad = set(fields) - set(_MAT_FIELDS)
        if bad:
            raise KeyError(f"unknown material fields {sorted(bad)}")
        self.scene.materials[index] = replace(
            m, **{k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                  for k, v in fields.items()})
        self._rebuild()

    def remove_material(self, index: int) -> None:
        """Delete a material and repoint users (the reference blocks deleting
        a referenced material in UI; we repoint to 0 like its fallback)."""
        del self.scene.materials[index]
        for s in self.scene.spheres:
            if s.material_id == index:
                s.material_id = 0
            elif s.material_id > index:
                s.material_id -= 1
        for o in self.scene.objects:
            if o.material_id == index:
                o.material_id = 0
            elif o.material_id > index:
                o.material_id -= 1
        self._rebuild()

    # ---------------------------------------------------------------- spheres
    def add_sphere(self, **fields) -> int:
        fields.setdefault("position", (0.0, 0.0, 0.0))
        fields.setdefault("radius", 1.0)
        i = self.scene.add_sphere(sphere_from_dict(fields))
        self._rebuild()
        return i

    def set_sphere(self, index: int, **fields) -> None:
        s = self.scene.spheres[index]
        bad = set(fields) - set(_SPH_FIELDS)
        if bad:
            raise KeyError(f"unknown sphere fields {sorted(bad)}")
        for k, v in fields.items():
            setattr(s, k, tuple(v) if k == "position" else
                    (int(v) if k == "material_id" else float(v)))
        self._rebuild()

    def remove_sphere(self, index: int) -> None:
        self.scene.remove_sphere(index)
        self._rebuild()

    # ----------------------------------------------------------------- meshes
    def load_mesh(self, path) -> int:
        """Load a glTF/OBJ file as a new mesh (ref mesh-add path,
        RayTracing.cpp:300-311)."""
        mesh = Mesh.load(path)
        mesh.source = str(path)
        i = self.scene.add_mesh(mesh)
        self._rebuild()
        return i

    def add_mesh(self, verts, uvs=None) -> int:
        i = self.scene.add_mesh(Mesh(np.asarray(verts, np.float32), uvs))
        self._rebuild()
        return i

    # -------------------------------------------------------------- instances
    def add_instance(self, **fields) -> int:
        fields.setdefault("mesh_id", 0)
        i = self.scene.add_object(instance_from_dict(fields))
        self._rebuild()
        return i

    def set_instance(self, index: int, **fields) -> None:
        o = self.scene.objects[index]
        bad = set(fields) - set(_OBJ_FIELDS)
        if bad:
            raise KeyError(f"unknown instance fields {sorted(bad)}")
        for k, v in fields.items():
            if k in ("mesh_id", "material_id"):
                setattr(o, k, int(v))
            else:
                setattr(o, k, np.asarray(v, np.float64))
        self._rebuild()

    def remove_instance(self, index: int) -> None:
        self.scene.remove_object(index)
        self._rebuild()

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON-able editor state (the viewer's scene panel model)."""
        s = self.scene
        return {
            "materials": [material_to_dict(m) for m in s.materials],
            "spheres": [sphere_to_dict(x) for x in s.spheres],
            "objects": [instance_to_dict(o) for o in s.objects],
            "meshes": [{"triangles": int(m.num_triangles),
                        "source": getattr(m, "source", None)}
                       for m in s.meshes],
            "textures": len(s.textures),
            "has_sky": s.sky is not None,
        }

    # ------------------------------------------------------------------- ops
    def apply(self, op: dict):
        """Apply one editor op (the viewer's POST /edit payload).

        op = {"op": <name>, ...args}; names mirror the methods above, e.g.
        {"op": "set_material", "index": 0, "albedo": [1,0,0]}.
        """
        op = dict(op)
        name = op.pop("op")
        allowed = {
            "add_material", "set_material", "remove_material",
            "add_sphere", "set_sphere", "remove_sphere",
            "load_mesh", "add_instance", "set_instance", "remove_instance",
        }
        if name not in allowed:
            raise KeyError(f"unknown editor op {name!r}")
        if name == "load_mesh":
            return self.load_mesh(op["path"])
        index = op.pop("index", None)
        fn = getattr(self, name)
        if name.startswith(("set_", "remove_")):
            return fn(int(index), **op) if name.startswith("set_") \
                else fn(int(index))
        return fn(**op)
