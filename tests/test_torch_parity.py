"""Shared helpers of the rtm_tpu_torch parity tests (this module holds no
tests): scenes built by both packages, and a JAX scene carried into the
port as NumPy arrays."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import rtm_tpu
from rtm_tpu.accel.native import bvh_native

TRI_FIELDS = ("sph_pos", "sph_radius", "sph_mat", "tri_wa", "tri_wb",
              "tri_wc", "tri_la", "tri_lab", "tri_lac", "tri_normal",
              "tri_uv", "tri_mat", "tri_inv_model", "sky", "textures",
              "tex_size", "sky_quads", "tex_quads")


def host_scene(pkg_scenes, sid):
    """Built-in scene `sid` (1..5) or "gridK" (dragon_grid(K)) from either
    package's models.scenes."""
    if isinstance(sid, str) and sid.startswith("grid"):
        return pkg_scenes.dragon_grid(int(sid[4:]))
    return pkg_scenes.load_scene(sid)


def jax_scene(sid):
    """rtm_tpu's TracerScene built through its NumPy BVH builder, the one
    the port's builders match bitwise (rtm_tpu's native builder orders
    tied SAH splits of instanced copies differently)."""
    from rtm_tpu.models import scenes as jscenes

    mp = pytest.MonkeyPatch()
    mp.setattr(bvh_native, "build", lambda mesh: None)
    try:
        return rtm_tpu.build_tracer_scene(host_scene(jscenes, sid))
    finally:
        mp.undo()


def jax_scene_arrays(sj):
    """An rtm_tpu TracerScene's leaves as NumPy arrays plus its static
    metadata, in the form tracer_scene_from_numpy takes."""
    arrays = {f"materials.{f.name}": np.asarray(getattr(sj.materials, f.name))
              for f in dataclasses.fields(sj.materials)}
    arrays.update({name: np.asarray(getattr(sj, name))
                   for name in TRI_FIELDS})
    arrays.update({f"mxu_arrays.{k}": np.asarray(getattr(sj.mxu_arrays, k))
                   for k in ("pair", "attr", "info", "cbox")})
    arrays.update({f"trav_arrays.{k}": np.asarray(v)
                   for k, v in sj.trav_arrays._asdict().items()})
    mm = sj.mxu_meta
    meta = dict(any_textured=sj.any_textured,
                cluster_slices=sj.cluster_slices, env_sun=sj.env_sun,
                mxu_meta=dict(n_tris=mm.n_tris, nc=mm.nc,
                              supported=mm.supported,
                              textured_rows=mm.textured_rows),
                trav_meta=sj.trav_meta._asdict())
    return arrays, meta


def carry(sj, device="cpu"):
    """The port's TracerScene holding exactly the JAX scene's tables."""
    from rtm_tpu_torch.models.scene import tracer_scene_from_numpy

    return tracer_scene_from_numpy(*jax_scene_arrays(sj), device)
