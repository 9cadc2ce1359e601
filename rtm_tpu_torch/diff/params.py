"""Differentiable scene parameterization.

Port of rtm_tpu/diff/params.py.  `TracerScene` mixes float tensors with
integer ids and *derived* geometry (shader normals, the local-space arrays
of the UV quirk).  `SceneParams` holds the independent differentiable
parameters; `apply_params` rebuilds a consistent TracerScene from them
under autograd, so gradients flow through every derived quantity (triangle
normals included).

Hit *topology* (which primitive a sweep picks) is detached: gradients flow
through the hit distance, normal and shading of the chosen primitive.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SceneParams:
    """All-float tensors of optimizable scene parameters."""

    albedo: torch.Tensor            # (M,3)
    emission_color: torch.Tensor    # (M,3)
    emission_power: torch.Tensor    # (M,)
    roughness: torch.Tensor         # (M,)
    metallic: torch.Tensor          # (M,)
    sph_pos: torch.Tensor           # (S,3)
    sph_radius: torch.Tensor        # (S,)
    tri_verts: torch.Tensor         # (T,3,3) world-space A,B,C

    def fields(self) -> tuple:
        return tuple(f.name for f in dataclasses.fields(self))

    def tensors(self) -> list:
        return [getattr(self, k) for k in self.fields()]

    def map(self, fn) -> "SceneParams":
        """A SceneParams of fn(tensor) for every field."""
        return SceneParams(*(fn(t) for t in self.tensors()))


def extract_params(scene) -> SceneParams:
    m = scene.materials
    return SceneParams(
        albedo=m.albedo, emission_color=m.emission_color,
        emission_power=m.emission_power, roughness=m.roughness,
        metallic=m.metallic, sph_pos=scene.sph_pos,
        sph_radius=scene.sph_radius,
        tri_verts=torch.stack([scene.tri_wa, scene.tri_wb, scene.tri_wc],
                              dim=1))


def scene_params_from_numpy(arrays: dict, device) -> SceneParams:
    """rtm_tpu's SceneParams carried into the port: `arrays` maps each
    field name to its NumPy array."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True,
                                          order="C")).to(device)

    return SceneParams(*(t(arrays[f.name])
                         for f in dataclasses.fields(SceneParams)))


def apply_params(scene, p: SceneParams, rebuild_tri_geometry: bool = True):
    """Rebuild a consistent TracerScene from parameters (under autograd).

    rebuild_tri_geometry: when True (vertex optimization), triangle normals
    and the local-space UV-quirk arrays are recomputed from the world
    vertices through each triangle's stored world->local instance
    transform (scene.tri_inv_model), so optimizing the vertices of an
    instanced scene keeps exact UV parity; when False, only materials and
    spheres update and the triangle data keeps its build-time values."""
    mats = dataclasses.replace(
        scene.materials, albedo=p.albedo, emission_color=p.emission_color,
        emission_power=p.emission_power, roughness=p.roughness,
        metallic=p.metallic)
    out = dataclasses.replace(scene, materials=mats, sph_pos=p.sph_pos,
                              sph_radius=p.sph_radius)
    if rebuild_tri_geometry and scene.num_triangles > 0:
        a = p.tri_verts[:, 0]
        b = p.tri_verts[:, 1]
        c = p.tri_verts[:, 2]
        ab = b - a
        ac = c - a
        # shader-normal parity: cross on LOCAL vertices mapped through the
        # model matrix (NOT inverse-transpose, shader:252-255).  local
        # edges = R_w2l @ world edges, and model = R_w2l^-1, so the shader
        # normal is R_w2l^-1 @ cross(R_w2l ab, R_w2l ac)
        rot = scene.tri_inv_model[:, :, :3]                    # (T,3,3)
        off = scene.tri_inv_model[:, :, 3]                     # (T,3)
        # per-triangle 3x3 products elementwise: full f32 on the card
        # whatever the caller's TF32 flags
        la = (rot * a[:, None, :]).sum(dim=-1) + off
        lab = (rot * ab[:, None, :]).sum(dim=-1)
        lac = (rot * ac[:, None, :]).sum(dim=-1)
        n_local = torch.linalg.cross(lab, lac, dim=-1)
        # model rotation = inv(rot): solve instead of transpose so
        # non-orthogonal (scaled) instances stay exact
        n = torch.linalg.solve(rot, n_local[..., None])[..., 0]
        norm = torch.linalg.norm(n, dim=-1, keepdim=True)
        n = n / torch.clamp(norm, min=1e-30)
        out = dataclasses.replace(out, tri_wa=a, tri_wb=b, tri_wc=c,
                                  tri_la=la, tri_lab=lab, tri_lac=lac,
                                  tri_normal=n)
    return out
