"""The benchmark's one door into the system under test, rtm_tpu_torch.

Everything the harness hands the program goes through here: the scene
description (as the program's host `Scene`), the camera and the render
settings.  The reference never imports this module.
"""
from __future__ import annotations

import numpy as np


def port_scene(desc):
    """The program's host Scene of a reference.scene.Description: the same
    arrays, handed over through the program's public constructors."""
    from rtm_tpu_torch import Material, Mesh, MeshInstance, Scene, SphereDef

    s = Scene(sky=desc.sky.copy())
    s.textures.extend(t.copy() for t in desc.textures)
    for m in desc.materials:
        s.add_material(Material(tuple(m[0]), tuple(m[1]), m[2], m[3], m[4],
                                m[5], int(m[6])))
    mesh_id = {}
    for name, (verts, uvs) in desc.meshes.items():
        mesh_id[name] = s.add_mesh(Mesh(verts.copy(), uvs.copy()))
    for mesh, pos, scale, rot, mat in desc.instances:
        s.add_object(MeshInstance(mesh_id=mesh_id[mesh],
                                  position=np.array(pos, float),
                                  scale=np.array(scale, float),
                                  rotation=np.array(rot, float),
                                  material_id=mat))
    for pos, radius, mat in desc.spheres:
        s.add_sphere(SphereDef(tuple(pos), radius, mat))
    return s


def port_camera(cam: dict):
    from rtm_tpu_torch import Camera

    return Camera(fov=cam["fov"], near=cam["near"], far=cam["far"],
                  position=np.array(cam["position"], float),
                  direction=np.array(cam["direction"], float),
                  focus_distance=cam["focus_distance"],
                  defocus_strength=cam["defocus_strength"],
                  blur_strength=cam["blur_strength"])


def render_config(render: dict, spp: int):
    from rtm_tpu_torch import RenderConfig

    return RenderConfig(width=render["width"], height=render["height"],
                        max_bounces=render["max_bounces"], max_frames=spp,
                        draw_environment=render["draw_environment"],
                        accumulate=True)
