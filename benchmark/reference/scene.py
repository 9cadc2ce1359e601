"""The scene description a configuration file names, and the plain
reference's own tables built from it.

A configuration file (benchmark/configs/<name>.json) describes a scene as
data: materials, procedural textures and sky, meshes (literal triangles or
an indexed vertex list), instances with a translate / rotate-XYZ (degrees)
/ scale transform, grids of instances, spheres, the camera and the render
settings.  `describe` turns it into plain NumPy arrays; the harness hands
those same arrays to the program, and `build_tables` bakes the reference's
world-space triangle tables from them.  Nothing here imports the program.

The transform and the baked quantities follow the upstream renderer
(Ray-Tracing-Machine, Mesh.cpp:44-63 and RayTracing.shader:235-303):
world vertices through the model matrix, the hit normal as the local
cross product mapped through the model matrix (not its inverse
transpose), and the local vertex and edges kept for the texture UV.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Description:
    """One scene as plain arrays.  meshes: name -> (verts (T,3,3) f32,
    uvs (T,3,2) f32); instances: (mesh name, position (3,), scale (3,),
    rotation degrees (3,), material id); materials: rows of albedo (3),
    emission color (3), roughness, metallic, emission power, refraction
    ratio, texture id; spheres: (position (3,), radius, material id)."""

    materials: list
    meshes: dict
    instances: list
    spheres: list
    textures: list
    sky: np.ndarray
    camera: dict
    render: dict


def _u8(img: np.ndarray) -> np.ndarray:
    """8-bit quantised, as a loaded image file is."""
    return np.round(np.clip(img, 0, 1) * 255.0) / np.float32(255.0)


def make_image(spec: dict) -> np.ndarray:
    """A procedural (H, W, 3) f32 image: `gradient` (a horizon-to-zenith
    sky) or `checker` (an 8-texel checkerboard)."""
    kind = spec["kind"]
    if kind == "gradient":
        h, w = spec["h"], spec["w"]
        v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
        img = np.zeros((h, w, 3), np.float32)
        for c, (lo, span) in enumerate(spec["rgb"]):
            img[..., c] = lo + span * v
        return _u8(img)
    if kind == "checker":
        n, cell = spec["n"], spec["cell"]
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        c = ((xx // cell + yy // cell) % 2).astype(np.float32)
        lo, span = spec["levels"]
        return _u8(np.stack([c, c, c], axis=-1) * span + lo)
    raise ValueError(f"unknown image kind {kind!r}")


def make_mesh(spec: dict):
    """(verts (T,3,3) f32, uvs (T,3,2) f32) of a mesh entry: `triangles`
    (rows of a, b, c and optional uv a, uv b, uv c) or `vertices` +
    `faces` (+ `scale`)."""
    if "triangles" in spec:
        rows = spec["triangles"]
        verts = np.array([r[:3] for r in rows], np.float32).reshape(-1, 3, 3)
        uvs = np.array([r[3:6] if len(r) > 3 else [[0, 0]] * 3
                        for r in rows], np.float32).reshape(-1, 3, 2)
        return verts, uvs
    v = np.array(spec["vertices"], np.float32) * spec.get("scale", 1.0)
    f = np.array(spec["faces"], np.int64)
    verts = v[f]
    return verts, np.zeros((len(f), 3, 2), np.float32)


def describe(config: dict) -> Description:
    """The Description of a configuration file's contents."""
    meshes = {name: make_mesh(m) for name, m in config["meshes"].items()}
    instances = []
    for inst in config.get("instances", []):
        instances.append((inst["mesh"], np.array(inst["position"], float),
                          np.array(inst["scale"], float),
                          np.array(inst["rotation"], float),
                          int(inst["material"])))
    for g in config.get("instance_grids", []):
        k, pitch = g["k"], g["pitch"]
        for i in range(k):
            for j in range(k):
                instances.append((
                    g["mesh"],
                    np.array([pitch * (i - (k - 1) / 2), g["y"],
                              g["z0"] - pitch * j]),
                    np.array(g["scale"], float),
                    np.array([0.0, g["rot_step_deg"] * (i + j), 0.0]),
                    int(g["material"])))
    spheres = [(np.array(s["position"], float), float(s["radius"]),
                int(s["material"])) for s in config.get("spheres", [])]
    return Description(
        materials=[tuple(m) for m in config["materials"]], meshes=meshes,
        instances=instances, spheres=spheres,
        textures=[make_image(t) for t in config.get("textures", [])],
        sky=make_image(config["sky"]), camera=dict(config["camera"]),
        render=dict(config["render"]))


def _rotate(m: np.ndarray, angle: float, axis) -> np.ndarray:
    """m @ R(angle, axis) (glm::rotate)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    t = (1.0 - c) * axis
    r = np.eye(4)
    r[:3, :3] = np.array([
        [c + t[0] * axis[0], t[1] * axis[0] - s * axis[2],
         t[2] * axis[0] + s * axis[1]],
        [t[0] * axis[1] + s * axis[2], c + t[1] * axis[1],
         t[2] * axis[1] - s * axis[0]],
        [t[0] * axis[2] - s * axis[1], t[1] * axis[2] + s * axis[0],
         c + t[2] * axis[2]]])
    return m @ r


def model_matrix(position, scale, rotation_deg) -> np.ndarray:
    """translate, rotate X, Y, Z (degrees), scale (Mesh.cpp:44-63)."""
    m = np.eye(4)
    m[:3, 3] = position
    rot = np.radians(rotation_deg)
    for k in range(3):
        m = _rotate(m, rot[k], np.eye(3)[k])
    return m @ np.diag([*scale, 1.0])


@dataclass
class Tables:
    """The reference's flat scene, NumPy f32 (ids i32), in the
    description's own order: instances in order, each mesh's triangles
    in order."""

    wa: np.ndarray
    wb: np.ndarray
    wc: np.ndarray
    la: np.ndarray
    lab: np.ndarray
    lac: np.ndarray
    normal: np.ndarray
    uv: np.ndarray
    tri_mat: np.ndarray
    sph_pos: np.ndarray
    sph_radius: np.ndarray
    sph_mat: np.ndarray
    mat: np.ndarray          # (M, 11): albedo, emission color, rough,
    #                          metal, emission power, refraction, tex id
    textures: list
    sky: np.ndarray


def build_tables(desc: Description) -> Tables:
    parts = {k: [] for k in ("wa", "wb", "wc", "la", "lab", "lac", "normal",
                             "uv", "tri_mat")}
    for mesh, pos, scale, rot, mat in desc.instances:
        verts, uvs = desc.meshes[mesh]
        m = model_matrix(pos, scale, rot)
        v = verts.astype(np.float64)
        world = v @ m[:3, :3].T + m[:3, 3]
        ab = v[:, 1] - v[:, 0]
        ac = v[:, 2] - v[:, 0]
        n = np.cross(ab, ac) @ m[:3, :3].T
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        for key, val in (("wa", world[:, 0]), ("wb", world[:, 1]),
                         ("wc", world[:, 2]), ("la", v[:, 0]), ("lab", ab),
                         ("lac", ac), ("normal", n), ("uv", uvs)):
            parts[key].append(val.astype(np.float32))
        parts["tri_mat"].append(np.full(len(v), mat, np.int32))
    flat = {k: (np.concatenate(v) if v else
                np.zeros((0, 3, 2) if k == "uv" else
                         (0,) if k == "tri_mat" else (0, 3), np.float32))
            for k, v in parts.items()}
    sph = desc.spheres
    return Tables(
        **flat,
        sph_pos=np.array([s[0] for s in sph], np.float32).reshape(-1, 3),
        sph_radius=np.array([s[1] for s in sph], np.float32),
        sph_mat=np.array([s[2] for s in sph], np.int32),
        mat=np.array([[*m[0], *m[1], m[2], m[3], m[4], m[5], m[6]]
                      for m in desc.materials], np.float32),
        textures=list(desc.textures), sky=desc.sky)
