"""Scene model: host container + device-ready flattened tensors.

The host `Scene` mirrors ``RT::Scene`` + the client's sphere list (ref:
Engine/src/Engine/Render/Scene.h:23-28, RayTracing/src/SceneWrapper.h:33-53).
`build_tracer_scene` plays the role of the reference's SceneWrapper::build
(SceneWrapper.cpp:10-46): it flattens meshes+instances into global arrays,
pre-transforming each instanced triangle to world space on the host (for an
affine instance transform the ray parameter t, the barycentrics and the hit
acceptance are identical to the reference's local-space test).

Reference quirks preserved exactly:
  * Hit normals: the shader computes cross(B-A, C-A) on the *local* vertices
    and maps it through the model matrix — NOT the inverse transpose
    (shader:252-255).  We precompute that exact vector per world triangle.
  * Texture UV barycentrics: closestHit mixes the *world* ray with *local*
    vertices (shader:257-268) — a space-mixing reference bug.  We store local
    A and local edges so the device code reproduces it bit-for-bit.
  * Backface culling det > 0 (shader:301): preserved for instance transforms
    with positive determinant (all reference scenes; asserted at build).

The host math is NumPy, identical to rtm_tpu's; the result is a dataclass
of torch tensors on one device.  `build_tracer_scene` puts it on the card
unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .material import Materials


@dataclass
class SphereDef:
    """Host sphere (ref SceneWrapper.h Sphere: position, radius, materialId)."""
    position: tuple
    radius: float
    material_id: int


@dataclass
class Scene:
    """Host-side scene graph (mutable; the editor-facing model)."""

    materials: list = field(default_factory=list)   # list[Material]
    meshes: list = field(default_factory=list)      # list[Mesh]
    objects: list = field(default_factory=list)     # list[MeshInstance]
    spheres: list = field(default_factory=list)     # list[SphereDef]
    textures: list = field(default_factory=list)    # list[np (H,W,3) f32 in [0,1]]
    sky: np.ndarray | None = None                   # (H,W,3) f32 or None

    # --- editor CRUD parity (ref RayTracing.cpp:164-463) -------------------
    def add_material(self, m) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_sphere(self, s: SphereDef) -> int:
        self.spheres.append(s)
        return len(self.spheres) - 1

    def add_mesh(self, mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_object(self, inst) -> int:
        self.objects.append(inst)
        return len(self.objects) - 1

    def remove_sphere(self, i: int) -> None:
        del self.spheres[i]

    def remove_object(self, i: int) -> None:
        del self.objects[i]


@dataclass
class TracerScene:
    """Flattened, device-ready scene: every array field is a torch tensor
    on one device (the analog of the reference's bound GPU buffer set,
    RayTracing.cpp:895-909, minus std140 padding)."""

    materials: Materials

    sph_pos: torch.Tensor      # (S,3) f32
    sph_radius: torch.Tensor   # (S,)  f32
    sph_mat: torch.Tensor      # (S,)  i32

    tri_wa: torch.Tensor       # (T,3) f32 world-space vertex A
    tri_wb: torch.Tensor       # (T,3)
    tri_wc: torch.Tensor       # (T,3)
    tri_la: torch.Tensor       # (T,3) local-space A      (UV parity path)
    tri_lab: torch.Tensor      # (T,3) local edge B-A
    tri_lac: torch.Tensor      # (T,3) local edge C-A
    tri_normal: torch.Tensor   # (T,3) normalized shader-normal
    tri_uv: torch.Tensor       # (T,3,2)
    tri_mat: torch.Tensor      # (T,)  i32
    # (T,3,4) world->local affine rows of each triangle's instance transform
    tri_inv_model: torch.Tensor

    sky: torch.Tensor          # (Hs,Ws,3) f32 equirect map (ClampToEdge/Linear)
    textures: torch.Tensor     # (K,TH,TW,3) f32 padded stack (Repeat/Linear)
    tex_size: torch.Tensor     # (K,2) i32 actual (H,W) per texture
    # quad-packed bilinear tables (ops/shade.py build_quad_flat): one row
    # per texel holding the 2x2 footprint, so a bilinear tap is one row
    sky_quads: torch.Tensor    # (Hs*Ws, 4) i32 packed / (.., 12) f32
    tex_quads: torch.Tensor    # (K*TH*TW, 4) i32 packed / (.., 12) f32

    # does any material reference a texture?  The kernels emit the
    # deferred-texture records only when true.
    any_textured: bool = False

    # SAH-treelet cluster cut (accel/clusters.py): (lo, hi) triangle ranges,
    # contiguous in the stored (permuted) triangle order.
    cluster_slices: tuple = ()

    # skip-link BVH traversal tables (ops/kernels/trav_kernel.py
    # TravArrays/TravMeta); trav_meta.supported False beyond the trav
    # table limits
    trav_arrays: object = None
    trav_meta: object = None

    # mxu pair-test tables (ops/kernels/mxu_kernel.py MxuArrays/MxuMeta);
    # mxu_meta.supported False beyond <= 2047 triangles
    mxu_arrays: object = None
    mxu_meta: object = None

    # environment model: False = equirect sky map (shader:216-218); True =
    # the legacy kernel's procedural sun/sky (ops/shade.py)
    env_sun: bool = False

    @property
    def num_spheres(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_wa.shape[0]

    @property
    def num_textures(self) -> int:
        return self.textures.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_wa.device

    def derived(self, key, build):
        """`build()`, made on first use and kept with this scene: index
        tables that follow from the scene's structure alone (its shapes,
        cluster cut and table metadata), uploaded once as rtm_tpu's jit
        bakes them into its executable.  Nothing derived from the values
        of the differentiable tensors may be kept here.  A new scene (an
        editor rebuild, `apply_params`, `dataclasses.replace`) starts with
        none."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]


def _resolve_device(device) -> torch.device:
    """The card unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "build_tracer_scene: no CUDA device is available; pass "
            "device='cpu' to build the scene for the CPU")
    return torch.device("cuda")


def _stack_textures(textures: list[np.ndarray]):
    """(stack (K,TH,TW,3) f32, sizes (K,2) i32, quads (K*TH*TW, 4|12)) in
    NumPy.  i32-packed quad rows are exact for u8-sourced texels; arbitrary
    float textures keep f32 rows."""
    from ..ops.shade import build_quad_flat, quad_exact_u8

    if not textures:
        return (np.zeros((1, 1, 1, 3), np.float32), np.ones((1, 2), np.int32),
                np.zeros((1, 4), np.int32))
    th = max(t.shape[0] for t in textures)
    tw = max(t.shape[1] for t in textures)
    packed = all(quad_exact_u8(t[..., :3]) for t in textures)
    qdtype = np.int32 if packed else np.float32
    qw = 4 if packed else 12
    stack = np.zeros((len(textures), th, tw, 3), np.float32)
    sizes = np.zeros((len(textures), 2), np.int32)
    quads = np.zeros((len(textures), th, tw, qw), qdtype)
    for i, t in enumerate(textures):
        h, w = t.shape[0], t.shape[1]
        stack[i, :h, :w] = t[..., :3]
        sizes[i] = (h, w)
        # per-texture quad table at TRUE extent (repeat wrap baked), placed
        # into the padded row layout so base + y*TW + x indexes it
        quads[i, :h, :w] = build_quad_flat(t[..., :3], wrap="repeat",
                                           dtype=qdtype).reshape(h, w, qw)
    return stack, sizes, quads.reshape(len(textures) * th * tw, qw)


def _morton_order(wa: np.ndarray, wb: np.ndarray, wc: np.ndarray):
    """Triangle permutation by 3-D Morton code of the world centroid."""
    t = wa.shape[0]
    if t == 0:
        return np.zeros((0,), np.int64)
    cen = (wa + wb + wc) / 3.0
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-12)
    q = np.clip(((cen - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def build_tracer_scene(scene: Scene, order: str = "bvh",
                       cluster_max_tris: int = 128,
                       env_model: str = "map", device=None,
                       use_native: bool = True) -> TracerScene:
    """Flatten the host scene into the device layout (SceneWrapper parity).

    order: 'bvh' (default — SAH-BVH treelet cut, accel/clusters.py),
    'morton' (global Morton sort) or 'buffer' (reference traversal order).
    device: where the tensors live; None means the card, and raises
    RuntimeError when there is none.
    use_native: the SAH builder, native C++ (accel/native) or NumPy; the
    tables are bitwise the same either way.
    """
    dev = _resolve_device(device)

    if scene.spheres:
        sph_pos = np.array([s.position for s in scene.spheres], np.float32)
        sph_radius = np.array([s.radius for s in scene.spheres], np.float32)
        sph_mat = np.array([s.material_id for s in scene.spheres], np.int32)
    else:
        sph_pos = np.zeros((0, 3), np.float32)
        sph_radius = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)

    wa, wb, wc, la, lab, lac, nrm, uv, mat = [], [], [], [], [], [], [], [], []
    invm = []
    for inst in scene.objects:
        mesh = scene.meshes[inst.mesh_id]
        m = inst.model_matrix()
        if np.linalg.det(m[:3, :3]) <= 0:
            raise ValueError(
                "instance transform with non-positive determinant would flip "
                "the reference's backface culling; not supported")
        v = mesh.verts.astype(np.float64)            # (T,3,3) local
        world = v @ m[:3, :3].T + m[:3, 3]           # (T,3,3)
        w2l = np.linalg.inv(m.astype(np.float64))[:3, :4]   # world->local
        invm.append(np.broadcast_to(w2l, (mesh.num_triangles, 3, 4)))
        e_ab = v[:, 1] - v[:, 0]
        e_ac = v[:, 2] - v[:, 0]
        n_local = np.cross(e_ab, e_ac)
        n_shader = n_local @ m[:3, :3].T             # model matrix, NOT inv-transpose
        norm = np.linalg.norm(n_shader, axis=-1, keepdims=True)
        n_shader = n_shader / np.maximum(norm, 1e-30)
        wa.append(world[:, 0]); wb.append(world[:, 1]); wc.append(world[:, 2])
        la.append(v[:, 0]); lab.append(e_ab); lac.append(e_ac)
        nrm.append(n_shader)
        uv.append(mesh.uvs)
        mat.append(np.full(mesh.num_triangles, inst.material_id, np.int32))

    def cat(parts, shape):
        if parts:
            return np.concatenate(parts).astype(np.float32)
        return np.zeros(shape, np.float32)

    tri_wa = cat(wa, (0, 3)); tri_wb = cat(wb, (0, 3)); tri_wc = cat(wc, (0, 3))
    tri_la = cat(la, (0, 3)); tri_lab = cat(lab, (0, 3)); tri_lac = cat(lac, (0, 3))
    tri_normal = cat(nrm, (0, 3))
    tri_uv = (np.concatenate(uv).astype(np.float32) if uv
              else np.zeros((0, 3, 2), np.float32))
    tri_mat = np.concatenate(mat) if mat else np.zeros((0,), np.int32)
    tri_inv_model = cat(invm, (0, 3, 4))

    cluster_slices: tuple = ()
    trav_bvh = None
    if order in ("bvh", "morton") and tri_wa.shape[0] > 1:
        if order == "bvh":
            from ..accel.clusters import bvh_cluster_slices
            perm, cluster_slices, bvh = bvh_cluster_slices(
                np.stack([tri_wa, tri_wb, tri_wc], axis=1),
                max_tris=cluster_max_tris, use_native=use_native)
            # The trav tables' hierarchy over the permuted triangles.
            # Rebuilding it there gives the same nodes in the identity
            # order: each node's triangles already lie left block, then
            # right block, so the in-place partition moves none.
            trav_bvh = dataclasses.replace(
                bvh, order=np.arange(len(perm), dtype=np.uint32))
        else:
            perm = _morton_order(tri_wa, tri_wb, tri_wc)
        tri_wa, tri_wb, tri_wc = tri_wa[perm], tri_wb[perm], tri_wc[perm]
        tri_la, tri_lab, tri_lac = tri_la[perm], tri_lab[perm], tri_lac[perm]
        tri_normal, tri_uv, tri_mat = tri_normal[perm], tri_uv[perm], tri_mat[perm]
        tri_inv_model = tri_inv_model[perm]
    elif order not in ("bvh", "morton", "buffer"):
        raise ValueError(f"unknown triangle order {order!r}")

    any_textured = any(int(m.texture_id) >= 0 for m in scene.materials)

    sky = (np.asarray(scene.sky, np.float32) if scene.sky is not None
           else np.zeros((1, 1, 3), np.float32))
    textures, tex_size, tex_quads = _stack_textures(scene.textures)

    from ..ops.shade import build_quad_flat, quad_exact_u8
    sky_quads = build_quad_flat(
        sky, wrap="clamp",
        dtype=np.int32 if quad_exact_u8(sky) else np.float32)

    from ..ops.kernels.mxu_kernel import build_mxu_tables
    from ..ops.kernels.trav_kernel import build_trav_tables
    tex_ids_np = (np.array([m.texture_id for m in scene.materials], np.int32)
                  if scene.materials else np.zeros((0,), np.int32))
    n_materials = max(len(scene.materials), 1)   # Materials is never empty
    host = (tri_wa, tri_wb, tri_wc, tri_normal, tri_mat, tex_ids_np,
            n_materials, len(sph_pos))
    tt = build_trav_tables(*host, bvh=trav_bvh, use_native=use_native)
    mt = build_mxu_tables(*host)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TracerScene(
        materials=Materials.from_list(scene.materials, dev),
        sph_pos=t(sph_pos), sph_radius=t(sph_radius), sph_mat=t(sph_mat),
        tri_wa=t(tri_wa), tri_wb=t(tri_wb), tri_wc=t(tri_wc),
        tri_la=t(tri_la), tri_lab=t(tri_lab), tri_lac=t(tri_lac),
        tri_normal=t(tri_normal), tri_uv=t(tri_uv), tri_mat=t(tri_mat),
        tri_inv_model=t(tri_inv_model),
        sky=t(sky), textures=t(textures), tex_size=t(tex_size),
        sky_quads=t(sky_quads), tex_quads=t(tex_quads),
        any_textured=any_textured,
        cluster_slices=cluster_slices,
        trav_arrays=tt.arrays.to(dev),
        trav_meta=tt.meta,
        mxu_arrays=mt.arrays.to(dev),
        mxu_meta=mt.meta,
        env_sun=(env_model == "sun"),
    )


def scene_diff(a: TracerScene, b: TracerScene, prefix: str = "") -> list:
    """Names of the fields in which two TracerScenes differ: tensors
    (Materials and the mxu and trav tables included) bitwise, static
    metadata by ==.  Empty when the tables are the same (the native and
    NumPy SAH builders give such scenes)."""
    out = []
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        name = prefix + f.name
        if isinstance(va, torch.Tensor):
            ua, ub = (v.detach().cpu().contiguous().reshape(-1)
                      for v in (va, vb))
            if not (va.dtype == vb.dtype and va.shape == vb.shape
                    and (ua.numel() == 0 or torch.equal(
                        ua.view(torch.uint8), ub.view(torch.uint8)))):
                out.append(name)
        elif dataclasses.is_dataclass(va):
            out += scene_diff(va, vb, name + ".")
        elif va != vb:
            out.append(name)
    return out


_TENSOR_FIELDS = ("sph_pos", "sph_radius", "sph_mat", "tri_wa", "tri_wb",
                  "tri_wc", "tri_la", "tri_lab", "tri_lac", "tri_normal",
                  "tri_uv", "tri_mat", "tri_inv_model", "sky", "textures",
                  "tex_size", "sky_quads", "tex_quads")


def tracer_scene_from_numpy(arrays: dict, meta: dict, device) -> TracerScene:
    """Carry an rtm_tpu TracerScene into the port.

    arrays: the JAX scene's leaves as NumPy arrays, keyed by their dotted
    field path (`"sph_pos"`, `"materials.albedo"`, `"mxu_arrays.pair"`,
    ...), in rtm_tpu's layouts: the mxu `attr`/`info` tables sublane-
    replicated (A_ROWS, NC, 8, 128) / (NC, 8, 128), and `pair` a bfloat16
    array (or its uint16 bits), and the trav tables
    (`"trav_arrays.node_box"`, `.node_info`, `.tri_feat`, `.tri_info`) in
    their 128-entry chunks replicated over 8 sublanes.  meta:
    `any_textured`, `cluster_slices`, `env_sun`, and `mxu_meta` and
    `trav_meta` as dicts of their fields.
    """
    from ..ops.kernels.mxu_kernel import MxuMeta, mxu_arrays_from_tpu
    from ..ops.kernels.trav_kernel import TravMeta, trav_arrays_from_tpu

    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)

    mats = Materials(**{f.name: t(arrays["materials." + f.name])
                        for f in dataclasses.fields(Materials)})
    mm = meta["mxu_meta"]
    tm = meta["trav_meta"]
    trav_meta = TravMeta(int(tm["n_nodes"]), int(tm["n_leaves"]),
                         int(tm["leaf_k"]), int(tm["n_spheres"]),
                         bool(tm["supported"]),
                         tuple(int(r) for r in tm["textured_rows"]))
    return TracerScene(
        materials=mats,
        **{name: t(arrays[name]) for name in _TENSOR_FIELDS},
        any_textured=bool(meta["any_textured"]),
        cluster_slices=tuple(tuple(int(v) for v in s)
                             for s in meta["cluster_slices"]),
        trav_arrays=trav_arrays_from_tpu(
            *(arrays["trav_arrays." + k] for k in ("node_box", "node_info",
                                                    "tri_feat", "tri_info")),
            trav_meta).to(dev),
        trav_meta=trav_meta,
        mxu_arrays=mxu_arrays_from_tpu(
            arrays["mxu_arrays.pair"], arrays["mxu_arrays.attr"],
            arrays["mxu_arrays.info"], arrays["mxu_arrays.cbox"]).to(dev),
        mxu_meta=MxuMeta(int(mm["n_tris"]), int(mm["nc"]),
                         bool(mm["supported"]),
                         tuple(int(r) for r in mm["textured_rows"])),
        env_sun=bool(meta["env_sun"]),
    )
