"""Per-ray BVH traversal path-tracing kernel: the forward path for scenes
beyond the mxu kernel's tables (more than 2047 triangles, or more than 128
materials, textured triangles or spheres).

Port of rtm_tpu/ops/pallas/trav_kernel.py.  One kernel runs the whole
frames x bounces loop per ray, as the mxu kernel does, with the triangle
search replaced by the reference shader's own algorithm
(RayTracing.shader:324-484): a stackless descent of a skip-link BVH over a
SAH leaf cut (accel/trav.py), `cur = hit ? cur+1 : skip[cur]`, with box
entry pruned by the ray's best t, and every triangle of an entered leaf
tested by Moller-Trumbore.  Shading, scatter and the deferred texture /
miss records are the mxu kernel's (vreg_common.shade_tail), so the
post-pass (megakernel.mega_postpass) is shared unchanged.

Two implementations of one contract (`trav_trace`):
  * the CUDA kernel (csrc/trav_trace.cu), one thread per dispatch slot;
  * the plain version `trav_trace_plain`, batched over slots: a Python
    loop of node steps over the rays still walking, each followed by the
    leaf tests of the rays that entered a leaf, all in the kernel's f32
    formulas.
The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.

Tables.  The TPU kernel's chunked, sublane-replicated (.., 8, 128) gather
tables become plain ones: one 16-byte record per node ([x, y, z] boxes as
conservative bf16 (lo, hi) pairs, and the info word skip | (leaf+1)<<10 |
count<<20), so a node is one int4 load, and one row per (leaf, k)
triangle, leaves contiguous.  Limits: < 1024 nodes (the 10-bit skip link;
skip = n_nodes is the done sentinel), <= 512 leaves, <= 128 materials,
spheres and textured triangles.  rtm_tpu also bounds the tables by the
v5e's VMEM; on the H100 they live in device memory, so that term is gone.

Numerics (the contract with rtm_tpu's kernel): node entry is the slab
near distance from the bf16-pair boxes, BIG unless tf >= 0 and tn <= tf,
entered only when strictly below the best t, which starts at the
sphere's; a triangle passes when min(det - DET_EPS, tdet, udet, vdet,
det - udet - vdet) >= 0 and is ordered by tdet / max(det, DET_EPS) with an
IEEE division (the TPU multiplies by an approximate reciprocal); it
replaces the winner only when strictly nearer, so a sphere wins ties and
the first triangle in DFS-leaf, then k, order wins among equals.

Outputs, in dispatch-slot order (one column per slot): color (3, N),
miss (8F, N) and, for textured scenes, rec (8FB, N), in the mxu kernel's
row layouts; with_stats adds stats (2, N) i32, each slot's node visits and
triangle tests summed over frames and bounces.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...config import RenderConfig
from ..intersect import DET_EPS
from ..rng import U32_MASK
from .build import check_arg, load_kernel_library, ptr
from .megakernel import (SEED_STRIDE, _pack_camera, mega_postpass,
                         slot_to_xy, slots_to_image, use_block8)
from .vreg_common import (BIG, M_ROWS, NO_TEX, SP_ROWS, X_ROWS, PathState,
                          _M_ALB, _M_ALR, _M_EMB, _M_EMP, _M_EMR, _M_METAL,
                          _M_REFR, _M_ROUGH, _M_TEX, _SP_ALB, _SP_ALR,
                          _SP_CX, _SP_CZ, _SP_EMB, _SP_EMP, _SP_EMR,
                          _SP_METAL, _SP_R, _SP_REFR, _SP_ROUGH, _SP_TEX,
                          _X_ABX, _X_ABZ, _X_ACX, _X_ACZ, _X_LAX, _X_LAZ,
                          _X_U0, _X_U1, _X_U2, _X_V0, _X_V1, _X_V2, _cross,
                          _safe_inv_dirs, camera_frame, jittered_ray,
                          miss_rows, shade_tail, sphere_nearest_smem)

TAB_W = 128                  # entries per side table (<= 128 materials,
#                              textured triangles)
MAX_NODES = 1024             # skip links are 10 bits; skip = n_nodes = done
MAX_LEAVES = 512
MAX_LEAF_K = 4095            # the 12-bit triangle count of a node's info

# triangle feature columns (TravArrays.tri_feat): vertex A and the edges;
# the Moller-Trumbore terms are derived from them per test
_TF_AX, _TF_AY, _TF_AZ = 0, 1, 2
_TF_ABX, _TF_ABY, _TF_ABZ = 3, 4, 5
_TF_ACX, _TF_ACY, _TF_ACZ = 6, 7, 8
_TF_SNX, _TF_SNY, _TF_SNZ = 9, 10, 11      # shading normal
TF_ROWS = 12

# node info word: skip | (leaf + 1) << 10 | count << 20
_SKIP_MASK = 0x3FF
_LEAF_SHIFT = 10
_CNT_SHIFT = 20


@dataclass
class TravArrays:
    """Geometry tables of the traversal kernel, built on the host at scene
    build (the structure depends on the data).  Material / texture /
    sphere tables are rebuilt per dispatch from the live scene
    (`trav_side_tables`), so only a vertex edit needs a scene rebuild."""

    node: torch.Tensor       # (N, 4) i32: x, y, z bf16 (lo | hi<<16), info
    tri_feat: torch.Tensor   # (L*K, TF_ROWS) f32, row leaf*K + k
    tri_info: torch.Tensor   # (L*K,) i32 mat | texslot<<8

    def to(self, device) -> "TravArrays":
        return TravArrays(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


class TravMeta(NamedTuple):
    """Static traversal metadata (rtm_tpu's TravMeta, field for field)."""

    n_nodes: int             # the done sentinel
    n_leaves: int
    leaf_k: int              # K (padded leaf width)
    n_spheres: int
    supported: bool          # fits all table limits
    textured_rows: tuple     # scene triangle rows with a textured material


class TravTables(NamedTuple):
    arrays: TravArrays
    meta: TravMeta


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bfloat16 bits (uint32 holding 16 bits), rounded to nearest,
    ties to even: the conversion of ml_dtypes and torch.bfloat16 for
    finite values and infinities."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _pack_box_bf16(node_box: np.ndarray) -> np.ndarray:
    """(6, N) f32 [lo3, hi3] -> (3, N) i32 with per-axis (lo, hi) as a
    CONSERVATIVE bf16 pair (lo in the low 16 bits, hi in the high 16): a
    2^-7 relative margin before round-to-nearest guarantees bf16(lo') <= lo
    and bf16(hi') >= hi (bf16 rounding error is <= 2^-9 relative), so the
    slab test stays conservative: boxes get <= 1.6% looser, hits are never
    missed.  Bitwise equal to rtm_tpu's, which rounds through ml_dtypes."""
    m = np.float32(2.0 ** -7)
    tiny = np.float32(1e-37)
    lo = node_box[0:3]
    hi = node_box[3:6]
    lo_b = _bf16_bits(lo - np.abs(lo) * m - tiny)
    hi_b = _bf16_bits(hi + np.abs(hi) * m + tiny)
    assert np.all(_bf16_value(lo_b) <= lo)
    assert np.all(_bf16_value(hi_b) >= hi)
    return (lo_b | (hi_b << 16)).view(np.int32)


def _empty_arrays(k: int) -> TravArrays:
    """Placeholder tables of a scene the kernel does not trace."""
    return TravArrays(node=torch.zeros((1, 4), dtype=torch.int32),
                      tri_feat=torch.zeros((k, TF_ROWS), dtype=torch.float32),
                      tri_info=torch.full((k,), NO_TEX << 8,
                                          dtype=torch.int32))


def build_trav_tables(tri_wa, tri_wb, tri_wc, tri_normal, tri_mat,
                      mat_texture_id, n_materials: int, n_spheres: int,
                      max_leaf_tris: int = 16, bvh=None,
                      use_native: bool = True) -> TravTables:
    """The geometry tables (CPU tensors) and meta from host NumPy arrays,
    with rtm_tpu's adaptive leaf size, so the TravBVH and TravMeta are the
    ones rtm_tpu builds.  bvh: the accel.bvh BVH over these triangles when
    the caller has it (built here otherwise, by the native builder unless
    use_native=False)."""
    from ...accel.bvh import build_bvh
    from ...accel.trav import build_trav
    from ...models.mesh import Mesh

    t = len(tri_wa)
    # adaptive leaf size: prefer <= 128 leaves and <= 256 nodes (rtm_tpu's
    # single-gather tables); grow the leaf until the structure fits,
    # hard-capped by MAX_LEAVES.  The SAH hierarchy is built once and
    # re-cut per k.
    k = max_leaf_tris
    trav = None
    n_nodes = n_leaves = 0
    if t > 0:
        verts = np.stack([tri_wa, tri_wb, tri_wc], axis=1).astype(np.float32)
        if bvh is None:
            bvh = build_bvh(Mesh(verts, None), use_native)
        while True:
            trav = build_trav(verts, max_leaf_tris=k, bvh=bvh)
            n_nodes, n_leaves = trav.num_nodes, trav.num_leaves
            if (n_leaves <= 128 and n_nodes <= 256) or k >= 256:
                break
            k += 8
        # beyond ~32k triangles accept more leaves rather than huge ones
        while n_leaves > MAX_LEAVES - 8:
            k *= 2
            trav = build_trav(verts, max_leaf_tris=k, bvh=bvh)
            n_nodes, n_leaves = trav.num_nodes, trav.num_leaves

    # n_nodes strictly < MAX_NODES: skip can equal n_nodes (the done
    # sentinel), which must fit the 10-bit field
    supported = (n_nodes < MAX_NODES and n_leaves <= MAX_LEAVES
                 and k <= MAX_LEAF_K and n_materials <= 128
                 and n_spheres <= 128)

    tex_id = np.asarray(mat_texture_id).astype(np.int64)
    tri_mat = np.asarray(tri_mat, np.int64)
    # textured-triangle side table: scene row -> slot (or NO_TEX)
    textured_rows = (np.nonzero(tex_id[tri_mat] >= 0)[0]
                     if t > 0 else np.zeros(0, np.int64))
    if len(textured_rows) > 128:
        supported = False
        textured_rows = textured_rows[:128]
    slot_of_row = np.full(max(t, 1), NO_TEX, np.int64)
    slot_of_row[textured_rows] = np.arange(len(textured_rows))

    if t > 0 and supported:
        cnt = np.zeros(n_nodes, np.int64)
        for nid in range(n_nodes):
            if trav.leaf_id[nid] >= 0:
                s, e = trav.slices[trav.leaf_id[nid]]
                cnt[nid] = e - s
        info = (trav.skip.astype(np.int64)
                | ((trav.leaf_id.astype(np.int64) + 1) << _LEAF_SHIFT)
                | (cnt << _CNT_SHIFT)).astype(np.int32)
        node = np.zeros((n_nodes, 4), np.int32)
        node[:, 0:3] = _pack_box_bf16(
            np.concatenate([trav.lo.T, trav.hi.T])).T
        node[:, 3] = info

        # per-(leaf, k) triangle rows in BVH order; padding rows hold a
        # degenerate triangle (zero edges: det == 0 fails the gate)
        o = trav.order
        a = np.asarray(tri_wa, np.float32)[o]
        ab = np.asarray(tri_wb, np.float32)[o] - a
        ac = np.asarray(tri_wc, np.float32)[o] - a
        feat_t = np.concatenate(
            [a, ab, ac, np.asarray(tri_normal, np.float32)[o]], axis=1)
        info_t = (tri_mat[o] | (slot_of_row[o] << 8)).astype(np.int32)
        tri_feat = np.zeros((n_leaves, k, TF_ROWS), np.float32)
        tri_info = np.full((n_leaves, k), NO_TEX << 8, np.int32)
        for li, (s, e) in enumerate(trav.slices):
            tri_feat[li, :e - s] = feat_t[s:e]
            tri_info[li, :e - s] = info_t[s:e]
        arrays = TravArrays(
            node=torch.from_numpy(node),
            tri_feat=torch.from_numpy(tri_feat.reshape(-1, TF_ROWS)),
            tri_info=torch.from_numpy(tri_info.reshape(-1)))
    else:
        arrays = _empty_arrays(k)

    return TravTables(arrays, TravMeta(
        n_nodes, n_leaves, k, n_spheres, supported,
        tuple(int(r) for r in textured_rows)))


def trav_arrays_from_tpu(node_box, node_info, tri_feat, tri_info,
                         meta: TravMeta) -> TravArrays:
    """TravArrays (CPU) from rtm_tpu's trav leaves as NumPy arrays, whose
    gather tables are 128-entry chunks replicated over 8 sublanes:
    `node_box` (3, NC, 8, 128) i32 bf16 pairs, `node_info` (NC, 8, 128),
    `tri_feat` (K, LC, TF_ROWS, 8, 128) f32, `tri_info` (K, LC, 8, 128)."""
    if not meta.supported or meta.n_nodes == 0:
        return _empty_arrays(meta.leaf_k)
    nn, nl, k = meta.n_nodes, meta.n_leaves, meta.leaf_k

    def entries(a):          # (..., C, 8, 128) -> (..., C*128)
        a = np.asarray(a)[..., 0, :]
        return a.reshape(a.shape[:-2] + (-1,))

    node = np.concatenate([entries(node_box)[:, :nn],
                           entries(node_info)[None, :nn]]).T
    feat = entries(np.asarray(tri_feat).transpose(0, 2, 1, 3, 4))  # (K,TF,E)
    feat = feat[..., :nl].transpose(2, 0, 1).reshape(nl * k, TF_ROWS)

    info = entries(tri_info)[:, :nl].T.reshape(nl * k)
    return TravArrays(
        node=torch.from_numpy(np.ascontiguousarray(node, np.int32)),
        tri_feat=torch.from_numpy(np.ascontiguousarray(feat, np.float32)),
        tri_info=torch.from_numpy(np.ascontiguousarray(info, np.int32)))


# ---------------------------------------------------------------------------
# Traced side tables (material / texture / sphere values stay live: they
# are rebuilt from the scene's tensors each dispatch, so value
# optimization needs no scene rebuild).  Port of
# rtm_tpu/ops/pallas/trav_kernel.py:316-380; each is a plain
# (rows, entries) f32 table that the kernels index directly.
# ---------------------------------------------------------------------------

def traced_mat_tab(materials) -> torch.Tensor:
    """(M_ROWS, 128) f32 material table from the live Materials."""
    m = materials.albedo.shape[0]
    rows = torch.zeros((M_ROWS, TAB_W), dtype=torch.float32,
                       device=materials.albedo.device)
    rows[_M_ALR:_M_ALB + 1, :m] = materials.albedo.T
    rows[_M_EMR:_M_EMB + 1, :m] = materials.emission_color.T
    rows[_M_EMP, :m] = materials.emission_power
    rows[_M_ROUGH, :m] = materials.roughness
    rows[_M_METAL, :m] = materials.metallic
    rows[_M_REFR, :m] = materials.refraction_ratio
    rows[_M_TEX, :m] = materials.texture_id.to(torch.float32)
    return rows


def traced_tex_tab(scene, textured_rows: tuple) -> torch.Tensor:
    """(X_ROWS, 128) f32 uv/local-barycentric side table of the textured
    triangles (shader:257-268,575-580), slot i = scene row textured_rows[i];
    the row index is uploaded once per scene (TracerScene.derived)."""
    rows = torch.zeros((X_ROWS, TAB_W), dtype=torch.float32,
                       device=scene.tri_wa.device)
    if textured_rows:
        r = scene.derived(("textured_rows", textured_rows),
                          lambda: torch.tensor(textured_rows,
                                               dtype=torch.long,
                                               device=rows.device))
        w = len(textured_rows)
        rows[_X_LAX:_X_LAZ + 1, :w] = scene.tri_la[r].T
        rows[_X_ABX:_X_ABZ + 1, :w] = scene.tri_lab[r].T
        rows[_X_ACX:_X_ACZ + 1, :w] = scene.tri_lac[r].T
        uv = scene.tri_uv[r]                                 # (w,3,2)
        for row, (k, j) in ((_X_U0, (0, 0)), (_X_V0, (0, 1)),
                            (_X_U1, (1, 0)), (_X_V1, (1, 1)),
                            (_X_U2, (2, 0)), (_X_V2, (2, 1))):
            rows[row, :w] = uv[:, k, j]
    return rows


def traced_sph_tabs(scene) -> torch.Tensor:
    """(SP_ROWS, S_pad) f32 sphere table, S_pad = the sphere count rounded
    up to 8.  Padding spheres parked at BIG with r=0 can never hit."""
    s_cnt = scene.sph_pos.shape[0]
    sp = max(8, -(-max(s_cnt, 1) // 8) * 8)
    rows = torch.zeros((SP_ROWS, sp), dtype=torch.float32,
                       device=scene.sph_pos.device)
    rows[_SP_CX:_SP_CZ + 1] = BIG
    rows[_SP_TEX] = -1.0
    if s_cnt:
        m = scene.materials
        sm = scene.sph_mat.long()
        rows[_SP_CX:_SP_CZ + 1, :s_cnt] = scene.sph_pos.T
        rows[_SP_R, :s_cnt] = scene.sph_radius
        rows[_SP_ALR:_SP_ALB + 1, :s_cnt] = m.albedo[sm].T
        rows[_SP_EMR:_SP_EMB + 1, :s_cnt] = m.emission_color[sm].T
        rows[_SP_EMP, :s_cnt] = m.emission_power[sm]
        rows[_SP_ROUGH, :s_cnt] = m.roughness[sm]
        rows[_SP_METAL, :s_cnt] = m.metallic[sm]
        rows[_SP_REFR, :s_cnt] = m.refraction_ratio[sm]
        rows[_SP_TEX, :s_cnt] = m.texture_id[sm].to(torch.float32)
    return rows


class SideTables(NamedTuple):
    """The material, texture and sphere tables a dispatch reads, rebuilt
    from the scene's live values, so an edit of a material or sphere needs
    no scene rebuild."""

    mat: torch.Tensor            # (M_ROWS, 128) f32
    tex: torch.Tensor | None     # (X_ROWS, 128) f32, textured scenes only
    sph: torch.Tensor            # (SP_ROWS, S_pad) f32


def build_side_tables(scene, textured_rows: tuple) -> SideTables:
    tex = (traced_tex_tab(scene, textured_rows)
           if scene.any_textured else None)
    return SideTables(traced_mat_tab(scene.materials), tex,
                      traced_sph_tabs(scene))


def trav_side_tables(scene) -> SideTables:
    return build_side_tables(scene, scene.trav_meta.textured_rows)


def check_side_tables(kernel: str, scene, tables: SideTables, dev):
    """The side tables as a kernel takes them: (mat, tex or None, sph);
    raises ValueError on a wrong dtype, shape or device."""
    mat, tex, sph = tables
    check_arg(kernel, "mat", mat, torch.float32, (M_ROWS, TAB_W), dev)
    check_arg(kernel, "sph", sph, torch.float32,
              (SP_ROWS, None if sph is None else sph.shape[1]), dev)
    if sph.shape[1] < scene.num_spheres:
        raise ValueError(f"{kernel}: sph holds {sph.shape[1]} spheres, "
                         f"the scene {scene.num_spheres}")
    if not scene.any_textured:
        return mat, None, sph
    check_arg(kernel, "tex", tex, torch.float32, (X_ROWS, TAB_W), dev)
    return mat, tex, sph


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

LEAF_BLOCK = 64              # leaf triangles tested per batched step


def _unpack_boxes(node):
    """(M, 4) node records -> per-axis (lo, hi) f32 from the bf16 pairs."""
    w = node[:, 0:3]
    lo = (w << 16).view(torch.float32)
    hi = (w & -65536).view(torch.float32)
    return lo, hi


def trav_nearest_plain(ta: TravArrays, tm: TravMeta, ox, oy, oz, dx, dy, dz,
                       best, active):
    """Nearest triangle by the skip-link descent, batched over rays: the
    kernel's `trav_nearest` (csrc/trav_trace.cu) on (N,) tensors.

    best: (N,) f32 initial best t (the sphere's, BIG for none); only
    `active` rays walk.  Returns (got, best, row, visits, tests): got where
    a triangle beat the initial best, best its t, row its tri_feat row
    (leaf * K + k; 0 where not got), visits the nodes each ray tested and
    tests the triangles it tested."""
    n = ox.shape[0]
    dev = ox.device
    n_nodes, kk = tm.n_nodes, tm.leaf_k
    inv_dx, inv_dy, inv_dz = _safe_inv_dirs(dx, dy, dz)
    best = best.clone()
    row = torch.zeros(n, dtype=torch.long, device=dev)
    got = torch.zeros(n, dtype=torch.bool, device=dev)
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    tests = torch.zeros(n, dtype=torch.int32, device=dev)
    cur = torch.zeros(n, dtype=torch.long, device=dev)
    lanes = torch.nonzero(active).squeeze(1) if n_nodes else cur[:0]
    while lanes.numel():
        c = cur[lanes]
        rec = ta.node[c]
        lo, hi = _unpack_boxes(rec)
        o3 = (ox[lanes], oy[lanes], oz[lanes])
        i3 = (inv_dx[lanes], inv_dy[lanes], inv_dz[lanes])
        t1 = [(lo[:, j] - o3[j]) * i3[j] for j in range(3)]
        t2 = [(hi[:, j] - o3[j]) * i3[j] for j in range(3)]
        mn = [torch.minimum(a, b) for a, b in zip(t1, t2)]
        mx = [torch.maximum(a, b) for a, b in zip(t1, t2)]
        tn = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
        tf = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
        near = torch.where((tf >= 0.0) & (tn <= tf), tn, BIG)
        hit = near < best[lanes]
        info = rec[:, 3]
        leaf1 = (info >> _LEAF_SHIFT) & 0x3FF
        is_leaf = leaf1 > 0
        visits[lanes] += 1
        cur[lanes] = torch.where(hit & ~is_leaf, c + 1,
                                 (info & _SKIP_MASK).long())
        enter = hit & is_leaf
        if bool(enter.any()):
            el = lanes[enter]
            cnt = (info[enter] >> _CNT_SHIFT) & 0xFFF
            tests[el] += cnt
            _leaf_tests(ta, el, (leaf1[enter] - 1).long() * kk, cnt,
                        ox, oy, oz, dx, dy, dz, best, row, got)
        lanes = lanes[cur[lanes] < n_nodes]
    return got, best, row, visits, tests


def _leaf_tests(ta, el, base, cnt, ox, oy, oz, dx, dy, dz, best, row, got):
    """Test triangles k < cnt of each ray's leaf (rows base + k) in blocks
    of LEAF_BLOCK, updating best / row / got of rays `el` in place.  The
    first k that attains a block's minimum wins the block, and a block
    wins only when strictly below the best so far: the kernel's sequential
    strict improve."""
    o = [v[el][:, None] for v in (ox, oy, oz)]
    d = [v[el][:, None] for v in (dx, dy, dz)]
    b = best[el]
    r = row[el]
    g = got[el]
    k_max = int(cnt.max())
    for k0 in range(0, k_max, LEAF_BLOCK):
        ks = torch.arange(k0, min(k0 + LEAF_BLOCK, k_max), device=el.device)
        rows = base[:, None] + ks
        f = ta.tri_feat[rows]                              # (M, B, 12)
        aox = o[0] - f[..., _TF_AX]
        aoy = o[1] - f[..., _TF_AY]
        aoz = o[2] - f[..., _TF_AZ]
        abx, aby, abz = f[..., _TF_ABX], f[..., _TF_ABY], f[..., _TF_ABZ]
        acx, acy, acz = f[..., _TF_ACX], f[..., _TF_ACY], f[..., _TF_ACZ]
        nx, ny, nz = _cross(abx, aby, abz, acx, acy, acz)
        det = -(d[0] * nx + d[1] * ny + d[2] * nz)
        tdet = aox * nx + aoy * ny + aoz * nz
        dax, day, daz = _cross(aox, aoy, aoz, d[0], d[1], d[2])
        udet = acx * dax + acy * day + acz * daz
        vdet = -(abx * dax + aby * day + abz * daz)
        wdet = det - udet - vdet
        mm = torch.minimum(torch.minimum(det - DET_EPS, tdet),
                           torch.minimum(torch.minimum(udet, vdet), wdet))
        t = tdet / torch.clamp(det, min=DET_EPS)
        ok = (mm >= 0.0) & (ks < cnt[:, None])
        t_min, k_arg = torch.where(ok, t, float("inf")).min(dim=1)
        better = t_min < b
        b = torch.where(better, t_min, b)
        r = torch.where(better, base + k0 + k_arg, r)
        g = g | better
    best[el] = b
    row[el] = r
    got[el] = g


def trav_trace_plain(scene, tables: SideTables, camf, frame_index: int,
                     pixel_offset: int, n_rays: int, cfg: RenderConfig,
                     with_stats: bool = False):
    """Plain PyTorch version of the kernel: the same outputs from the same
    inputs, batched over rays with Python loops over frames, bounces and
    traversal steps.  Runs on any device."""
    dev = camf.device
    w, h = cfg.width, cfg.height
    frames, bounces = cfg.max_frames, cfg.max_bounces
    textured = scene.any_textured
    ta, tm = scene.trav_arrays, scene.trav_meta
    have_tris = tm.n_nodes > 0
    have_sph = scene.num_spheres > 0
    n = n_rays
    f32 = dict(dtype=torch.float32, device=dev)
    sel = torch.where

    lin = pixel_offset + torch.arange(n, dtype=torch.int64, device=dev)
    if use_block8(w, h):
        xpix, ypix = slot_to_xy(lin, w)
    else:
        xpix, ypix = lin % w, lin // w
    lin_u = (ypix * w + xpix) & U32_MASK
    basis = camera_frame(camf, w, h, xpix, ypix)

    miss = torch.empty((8 * frames, n), **f32)
    rec = torch.empty((8 * frames * bounces, n), **f32) if textured else None
    stats = torch.zeros((2, n), dtype=torch.int32, device=dev)
    zero = torch.zeros(n, **f32)
    col = [zero] * 3

    for frame in range(1, frames + 1):
        seed = (lin_u + frame * frame_index * SEED_STRIDE) & U32_MASK
        ox, oy, oz, dx, dy, dz, seed = jittered_ray(seed, basis)
        s = PathState(ox, oy, oz, dx, dy, dz, seed,
                      torch.ones(n, dtype=torch.bool, device=dev),
                      [torch.ones(n, **f32) for _ in range(3)], col,
                      [zero] * 3, [zero] * 3)

        for b in range(bounces):
            s.seed = (s.seed + b) & U32_MASK                 # shader:659
            if have_sph:
                t_sph, s_idx = sphere_nearest_smem(tables.sph, s.ox, s.oy,
                                                   s.oz, s.dx, s.dy, s.dz)
            else:
                t_sph = torch.full((n,), BIG, **f32)
                s_idx = torch.zeros(n, dtype=torch.int32, device=dev)

            w_sn = None
            if have_tris:
                got, t_tri, win, visits, tests = trav_nearest_plain(
                    ta, tm, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, t_sph,
                    s.alive)
                stats[0] += visits
                stats[1] += tests
                use_tri = got
                t_hit = sel(got, t_tri, t_sph)
                winfo = sel(got, ta.tri_info[win], NO_TEX << 8)
                w_sn = [sel(got, ta.tri_feat[win, j], 0.0)
                        for j in (_TF_SNX, _TF_SNY, _TF_SNZ)]
            else:
                use_tri = torch.zeros(n, dtype=torch.bool, device=dev)
                t_hit = t_sph
                winfo = torch.full((n,), NO_TEX << 8, dtype=torch.int32,
                                   device=dev)
            rows = shade_tail(tables, have_tris, have_sph, textured, s,
                              use_tri, t_hit, winfo, w_sn, s_idx)
            if textured:
                row = ((frame - 1) * bounces + b) * 8
                rec[row:row + 8] = torch.stack(rows)

        col = s.col
        miss[(frame - 1) * 8:frame * 8] = miss_rows(s)

    return torch.stack(col), miss, rec, (stats if with_stats else None)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, ctypes.c_uint32, _I, _I, _I, _I, _I, _I,   # camf .. bounces
             _P, _P, _P, _I, _I,                              # geometry
             _P, _P, _P, _I, _I,                              # side tables
             _P, _P, _P, _P, _P]                              # outs, stream


def trav_trace(scene, tables: SideTables, camf, frame_index: int,
               pixel_offset: int, n_rays: int, cfg: RenderConfig,
               with_stats: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays): returns
    (color (3,N), miss (8F,N), rec (8FB,N) or None, stats (2,N) i32 or
    None).

    CPU tensors go to `trav_trace_plain`; CUDA tensors launch the kernel
    of csrc/trav_trace.cu (built at first use) and raise on any launch
    error.  `trav_trace.launches` counts the kernel launches."""
    tm = scene.trav_meta
    if tm is None or not tm.supported:
        raise ValueError("trav_trace: scene exceeds the trav table limits")
    dev = camf.device
    if scene.device != dev:
        raise ValueError(f"trav_trace: camera row on {dev}, scene on "
                         f"{scene.device}")
    if dev.type == "cpu":
        return trav_trace_plain(scene, tables, camf, frame_index,
                                pixel_offset, n_rays, cfg, with_stats)
    if dev.type != "cuda":
        raise ValueError(f"trav_trace: unsupported device {dev}")
    n = int(n_rays)
    if n <= 0 or pixel_offset < 0:
        raise ValueError("trav_trace: need n_rays > 0 and pixel_offset >= 0")
    frames, bounces = cfg.max_frames, cfg.max_bounces
    ta = scene.trav_arrays
    rows = max(tm.n_leaves, 1) * tm.leaf_k
    chk = lambda *a: check_arg("trav_trace", *a)  # noqa: E731
    chk("camf", camf, torch.float32, (64,), dev)
    chk("node", ta.node, torch.int32, (max(tm.n_nodes, 1), 4), dev)
    chk("tri_feat", ta.tri_feat, torch.float32, (rows, TF_ROWS), dev)
    chk("tri_info", ta.tri_info, torch.int32, (rows,), dev)
    if ta.node.data_ptr() % 16 or ta.tri_feat.data_ptr() % 16:
        raise ValueError("trav_trace: node and tri_feat must be 16-byte "
                         "aligned (the kernel reads them as int4 / float4)")
    mat, tex, sph = check_side_tables("trav_trace", scene, tables, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    color = torch.empty((3, n), **f32)
    miss = torch.empty((8 * frames, n), **f32)
    rec = (torch.empty((8 * frames * bounces, n), **f32)
           if scene.any_textured else None)
    stats = (torch.empty((2, n), dtype=torch.int32, device=dev)
             if with_stats else None)

    lib = load_kernel_library("trav_trace")
    fn = lib.trav_trace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(camf.data_ptr(), int(frame_index) & U32_MASK,
                 int(pixel_offset), n, cfg.width, cfg.height, frames,
                 bounces, ta.node.data_ptr(), ta.tri_feat.data_ptr(),
                 ta.tri_info.data_ptr(), tm.n_nodes, tm.leaf_k,
                 mat.data_ptr(), ptr(tex), sph.data_ptr(), sph.shape[1],
                 scene.num_spheres, color.data_ptr(), miss.data_ptr(),
                 ptr(rec), ptr(stats), stream)
    if err != 0:
        raise RuntimeError(f"trav_trace: kernel launch failed with CUDA "
                           f"error {err}")
    trav_trace.launches += 1
    return color, miss, rec, stats


trav_trace.launches = 0


# ---------------------------------------------------------------------------
# Drivers: kernel + shared post-pass
# ---------------------------------------------------------------------------

def render_rays_trav(scene, cam, frame_index: int, cfg: RenderConfig,
                     pixel_offset: int, n_rays: int,
                     skip_postpass: bool = False, with_stats: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays) and run
    the post-pass: returns (n_rays, 3) slot radiance, and with_stats also
    the (2, n_rays) i32 per-slot node visits and triangle tests.
    skip_postpass returns the kernel's raw color instead."""
    camf = _pack_camera(cam, scene.device)
    color, miss, rec, stats = trav_trace(scene, trav_side_tables(scene),
                                         camf, frame_index, pixel_offset,
                                         n_rays, cfg, with_stats)
    color = color.T
    if skip_postpass:
        out = color.contiguous()
    else:
        out = mega_postpass(color, miss, rec, scene, cfg, n_rays)
    if with_stats:
        return out, stats
    return out


def render_trav(scene, cam, frame_index: int, cfg: RenderConfig):
    """Full-frame forward dispatch through the kernel: (H, W, 3) f32
    radiance averaged over cfg.max_frames samples."""
    color = render_rays_trav(scene, cam, frame_index, cfg, pixel_offset=0,
                             n_rays=cfg.width * cfg.height)
    if use_block8(cfg.width, cfg.height):
        return slots_to_image(color, cfg.width, cfg.height)
    return color.reshape(cfg.height, cfg.width, 3)
