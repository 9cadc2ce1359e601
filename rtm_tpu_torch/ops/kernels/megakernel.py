"""The megakernel path, and the slot maps, camera packing, cluster tables
and texture/sky post-pass that the per-ray kernels share.

Port of rtm_tpu/ops/pallas/megakernel.py: the constants, the 8x8-block
dispatch-slot order (`use_block8`, `slot_to_xy`, `pixel_to_slot`,
`image_to_slots`, `slots_to_image`), `_pack_camera`, the scene tables
(`MegaPack`, `build_mega_pack`), the megakernel (`mega_trace` over
csrc/mega_trace.cu, its plain version `mega_trace_plain`, the drivers
`render_rays_megakernel` / `render_megakernel`, and `megakernel_fits`) and
the post-pass (`mega_postpass` over csrc/postpass.cu, its plain version
`mega_postpass_dense`, and `mega_postpass_compact`).

The megakernel runs the whole frames x bounces loop per ray: camera ray
with both jitters, PCG draws, a sweep over the scene's SAH treelet
clusters in which a ray tile skips a cluster that no alive ray of it can
improve on (in table order, or nearest-first), the sphere loop, the
winner's 40 attributes, its exact t from its plane, shading and scatter.
The kernels defer the two texture-map consumers: they emit per-bounce
records (emission-known terms, uv/texid) and per-sample miss records
(direction + contribution), and the post-pass reconstructs
color = sum_b E_b * prod_{k<b} A_k with one texture tap per significant
record (RayTracing.shader:575-586 albedo chain, :663-666 sky at miss).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from ...config import RenderConfig
from ...models.camera import CAMERA_ROW, host_to_device
from ...utils.tracing import span
from ..intersect import DET_EPS, cross3
from ..rng import U32_MASK
from ..shade import (PI, TWO_PI, sample_texture_quads, sky_tap,
                     sun_sky_constants)
from .build import check_arg, load_kernel_library, ptr
from .vreg_common import (BIG, _cross, _normalize, _safe_inv_dirs,
                          camera_frame, jittered_ray, scatter_step,
                          sphere_nearest_smem)

CLUSTER = 128                   # triangles per cull cluster
SEED_STRIDE = 735529            # shader:697
DEFAULT_RAY_TILE = 512          # rays per cull decision (one thread block)
MAX_RAY_TILE = 512              # threads per block of csrc/mega_trace.cu
KEY_LANES = 128                 # nearest-first sweep: most clusters it takes

# attribute-table columns (T', NUM_ATTRS)
_A_NX, _A_NY, _A_NZ = 0, 1, 2
_A_ALR, _A_ALG, _A_ALB = 3, 4, 5
_A_EMR, _A_EMG, _A_EMB = 6, 7, 8
_A_EMP, _A_ROUGH, _A_METAL, _A_REFR, _A_TEX = 9, 10, 11, 12, 13
_A_LAX, _A_LAY, _A_LAZ = 14, 15, 16
_A_ABX, _A_ABY, _A_ABZ = 17, 18, 19
_A_ACX, _A_ACY, _A_ACZ = 20, 21, 22
_A_U0, _A_V0, _A_U1, _A_V1, _A_U2, _A_V2 = 23, 24, 25, 26, 27, 28
_A_GNX, _A_GNY, _A_GNZ, _A_GAN = 29, 30, 31, 32   # geometric n, dot(A,n):
NUM_ATTRS = 40                                     # exact-t recovery

# sphere-table rows (S_ROWS, S'): quadratic inputs + joined material (the
# row order of csrc/bounce_common.cuh SP_*)
_S_CX, _S_CY, _S_CZ, _S_R = 0, 1, 2, 3
_S_ALR, _S_ALG, _S_ALB = 4, 5, 6
_S_EMR, _S_EMG, _S_EMB = 7, 8, 9
_S_EMP, _S_ROUGH, _S_METAL, _S_REFR, _S_TEX = 10, 11, 12, 13, 14
S_ROWS = 16


# ---------------------------------------------------------------------------
# Scene tables
# ---------------------------------------------------------------------------

class MegaPack(NamedTuple):
    """Device-layout scene tables of the megakernel and the cluster sweep.

    rtm_tpu keeps the attribute table as a bf16 Dekker 3-split (3, 40, T')
    for its one-hot MXU extraction; the port stores the f32 value those
    three one-hot products sum to, (a0 + a1) + a2, one row per padded
    triangle, and reads the winner's row with a plain load."""

    tri_feats: torch.Tensor | None   # (T', 16) f32, cluster-padded
    tri_attrs: torch.Tensor | None   # (T', NUM_ATTRS) f32
    boxes: torch.Tensor | None       # (C, 8) f32 [lo3, hi3, 0, 0]
    spheres: torch.Tensor | None     # (S_ROWS, S') f32, S' = 8-multiple
    n_clusters: int
    n_spheres_padded: int = 0
    # per-cluster (row offset, padded width) in the padded table: widths
    # are 8-row multiples, variable under the SAH treelet cut
    cluster_offsets: tuple = ()
    cluster_widths: tuple = ()
    offsets_dev: torch.Tensor | None = None   # (C,) i32, for the kernels
    widths_dev: torch.Tensor | None = None    # (C,) i32
    # (T',) i32 padded-table row -> scene triangle id, -1 for padding
    padded_to_real: torch.Tensor | None = None

    @property
    def n_padded_tris(self) -> int:
        return sum(self.cluster_widths)


def _cluster_slices(scene) -> tuple:
    t = scene.num_triangles
    return scene.cluster_slices or tuple(
        (i * CLUSTER, min((i + 1) * CLUSTER, t))
        for i in range(-(-t // CLUSTER)))


def _padded_widths(slices) -> list:
    return [max(8, -(-(hi - lo) // 8) * 8) for lo, hi in slices]


def _bf16_split_sum(x):
    """The f32 value rtm_tpu's one-hot extraction reads from its bf16 Dekker
    3-split of x (megakernel.py:240-247, :801-806): (a0 + a1) + a2."""
    a0 = x.to(torch.bfloat16)
    r1 = x - a0.float()
    a1 = r1.to(torch.bfloat16)
    a2 = (r1 - a1.float()).to(torch.bfloat16)
    return (a0.float() + a1.float()) + a2.float()


def _attr_rows(scene, n, an):
    """(T, NUM_ATTRS) f32: shading normal, material, local A / AB / AC,
    uvs, geometric plane (n, a.n) of each scene triangle."""
    m = scene.materials
    tm = scene.tri_mat.long()
    alb, emc = m.albedo.detach()[tm], m.emission_color.detach()[tm]
    la, lab, lac = scene.tri_la, scene.tri_lab, scene.tri_lac
    uv = scene.tri_uv
    nrm = scene.tri_normal
    cols = [nrm[:, 0], nrm[:, 1], nrm[:, 2],
            alb[:, 0], alb[:, 1], alb[:, 2], emc[:, 0], emc[:, 1], emc[:, 2],
            m.emission_power.detach()[tm], m.roughness.detach()[tm],
            m.metallic.detach()[tm], m.refraction_ratio.detach()[tm],
            m.texture_id[tm].float(),
            la[:, 0], la[:, 1], la[:, 2], lab[:, 0], lab[:, 1], lab[:, 2],
            lac[:, 0], lac[:, 1], lac[:, 2],
            uv[:, 0, 0], uv[:, 0, 1], uv[:, 1, 0], uv[:, 1, 1],
            uv[:, 2, 0], uv[:, 2, 1],
            n[:, 0], n[:, 1], n[:, 2], an]
    cols += [torch.zeros_like(cols[0])] * (NUM_ATTRS - len(cols))
    return torch.stack([c.detach() for c in cols], dim=1)


def _sphere_rows(scene):
    """(S_ROWS, S') f32 sphere table; padding spheres sit at BIG with
    r = 0 (never hit) and texid -1."""
    s = scene.num_spheres
    sp = max(8, -(-s // 8) * 8)
    m = scene.materials
    sm = scene.sph_mat.long()
    alb, emc = m.albedo.detach()[sm], m.emission_color.detach()[sm]
    pos = scene.sph_pos.detach()
    rows = torch.stack([
        pos[:, 0], pos[:, 1], pos[:, 2], scene.sph_radius.detach(),
        alb[:, 0], alb[:, 1], alb[:, 2], emc[:, 0], emc[:, 1], emc[:, 2],
        m.emission_power.detach()[sm], m.roughness.detach()[sm],
        m.metallic.detach()[sm], m.refraction_ratio.detach()[sm],
        m.texture_id[sm].float(), torch.zeros_like(pos[:, 0])], dim=0)
    pad = torch.zeros((S_ROWS, sp - s), dtype=torch.float32,
                      device=pos.device)
    pad[_S_CX:_S_CZ + 1] = BIG
    pad[_S_TEX] = -1.0
    return torch.cat([rows, pad], dim=1).contiguous(), sp


class _PackIndex(NamedTuple):
    """The pack's tables that follow from the cluster cut alone (rtm_tpu's
    jit constants), uploaded once per scene: `build_mega_pack` keeps them
    with the scene (TracerScene.derived)."""

    offsets: tuple              # per-cluster first padded row
    widths: tuple               # per-cluster padded width
    p2r: torch.Tensor           # (T',) i64 padded row -> scene row, -1 pad
    real: torch.Tensor          # (T', 1) bool: p2r >= 0
    seg: torch.Tensor           # (T,) i64 cluster of each clustered row
    rows: torch.Tensor          # (T,) i64 the clustered rows, cluster order
    offsets_dev: torch.Tensor   # (C,) i32
    widths_dev: torch.Tensor    # (C,) i32
    padded_to_real: torch.Tensor  # (T',) i32


def _pack_index(slices, dev) -> _PackIndex:
    widths = _padded_widths(slices)
    offs = [int(o) for o in np.cumsum([0] + widths[:-1])]
    p2r = np.full(sum(widths), -1, np.int64)
    for (lo, hi), o in zip(slices, offs):
        p2r[o:o + hi - lo] = np.arange(lo, hi)
    lo_i = np.array([lo for lo, _ in slices], np.int64)
    hi_i = np.array([hi for _, hi in slices], np.int64)
    seg = np.repeat(np.arange(len(slices)), hi_i - lo_i)
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in slices])

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    p2r_t = up(p2r)
    return _PackIndex(
        offsets=tuple(offs), widths=tuple(widths), p2r=p2r_t,
        real=(p2r_t >= 0)[:, None], seg=up(seg), rows=up(rows),
        offsets_dev=up(np.asarray(offs, np.int32)),
        widths_dev=up(np.asarray(widths, np.int32)),
        padded_to_real=up(p2r.astype(np.int32)))


@span("rtm.mega.pack")
def build_mega_pack(scene) -> MegaPack:
    """Pack the scene into the megakernel's and the sweep's tables, on the
    scene's device and without autograd (this path is forward-only, as in
    rtm_tpu).

    Clusters follow the scene's SAH treelet cut when present (tight,
    variable width), else fixed 128-triangle slices of the stored order.
    Padding rows have n = 0, so det == 0 fails the gate, and texid -1.
    The index tables of the cut are built once per scene (`_pack_index`);
    the features, attributes and boxes, which follow the scene's
    differentiable tensors, are packed on every call, on the device."""
    dev = scene.device
    with torch.no_grad():
        sph, sp = (_sphere_rows(scene) if scene.num_spheres > 0
                   else (None, 0))
        if scene.num_triangles == 0:
            return MegaPack(None, None, None, sph, 0, sp)
        ix = scene.derived("mega_pack_index", lambda: _pack_index(
            _cluster_slices(scene), dev))
        a = scene.tri_wa.detach()
        b = scene.tri_wb.detach()
        c = scene.tri_wc.detach()
        ab = b - a
        ac = c - a
        n = cross3(ab, ac)
        an = (a * n).sum(dim=-1)
        g1 = cross3(ac, a)
        g2 = cross3(ab, a)
        feats = torch.stack([n[:, 0], n[:, 1], n[:, 2], an,
                             ab[:, 0], ab[:, 1], ab[:, 2],
                             ac[:, 0], ac[:, 1], ac[:, 2],
                             g1[:, 0], g1[:, 1], g1[:, 2],
                             g2[:, 0], g2[:, 1], g2[:, 2]], dim=1)  # (T,16)
        verts = torch.stack([a, b, c], dim=1)
        vmin = verts.amin(dim=1)
        vmax = verts.amax(dim=1)

        nc = len(ix.widths)
        src = ix.p2r.clamp(min=0)
        tri_feats = torch.where(ix.real, feats[src], 0.0)
        attrs = torch.where(ix.real, _attr_rows(scene, n, an)[src], 0.0)
        attrs[:, _A_TEX] = torch.where(ix.real[:, 0], attrs[:, _A_TEX], -1.0)
        seg3 = ix.seg[:, None].expand(-1, 3)
        box_lo = torch.full((nc, 3), float("inf"), device=dev)
        box_hi = torch.full((nc, 3), float("-inf"), device=dev)
        box_lo = box_lo.scatter_reduce(0, seg3, vmin[ix.rows], "amin")
        box_hi = box_hi.scatter_reduce(0, seg3, vmax[ix.rows], "amax")
        boxes = torch.cat([box_lo, box_hi,
                           torch.zeros((nc, 2), device=dev)], dim=1)
    return MegaPack(
        tri_feats=tri_feats.contiguous(),
        tri_attrs=_bf16_split_sum(attrs).contiguous(),
        boxes=boxes.contiguous(), spheres=sph,
        n_clusters=nc, n_spheres_padded=sp,
        cluster_offsets=ix.offsets, cluster_widths=ix.widths,
        offsets_dev=ix.offsets_dev, widths_dev=ix.widths_dev,
        padded_to_real=ix.padded_to_real)


def megakernel_fits(scene, cfg: RenderConfig) -> bool:
    """Whether a full-frame megakernel dispatch of `scene` fits the device.

    rtm_tpu bounds its kernel by the v5e's VMEM, where the whole attribute
    table and the one-hot operands live (megakernel.py:139-153).  This
    kernel keeps its tables in device memory and stages at most one
    cluster's rows in shared memory, so the footprint is the tables plus
    the dispatch's color / miss / rec outputs, with room for the
    post-pass's copy of the records; it is held against the free memory
    of the card (or the host's memory for the plain version).  Above it
    render_dispatch falls to wavefront2, loudly, as rtm_tpu does."""
    slices = _cluster_slices(scene) if scene.num_triangles else ()
    tp = sum(_padded_widths(slices))
    sp = max(8, -(-scene.num_spheres // 8) * 8) if scene.num_spheres else 0
    tables = (tp * (16 + NUM_ATTRS) + len(slices) * 10
              + sp * S_ROWS + 64) * 4
    rows = 3 + 8 * cfg.max_frames * (
        1 + (cfg.max_bounces if scene.any_textured else 0))
    outputs = rows * cfg.width * cfg.height * 4
    need = tables + 2 * outputs
    dev = scene.device
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info(dev)[0]
    else:
        free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return need <= free


# ---------------------------------------------------------------------------
# The sweep's plain operations (shared with the cluster-sweep and intersect
# kernels' plain versions)
# ---------------------------------------------------------------------------

def _slab_near(box, ox, oy, oz, inv_dx, inv_dy, inv_dz, miss=BIG):
    """megakernel._slab_near: per-ray entry distance to the box [lo3, hi3]
    (`miss` where the ray misses it; min and max propagate NaN).  box rows
    0..5 may be scalars or (C,) rows against (N, 1) rays."""
    t1x = (box[0] - ox) * inv_dx
    t2x = (box[3] - ox) * inv_dx
    t1y = (box[1] - oy) * inv_dy
    t2y = (box[4] - oy) * inv_dy
    t1z = (box[2] - oz) * inv_dz
    t2z = (box[5] - oz) * inv_dz
    tn = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                     torch.minimum(t1y, t2y)),
                       torch.minimum(t1z, t2z))
    tf = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                     torch.maximum(t1y, t2y)),
                       torch.maximum(t1z, t2z))
    return torch.where((tf >= 0.0) & (tn <= tf), tn, miss)


def pair_t(f, ox, oy, oz, dx, dy, dz, wx, wy, wz):
    """The sweep's pair test (megakernel.py:446-462) of (N, 1) rays against
    the (16, W) feature rows f: (N, W) ordering distances, BIG where the
    min-chain gate fails.  Ordered by the exact tdet / max(det, eps) where
    rtm_tpu multiplies by an approximate reciprocal."""
    det = -(dx * f[0:1] + dy * f[1:2] + dz * f[2:3])
    tdet = (ox * f[0:1] + oy * f[1:2] + oz * f[2:3]) - f[3:4]
    udet = ((wx * f[7:8] + wy * f[8:9] + wz * f[9:10])
            - (dx * f[10:11] + dy * f[11:12] + dz * f[12:13]))
    vdet = ((dx * f[13:14] + dy * f[14:15] + dz * f[15:16])
            - (wx * f[4:5] + wy * f[5:6] + wz * f[6:7]))
    wdet = det - udet - vdet
    m = torch.minimum(torch.minimum(det - DET_EPS, tdet),
                      torch.minimum(torch.minimum(udet, vdet), wdet))
    return torch.where(m >= 0.0, tdet / torch.clamp(det, min=DET_EPS), BIG)


def cluster_argmin(tt, off: int):
    """(N, 1) least t of an (N, W) cluster block and its table row (the
    lowest row on ties), offset by the cluster's first row `off`."""
    cmin = tt.amin(dim=1, keepdim=True)
    col = torch.arange(tt.shape[1], device=tt.device)[None, :]
    cand = torch.where(tt == cmin, col, 2 ** 30).amin(dim=1, keepdim=True)
    return cmin, cand + off


# ---------------------------------------------------------------------------
# Ray-slot ordering: 8x8 pixel blocks
# ---------------------------------------------------------------------------
# Dispatch slots walk the frame in 8x8 pixel blocks (the reference's
# compute workgroup, RayTracing.shader:13), so a block of consecutive slots
# is a compact pixel patch and its rays stay coherent for the chunk cull.

def use_block8(width: int, height: int) -> bool:
    return width % 8 == 0 and height % 8 == 0


def slot_to_xy(lin, width: int):
    """Dispatch slot -> pixel (x, y) under 8x8-block order (any int
    tensor)."""
    t = lin // 64
    j = lin % 64
    bx = t % (width // 8)
    by = t // (width // 8)
    return bx * 8 + j % 8, by * 8 + j // 8


def pixel_to_slot(p, width: int):
    """Row-major pixel id -> dispatch slot (inverse of slot_to_xy)."""
    x = p % width
    y = p // width
    return ((y // 8) * (width // 8) + x // 8) * 64 + (y % 8) * 8 + x % 8


def image_to_slots(img, width: int, height: int):
    """(H, W, C) row-major -> (W*H, C) slot order (exact inverse of
    slots_to_image)."""
    c = img.shape[-1]
    v = img.reshape(height // 8, 8, width // 8, 8, c)
    return v.permute(0, 2, 1, 3, 4).reshape(width * height, c)


def slots_to_image(color, width: int, height: int):
    """(W*H, C) slot order -> (H, W, C) row-major as a pure layout op."""
    c = color.shape[-1]
    img = color.reshape(height // 8, width // 8, 8, 8, c)
    return img.permute(0, 2, 1, 3, 4).reshape(height, width, c)


# ---------------------------------------------------------------------------
# Camera uniform
# ---------------------------------------------------------------------------

def _pack_camera(cam, device=None) -> torch.Tensor:
    """The spec's (64,) f32 camera row on `device` (default: the spec's) —
    matrices stored column-major (the kernels read m[i,j] at j*4+i).  A
    spec from `Camera.spec` carries the row already; another is packed
    from its fields.  A row on the host reaches a CUDA device by a copy
    the host does not wait for (models/camera.py `host_to_device`)."""
    camf = cam.row
    if camf is None:
        camf = torch.zeros(CAMERA_ROW, dtype=torch.float32,
                           device=cam.inv_projection.device)
        camf[0:16] = cam.inv_projection.T.reshape(-1)
        camf[16:32] = cam.inv_view.T.reshape(-1)
        camf[32:35] = cam.position
        camf[35] = cam.focus_distance
        camf[36] = cam.defocus_strength
        camf[37] = cam.blur_strength
    if device is None or camf.device == torch.device(device):
        return camf
    return host_to_device(camf, device)


# ---------------------------------------------------------------------------
# Post-pass
# ---------------------------------------------------------------------------

def _tex_uv_of_records(ra, rb, rc, sflag, have_sph: bool):
    """Record (ra, rb, rc) -> texture uv: triangles carry uv directly,
    sphere records carry the unit normal -> equirect uv."""
    if not have_sph:
        return ra, rb
    uu = torch.where(sflag, torch.atan2(rc, ra) / TWO_PI + 0.5, ra)
    vv = torch.where(
        sflag, torch.asin(torch.clamp(rb, -1.0 + 1e-6, 1.0 - 1e-6)) / PI
        + 0.5, rb)
    return uu, vv


def _sample_scene_textures(scene, tid, uu, vv):
    return sample_texture_quads(scene.tex_quads, scene.tex_size,
                                scene.textures.shape[1],
                                scene.textures.shape[2], tid, uu, vv)


def _add_sky(color, miss, f: int, n: int, scene, cfg, pt=None):
    """Frame f's deferred sky term: contribution * env(direction), times
    the ray's final texture-albedo product `pt` when textured."""
    frow = f * 8
    mdir = miss[frow:frow + 3, :n].T
    mctr = miss[frow + 3:frow + 6, :n].T
    mmask = miss[frow + 6, :n] > 0.5
    sky_term = mctr * sky_tap(scene, mdir, mmask) * (
        1.0 if cfg.draw_environment else 0.0)
    if pt is not None:
        sky_term = sky_term * pt
    return color + torch.where(mmask[:, None], sky_term, 0.0)


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_POSTPASS_ARGTYPES = [_P, _LL, _LL, _P, _LL, _P, _LL,  # color, miss, rec
                      _P, _I, _P, _I, _I, _I,          # texture quads
                      _P, _I, _I, _I, _P, ctypes.c_float,  # environment
                      _I, _I, _I, _I, _I, _P, _P]      # .. out, stream
ENV_MAP_F32, ENV_MAP_PACKED, ENV_SUN = 0, 1, 2         # csrc/postpass.cu
_POSTPASS = {}                     # the launch function and the sun's row


def _postpass_launch():
    """csrc/postpass.cu's launch function, its argument types set, and
    procedural_sun_sky's constants as its 12 host floats (horizon, zenith,
    ground, sun direction); made once."""
    if not _POSTPASS:
        fn = load_kernel_library("postpass").postpass_dense_launch
        fn.argtypes = _POSTPASS_ARGTYPES
        fn.restype = ctypes.c_int
        sun = sun_sky_constants("cpu").reshape(-1).tolist()
        _POSTPASS.update(fn=fn, sun=(ctypes.c_float * 12)(*sun))
    return _POSTPASS["fn"], _POSTPASS["sun"]


def _postpass_tables(scene) -> tuple:
    """(texture quads packed, environment variant) of the scene's tables
    for the kernel, checked once per scene."""
    def build():
        for name, q in (("tex_quads", scene.tex_quads),
                        ("sky_quads", scene.sky_quads)):
            width = 4 if q.dtype == torch.int32 else 12
            if (q.dtype not in (torch.int32, torch.float32) or q.dim() != 2
                    or q.shape[1] != width or not q.is_contiguous()
                    or q.data_ptr() % 16):
                raise ValueError(f"mega_postpass: {name} must be a "
                                 "contiguous, 16-byte aligned (.., 4) int32 "
                                 "or (.., 12) float32 quad table")
        check_arg("mega_postpass", "tex_size", scene.tex_size, torch.int32,
                  (scene.textures.shape[0], 2), scene.device)
        env = (ENV_SUN if scene.env_sun else ENV_MAP_PACKED
               if scene.sky_quads.dtype == torch.int32 else ENV_MAP_F32)
        return int(scene.tex_quads.dtype == torch.int32), env
    return scene.derived("postpass_tables", build)


def _check_rows(name: str, t, rows: int, n: int, dev) -> None:
    if (t is None or t.device != dev or t.dtype != torch.float32
            or t.dim() != 2 or t.shape[0] != rows or t.shape[1] < n):
        got = "None" if t is None else f"{t.dtype} {tuple(t.shape)} on " \
            f"{t.device}"
        raise ValueError(f"mega_postpass: {name} must be a float32 tensor "
                         f"of shape ({rows}, >= {n}) on {dev}; got {got}")


def _check_postpass(color, miss, rec, scene, cfg, n: int):
    """Raise ValueError unless the post-pass's inputs are f32 on the
    scene's device: color (n, 3) of any strides, miss (8F, >= n) and, for
    a textured scene, rec (8FB, >= n)."""
    dev = color.device
    if n <= 0:
        raise ValueError("mega_postpass: need n > 0")
    if scene.device != dev:
        raise ValueError(f"mega_postpass: inputs on {dev}, scene on "
                         f"{scene.device}")
    if color.dtype != torch.float32 or color.shape != (n, 3):
        raise ValueError(f"mega_postpass: color must be a float32 tensor of "
                         f"shape ({n}, 3); got {color.dtype} "
                         f"{tuple(color.shape)}")
    _check_rows("miss", miss, 8 * cfg.max_frames, n, dev)
    if scene.any_textured:
        _check_rows("rec", rec, 8 * cfg.max_frames * cfg.max_bounces, n, dev)


@span("rtm.postpass")
def mega_postpass(color, miss, rec, scene, cfg, n: int):
    """The texture/sky reconstruction over the kernels' deferred records,
    in the dense form on every scene: color (n, 3) of any strides (a
    tracing kernel's (3, n) rows, transposed), miss (8F, >= n), rec (8FB,
    >= n) or None for an untextured scene; returns (n, 3).

    CPU tensors go to `mega_postpass_dense`, its plain version.  CUDA
    tensors launch csrc/postpass.cu (built at first use) once and raise on
    arguments it does not take and on any launch error;
    `mega_postpass.launches` counts the launches.  The kernel replaces no
    TPU kernel (rtm_tpu's post-pass is XLA): the dense form as torch ops
    re-read (B, n) temporaries in dozens of launches a frame, ~24 ms of a
    1280x720, 4-sample, 8-bounce dispatch on the H100 and most of an
    interactive frame's host work.  Bytes bound it, each slot's records,
    miss rows and color read once and its pixel written once (1.08 GB
    that dispatch, 0.32 ms at 3.35 TB/s); one thread a slot, coalesced
    field rows, one quad-row load a texture or sky tap, the plain form's
    operations in its order (csrc/postpass.cu says more).

    rtm_tpu takes its compacted form for textured multi-bounce scenes
    unless `RTM_DENSE_POSTPASS=1`; the port's post-pass is the one that
    switch forces, and it has no switch.  The compacted form gives the
    same bits."""
    dev = color.device
    _check_postpass(color, miss, rec, scene, cfg, n)
    if dev.type == "cpu":
        return mega_postpass_dense(color, miss, rec, scene, cfg, n)
    if dev.type != "cuda":
        raise ValueError(f"mega_postpass: unsupported device {dev}")
    textured = scene.any_textured
    if miss.stride(1) != 1 or (textured and rec.stride(1) != 1):
        raise ValueError("mega_postpass: miss and rec need contiguous rows")
    tex_packed, env = _postpass_tables(scene)
    fn, sun = _postpass_launch()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(color.data_ptr(), color.stride(0), color.stride(1),
                 miss.data_ptr(), miss.stride(0),
                 rec.data_ptr() if textured else None,
                 rec.stride(0) if textured else 0,
                 scene.tex_quads.data_ptr(), tex_packed,
                 scene.tex_size.data_ptr(), *scene.textures.shape[:3],
                 scene.sky_quads.data_ptr(), env, *scene.sky.shape[:2], sun,
                 1.0 if cfg.draw_environment else 0.0, int(textured),
                 int(scene.num_spheres > 0), n, cfg.max_frames,
                 cfg.max_bounces, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mega_postpass: kernel launch failed with CUDA "
                           f"error {err}")
    mega_postpass.launches += 1
    return out


mega_postpass.launches = 0


def _dense_frame(rt, color, scene, n: int, have_sph: bool):
    """One frame of the dense reconstruction over rt = (B, 8, n) records:
    one texture tap per (ray, bounce) slot.  Returns (color with texture
    terms added, final albedo product)."""
    bounces = rt.shape[0]
    has_tex = rt[:, 6] > -0.5                                  # (B, n)
    uu, vv = _tex_uv_of_records(rt[:, 3], rt[:, 4], rt[:, 5],
                                rt[:, 7] > 0.5, have_sph)
    tex_all = _sample_scene_textures(
        scene, torch.where(has_tex, rt[:, 6].to(torch.int32), 0),
        torch.where(has_tex, uu, 0.0), torch.where(has_tex, vv, 0.0))
    pt = torch.ones((n, 3), dtype=torch.float32, device=color.device)
    for b in range(bounces):
        s_term = rt[b, 0:3].T
        ht = has_tex[b][:, None]
        tex_rgb = tex_all[b]
        term = s_term * pt
        color = color + torch.where(ht, term * tex_rgb, term)
        pt = pt * torch.where(ht, tex_rgb, 1.0)
    return color, pt


def mega_postpass_dense(color, miss, rec, scene, cfg, n: int):
    """The dense reconstruction: one texture tap per (ray, bounce) slot."""
    frames = cfg.max_frames
    bounces = cfg.max_bounces
    have_sph = int(scene.sph_pos.shape[0]) > 0
    for f in range(frames):
        pt = None
        if scene.any_textured:
            rt = rec[f * bounces * 8:(f + 1) * bounces * 8, :n].reshape(
                bounces, 8, n)
            color, pt = _dense_frame(rt, color, scene, n, have_sph)
        color = _add_sky(color, miss, f, n, scene, cfg, pt)
    return color / float(frames)                          # shader:711


def _compact_frame(rt, color, scene, n: int, cap: int, bits: int,
                   have_sph: bool, sig_rays, cnt):
    """One frame of the compacted reconstruction over rt = (B, 8, n)
    records, given each slot's significance (n, B), each ray's count and
    the slot ids' width `bits`: (color with texture terms added, final
    albedo product).  Exact where the frame's significant count is at
    most `cap`; past it the caller takes the dense form's."""
    bounces = rt.shape[0]
    nb = n * bounces
    dev = color.device
    start = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    slot = torch.arange(nb, dtype=torch.int32, device=dev)
    key = slot | torch.where(sig_rays.reshape(-1), 0, 1 << bits).to(
        torch.int32)
    skey = torch.sort(key).values[:cap]
    valid = skey < (1 << bits)
    perm = (skey & ((1 << bits) - 1)).long()

    rec_t = rt.permute(2, 0, 1).reshape(nb, 8)
    crec = rec_t[perm]                                         # (cap, 8)
    has_tex = (crec[:, 6] > -0.5) & valid
    uu, vv = _tex_uv_of_records(crec[:, 3], crec[:, 4], crec[:, 5],
                                crec[:, 7] > 0.5, have_sph)
    tex_c = _sample_scene_textures(
        scene, torch.where(has_tex, crec[:, 6].to(torch.int32), 0),
        torch.where(has_tex, uu, 0.0),
        torch.where(has_tex, vv, 0.0))                         # (cap, 3)

    k = torch.arange(bounces, device=dev)
    seg = k[None, :] < cnt[:, None]                            # (n, B)
    pos = torch.clamp(start[:, None] + k[None, :], 0, cap - 1).long()
    s_k = torch.where(seg[..., None], crec[pos, 0:3], 0.0)
    f_k = torch.where((has_tex[pos] & seg)[..., None], tex_c[pos],
                      1.0)                                     # albedo
    pt = torch.ones((n, 3), dtype=torch.float32, device=dev)
    for b in range(bounces):
        color = color + s_k[:, b] * pt * f_k[:, b]
        pt = pt * f_k[:, b]
    return color, pt


def mega_postpass_compact(color, miss, rec, scene, cfg, n: int,
                          cap: int | None = None):
    """Compacted texture/sky reconstruction: taps only the significant
    records (textured or emissive).

      1. a significant mask per (ray, bounce) slot;
      2. one `torch.sort` of the ray-major slot ids with a "not
         significant" high bit: the first `cap` sorted keys are the
         compact slot list, grouped by ray with bounces ascending;
      3. one gather of the 8-field records at those slots and one
         texture tap per compact slot;
      4. the albedo chain and the sum per ray over its significant
         records in bounce order, as the dense form runs them (its other
         records add 0 and multiply by 1, exactly), from one (n, B)
         gather of each ray's segment.

    `cap` (default n) below n * bounces can overflow: each frame then also
    runs the dense form and the device selects by the frame's count
    (rtm_tpu's `lax.cond`), with no host read.  Both forms give the same
    bits, so a frame does not depend on the capacity or on how its slots
    were split into dispatches (rtm_tpu's compact form sums by a
    segmented scan, in another order).
    """
    frames = cfg.max_frames
    bounces = cfg.max_bounces
    if not scene.any_textured:
        raise ValueError("mega_postpass_compact needs a textured scene")
    nb = n * bounces
    bits = max(int(np.ceil(np.log2(max(nb, 2)))), 1)
    if bits > 30:
        raise ValueError("slot id + sentinel bit must fit int32")
    cap = n if cap is None else min(cap, nb)
    have_sph = int(scene.sph_pos.shape[0]) > 0

    for f in range(frames):
        rt = rec[f * bounces * 8:(f + 1) * bounces * 8, :n].reshape(
            bounces, 8, n)
        s_abs = rt[:, 0].abs() + rt[:, 1].abs() + rt[:, 2].abs()
        sig_rays = ((rt[:, 6] > -0.5) | (s_abs > 0.0)).T       # (n, B)
        cnt = sig_rays.sum(dim=1, dtype=torch.int32)
        t_color, pt = _compact_frame(rt, color, scene, n, cap, bits,
                                     have_sph, sig_rays, cnt)
        if cap < nb:
            d_color, d_pt = _dense_frame(rt, color, scene, n, have_sph)
            fits = cnt.sum() <= cap
            t_color = torch.where(fits, t_color, d_color)
            pt = torch.where(fits, pt, d_pt)
        color = _add_sky(t_color, miss, f, n, scene, cfg, pt)

    return color / float(frames)                          # shader:711


# ---------------------------------------------------------------------------
# The megakernel: plain version
# ---------------------------------------------------------------------------

class MegaStats(NamedTuple):
    """Per-(frame, bounce) work and winners of a megakernel dispatch, row
    fb = (frame - 1) * bounces + b: the cluster passes of each ray tile,
    the hit of each slot (padded-table row of an alive triangle winner,
    -2 - sphere of an alive sphere winner, -1 otherwise), and from the
    plain version only, which clusters each tile swept and which slots
    were alive at the bounce's start."""

    passes: torch.Tensor               # (FB, tiles) i32
    winners: torch.Tensor              # (FB, n) i32
    passed: torch.Tensor | None = None  # (FB, tiles, C) bool
    alive: torch.Tensor | None = None   # (FB, n) bool


def _ordered(pack: MegaPack, cull: bool, order: str) -> bool:
    """rtm_tpu's choice of the nearest-first sweep (megakernel.py:612-613,
    :1136-1137)."""
    if order not in ("static", "near"):
        raise ValueError(f"unknown cluster order {order!r}")
    return (cull and order == "near"
            and 0 < pack.n_clusters <= KEY_LANES)


def _sweep_near_plain(pack: MegaPack, state8, tile_live, ray_tile: int):
    """rtm_tpu `_tri_sweep_ordered` (megakernel.py:491-595), one tile at a
    time: each cluster's key is its least slab entry over the tile's alive
    rays (BIG when none enters), and the clusters are popped in key order,
    the lowest index first on ties, until the keys reach BIG; a popped
    cluster is swept when an alive ray enters it nearer than its best t.
    state8 and the returns as the static sweep's (cluster_sweep_plain,
    with_passed)."""
    n = state8.shape[1]
    tiles = n // ray_tile
    dev = state8.device
    ox, oy, oz, dx, dy, dz = ray = [state8[k][:, None] for k in range(6)]
    ray += _cross(ox, oy, oz, dx, dy, dz)                  # w = o x d
    alive = (state8[6] > 0.5)[:, None]
    inv = _safe_inv_dirs(dx, dy, dz)
    boxes_t = pack.boxes.T                          # rows (C,) per bound
    best_t = torch.full((n, 1), BIG, device=dev)
    best_i = torch.full((n, 1), -1, dtype=torch.int64, device=dev)
    passed = torch.zeros((tiles, pack.n_clusters), dtype=torch.bool,
                         device=dev)
    for tile in range(tiles):
        if not bool(tile_live[tile]):
            continue
        sl = slice(tile * ray_tile, (tile + 1) * ray_tile)
        r = [v[sl] for v in ray]
        a = alive[sl]
        near = _slab_near(boxes_t, r[0], r[1], r[2],
                          *(v[sl] for v in inv))    # (R, C)
        keys, order = torch.sort(torch.where(a, near, BIG).amin(dim=0),
                                 stable=True)
        bt, bi = best_t[sl], best_i[sl]
        for key, ci in zip(keys.tolist(), order.tolist()):
            if key >= BIG:
                break
            if not bool(((near[:, ci:ci + 1] < bt) & a).any()):
                continue
            passed[tile, ci] = True
            off, wdt = pack.cluster_offsets[ci], pack.cluster_widths[ci]
            cmin, cand = cluster_argmin(
                pair_t(pack.tri_feats[off:off + wdt].T, *r), off)
            better = cmin < bt
            bt = torch.where(better, cmin, bt)
            bi = torch.where(better, cand, bi)
        best_t[sl], best_i[sl] = bt, bi
    return (best_t[:, 0], best_i[:, 0].to(torch.int32),
            passed.sum(dim=1, dtype=torch.int32), passed)


def mega_trace_plain(scene, pack: MegaPack, camf, frame_index: int,
                     pixel_offset: int, n_rays: int, cfg: RenderConfig,
                     ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                     order: str = "static", with_stats: bool = False):
    """Plain PyTorch version of the kernel (megakernel.py:598-1057, an
    expression at a time), vectorised over rays with Python loops over
    frames, bounces and clusters.  Returns (color (3, N), miss (8F, N),
    rec (8FB, N) or None, MegaStats or None), in slot order.

    Layout of the kernel it stands for: ray tiles of `ray_tile` slots (one
    thread block) decide the cull together; slots past n_rays in the last
    tile are dead from the start; a tile whose rays are all dead leaves
    the bounce loop, and its remaining records keep the pre-fill (zeros,
    texid -1)."""
    dev = camf.device
    w, h = cfg.width, cfg.height
    frames, bounces = cfg.max_frames, cfg.max_bounces
    textured = scene.any_textured
    have_tris = pack.n_clusters > 0
    have_sph = pack.n_spheres_padded > 0
    ordered = _ordered(pack, cull, order)
    r = ray_tile
    n = n_rays
    n_pad = -(-n // r) * r
    tiles = n_pad // r
    f32 = dict(dtype=torch.float32, device=dev)
    sel = torch.where

    lin = pixel_offset + torch.arange(n_pad, dtype=torch.int64, device=dev)
    if use_block8(w, h):
        xpix, ypix = slot_to_xy(lin, w)
    else:
        xpix, ypix = lin % w, lin // w
    lin_u = (ypix * w + xpix) & U32_MASK        # seeds: row-major pixel id
    basis = camera_frame(camf, w, h, xpix, ypix)
    valid = torch.arange(n_pad, device=dev) < n

    miss = torch.empty((8 * frames, n_pad), **f32)
    rec = (torch.empty((8 * frames * bounces, n_pad), **f32) if textured
           else None)
    prefill = torch.zeros((8, 1), **f32)
    prefill[6] = -1.0
    zero = torch.zeros(n_pad, **f32)
    no_attr = torch.zeros((n_pad, NUM_ATTRS), **f32)
    col_r = col_g = col_b = zero
    st_passed, st_alive, st_win = [], [], []

    for frame in range(1, frames + 1):
        seed = (lin_u + frame * frame_index * SEED_STRIDE) & U32_MASK
        ox, oy, oz, dx, dy, dz, seed = jittered_ray(seed, basis)
        ctr_r = ctr_g = ctr_b = torch.ones(n_pad, **f32)
        alive = valid
        m_dx = m_dy = m_dz = m_cr = m_cg = m_cb = zero

        for b in range(bounces):
            tile_live = alive.view(tiles, r).any(dim=1)
            seed = (seed + b) & U32_MASK                      # shader:659
            if with_stats:
                st_alive.append(alive[:n])

            # ---- nearest triangle: the cluster sweep ----------------------
            t_tri = torch.full((n_pad,), BIG, **f32)
            i_tri = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
            passed = torch.zeros((tiles, pack.n_clusters), dtype=torch.bool,
                                 device=dev)
            if have_tris:
                state8 = torch.stack([ox, oy, oz, dx, dy, dz, alive.float(),
                                      zero])
                if ordered:
                    t_tri, i_tri, _, passed = _sweep_near_plain(
                        pack, state8, tile_live, r)
                else:
                    from .sweep_kernel import cluster_sweep_plain
                    t_tri, i_tri, _, passed = cluster_sweep_plain(
                        pack.tri_feats, pack.boxes, pack.cluster_offsets,
                        pack.cluster_widths, state8, r, cull,
                        with_passed=True)
                    # a tile whose rays are all dead has left the loop
                    passed &= tile_live[:, None]
                i_tri = i_tri.long()
            if with_stats:
                st_passed.append(passed)

            # ---- nearest sphere (shader:486-524) --------------------------
            if have_sph:
                t_sph, s_idx = sphere_nearest_smem(pack.spheres, ox, oy, oz,
                                                   dx, dy, dz)
            else:
                t_sph = torch.full((n_pad,), BIG, **f32)
                s_idx = torch.zeros(n_pad, dtype=torch.int32, device=dev)

            # sphere wins ties (the reference tests triangles with strict <
            # after spheres); the hit is decided on the sweep's t
            use_tri = t_tri < t_sph
            t_hit = sel(use_tri, t_tri, t_sph)
            hit = t_hit < BIG

            # ---- the winner's attributes: zero unless an alive triangle
            # winner (the one-hot fetch, megakernel.py:797-807) -------------
            fetch = use_tri & alive
            ext = (sel(fetch[:, None], pack.tri_attrs[i_tri.clamp(min=0)],
                       0.0) if have_tris else no_attr)

            def e(j, ext=ext):
                return ext[:, j]

            if have_tris:
                # exact hit distance of the winner from its plane
                gden = -(dx * e(_A_GNX) + dy * e(_A_GNY) + dz * e(_A_GNZ))
                t_ex = (ox * e(_A_GNX) + oy * e(_A_GNY) + oz * e(_A_GNZ)
                        - e(_A_GAN)) / sel(gden == 0.0, 1.0, gden)
                t_hit = sel(fetch, t_ex, t_hit)

            t_safe = sel(hit, t_hit, 0.0)
            hx = ox + t_safe * dx
            hy = oy + t_safe * dy
            hz = oz + t_safe * dz
            use_t = use_tri.float()
            use_s = (hit & ~use_tri).float()
            if with_stats:
                st_win.append(sel(fetch, i_tri, sel(
                    alive & (use_s > 0.0), -2 - s_idx.long(), -1))[:n])

            if have_sph:
                srow = sel((use_s > 0.0)[None, :],
                           pack.spheres[:, s_idx.long()], 0.0)

                def sx(j, srow=srow):
                    return srow[j]

                snx, sny, snz = _normalize(hx - sx(_S_CX), hy - sx(_S_CY),
                                           hz - sx(_S_CZ))
            else:
                def sx(j):
                    return zero

                snx = sny = snz = zero
            nxh = e(_A_NX) * use_t + snx * use_s
            nyh = e(_A_NY) * use_t + sny * use_s
            nzh = e(_A_NZ) * use_t + snz * use_s

            alr = e(_A_ALR) * use_t + sx(_S_ALR) * use_s
            alg = e(_A_ALG) * use_t + sx(_S_ALG) * use_s
            alb = e(_A_ALB) * use_t + sx(_S_ALB) * use_s
            emr = e(_A_EMR) * use_t + sx(_S_EMR) * use_s
            emg = e(_A_EMG) * use_t + sx(_S_EMG) * use_s
            emb = e(_A_EMB) * use_t + sx(_S_EMB) * use_s
            emp = e(_A_EMP) * use_t + sx(_S_EMP) * use_s
            rough = e(_A_ROUGH) * use_t + sx(_S_ROUGH) * use_s
            metal = e(_A_METAL) * use_t + sx(_S_METAL) * use_s
            refr = e(_A_REFR) * use_t + sx(_S_REFR) * use_s
            texid = (e(_A_TEX) * use_t + sx(_S_TEX) * use_s
                     + (-1.0) * (1.0 - use_t - use_s))

            live = alive & hit
            miss_now = alive & ~hit
            # first (and only) miss: direction and contribution for the sky
            m_dx = sel(miss_now, dx, m_dx)
            m_dy = sel(miss_now, dy, m_dy)
            m_dz = sel(miss_now, dz, m_dz)
            m_cr = sel(miss_now, ctr_r, m_cr)
            m_cg = sel(miss_now, ctr_g, m_cg)
            m_cb = sel(miss_now, ctr_b, m_cb)

            livef = live.float()
            if textured:
                has_tex = (texid > -0.5) & live
                htf = has_tex.float()
                # S_b = P^m * (tex ? emp : emc * emp)  (shader:575-585)
                s_r = ctr_r * sel(has_tex, emp, emr * emp) * livef
                s_g = ctr_g * sel(has_tex, emp, emg * emp) * livef
                s_b = ctr_b * sel(has_tex, emp, emb * emp) * livef
                # uv: the reference's space-mixed barycentrics
                # (shader:257-268); spheres record their normal
                aox = ox - e(_A_LAX)
                aoy = oy - e(_A_LAY)
                aoz = oz - e(_A_LAZ)
                dax, day, daz = _cross(aox, aoy, aoz, dx, dy, dz)
                nvx, nvy, nvz = _cross(e(_A_ABX), e(_A_ABY), e(_A_ABZ),
                                       e(_A_ACX), e(_A_ACY), e(_A_ACZ))
                detl = -(dx * nvx + dy * nvy + dz * nvz)
                invl = 1.0 / sel(detl == 0.0, 1.0, detl)
                ub = (e(_A_ACX) * dax + e(_A_ACY) * day
                      + e(_A_ACZ) * daz) * invl
                vb = -(e(_A_ABX) * dax + e(_A_ABY) * day
                       + e(_A_ABZ) * daz) * invl
                wb = 1.0 - ub - vb
                uu = e(_A_U0) * wb + e(_A_U1) * ub + e(_A_U2) * vb
                vv = e(_A_V0) * wb + e(_A_V1) * ub + e(_A_V2) * vb
                rows = torch.stack([s_r, s_g, s_b,
                                    uu * use_t + snx * use_s,
                                    vv * use_t + sny * use_s,
                                    snz * use_s, sel(has_tex, texid, -1.0),
                                    use_s * htf])
                row = ((frame - 1) * bounces + b) * 8
                rec[row:row + 8] = sel(tile_live.repeat_interleave(r),
                                       rows, prefill)
                # P^m *= (tex ? 1 : albedo)
                keep = 1.0 - livef * (1.0 - htf)
                ctr_r = ctr_r * (keep + livef * (1.0 - htf) * alr)
                ctr_g = ctr_g * (keep + livef * (1.0 - htf) * alg)
                ctr_b = ctr_b * (keep + livef * (1.0 - htf) * alb)
            else:
                col_r = col_r + emr * emp * ctr_r * livef
                col_g = col_g + emg * emp * ctr_g * livef
                col_b = col_b + emb * emp * ctr_b * livef
                ctr_r = ctr_r * (1.0 - livef + livef * alr)
                ctr_g = ctr_g * (1.0 - livef + livef * alg)
                ctr_b = ctr_b * (1.0 - livef + livef * alb)

            # ---- scatter (shader:590-649) ---------------------------------
            n_ox, n_oy, n_oz, n_dx, n_dy, n_dz, n_seed = scatter_step(
                dx, dy, dz, nxh, nyh, nzh, hx, hy, hz, rough, metal, refr,
                seed)
            ox, oy, oz = sel(live, n_ox, ox), sel(live, n_oy, oy), sel(
                live, n_oz, oz)
            dx, dy, dz = sel(live, n_dx, dx), sel(live, n_dy, dy), sel(
                live, n_dz, dz)
            seed = sel(live, n_seed, seed)
            alive = live

        valid_m = ((m_dx * m_dx + m_dy * m_dy + m_dz * m_dz) > 0.0).float()
        miss[(frame - 1) * 8:frame * 8] = torch.stack(
            [m_dx, m_dy, m_dz, m_cr, m_cg, m_cb, valid_m, zero])

    stats = None
    if with_stats:
        passed = torch.stack(st_passed)
        stats = MegaStats(passed.sum(dim=2, dtype=torch.int32),
                          torch.stack(st_win).to(torch.int32), passed,
                          torch.stack(st_alive))
    return (torch.stack([col_r, col_g, col_b])[:, :n], miss[:, :n],
            None if rec is None else rec[:, :n], stats)


# ---------------------------------------------------------------------------
# The megakernel: kernel wrapper and drivers
# ---------------------------------------------------------------------------

_ARGTYPES = [_P, ctypes.c_uint32, _I, _I, _I, _I, _I, _I, _I,  # .. ray_tile
             _P, _P, _P, _P, _P, _I, _I, _I,       # cluster tables, flags
             _P, _I,                               # sphere table
             _P, _P, _P, _P, _P, _P]               # outputs, stream


@span("rtm.mega.trace")
def mega_trace(scene, pack: MegaPack, camf, frame_index: int,
               pixel_offset: int, n_rays: int, cfg: RenderConfig,
               ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
               order: str = "static", with_stats: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays) over
    `pack` (build_mega_pack of `scene`): returns (color (3, N), miss
    (8F, N), rec (8FB, N) or None, MegaStats or None); the kernel's stats
    hold the passes and the winners only.

    CPU tensors go to `mega_trace_plain`; CUDA tensors launch the kernel
    of csrc/mega_trace.cu (built at first use) and raise on arguments it
    does not take and on any launch error.  `mega_trace.launches` counts
    the kernel launches."""
    dev = camf.device
    ordered = _ordered(pack, cull, order)
    if scene.device != dev:
        raise ValueError(f"mega_trace: camera row on {dev}, scene on "
                         f"{scene.device}")
    if dev.type == "cpu":
        color, miss, rec, stats = mega_trace_plain(
            scene, pack, camf, frame_index, pixel_offset, n_rays, cfg,
            ray_tile, cull, order, with_stats)
        return color, miss, rec, stats
    if dev.type != "cuda":
        raise ValueError(f"mega_trace: unsupported device {dev}")
    n = int(n_rays)
    if n <= 0 or pixel_offset < 0:
        raise ValueError("mega_trace: need n_rays > 0 and pixel_offset >= 0")
    if not (0 < ray_tile <= MAX_RAY_TILE and ray_tile % 32 == 0):
        raise ValueError("mega_trace: ray_tile must be a multiple of 32 in "
                         f"(0, {MAX_RAY_TILE}]; got {ray_tile}")
    frames, bounces = cfg.max_frames, cfg.max_bounces
    nc, sp = pack.n_clusters, pack.n_spheres_padded
    chk = lambda *a: check_arg("mega_trace", *a)  # noqa: E731
    chk("camf", camf, torch.float32, (64,), dev)
    if nc > 0:
        tp = pack.n_padded_tris
        chk("tri_feats", pack.tri_feats, torch.float32, (tp, 16), dev)
        chk("tri_attrs", pack.tri_attrs, torch.float32, (tp, NUM_ATTRS), dev)
        chk("boxes", pack.boxes, torch.float32, (nc, 8), dev)
        chk("offsets", pack.offsets_dev, torch.int32, (nc,), dev)
        chk("widths", pack.widths_dev, torch.int32, (nc,), dev)
    if sp > 0:
        chk("spheres", pack.spheres, torch.float32, (S_ROWS, sp), dev)

    f32 = dict(dtype=torch.float32, device=dev)
    color = torch.empty((3, n), **f32)
    miss = torch.empty((8 * frames, n), **f32)
    rec = (torch.empty((8 * frames * bounces, n), **f32)
           if scene.any_textured else None)
    tiles = -(-n // ray_tile)
    stats = (MegaStats(torch.empty((frames * bounces, tiles),
                                   dtype=torch.int32, device=dev),
                       torch.empty((frames * bounces, n), dtype=torch.int32,
                                   device=dev)) if with_stats else None)
    fn = load_kernel_library("mega_trace").mega_trace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(camf.data_ptr(), int(frame_index) & U32_MASK,
                 int(pixel_offset), n, cfg.width, cfg.height, frames,
                 bounces, ray_tile, ptr(pack.tri_feats), ptr(pack.tri_attrs),
                 ptr(pack.boxes), ptr(pack.offsets_dev),
                 ptr(pack.widths_dev), nc, int(bool(cull)), int(ordered),
                 ptr(pack.spheres), sp, color.data_ptr(), miss.data_ptr(),
                 ptr(rec), ptr(stats and stats.passes),
                 ptr(stats and stats.winners), stream)
    if err != 0:
        raise RuntimeError(f"mega_trace: kernel launch failed with CUDA "
                           f"error {err}")
    mega_trace.launches += 1
    return color, miss, rec, stats


mega_trace.launches = 0


def render_rays_megakernel(scene, cam, frame_index: int, cfg: RenderConfig,
                           pixel_offset: int, n_rays: int,
                           ray_tile: int = DEFAULT_RAY_TILE,
                           cull: bool = True, skip_postpass: bool = False,
                           order: str = "static"):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays) of the
    cfg.width x cfg.height grid through the megakernel and the post-pass:
    the unit a banded multi-device renderer dispatches per device.
    Returns (n_rays, 3) in slot order (8x8 pixel blocks when both sides are
    multiples of 8, else row-major).  skip_postpass returns the kernel's
    raw color.  order: "static" (table order, rtm_tpu's default) or "near"
    (nearest-first, taken with cull and at most KEY_LANES clusters)."""
    pack = build_mega_pack(scene)
    camf = _pack_camera(cam, scene.device)
    color, miss, rec, _ = mega_trace(scene, pack, camf, frame_index,
                                     pixel_offset, n_rays, cfg, ray_tile,
                                     cull, order)
    color = color.T
    if skip_postpass:
        return color.contiguous()
    return mega_postpass(color, miss, rec, scene, cfg, n_rays)


def render_megakernel(scene, cam, frame_index: int, cfg: RenderConfig,
                      ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                      order: str = "static"):
    """Full-frame forward dispatch through the megakernel: (H, W, 3) f32
    radiance averaged over cfg.max_frames samples, the contract of
    render_dispatch.  Forward only: the gradient routes are mxu replay,
    wavefront2, xla and pallas."""
    color = render_rays_megakernel(scene, cam, frame_index, cfg,
                                   pixel_offset=0,
                                   n_rays=cfg.width * cfg.height,
                                   ray_tile=ray_tile, cull=cull, order=order)
    if use_block8(cfg.width, cfg.height):
        return slots_to_image(color, cfg.width, cfg.height)
    return color.reshape(cfg.height, cfg.width, 3)
