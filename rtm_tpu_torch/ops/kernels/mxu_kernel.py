"""Brute-force pair-test path-tracing kernel for small scenes (<= 2047
triangles): the main forward path of the port.

Port of rtm_tpu/ops/pallas/mxu_kernel.py.  One kernel runs the whole
frames x bounces loop per ray: camera ray with both jitters, PCG draws,
the sphere loop, a pair test of the ray against every triangle in
Morton-ordered 128-triangle chunks (chunks culled by their bbox), an argmin
with the triangle index packed into the low 11 bits of the ordering t, an
exact f32 retest of the winner, attribute fetch, shading, scatter, and the
deferred texture/miss records that the post-pass (megakernel.mega_postpass)
turns into radiance.

The pair test is linear in the ray's Pluecker feature vector
f = [d, o x d, o, 1]: per triangle, four rows give the three edge side
tests s1, s2, s3 (their sum is det = -d.n, the backface gate) and
tdet = (o - a).n.  A pair passes when all four are >= 0 and is ordered by
tt = min(tdet / max(det, DET_EPS), 1e28).

Two implementations of one contract (`mxu_trace`), both over the TPU
kernel's bf16 K-stack table (`pair` rows [A_hi | A_hi | A_lo]):
  * the CUDA kernel (csrc/mxu_trace.cu), one thread per ray, the pair
    products on the tensor cores (mma.sync, bf16 in, f32 accumulate): the
    rows' 16 bits (A_hi + A_lo) against the ray's f32 features split into
    three bf16 parts, the f32 product of the table's values;
  * the plain version `mxu_trace_plain`, vectorised over rays, which keeps
    the TPU kernel's bf16x3 product (`pair` against [b_hi; b_lo; b_hi]) so
    that on the CPU it tracks rtm_tpu as closely as summation order allows.
The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.

Outputs, all in dispatch-slot order (one column per slot):
  color  (3, N)     radiance summed over frames (untextured scenes only;
                    zero when textured — the post-pass adds everything)
  miss   (8F, N)    per frame: miss direction, contribution, valid, 0
  rec    (8FB, N)   textured scenes: per (frame, bounce) s_rgb, uv or
                    sphere normal, texid or -1, sphere flag
  hitrec (FB, N)    optional packed winner: HR_TRI | scene row,
                    HR_SPH | sphere, 0 = miss
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
from .trav_kernel import SideTables, build_side_tables, check_side_tables
from .vreg_common import (BIG, NO_TEX, PathState, _cross, _safe_inv_dirs,
                          camera_frame, jittered_ray, miss_rows, shade_tail,
                          sphere_nearest_smem)

K = 16                       # ray feature depth: [d, oxd, o, 1] pad 10->16
KS = 3 * K                   # bf16x3 stacked contraction depth
Q = 4                        # pair rows per triangle: s1, s2, s3, tdet
CHUNK = 128                  # triangles per cull chunk
BLOCK = 256                  # the kernel's slots per thread block: its cull
                             # granule (csrc/mxu_trace.cu BLOCK; _library
                             # checks the two agree)
MAX_TRIS = 2047              # 11-bit index pack in the t mantissa
IDX_MASK = 0x7FF

# hitrec packing (record-replay gradients, ops/trace_ref.py in rtm_tpu):
# bits 0..11 the winning primitive index, bit 14 triangle, bit 15 sphere,
# 0 = miss
HR_TRI = 1 << 14
HR_SPH = 1 << 15
HR_IDX = 0xFFF

# attribute table columns (MxuArrays.attr)
_A_NX, _A_NY, _A_NZ, _A_ANDOT = 0, 1, 2, 3
_A_SNX, _A_SNY, _A_SNZ = 4, 5, 6
A_ROWS = 8


@dataclass
class MxuArrays:
    """Static geometry tables in Morton order, chunk-padded to NC*128 rows
    (material/texture/sphere side tables are rebuilt per dispatch)."""

    pair: torch.Tensor     # (NC, Q*128, KS) bf16 K-stacked [A_hi|A_hi|A_lo]
    attr: torch.Tensor     # (NC*128, A_ROWS) f32 n, a.n, shading normal
    info: torch.Tensor     # (NC*128,) i32 mat | texslot<<8 | scene row<<16
    cbox: torch.Tensor     # (NC, 8) f32 chunk bbox lo3 hi3

    def to(self, device) -> "MxuArrays":
        return MxuArrays(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


class MxuMeta(NamedTuple):
    n_tris: int
    nc: int                  # 128-triangle chunks
    supported: bool
    textured_rows: tuple     # scene rows with a textured material


class MxuTables(NamedTuple):
    arrays: MxuArrays
    meta: MxuMeta


def _morton3(vals: np.ndarray) -> np.ndarray:
    """(T,3) centroids -> 30-bit Morton codes (10 bits/axis)."""
    lo = vals.min(axis=0)
    ext = np.maximum(vals.max(axis=0) - lo, 1e-12)
    q = np.clip(((vals - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def build_mxu_tables(tri_wa, tri_wb, tri_wc, tri_normal, tri_mat,
                     mat_texture_id, n_materials: int,
                     n_spheres: int) -> MxuTables:
    """Pack the pair-test rows + attribute tables from host numpy arrays
    (CPU tensors).  Triangles are MORTON-ordered so 128-triangle chunks are
    spatially compact and the kernels cull whole chunks by their bbox."""
    t = len(tri_wa)
    supported = (t <= MAX_TRIS and n_materials <= 128 and n_spheres <= 128)

    tex_id = np.asarray(mat_texture_id).astype(np.int64)
    textured_rows = (np.nonzero(tex_id[np.asarray(tri_mat,
                                                  np.int64)] >= 0)[0]
                     if t > 0 else np.zeros(0, np.int64))
    if len(textured_rows) > 128:
        supported = False
        textured_rows = textured_rows[:128]
    slot_of_row = np.full(max(t, 1), NO_TEX, np.int64)
    slot_of_row[textured_rows] = np.arange(len(textured_rows))

    if t > 0 and supported:
        wa = np.asarray(tri_wa, np.float64)
        wb = np.asarray(tri_wb, np.float64)
        wc = np.asarray(tri_wc, np.float64)
        order = np.argsort(_morton3((wa + wb + wc) / 3.0), kind="stable")
        tri_mat_o = np.asarray(tri_mat, np.int64)[order]
        slot_o = slot_of_row[order]
        nsh_o = np.asarray(tri_normal, np.float32)[order]

        nc = -(-t // CHUNK)
        tp = nc * CHUNK
        a = np.zeros((tp, 3), np.float64)
        b = np.zeros((tp, 3), np.float64)
        c3 = np.zeros((tp, 3), np.float64)
        a[:t] = wa[order]
        b[:t] = wb[order]
        c3[:t] = wc[order]
        n = np.cross(b - a, c3 - a)          # zero rows for padding: det=0

        # per-chunk bounding boxes for the in-kernel cull
        cbox = np.zeros((nc, 8), np.float32)
        for c in range(nc):
            s, e = c * CHUNK, min((c + 1) * CHUNK, t)
            vs = np.concatenate([a[s:e], b[s:e], c3[s:e]], axis=0)
            cbox[c, 0:3] = vs.min(axis=0)
            cbox[c, 3:6] = vs.max(axis=0)

        # pair rows: reversed edges (c->b),(a->c),(b->a) make the side sum
        # equal -d.n = det (the repo's backface gate); tdet = (o-a).n
        rows = np.zeros((tp, Q, K), np.float64)
        for qi, (p, qq) in enumerate(((c3, b), (a, c3), (b, a))):
            rows[:, qi, 0:3] = np.cross(p, qq)      # on d
            rows[:, qi, 3:6] = qq - p               # on m = o x d
        rows[:, 3, 6:9] = n                         # tdet: + o.n
        rows[:, 3, 9] = -(a * n).sum(-1)            # ... - a.n
        # padding rows: all-zero features would pass the >= 0 test; their
        # constant tdet term parked at -1 excludes them
        rows[t:, 3, 9] = -1.0
        pair_f32 = torch.from_numpy(
            rows.reshape(nc, CHUNK, Q, K).transpose(0, 2, 1, 3)
            .reshape(nc, Q * CHUNK, K).astype(np.float32))
        a_hi = pair_f32.to(torch.bfloat16)
        a_lo = (pair_f32 - a_hi.float()).to(torch.bfloat16)
        pair = torch.cat([a_hi, a_hi, a_lo], dim=2)   # (nc, Q*128, KS)

        nsh = np.zeros((tp, 3), np.float32)
        nsh[:t] = nsh_o
        attr = np.zeros((tp, A_ROWS), np.float32)
        attr[:, _A_NX:_A_NZ + 1] = n.astype(np.float32)
        attr[:, _A_ANDOT] = (a * n).sum(-1).astype(np.float32)
        attr[:, _A_SNX:_A_SNZ + 1] = nsh

        info = np.full((tp,), NO_TEX << 8, np.int64)
        # bits 0..7 material, 8..15 texture slot, 16..26 the scene row
        # (pre-Morton index): the replay path needs scene-order ids
        info[:t] = tri_mat_o | (slot_o << 8) | (order << 16)
        info = info.astype(np.int32)
    else:
        nc = 1
        pair = torch.zeros((1, Q * CHUNK, KS), dtype=torch.bfloat16)
        attr = np.zeros((CHUNK, A_ROWS), np.float32)
        info = np.full((CHUNK,), NO_TEX << 8, np.int32)
        cbox = np.zeros((1, 8), np.float32)

    arrays = MxuArrays(pair=pair, attr=torch.from_numpy(attr),
                       info=torch.from_numpy(info),
                       cbox=torch.from_numpy(cbox))
    return MxuTables(arrays, MxuMeta(t, nc, supported,
                                     tuple(int(r) for r in textured_rows)))


def mxu_arrays_from_tpu(pair, attr, info, cbox) -> MxuArrays:
    """MxuArrays (CPU) from rtm_tpu's mxu leaves as NumPy arrays: `pair`
    bfloat16 (or its uint16 bits), `attr` (A_ROWS, NC, 8, 128) and `info`
    (NC, 8, 128) sublane-replicated, `cbox` (NC, 8)."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype, copy=True, order="C"))

    pair_t = t(np.asarray(pair).view(np.int16), np.int16).view(
        torch.bfloat16)
    attr = np.asarray(attr, np.float32)
    attr_t = t(attr[:, :, 0, :].reshape(attr.shape[0], -1).T, np.float32)
    info_t = t(np.asarray(info)[:, 0, :].reshape(-1), np.int32)
    return MxuArrays(pair=pair_t, attr=attr_t, info=info_t,
                     cbox=t(cbox, np.float32))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def side_tables(scene) -> SideTables:
    return build_side_tables(scene, scene.mxu_meta.textured_rows)


def ray_features(ox, oy, oz, dx, dy, dz):
    """The ray side of the pair test: f = [d, o x d, o, 1, 0...] (K, N)
    split into b_hi = bf16(f) and b_lo = bf16(f - b_hi)."""
    mx, my, mz = _cross(ox, oy, oz, dx, dy, dz)
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    b32 = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, one]
                      + [zero] * (K - 10))                 # (K, N)
    b_hi = b32.to(torch.bfloat16)
    b_lo = (b32 - b_hi.float()).to(torch.bfloat16)
    return b_hi, b_lo


def pack_t(tt, idx):
    """The ordering key: tt's bits with the table index in the low 11."""
    return ((tt.view(torch.int32) & ~IDX_MASK) | idx).view(torch.float32)


def nearest_packed_plain(ma: MxuArrays, ox, oy, oz, dx, dy, dz):
    """All-pairs test through the bf16x3 K-stacked product, every chunk:
    the least packed key per ray, BIG where no pair passes.  (The kernel
    skips a chunk that no live ray of its block enters; that changes a key
    only for a ray lying in a triangle's plane, whose "hit" at t = 0 the
    retest rejects.)"""
    b_hi, b_lo = ray_features(ox, oy, oz, dx, dy, dz)
    rm = torch.cat([b_hi, b_lo, b_hi]).float()            # (KS, N)
    rowi = torch.arange(CHUNK, dtype=torch.int32, device=ox.device)[:, None]
    best = torch.full_like(ox, BIG)
    for c in range(ma.pair.shape[0]):
        acc = ma.pair[c].float() @ rm                      # (Q*128, N)
        s1, s2, s3, td = acc[0:128], acc[128:256], acc[256:384], acc[384:]
        det = s1 + s2 + s3
        m = torch.minimum(torch.minimum(s1, s2), torch.minimum(s3, td))
        tt = torch.clamp(td / torch.clamp(det, min=DET_EPS), max=1e28)
        packed = torch.where(m >= 0.0, pack_t(tt, rowi + c * CHUNK), BIG)
        best = torch.minimum(best, packed.amin(dim=0))
    return best


def _nearest_tri_plain(ma: MxuArrays, n_tris: int, ox, oy, oz, dx, dy, dz):
    """(got, win) of the all-pairs test, win the Morton table row."""
    best = nearest_packed_plain(ma, ox, oy, oz, dx, dy, dz)
    got = best < 1e29
    win = best.view(torch.int32) & IDX_MASK
    return got, torch.clamp(win, 0, max(n_tris - 1, 0)).long()


class MxuStats(NamedTuple):
    """Per-(frame, bounce) work of an mxu dispatch, row fb = (frame - 1) *
    bounces + b: the slots alive at the bounce's start, and per BLOCK-slot
    thread block of the kernel the chunks its cull passed (some alive ray
    of the block enters the chunk's box)."""

    alive: torch.Tensor    # (FB, N) bool
    passed: torch.Tensor   # (FB, ceil(N / BLOCK), NC) bool


def chunk_passes(ma: MxuArrays, alive, ox, oy, oz, dx, dy, dz):
    """The kernel's block-uniform chunk cull: (ceil(N / BLOCK), NC) bool,
    the slab test of csrc/mxu_trace.cu (fminf / fmaxf ignore NaN, as
    torch.fmin / torch.fmax do) of each alive ray against each chunk box,
    OR-ed over each block's slots."""
    inv = _safe_inv_dirs(dx, dy, dz)
    tn = tf = None
    for a, o in enumerate((ox, oy, oz)):
        t1 = (ma.cbox[None, :, a] - o[:, None]) * inv[a][:, None]  # (N, NC)
        t2 = (ma.cbox[None, :, a + 3] - o[:, None]) * inv[a][:, None]
        lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
        tn = lo if tn is None else torch.fmax(tn, lo)
        tf = hi if tf is None else torch.fmin(tf, hi)
    hit = alive[:, None] & (tf >= 0.0) & (tn <= tf)
    n = hit.shape[0]
    blocks = -(-n // BLOCK)
    hit = torch.nn.functional.pad(hit, (0, 0, 0, blocks * BLOCK - n))
    return hit.view(blocks, BLOCK, -1).any(dim=1)


def mxu_trace_plain(scene, tables: SideTables, camf, frame_index: int,
                    pixel_offset: int, n_rays: int, cfg: RenderConfig,
                    return_hitrec: bool = False, with_stats: bool = False):
    """Plain PyTorch version of the kernel: the same outputs from the same
    inputs, vectorised over rays with Python loops over frames, bounces and
    chunks.  Runs on any device.  with_stats appends an MxuStats (the
    kernel's work on these rays, for its bound) to the returned tuple."""
    dev = camf.device
    w, h = cfg.width, cfg.height
    frames, bounces = cfg.max_frames, cfg.max_bounces
    textured = scene.any_textured
    ma, mm = scene.mxu_arrays, scene.mxu_meta
    have_tris = mm.n_tris > 0
    have_sph = scene.num_spheres > 0
    sph = tables.sph
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
    hitrec = (torch.empty((frames * bounces, n), dtype=torch.int32,
                          device=dev) if return_hitrec else None)
    zero = torch.zeros(n, **f32)
    col = [zero] * 3
    st_alive, st_passed = [], []

    for frame in range(1, frames + 1):
        seed = (lin_u + frame * frame_index * SEED_STRIDE) & U32_MASK
        ox, oy, oz, dx, dy, dz, seed = jittered_ray(seed, basis)
        s = PathState(ox, oy, oz, dx, dy, dz, seed,
                      torch.ones(n, dtype=torch.bool, device=dev),
                      [torch.ones(n, **f32) for _ in range(3)], col,
                      [zero] * 3, [zero] * 3)

        for b in range(bounces):
            s.seed = (s.seed + b) & U32_MASK                 # shader:659
            ox, oy, oz, dx, dy, dz = s.ox, s.oy, s.oz, s.dx, s.dy, s.dz
            if have_sph:
                t_sph, s_idx = sphere_nearest_smem(sph, ox, oy, oz,
                                                   dx, dy, dz)
            else:
                t_sph = torch.full((n,), BIG, **f32)
                s_idx = torch.zeros(n, dtype=torch.int32, device=dev)

            if with_stats:
                st_alive.append(s.alive)
                st_passed.append(chunk_passes(ma, s.alive, ox, oy, oz,
                                              dx, dy, dz))
            w_sn = None
            if have_tris:
                got, win = _nearest_tri_plain(ma, mm.n_tris, ox, oy, oz,
                                              dx, dy, dz)
                wa = ma.attr[win]
                w_nx, w_ny, w_nz, w_an = (wa[:, _A_NX], wa[:, _A_NY],
                                          wa[:, _A_NZ], wa[:, _A_ANDOT])
                w_sn = (wa[:, _A_SNX], wa[:, _A_SNY], wa[:, _A_SNZ])
                # exact retest of the winner; when it fails the whole ray
                # takes its sphere/miss result for this bounce
                det_w = -(dx * w_nx + dy * w_ny + dz * w_nz)
                tdet_w = ox * w_nx + oy * w_ny + oz * w_nz - w_an
                t_ex = tdet_w / torch.clamp(det_w, min=DET_EPS)
                # sphere wins ties: triangle improve is strict <
                use_tri = (got & s.alive & (det_w > DET_EPS)
                           & (tdet_w >= 0.0) & (t_ex < t_sph))
                t_hit = sel(use_tri, t_ex, t_sph)
                winfo = sel(use_tri, ma.info[win], NO_TEX << 8)
            else:
                use_tri = torch.zeros(n, dtype=torch.bool, device=dev)
                t_hit = t_sph
                winfo = torch.full((n,), NO_TEX << 8, dtype=torch.int32,
                                   device=dev)

            if return_hitrec:
                hit = s.alive & (t_hit < BIG)
                hr = torch.zeros(n, dtype=torch.int32, device=dev)
                if have_tris:
                    hr = sel(use_tri & s.alive,
                             HR_TRI | ((winfo >> 16) & 0x7FF), hr)
                if have_sph:
                    hr = sel(hit & ~use_tri, HR_SPH | s_idx, hr)
                hitrec[(frame - 1) * bounces + b] = hr
            rows = shade_tail(tables, have_tris, have_sph, textured, s,
                              use_tri, t_hit, winfo, w_sn, s_idx)
            if textured:
                row = ((frame - 1) * bounces + b) * 8
                rec[row:row + 8] = torch.stack(rows)

        col = s.col
        miss[(frame - 1) * 8:frame * 8] = miss_rows(s)

    out = (torch.stack(col), miss, rec, hitrec)
    if with_stats:
        out += (MxuStats(torch.stack(st_alive), torch.stack(st_passed)),)
    return out


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEOMETRY = [_P, _P, _P, _P, _I, _I]                         # pair .. nc
_ARGTYPES = ([_P, ctypes.c_uint32, _I, _I, _I, _I, _I, _I]   # camf .. bounces
             + _GEOMETRY
             + [_P, _P, _P, _I, _I]                           # side tables
             + [_P, _P, _P, _P, _P])                          # outs, stream
_NEAREST_ARGTYPES = [_P, _P, _I] + _GEOMETRY + [_P, _P]


def _geometry_args(scene, dev):
    """The checked geometry tables as the C interface takes them."""
    ma, mm = scene.mxu_arrays, scene.mxu_meta
    nc = mm.nc
    chk = lambda *a: check_arg("mxu_trace", *a)  # noqa: E731
    chk("pair", ma.pair, torch.bfloat16, (nc, Q * CHUNK, KS), dev)
    chk("attr", ma.attr, torch.float32, (nc * CHUNK, A_ROWS), dev)
    chk("info", ma.info, torch.int32, (nc * CHUNK,), dev)
    chk("cbox", ma.cbox, torch.float32, (nc, 8), dev)
    if ma.pair.data_ptr() % 16:
        raise ValueError("mxu_trace: pair must be 16-byte aligned "
                         "(the kernel stages it with 16-byte copies)")
    return [ma.pair.data_ptr(), ma.attr.data_ptr(), ma.info.data_ptr(),
            ma.cbox.data_ptr(), mm.n_tris, nc]


def _library():
    """csrc/mxu_trace.cu's library, whose cull granule must be BLOCK (the
    plain version's `chunk_passes` mirrors it)."""
    lib = load_kernel_library("mxu_trace")
    block = lib.mxu_trace_block()
    if block != BLOCK:
        raise RuntimeError(f"mxu_trace: the kernel culls blocks of {block} "
                           f"slots, mxu_kernel.BLOCK is {BLOCK}")
    return lib


def _check_scene(name, scene, dev):
    mm = scene.mxu_meta
    if mm is None or not mm.supported:
        raise ValueError(f"{name}: scene exceeds the mxu table limits")
    if scene.device != dev:
        raise ValueError(f"{name}: inputs on {dev}, scene on {scene.device}")


def mxu_trace(scene, tables: SideTables, camf, frame_index: int,
              pixel_offset: int, n_rays: int, cfg: RenderConfig,
              return_hitrec: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays): returns
    (color (3,N), miss (8F,N), rec (8FB,N) or None, hitrec (FB,N) or None).

    CPU tensors go to `mxu_trace_plain`; CUDA tensors launch the kernel
    of csrc/mxu_trace.cu (built at first use) and raise on any launch
    error.  `mxu_trace.launches` counts the kernel launches."""
    dev = camf.device
    _check_scene("mxu_trace", scene, dev)
    if dev.type == "cpu":
        return mxu_trace_plain(scene, tables, camf, frame_index,
                               pixel_offset, n_rays, cfg, return_hitrec)
    if dev.type != "cuda":
        raise ValueError(f"mxu_trace: unsupported device {dev}")
    n = int(n_rays)
    if n <= 0 or pixel_offset < 0:
        raise ValueError("mxu_trace: need n_rays > 0 and pixel_offset >= 0")
    frames, bounces = cfg.max_frames, cfg.max_bounces
    check_arg("mxu_trace", "camf", camf, torch.float32, (64,), dev)
    geometry = _geometry_args(scene, dev)
    mat, tex, sph = check_side_tables("mxu_trace", scene, tables, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    color = torch.empty((3, n), **f32)
    miss = torch.empty((8 * frames, n), **f32)
    rec = (torch.empty((8 * frames * bounces, n), **f32)
           if scene.any_textured else None)
    hitrec = (torch.empty((frames * bounces, n), dtype=torch.int32,
                          device=dev) if return_hitrec else None)

    fn = _library().mxu_trace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(camf.data_ptr(), int(frame_index) & U32_MASK,
                 int(pixel_offset), n, cfg.width, cfg.height, frames,
                 bounces, *geometry, mat.data_ptr(), ptr(tex),
                 sph.data_ptr(), sph.shape[1], scene.num_spheres,
                 color.data_ptr(), miss.data_ptr(), ptr(rec), ptr(hitrec),
                 stream)
    if err != 0:
        raise RuntimeError(f"mxu_trace: kernel launch failed with CUDA "
                           f"error {err}")
    mxu_trace.launches += 1
    return color, miss, rec, hitrec


mxu_trace.launches = 0


def mxu_nearest(scene, rays, alive):
    """The kernel's pair pass alone, on given rays: `rays` (6, N) f32
    (o, d), `alive` (N,) bool; returns the least packed key per ray
    (`nearest_packed_plain`'s value; BIG for a dead ray or no pair).

    CPU tensors go to `nearest_packed_plain`; CUDA tensors launch csrc/mxu_trace.cu's pair-pass kernel (the device
    code `mxu_trace` runs: chunk cull, staging, tensor-core products,
    test, packing and reductions, over blocks of BLOCK rays).  For tests
    and measurement; `mxu_nearest.launches` counts its launches."""
    dev = rays.device
    _check_scene("mxu_nearest", scene, dev)
    if dev.type == "cpu":
        return torch.where(alive, nearest_packed_plain(scene.mxu_arrays,
                                                       *rays), BIG)
    if dev.type != "cuda":
        raise ValueError(f"mxu_nearest: unsupported device {dev}")
    n = rays.shape[-1]
    check_arg("mxu_nearest", "rays", rays, torch.float32, (6, n), dev)
    check_arg("mxu_nearest", "alive", alive, torch.bool, (n,), dev)
    geometry = _geometry_args(scene, dev)
    best = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _library().mxu_nearest_launch
    fn.argtypes = _NEAREST_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rays.data_ptr(), alive.data_ptr(), n, *geometry,
                 best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mxu_nearest: kernel launch failed with CUDA "
                           f"error {err}")
    mxu_nearest.launches += 1
    return best


mxu_nearest.launches = 0


# ---------------------------------------------------------------------------
# Drivers: kernel + shared post-pass
# ---------------------------------------------------------------------------

def render_rays_mxu(scene, cam, frame_index: int, cfg: RenderConfig,
                    pixel_offset: int, n_rays: int,
                    skip_postpass: bool = False,
                    return_hitrec: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays) and run
    the post-pass: returns (n_rays, 3) slot radiance, and the (F*B,
    n_rays) packed winner records when return_hitrec.  skip_postpass
    returns the kernel's raw color instead."""
    camf = _pack_camera(cam, scene.device)
    color, miss, rec, hitrec = mxu_trace(scene, side_tables(scene), camf,
                                         frame_index, pixel_offset, n_rays,
                                         cfg, return_hitrec)
    color = color.T
    if skip_postpass:
        out = color.contiguous()
    else:
        out = mega_postpass(color, miss, rec, scene, cfg, n_rays)
    if return_hitrec:
        return out, hitrec
    return out


def render_mxu(scene, cam, frame_index: int, cfg: RenderConfig):
    """Full-frame forward dispatch through the kernel: (H, W, 3) f32
    radiance averaged over cfg.max_frames samples."""
    color = render_rays_mxu(scene, cam, frame_index, cfg, pixel_offset=0,
                            n_rays=cfg.width * cfg.height)
    if use_block8(cfg.width, cfg.height):
        return slots_to_image(color, cfg.width, cfg.height)
    return color.reshape(cfg.height, cfg.width, 3)
