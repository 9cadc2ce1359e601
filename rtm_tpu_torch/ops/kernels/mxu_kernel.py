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

Two implementations of one contract (`mxu_trace`):
  * the CUDA kernel (csrc/mxu_trace.cu), one thread per ray, FP32 dot
    products against the `pair32` rows;
  * the plain version `mxu_trace_plain`, vectorised over rays, which keeps
    the TPU kernel's bf16x3 K-stacked matmul (`pair` rows against
    [B_hi; B_lo; B_hi]) so that on the CPU it tracks rtm_tpu as closely as
    summation order allows.
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
from .vreg_common import (BIG, NO_TEX, PathState, _cross, camera_frame,
                          jittered_ray, miss_rows, shade_tail,
                          sphere_nearest_smem)

K = 16                       # ray feature depth: [d, oxd, o, 1] pad 10->16
KS = 3 * K                   # bf16x3 stacked contraction depth
Q = 4                        # pair rows per triangle: s1, s2, s3, tdet
ROW_W = Q * 10               # pair32 floats per triangle
CHUNK = 128                  # triangles per cull chunk
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
    pair32: torch.Tensor   # (NC*128, ROW_W) f32 rows hi+lo, [q*10 + k]
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


def _pair32_from_pair(pair: torch.Tensor) -> torch.Tensor:
    """(NC, Q*128, KS) bf16 K-stack -> (NC*128, ROW_W) f32 rows hi + lo:
    the value the bf16x3 product multiplies, one row per triangle."""
    nc = pair.shape[0]
    rows = pair[..., 0:10].float() + pair[..., 2 * K:2 * K + 10].float()
    return (rows.reshape(nc, Q, CHUNK, 10).permute(0, 2, 1, 3)
            .reshape(nc * CHUNK, ROW_W).contiguous())


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

    arrays = MxuArrays(pair=pair, pair32=_pair32_from_pair(pair),
                       attr=torch.from_numpy(attr),
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
    return MxuArrays(pair=pair_t, pair32=_pair32_from_pair(pair_t),
                     attr=attr_t, info=info_t, cbox=t(cbox, np.float32))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def side_tables(scene) -> SideTables:
    return build_side_tables(scene, scene.mxu_meta.textured_rows)


def _nearest_tri_plain(ma: MxuArrays, n_tris: int, ox, oy, oz, dx, dy, dz):
    """All-pairs test through the bf16x3 K-stacked product, every chunk (the
    kernel's chunk cull is conservative, so skipping it changes nothing
    but time): returns (got, win) with win the Morton table row."""
    mx, my, mz = _cross(ox, oy, oz, dx, dy, dz)
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    b32 = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, one]
                      + [zero] * (K - 10))                 # (K, N)
    b_hi = b32.to(torch.bfloat16)
    b_lo = (b32 - b_hi.float()).to(torch.bfloat16)
    rm = torch.cat([b_hi, b_lo, b_hi]).float()            # (KS, N)
    rowi = torch.arange(CHUNK, dtype=torch.int32, device=ox.device)[:, None]
    best = torch.full_like(ox, BIG)
    for c in range(ma.pair.shape[0]):
        acc = ma.pair[c].float() @ rm                      # (Q*128, N)
        s1, s2, s3, td = acc[0:128], acc[128:256], acc[256:384], acc[384:]
        det = s1 + s2 + s3
        m = torch.minimum(torch.minimum(s1, s2), torch.minimum(s3, td))
        tt = torch.clamp(td / torch.clamp(det, min=DET_EPS), max=1e28)
        packed = ((tt.view(torch.int32) & ~IDX_MASK) | (rowi + c * CHUNK)
                  ).view(torch.float32)
        packed = torch.where(m >= 0.0, packed, BIG)
        best = torch.minimum(best, packed.amin(dim=0))
    got = best < 1e29
    win = best.view(torch.int32) & IDX_MASK
    return got, torch.clamp(win, 0, max(n_tris - 1, 0)).long()


def mxu_trace_plain(scene, tables: SideTables, camf, frame_index: int,
                    pixel_offset: int, n_rays: int, cfg: RenderConfig,
                    return_hitrec: bool = False):
    """Plain PyTorch version of the kernel: the same outputs from the same
    inputs, vectorised over rays with Python loops over frames, bounces and
    chunks.  Runs on any device."""
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

    return torch.stack(col), miss, rec, hitrec


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, ctypes.c_uint32, _I, _I, _I, _I, _I, _I,   # camf .. bounces
             _P, _P, _P, _P, _I, _I,                          # geometry
             _P, _P, _P, _I, _I,                              # side tables
             _P, _P, _P, _P, _P]                              # outs, stream


def mxu_trace(scene, tables: SideTables, camf, frame_index: int,
              pixel_offset: int, n_rays: int, cfg: RenderConfig,
              return_hitrec: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays): returns
    (color (3,N), miss (8F,N), rec (8FB,N) or None, hitrec (FB,N) or None).

    CPU tensors go to `mxu_trace_plain`; CUDA tensors launch the kernel
    of csrc/mxu_trace.cu (built at first use) and raise on any launch
    error.  `mxu_trace.launches` counts the kernel launches."""
    mm = scene.mxu_meta
    if mm is None or not mm.supported:
        raise ValueError("mxu_trace: scene exceeds the mxu table limits")
    dev = camf.device
    if scene.device != dev:
        raise ValueError(f"mxu_trace: camera row on {dev}, scene on "
                         f"{scene.device}")
    if dev.type == "cpu":
        return mxu_trace_plain(scene, tables, camf, frame_index,
                               pixel_offset, n_rays, cfg, return_hitrec)
    if dev.type != "cuda":
        raise ValueError(f"mxu_trace: unsupported device {dev}")
    n = int(n_rays)
    if n <= 0 or pixel_offset < 0:
        raise ValueError("mxu_trace: need n_rays > 0 and pixel_offset >= 0")
    frames, bounces = cfg.max_frames, cfg.max_bounces
    ma = scene.mxu_arrays
    nc = mm.nc
    chk = lambda *a: check_arg("mxu_trace", *a)  # noqa: E731
    chk("camf", camf, torch.float32, (64,), dev)
    chk("pair32", ma.pair32, torch.float32, (nc * CHUNK, ROW_W), dev)
    chk("attr", ma.attr, torch.float32, (nc * CHUNK, A_ROWS), dev)
    chk("info", ma.info, torch.int32, (nc * CHUNK,), dev)
    chk("cbox", ma.cbox, torch.float32, (nc, 8), dev)
    mat, tex, sph = check_side_tables("mxu_trace", scene, tables, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    color = torch.empty((3, n), **f32)
    miss = torch.empty((8 * frames, n), **f32)
    rec = (torch.empty((8 * frames * bounces, n), **f32)
           if scene.any_textured else None)
    hitrec = (torch.empty((frames * bounces, n), dtype=torch.int32,
                          device=dev) if return_hitrec else None)

    lib = load_kernel_library("mxu_trace")
    fn = lib.mxu_trace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(camf.data_ptr(), int(frame_index) & U32_MASK,
                 int(pixel_offset), n, cfg.width, cfg.height, frames,
                 bounces, ma.pair32.data_ptr(), ma.attr.data_ptr(),
                 ma.info.data_ptr(), ma.cbox.data_ptr(), mm.n_tris, nc,
                 mat.data_ptr(), ptr(tex), sph.data_ptr(), sph.shape[1],
                 scene.num_spheres, color.data_ptr(), miss.data_ptr(),
                 ptr(rec), ptr(hitrec), stream)
    if err != 0:
        raise RuntimeError(f"mxu_trace: kernel launch failed with CUDA "
                           f"error {err}")
    mxu_trace.launches += 1
    return color, miss, rec, hitrec


mxu_trace.launches = 0


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
