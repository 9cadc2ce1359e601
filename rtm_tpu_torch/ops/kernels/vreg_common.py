"""Shared per-ray bounce semantics of the path-tracing kernels, as plain
torch functions vectorised over rays.

Port of rtm_tpu/ops/pallas/vreg_common.py plus the in-kernel helpers of
rtm_tpu/ops/pallas/megakernel.py:345-391.  These are the plain versions:
the kernels' plain twins (`mxu_trace_plain`, `trav_trace_plain`) call
them, and csrc/bounce_common.cuh holds their `__device__` counterparts with
the same operation order, so the CUDA kernels and their plain versions
round alike.  Every function is an elementwise map over (N,) tensors:
camera ray generation with both jitters (shader:684-706), the PCG draws,
the sphere loop, the textured-UV recovery (shader:257-268), the scatter
step (shader:590-649) and the shading tail both kernels run after their
hit decision (`shade_tail`, on a `PathState`).

u32 seeds are carried in int64 tensors (see ops/rng.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..rng import pcg_hash
from ..shade import OFFSET

BIG = float(np.float32(1e30))     # in-kernel "miss" sentinel (< FLT_MAX)
TWO_PI = float(np.float32(2.0 * np.pi))
U2F = float(np.float32(256.0 / 4294967295.0))   # (s>>8) -> [0,1]

# material table rows (traced_mat_tab)
_M_ALR, _M_ALG, _M_ALB = 0, 1, 2
_M_EMR, _M_EMG, _M_EMB = 3, 4, 5
_M_EMP, _M_ROUGH, _M_METAL, _M_REFR, _M_TEX = 6, 7, 8, 9, 10
M_ROWS = 12

# textured-triangle side table rows (traced_tex_tab): local A, AB, AC, uvs
_X_LAX, _X_LAY, _X_LAZ = 0, 1, 2
_X_ABX, _X_ABY, _X_ABZ = 3, 4, 5
_X_ACX, _X_ACY, _X_ACZ = 6, 7, 8
_X_U0, _X_V0, _X_U1, _X_V1, _X_U2, _X_V2 = 9, 10, 11, 12, 13, 14
X_ROWS = 15

# sphere table rows (traced_sph_tabs)
_SP_CX, _SP_CY, _SP_CZ, _SP_R = 0, 1, 2, 3
_SP_ALR, _SP_ALG, _SP_ALB = 4, 5, 6
_SP_EMR, _SP_EMG, _SP_EMB = 7, 8, 9
_SP_EMP, _SP_ROUGH, _SP_METAL, _SP_REFR, _SP_TEX = 10, 11, 12, 13, 14
SP_ROWS = 16

NO_TEX = 255                 # texslot sentinel in packed (mat | slot<<8)


# ---------------------------------------------------------------------------
# RNG and vector helpers (megakernel.py:345-391)
# ---------------------------------------------------------------------------

def _pcg(s):
    return pcg_hash(s)


def _rand(s):
    """(uniform [0,1] f32, new_seed) — reference fastRandom (shader:130-134)
    with the kernels' conversion: the top 24 bits, |err| <= 6e-8."""
    s = _pcg(s)
    return (s >> 8).to(torch.float32) * U2F, s


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _normalize(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _safe_inv_dirs(dx, dy, dz):
    """NaN-safe slab reciprocals: clamp |d| away from 0 (sign-preserving).
    d==0 would give inf, and (lo-o)*inf = NaN when o sits exactly on the
    bound; with the clamp, |d|<eps rays see (+/-)huge slab bounds."""
    eps = 1e-12

    def safe(d):
        return torch.where(d.abs() < eps,
                           torch.where(d >= 0.0, eps, -eps), d)

    return 1.0 / safe(dx), 1.0 / safe(dy), 1.0 / safe(dz)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

def camera_frame(camf, width: int, height: int, xpix, ypix):
    """Per-ray camera basis (shader:684-691): returns (posx, posy, posz,
    fpx, fpy, fpz, rtx, rty, rtz, upx, upy, upz, defocus, blur, wf, hf).

    camf is the (64,) row from megakernel._pack_camera: matrices stored
    column-major, so m[i, j] sits at j*4+i."""

    def P(i, j):
        return camf[j * 4 + i]

    def V(i, j):
        return camf[16 + j * 4 + i]

    posx, posy, posz = camf[32], camf[33], camf[34]
    focus_d, defocus, blur = camf[35], camf[36], camf[37]
    wf, hf = float(width), float(height)

    px = xpix.to(torch.float32) / wf
    py = ypix.to(torch.float32) / hf
    nx_ = 2.0 * px - 1.0
    ny_ = 2.0 * py - 1.0
    cx = P(0, 0) * nx_ + P(0, 1) * ny_ + P(0, 2) + P(0, 3)
    cy = P(1, 0) * nx_ + P(1, 1) * ny_ + P(1, 2) + P(1, 3)
    cz = P(2, 0) * nx_ + P(2, 1) * ny_ + P(2, 2) + P(2, 3)
    cw = P(3, 0) * nx_ + P(3, 1) * ny_ + P(3, 2) + P(3, 3)
    inv_w = 1.0 / cw
    cx, cy, cz = cx * inv_w, cy * inv_w, cz * inv_w
    dx0 = (V(0, 0) * cx + V(0, 1) * cy + V(0, 2) * cz) * focus_d
    dy0 = (V(1, 0) * cx + V(1, 1) * cy + V(1, 2) * cz) * focus_d
    dz0 = (V(2, 0) * cx + V(2, 1) * cy + V(2, 2) * cz) * focus_d
    fpx, fpy, fpz = posx + dx0, posy + dy0, posz + dz0
    rtx, rty, rtz = V(0, 0), V(1, 0), V(2, 0)
    upx, upy, upz = V(0, 1), V(1, 1), V(2, 1)
    return (posx, posy, posz, fpx, fpy, fpz, rtx, rty, rtz,
            upx, upy, upz, defocus, blur, wf, hf)


def jittered_ray(seed, frame_basis):
    """Defocus + blur disk jitters (shader:699-706): returns
    (ox, oy, oz, dx, dy, dz, seed') — consumes 4 _rand draws."""
    (posx, posy, posz, fpx, fpy, fpz, rtx, rty, rtz,
     upx, upy, upz, defocus, blur, wf, hf) = frame_basis
    r1, seed = _rand(seed)
    ang = r1 * TWO_PI
    r2, seed = _rand(seed)
    rad = torch.sqrt(r2)
    fjx = torch.cos(ang) * rad / wf * defocus
    fjy = torch.sin(ang) * rad / hf * defocus
    r3, seed = _rand(seed)
    ang2 = r3 * TWO_PI
    r4, seed = _rand(seed)
    rad2 = torch.sqrt(r4)
    djx = torch.cos(ang2) * rad2 / wf * blur
    djy = torch.sin(ang2) * rad2 / hf * blur

    ox = posx + fjx * rtx + fjy * upx
    oy = posy + fjx * rty + fjy * upy
    oz = posz + fjx * rtz + fjy * upz
    tx = fpx + djx * rtx + djy * upx
    ty = fpy + djx * rty + djy * upy
    tz = fpz + djx * rtz + djy * upz
    dx, dy, dz = _normalize(tx - ox, ty - oy, tz - oz)
    return ox, oy, oz, dx, dy, dz, seed


# ---------------------------------------------------------------------------
# Spheres, texture UVs, scatter
# ---------------------------------------------------------------------------

def sphere_nearest_smem(sph, ox, oy, oz, dx, dy, dz):
    """Nearest sphere (shader:486-524) over the (SP_ROWS, S_pad) table:
    (t, idx).  Padding spheres parked at BIG (r=0) can never hit; a later
    sphere must be strictly nearer to win."""
    t_sph = torch.full_like(ox, BIG)
    s_idx = torch.zeros_like(ox, dtype=torch.int32)
    for s in range(sph.shape[1]):
        ocx = ox - sph[_SP_CX, s]
        ocy = oy - sph[_SP_CY, s]
        ocz = oz - sph[_SP_CZ, s]
        rr_ = sph[_SP_R, s]
        a_q = dx * dx + dy * dy + dz * dz
        b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rr_ * rr_
        delta = b_q * b_q - 4.0 * a_q * c_q
        okd = delta >= 0.0
        tq = (-b_q - torch.sqrt(torch.where(okd, delta, 0.0))) / (2.0 * a_q)
        ok = okd & (tq >= 0.0) & (tq < t_sph)
        t_sph = torch.where(ok, tq, t_sph)
        s_idx = torch.where(ok, s, s_idx)
    return t_sph, s_idx


def tex_uv(tex, slot, ox, oy, oz, dx, dy, dz):
    """Space-mixed barycentric UV of the winning textured triangle
    (shader:257-268) from the (X_ROWS, 128) side table at `slot`."""
    col = tex[:, slot.long()]                          # (X_ROWS, N)
    aox = ox - col[_X_LAX]
    aoy = oy - col[_X_LAY]
    aoz = oz - col[_X_LAZ]
    abx_, aby_, abz_ = col[_X_ABX], col[_X_ABY], col[_X_ABZ]
    acx_, acy_, acz_ = col[_X_ACX], col[_X_ACY], col[_X_ACZ]
    dax, day, daz = _cross(aox, aoy, aoz, dx, dy, dz)
    nvx, nvy, nvz = _cross(abx_, aby_, abz_, acx_, acy_, acz_)
    detl = -(dx * nvx + dy * nvy + dz * nvz)
    invl = 1.0 / torch.where(detl == 0.0, 1.0, detl)
    ub = (acx_ * dax + acy_ * day + acz_ * daz) * invl
    vb = -(abx_ * dax + aby_ * day + abz_ * daz) * invl
    wb = 1.0 - ub - vb
    uu = col[_X_U0] * wb + col[_X_U1] * ub + col[_X_U2] * vb
    vv = col[_X_V0] * wb + col[_X_V1] * ub + col[_X_V2] * vb
    return uu, vv


def scatter_step(dx, dy, dz, nxh, nyh, nzh, hx, hy, hz,
                 rough, metal, refr, seed):
    """Scatter (shader:590-649): returns (n_ox, n_oy, n_oz, n_dx, n_dy,
    n_dz, n_seed) — refractive branch consumes 1 draw, diffuse/specular 6;
    the per-ray select keeps the chosen branch's seed."""
    w = torch.where
    d_dot_n = _dot(dx, dy, dz, nxh, nyh, nzh)
    is_refract = refr > 1.0
    is_front = d_dot_n < 0.0
    rt = w(is_front, 1.0 / w(refr == 0.0, 1.0, refr), refr)
    hnx = w(is_front, nxh, -nxh)
    hny = w(is_front, nyh, -nyh)
    hnz = w(is_front, nzh, -nzh)
    cos_t = torch.clamp(-_dot(dx, dy, dz, hnx, hny, hnz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    cannot = rt * sin_t > 1.0
    r0 = (1.0 - rt) / (1.0 + rt)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    r0p = r0 + (1.0 - r0) * omc * omc * omc * omc * omc
    rr, seed_refr = _rand(seed)
    do_refl = cannot | (r0p > rr)
    ddh = _dot(dx, dy, dz, hnx, hny, hnz)
    rfx = dx - 2.0 * ddh * hnx
    rfy = dy - 2.0 * ddh * hny
    rfz = dz - 2.0 * ddh * hnz
    kk = 1.0 - rt * rt * (1.0 - ddh * ddh)
    sq = torch.sqrt(torch.clamp(kk, min=1e-12))
    rxx = rt * dx - (rt * ddh + sq) * hnx
    rxy = rt * dy - (rt * ddh + sq) * hny
    rxz = rt * dz - (rt * ddh + sq) * hnz
    okk = kk >= 0.0
    rxx = w(okk, rxx, 0.0)
    rxy = w(okk, rxy, 0.0)
    rxz = w(okk, rxz, 0.0)
    o_rx = w(do_refl, hx + hnx * OFFSET, hx - hnx * OFFSET)
    o_ry = w(do_refl, hy + hny * OFFSET, hy - hny * OFFSET)
    o_rz = w(do_refl, hz + hnz * OFFSET, hz - hnz * OFFSET)
    d_rx = w(do_refl, rfx, rxx)
    d_ry = w(do_refl, rfy, rxy)
    d_rz = w(do_refl, rfz, rxz)

    u1_, s1 = _rand(seed)
    u2_, s2 = _rand(s1)
    u3_, s3 = _rand(s2)
    ddx, ddy, ddz = _normalize(nxh + 2.0 * u1_ - 1.0,
                               nyh + 2.0 * u2_ - 1.0,
                               nzh + 2.0 * u3_ - 1.0)
    u4_, s4 = _rand(s3)
    u5_, s5 = _rand(s4)
    u6_, s6 = _rand(s5)
    ddn2 = _dot(dx, dy, dz, nxh, nyh, nzh)
    sp_x = dx - 2.0 * ddn2 * nxh + (2.0 * u4_ - 1.0) * (1.0 - metal)
    sp_y = dy - 2.0 * ddn2 * nyh + (2.0 * u5_ - 1.0) * (1.0 - metal)
    sp_z = dz - 2.0 * ddn2 * nzh + (2.0 * u6_ - 1.0) * (1.0 - metal)
    spx, spy, spz = _normalize(sp_x, sp_y, sp_z)
    dfx, dfy, dfz = _normalize(
        ddx * (1.0 - rough) + spx * rough,
        ddy * (1.0 - rough) + spy * rough,
        ddz * (1.0 - rough) + spz * rough)

    n_ox = w(is_refract, o_rx, hx + nxh * OFFSET)
    n_oy = w(is_refract, o_ry, hy + nyh * OFFSET)
    n_oz = w(is_refract, o_rz, hz + nzh * OFFSET)
    n_dx = w(is_refract, d_rx, dfx)
    n_dy = w(is_refract, d_ry, dfy)
    n_dz = w(is_refract, d_rz, dfz)
    n_seed = w(is_refract, seed_refr, s6)
    return n_ox, n_oy, n_oz, n_dx, n_dy, n_dz, n_seed


# ---------------------------------------------------------------------------
# The per-bounce shading tail shared by the per-ray kernels
# ---------------------------------------------------------------------------

@dataclass
class PathState:
    """One frame's per-ray path state, (N,) tensors, carried across
    bounces (PathState in csrc/bounce_common.cuh).  `col` sums over
    frames; the rest is reset at each frame's camera ray."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    seed: torch.Tensor                   # u32 in int64
    alive: torch.Tensor                  # bool
    ctr: list                            # contribution r, g, b
    col: list                            # radiance r, g, b
    m_d: list                            # miss direction
    m_c: list                            # contribution at the miss


def shade_tail(tables, have_tris: bool, have_sph: bool, textured: bool,
               s: PathState, use_tri, t_hit, winfo, w_sn, s_idx):
    """Everything a bounce does after its hit decision (shader:545-666):
    material / sphere fetch, the triangle/sphere mix, the miss record,
    the texture record or the emission sum, the contribution update and
    the scatter.  use_tri / t_hit / winfo (mat | texslot<<8) / w_sn (the
    winner's shading normal) / s_idx describe the hit; `s` is updated in
    place.  Returns the bounce's 8 texture-record rows (textured scenes)
    or None.  `tables` is (mat, tex, sph) as trav_kernel.SideTables."""
    mat, tex, sph = tables
    sel = torch.where
    ox, oy, oz, dx, dy, dz = s.ox, s.oy, s.oz, s.dx, s.dy, s.dz
    f32 = dict(dtype=torch.float32, device=ox.device)
    zero = torch.zeros_like(ox)

    hit = s.alive & (t_hit < BIG)
    t_safe = sel(hit, t_hit, 0.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz

    use_t = use_tri.float()
    use_s = (hit & ~use_tri).float()

    if have_tris:
        tm = mat[:, (winfo & 0xFF).long()]
    else:
        tm = torch.zeros((mat.shape[0], ox.shape[0]), **f32)
        tm[_M_TEX] = -1.0
    if have_sph:
        sm = sph[:, s_idx.long()]
        snx, sny, snz = _normalize(hx - sm[_SP_CX], hy - sm[_SP_CY],
                                   hz - sm[_SP_CZ])
        s_al = (sm[_SP_ALR], sm[_SP_ALG], sm[_SP_ALB])
        s_em = (sm[_SP_EMR], sm[_SP_EMG], sm[_SP_EMB])
        s_emp, s_rough, s_metal, s_refr, s_tex = (
            sm[_SP_EMP], sm[_SP_ROUGH], sm[_SP_METAL], sm[_SP_REFR],
            sm[_SP_TEX])
    else:
        s_al = s_em = (zero,) * 3
        s_emp = s_rough = s_metal = s_refr = zero
        s_tex = zero - 1.0
        snx = sny = snz = zero

    if have_tris:
        nxh = w_sn[0] * use_t + snx * use_s
        nyh = w_sn[1] * use_t + sny * use_s
        nzh = w_sn[2] * use_t + snz * use_s
    else:
        nxh, nyh, nzh = snx * use_s, sny * use_s, snz * use_s

    def mix(tv, sv):
        return tv * use_t + sv * use_s

    al = [mix(tm[r], s_al[i])
          for i, r in enumerate((_M_ALR, _M_ALG, _M_ALB))]
    em = [mix(tm[r], s_em[i])
          for i, r in enumerate((_M_EMR, _M_EMG, _M_EMB))]
    emp = mix(tm[_M_EMP], s_emp)
    rough = mix(tm[_M_ROUGH], s_rough)
    metal = mix(tm[_M_METAL], s_metal)
    refr = mix(tm[_M_REFR], s_refr)
    texid = mix(tm[_M_TEX], s_tex) + (-1.0) * (1.0 - use_t - use_s)

    live = s.alive & hit
    miss_now = s.alive & ~hit
    s.m_d = [sel(miss_now, v, m) for v, m in zip((dx, dy, dz), s.m_d)]
    s.m_c = [sel(miss_now, v, m) for v, m in zip(s.ctr, s.m_c)]

    livef = live.float()
    ctr = s.ctr
    rec = None
    if textured:
        has_tex = (texid > -0.5) & live
        htf = has_tex.float()
        s_rgb = [ctr[i] * sel(has_tex, emp, em[i] * emp) * livef
                 for i in range(3)]
        if have_tris:
            slot = torch.clamp((winfo >> 8) & 0xFF, 0, 127)
            uu, vv = tex_uv(tex, slot, ox, oy, oz, dx, dy, dz)
        else:
            uu = vv = zero
        rec = s_rgb + [uu * use_t + snx * use_s, vv * use_t + sny * use_s,
                       snz * use_s, sel(has_tex, texid, -1.0),
                       use_s * htf]
        keep = 1.0 - livef * (1.0 - htf)
        s.ctr = [ctr[i] * (keep + livef * (1.0 - htf) * al[i])
                 for i in range(3)]
    else:
        s.col = [s.col[i] + em[i] * emp * ctr[i] * livef for i in range(3)]
        s.ctr = [ctr[i] * (1.0 - livef + livef * al[i]) for i in range(3)]

    (n_ox, n_oy, n_oz, n_dx, n_dy, n_dz, n_seed) = scatter_step(
        dx, dy, dz, nxh, nyh, nzh, hx, hy, hz, rough, metal, refr, s.seed)
    s.ox, s.oy, s.oz = sel(live, n_ox, ox), sel(live, n_oy, oy), sel(
        live, n_oz, oz)
    s.dx, s.dy, s.dz = sel(live, n_dx, dx), sel(live, n_dy, dy), sel(
        live, n_dz, dz)
    s.seed = sel(live, n_seed, s.seed)
    s.alive = live
    return rec


def miss_rows(s: PathState) -> torch.Tensor:
    """The frame's 8 miss-record rows: direction, contribution, valid, 0."""
    m_d = s.m_d
    valid = ((m_d[0] * m_d[0] + m_d[1] * m_d[1] + m_d[2] * m_d[2])
             > 0.0).float()
    return torch.stack(m_d + s.m_c + [valid, torch.zeros_like(valid)])

