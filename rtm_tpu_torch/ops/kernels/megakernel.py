"""Slot maps, camera packing, the cluster tables and the texture/sky
post-pass shared by the per-ray kernels.

Port of the parts of rtm_tpu/ops/pallas/megakernel.py that the mxu, trav
and wavefront2 paths run: the constants, the 8x8-block dispatch-slot order
(`use_block8`, `slot_to_xy`, `pixel_to_slot`, `image_to_slots`,
`slots_to_image`),
`_pack_camera`, the cluster tables the sweep reads (`MegaPack`,
`build_mega_pack`), and the post-pass (`mega_postpass`,
`mega_postpass_dense`, `_seg_scan8`, `mega_postpass_compact`) as torch
ops.  The megakernel itself (`_make_kernel`, `render_rays_megakernel`) is
not ported yet: see ROADMAP.md, queue 1 item 8.

The kernels defer the two texture-map consumers: they emit per-bounce
records (emission-known terms, uv/texid) and per-sample miss records
(direction + contribution), and the post-pass reconstructs
color = sum_b E_b * prod_{k<b} A_k with one texture tap per significant
record (RayTracing.shader:575-586 albedo chain, :663-666 sky at miss).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..intersect import cross3
from ..shade import PI, TWO_PI, env_radiance, sample_texture_quads
from .vreg_common import BIG  # noqa: F401  (re-exported kernel constant)

CLUSTER = 128                   # triangles per cull cluster
SEED_STRIDE = 735529            # shader:697


# ---------------------------------------------------------------------------
# Cluster tables (the parts of rtm_tpu's MegaPack the sweep reads)
# ---------------------------------------------------------------------------

class MegaPack(NamedTuple):
    """Device-layout cluster tables of a scene.

    Only what the cluster sweep reads (ops/kernels/sweep_kernel.py): the
    16-feature rows, the cluster boxes and layout, and the padded-row ->
    scene-row map.  rtm_tpu's MegaPack also holds the bf16 3-split
    attribute table and the sphere table, the megakernel's one-hot
    extraction inputs; they come with the megakernel (ROADMAP.md queue 1
    item 8)."""

    tri_feats: torch.Tensor | None   # (T', 16) f32, cluster-padded
    boxes: torch.Tensor | None       # (C, 8) f32 [lo3, hi3, 0, 0]
    n_clusters: int
    # per-cluster (row offset, padded width) in the padded table: widths
    # are 8-row multiples, variable under the SAH treelet cut
    cluster_offsets: tuple = ()
    cluster_widths: tuple = ()
    offsets_dev: torch.Tensor | None = None   # (C,) i32, for the kernel
    widths_dev: torch.Tensor | None = None    # (C,) i32
    # (T',) i32 padded-table row -> scene triangle id, -1 for padding
    padded_to_real: torch.Tensor | None = None

    @property
    def n_padded_tris(self) -> int:
        return sum(self.cluster_widths)


def build_mega_pack(scene) -> MegaPack:
    """Pack the scene's triangles into the sweep's cluster tables, on the
    scene's device and without autograd (the sweep is an argmin oracle).

    Clusters follow the scene's SAH treelet cut when present (tight,
    variable width), else fixed 128-triangle slices of the stored order.
    Padding rows have n = 0, so det == 0 fails the gate."""
    t = scene.num_triangles
    dev = scene.device
    if t == 0:
        return MegaPack(None, None, 0)
    slices = scene.cluster_slices or tuple(
        (i * CLUSTER, min((i + 1) * CLUSTER, t))
        for i in range(-(-t // CLUSTER)))
    with torch.no_grad():
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

        offs, widths = [], []
        off = 0
        for lo, hi in slices:
            w_pad = max(8, -(-(hi - lo) // 8) * 8)
            offs.append(off)
            widths.append(w_pad)
            off += w_pad
        p2r = np.full(off, -1, np.int64)
        for (lo, hi), o in zip(slices, offs):
            p2r[o:o + hi - lo] = np.arange(lo, hi)
        p2r_t = torch.from_numpy(p2r).to(dev)
        real = (p2r_t >= 0)[:, None]
        tri_feats = torch.where(real, feats[p2r_t.clamp(min=0)], 0.0)
        lo_i = torch.tensor([s[0] for s in slices], device=dev)
        hi_i = torch.tensor([s[1] for s in slices], device=dev)
        seg = torch.repeat_interleave(torch.arange(len(slices), device=dev),
                                      hi_i - lo_i)
        rows = torch.cat([torch.arange(s[0], s[1]) for s in slices]).to(dev)
        box_lo = torch.full((len(slices), 3), float("inf"), device=dev)
        box_hi = torch.full((len(slices), 3), float("-inf"), device=dev)
        box_lo = box_lo.scatter_reduce(0, seg[:, None].expand(-1, 3),
                                       vmin[rows], "amin")
        box_hi = box_hi.scatter_reduce(0, seg[:, None].expand(-1, 3),
                                       vmax[rows], "amax")
        boxes = torch.cat([box_lo, box_hi,
                           torch.zeros((len(slices), 2), device=dev)], dim=1)
    return MegaPack(
        tri_feats=tri_feats.contiguous(), boxes=boxes.contiguous(),
        n_clusters=len(slices), cluster_offsets=tuple(offs),
        cluster_widths=tuple(widths),
        offsets_dev=torch.tensor(offs, dtype=torch.int32, device=dev),
        widths_dev=torch.tensor(widths, dtype=torch.int32, device=dev),
        padded_to_real=p2r_t.to(torch.int32))


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
    """Pack camera scalars into one (64,) f32 row — matrices stored
    column-major (the kernels read m[i,j] at j*4+i)."""
    camf = torch.zeros(64, dtype=torch.float32,
                       device=cam.inv_projection.device)
    camf[0:16] = cam.inv_projection.T.reshape(-1)
    camf[16:32] = cam.inv_view.T.reshape(-1)
    camf[32:35] = cam.position
    camf[35] = cam.focus_distance
    camf[36] = cam.defocus_strength
    camf[37] = cam.blur_strength
    return camf if device is None else camf.to(device)


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
    mdir = torch.where(mmask[:, None], mdir,
                       torch.tensor([1.0, 0.0, 0.0], device=mdir.device))
    sky_term = mctr * env_radiance(scene, mdir) * (
        1.0 if cfg.draw_environment else 0.0)
    if pt is not None:
        sky_term = sky_term * pt
    return color + torch.where(mmask[:, None], sky_term, 0.0)


def mega_postpass(color, miss, rec, scene, cfg, n: int):
    """The texture/sky reconstruction over the kernel's deferred records:
    the compacted form for textured multi-bounce scenes, the dense form
    otherwise."""
    if scene.any_textured and cfg.max_bounces > 1:
        return mega_postpass_compact(color, miss, rec, scene, cfg, n)
    return mega_postpass_dense(color, miss, rec, scene, cfg, n)


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


def _seg_scan8(first, v3, bounces: int, op: str):
    """Segmented inclusive Hillis-Steele scan of (L, 3) values, op 'add' or
    'mul'.  `first` marks segment starts; segments are <= `bounces` long,
    so ceil(log2(bounces)) masked shift steps complete the scan."""
    ident = 0.0 if op == "add" else 1.0
    stop = first
    d = 1
    while d < bounces:
        sh_v = torch.cat([torch.full((d, 3), ident, dtype=v3.dtype,
                                     device=v3.device), v3[:-d]])
        sh_f = torch.cat([torch.ones(d, dtype=torch.bool,
                                     device=stop.device), stop[:-d]])
        keep = torch.where(stop[:, None], ident, sh_v)
        v3 = v3 + keep if op == "add" else v3 * keep
        stop = stop | sh_f
        d *= 2
    return v3


def mega_postpass_compact(color, miss, rec, scene, cfg, n: int,
                          cap: int | None = None):
    """Compacted texture/sky reconstruction: taps only the significant
    records (textured or emissive).

      1. a significant mask per (ray, bounce) slot;
      2. one `torch.sort` of the ray-major slot ids with a "not
         significant" high bit: the first `cap` sorted keys are the
         compact slot list, grouped by ray with bounces ascending;
      3. one gather of the 8-field records at those slots, one texture
         tap per compact slot, and the albedo chain evaluated in compact
         order with a segmented scan (_seg_scan8);
      4. per-ray results read back with one n-row gather at the end of
         each ray's segment.

    A frame whose significant count exceeds `cap` (default n) takes the
    dense form instead: a host branch on that count, one `.item()` per
    frame.  Both branches give the same result up to summation order.
    """
    frames = cfg.max_frames
    bounces = cfg.max_bounces
    if not scene.any_textured:
        raise ValueError("mega_postpass_compact needs a textured scene")
    nb = n * bounces
    bits = max(int(np.ceil(np.log2(max(nb, 2)))), 1)
    if bits > 30:
        raise ValueError("slot id + sentinel bit must fit int32")
    if cap is None:
        cap = n
    have_sph = int(scene.sph_pos.shape[0]) > 0
    dev = color.device

    for f in range(frames):
        rt = rec[f * bounces * 8:(f + 1) * bounces * 8, :n].reshape(
            bounces, 8, n)
        s_abs = rt[:, 0].abs() + rt[:, 1].abs() + rt[:, 2].abs()
        sig_rays = ((rt[:, 6] > -0.5) | (s_abs > 0.0)).T       # (n, B)
        cnt = sig_rays.sum(dim=1, dtype=torch.int32)
        n_sig = int(cnt.sum())
        if n_sig > cap:
            color, pt = _dense_frame(rt, color, scene, n, have_sph)
        else:
            start = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
            slot = torch.arange(nb, dtype=torch.int32, device=dev)
            key = slot | torch.where(sig_rays.reshape(-1), 0, 1 << bits).to(
                torch.int32)
            skey = torch.sort(key).values[:cap]
            valid = skey < (1 << bits)
            perm = (skey & ((1 << bits) - 1)).long()

            rec_t = rt.permute(2, 0, 1).reshape(nb, 8)
            crec = rec_t[perm]                                 # (cap, 8)
            has_tex = (crec[:, 6] > -0.5) & valid
            uu, vv = _tex_uv_of_records(crec[:, 3], crec[:, 4], crec[:, 5],
                                        crec[:, 7] > 0.5, have_sph)
            tex_c = _sample_scene_textures(
                scene, torch.where(has_tex, crec[:, 6].to(torch.int32), 0),
                torch.where(has_tex, uu, 0.0),
                torch.where(has_tex, vv, 0.0))                 # (cap, 3)

            htf = has_tex[:, None]
            f_c = torch.where(htf, tex_c, 1.0)                 # albedo factor
            # segment starts: first element, or a new ray id.  Invalid tail
            # slots carry contrib 0 / factor 1 and are never read back.
            ray_c = perm // bounces
            first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               ray_c[1:] != ray_c[:-1]])
            incl_p = _seg_scan8(first, f_c, bounces, "mul")
            excl_p = torch.where(
                first[:, None], 1.0,
                torch.cat([torch.ones((1, 3), dtype=torch.float32,
                                      device=dev), incl_p[:-1]]))
            contrib = crec[:, 0:3] * excl_p * torch.where(htf, tex_c, 1.0)
            incl_s = _seg_scan8(first, contrib, bounces, "add")

            end_idx = torch.clamp(start + cnt - 1, 0, cap - 1).long()
            got = (cnt > 0)[:, None]
            color = color + torch.where(got, incl_s[end_idx], 0.0)
            pt = torch.where(got, incl_p[end_idx], 1.0)
        color = _add_sky(color, miss, f, n, scene, cfg, pt)

    return color / float(frames)                          # shader:711
