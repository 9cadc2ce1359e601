"""Sorted-wavefront renderer: the cluster-sweep kernel + torch shading per
bounce (backend="wavefront2").

Port of rtm_tpu/ops/wavefront2.py.  Per bounce:
  * the ray stream is re-sorted by a locality key (Morton cell of the
    origin x direction octant, dead rays last) from bounce `sort_from` on,
    so the rays sharing a 512-slot kernel tile agree on which SAH treelet
    clusters matter and the tile-uniform cull stays effective; sorting is
    a pure lane permutation (stable sort);
  * the nearest-triangle sweep runs in the cluster-sweep kernel
    (ops/kernels/sweep_kernel.py) on a detached (8, Np) ray band, and
    returns only the winner's padded-table row;
  * the hit distance is recomputed from the winner's plane
    (trace_ref._triangle_t_from_idx), and everything else (attribute
    fetch, texture / sky, scatter, PCG) is the reference renderer's
    `bounce_payload` / `shade_bounce`, so autograd flows through this
    renderer with the hit topology detached.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from .intersect import FLT_MAX
from .kernels.megakernel import (build_mega_pack, slot_to_xy, slots_to_image,
                                 use_block8)
from .kernels.sweep_kernel import DEFAULT_RAY_TILE, sweep_call
from .trace_ref import (_triangle_t_from_idx, bounce_payload,
                        camera_ray_basis, camera_rays, shade_bounce)


def _scene_bounds(scene):
    """World AABB for the sort-key grid (no autograd; tiny)."""
    with torch.no_grad():
        los, his = [], []
        if scene.num_triangles > 0:
            v = torch.cat([scene.tri_wa, scene.tri_wb, scene.tri_wc], 0)
            los.append(v.amin(dim=0))
            his.append(v.amax(dim=0))
        if scene.num_spheres > 0:
            r = scene.sph_radius[:, None]
            los.append((scene.sph_pos - r).amin(dim=0))
            his.append((scene.sph_pos + r).amax(dim=0))
        if not los:
            return (torch.zeros(3, device=scene.device),
                    torch.ones(3, device=scene.device))
        lo, hi = los[0], his[0]
        for a, b in zip(los[1:], his[1:]):
            lo, hi = torch.minimum(lo, a), torch.maximum(hi, b)
        return lo.detach(), hi.detach()


def _sort_perm(o, d, alive, lo, hi):
    """Locality permutation over (N,3)/(N,) ray state: Morton(origin cell,
    4 bits/axis) x direction octant; dead rays to the end."""
    with torch.no_grad():
        ext = torch.clamp(hi - lo, min=1e-6)
        cell = torch.clamp(((o - lo[None, :]) / ext[None, :] * 16.0)
                           .to(torch.int32), 0, 15)           # (N,3)
        m = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
        for bit in range(4):
            for ax in range(3):
                m = m | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
        octant = ((d[:, 0] > 0).to(torch.int32)
                  | ((d[:, 1] > 0).to(torch.int32) << 1)
                  | ((d[:, 2] > 0).to(torch.int32) << 2))
        key = torch.where(alive, (m << 3) | octant, 2 ** 30)
        return torch.sort(key, stable=True).indices


def render_rays_wavefront2(scene, cam, frame_index: int, cfg: RenderConfig,
                           pixel_offset: int, n_rays: int,
                           ray_tile: int = DEFAULT_RAY_TILE,
                           cull: bool = True, sort_from: int = 1,
                           debug_passes: bool = False):
    """Trace dispatch slots [pixel_offset, pixel_offset + n_rays).

    Returns (n_rays, 3) radiance averaged over cfg.max_frames samples.
    sort_from: first bounce before which the stream is re-sorted (camera
    rays are already coherent; a value >= max_bounces disables sorting).
    debug_passes: also return the summed cluster-pass count per slot (the
    cull heatmap, ref debug visualizations RayTracing.shader:345-374)."""
    dev = scene.device
    w = cfg.width
    n = n_rays
    r = ray_tile
    n_pad = -(-n // r) * r
    draw_env = 1.0 if cfg.draw_environment else 0.0

    pack = build_mega_pack(scene)
    lo, hi = _scene_bounds(scene)

    lin = torch.arange(n_pad, dtype=torch.int64, device=dev) + pixel_offset
    if use_block8(w, cfg.height):
        # slots walk 8x8 pixel blocks: a 512-ray kernel tile is a 64x8
        # strip, so the tile-uniform cull sees coherent camera rays
        x, y = slot_to_xy(lin, w)
    else:
        x, y = lin % w, lin // w
    in_range = torch.arange(n_pad, device=dev) < n
    basis = camera_ray_basis(cam, cfg, x, y)

    out_color = torch.zeros((n_pad, 3), device=dev)
    out_passes = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for frame in range(1, cfg.max_frames + 1):
        o, d, sd = camera_rays(cam, cfg, x, y, frame, frame_index, basis)
        color = torch.zeros((n_pad, 3), device=dev)
        contrib = torch.ones((n_pad, 3), device=dev)
        alive = in_range
        pix = torch.arange(n_pad, device=dev)
        passes = torch.zeros(n_pad, dtype=torch.int32, device=dev)

        for b in range(cfg.max_bounces):
            if b >= sort_from:
                perm = _sort_perm(o, d, alive, lo, hi)
                o, d, sd = o[perm], d[perm], sd[perm]
                color, contrib = color[perm], contrib[perm]
                alive, pix, passes = alive[perm], pix[perm], passes[perm]

            sd = (sd + b) & 0xFFFFFFFF                          # shader:659
            if pack.n_clusters > 0:
                state8 = torch.cat([o.T, d.T, alive[None, :].to(torch.float32),
                                    torch.zeros((1, n_pad), device=dev)],
                                   dim=0).detach()
                _, i_pad, npass = sweep_call(pack, state8, ray_tile=r,
                                             cull=cull)
                i_real = torch.where(
                    i_pad >= 0,
                    pack.padded_to_real[torch.clamp(i_pad, min=0).long()], -1)
                tri_hit = (_triangle_t_from_idx(scene, o, d, i_real), i_real)
                passes = passes + npass
            else:
                tri_hit = (torch.full((n_pad,), FLT_MAX, device=dev),
                           torch.full((n_pad,), -1, dtype=torch.int32,
                                      device=dev))
            p = bounce_payload(scene, None, o, d, 0, tri_hit=tri_hit)
            o, d, sd, color, contrib, alive = shade_bounce(
                scene, cfg, draw_env, o, d, sd, color, contrib, alive, p)

        out_color = out_color.index_add(0, pix, color)
        out_passes = out_passes.index_add(0, pix, passes)

    img = out_color[:n] / float(cfg.max_frames)                 # shader:711
    if debug_passes:
        return img, out_passes[:n]
    return img


def render_wavefront2(scene, cam, frame_index: int, cfg: RenderConfig,
                      ray_tile: int = DEFAULT_RAY_TILE, cull: bool = True,
                      sort_from: int = 1):
    """Full-frame sorted-wavefront dispatch: (H, W, 3) f32, the contract of
    render_dispatch."""
    color = render_rays_wavefront2(
        scene, cam, frame_index, cfg, pixel_offset=0,
        n_rays=cfg.width * cfg.height, ray_tile=ray_tile, cull=cull,
        sort_from=sort_from)
    if use_block8(cfg.width, cfg.height):
        return slots_to_image(color, cfg.width, cfg.height)
    return color.reshape(cfg.height, cfg.width, 3)
