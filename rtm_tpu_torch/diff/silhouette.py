"""Silhouette-aware gradients: soft primary visibility.

Port of rtm_tpu/diff/silhouette.py.  The renderer's hit topology is
detached (argmin indices), so geometry gradients are exact for interior
shading terms but zero at visibility silhouettes: moving a sphere's edge
across a pixel is a step function.  This module adds the standard
soft-visibility treatment (SoftRas-style sigmoid coverage) for the
PRIMARY hit, where silhouette terms dominate inverse-rendering objectives:

    margin  m = signed distance-to-silhouette proxy of the winning
                primitive (sphere: (r^2 - p^2)/r^2 with p the ray's
                perpendicular miss distance; triangle: min barycentric
                coordinate of the hit point),
    alpha   = sigmoid(m / tau),
    img     = alpha * img_hard + (1 - alpha) * img_deoccluded.

Both margins are smooth functions of the geometry parameters, so autograd
picks up the edge term that the detached argmin drops; as tau -> 0 the
soft image converges to the hard render.

The blend target is the DE-OCCLUDED radiance: the same ray re-traced from
just past the winning primitive's exit point (a sphere's far root, a
triangle's far side) through the full multi-bounce pipeline, so
object-over-object silhouettes blend toward the occluded object's shaded
radiance and object-over-sky edges reduce to the sky term.

Misses are encoded FLT_MAX, not inf, and every lane a `torch.where`
discards is kept finite (clamped before sqrt, zeroed exits on miss
lanes): the backward pass of `where` multiplies the unselected branch's
gradient by 0, and 0 * inf is NaN.

Use: diff.render_loss(..., soft_tau=0.01) or render_soft_primary directly.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..ops import rng
from ..ops.intersect import (FLT_MAX, TriFeatures, cross3, dot3,
                             nearest_sphere, nearest_triangle, normalize)
from ..ops.trace_ref import (bounce_payload, camera_ray_basis, render_pixels,
                             shade_bounce)


def primary_soft_alpha(scene, origin, direction, tau: float,
                       with_exit: bool = False):
    """Soft coverage of each ray's primary hit: (N,) in (0, 1).

    Interior rays saturate to ~1; rays crossing a silhouette get a smooth
    transition of width ~tau in margin units.  Differentiable in sphere
    centers/radii and triangle vertices.

    with_exit: also return the winner's EXIT distance (far sphere root /
    the triangle's t), where the de-occluded re-trace starts, and a hit
    mask."""
    n = origin.shape[0]
    dev = origin.device

    if scene.num_spheres > 0:
        t_s, i_s = nearest_sphere(origin, direction, scene.sph_pos,
                                  scene.sph_radius)
        si = torch.clamp(i_s, 0, scene.num_spheres - 1).long()
        c = scene.sph_pos[si]
        r = scene.sph_radius[si]
        oc = origin - c
        # perpendicular miss distance^2 of the (unit-direction) ray
        along = dot3(oc, direction)
        p2 = dot3(oc, oc) - along * along
        m_sph = (r * r - p2) / torch.clamp(r * r, min=1e-12)
        a_sph = torch.where(i_s >= 0, torch.sigmoid(m_sph / tau), 1.0)
        # far root, clamped away from 0 (sqrt'(0) = inf) and zeroed on
        # miss lanes, where -along of a clamped winner is unbounded
        disc = torch.sqrt(torch.clamp(r * r - p2, min=1e-12))
        t_exit_s = torch.where(i_s >= 0, -along + disc, 0.0)
    else:
        t_s = torch.full((n,), float("inf"), device=dev)
        a_sph = torch.ones((n,), device=dev)
        t_exit_s = torch.zeros((n,), device=dev)

    if scene.num_triangles > 0:
        feats = TriFeatures.build(scene.tri_wa, scene.tri_wb, scene.tri_wc)
        t_t, i_t = nearest_triangle(origin, direction, feats)
        ti = torch.clamp(i_t, 0, scene.num_triangles - 1).long()
        a = scene.tri_wa[ti]
        b = scene.tri_wb[ti]
        cc = scene.tri_wc[ti]
        nvec = cross3(b - a, cc - a)
        det = -dot3(direction, nvec)
        inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
        dao = cross3(origin - a, direction)
        u = dot3(cc - a, dao) * inv_det
        v = -dot3(b - a, dao) * inv_det
        w = 1.0 - u - v
        m_tri = torch.minimum(torch.minimum(u, v), w)      # < 0 outside
        a_tri = torch.where(i_t >= 0, torch.sigmoid(m_tri / tau), 1.0)
        # thin primitive; miss lanes (t_t == FLT_MAX) masked to 0, or
        # FLT_MAX * direction would overflow in the re-trace's origin
        t_exit_t = torch.where(i_t >= 0, t_t, 0.0)
    else:
        t_t = torch.full((n,), float("inf"), device=dev)
        a_tri = torch.ones((n,), device=dev)
        t_exit_t = torch.zeros((n,), device=dev)

    # the winner's margin is the one that matters
    use_tri = t_t < t_s
    alpha = torch.where(use_tri, a_tri, a_sph)
    if not with_exit:
        return alpha
    hit = torch.minimum(t_t, t_s) < FLT_MAX
    t_exit = torch.where(use_tri, t_exit_t, t_exit_s)
    t_exit = torch.where(hit, torch.clamp(t_exit, min=0.0), 0.0)
    return alpha, t_exit, hit


def render_soft_primary(scene, cam, x, y, frame_index: int,
                        cfg: RenderConfig, tau: float = 0.01,
                        chunk: int = 512, backend: str = "xla",
                        remat: bool = False):
    """Hard multi-bounce render (render_pixels on `backend`) blended with
    soft primary coverage.  Returns (N, 3) on the scene's device; equals
    render_pixels as tau -> 0, but differentiable through primary
    silhouettes."""
    x = x.to(scene.device)
    y = y.to(scene.device)
    img = render_pixels(scene, cam, x, y, frame_index, cfg, chunk=chunk,
                        backend=backend, remat=remat)

    focus_point, _, _, position = camera_ray_basis(cam, cfg, x, y)
    # primary-ray direction of the FIRST sample, no jitter (the coverage
    # factor is a per-pixel geometric weight, not a stochastic estimate)
    direction = normalize(focus_point - position[None, :])
    origin = position[None, :].expand_as(direction)
    alpha, t_exit, hit = primary_soft_alpha(scene, origin, direction, tau,
                                            with_exit=True)

    # de-occluded radiance: the same ray re-traced from just past the
    # winner's exit, full multi-bounce; misses reduce to the sky term
    o_behind = origin + (t_exit + 1e-3)[:, None] * direction
    o_behind = torch.where(hit[:, None], o_behind, origin)
    occ = _trace_radiance(scene, cfg, o_behind, direction,
                          rng.pixel_seed(x, y, cfg.width, 1, frame_index),
                          chunk=chunk)
    return alpha[:, None] * img + (1.0 - alpha[:, None]) * occ


def _trace_radiance(scene, cfg: RenderConfig, o, d, seed, chunk: int = 512):
    """Full bounce loop from explicit start rays (the de-occlusion
    re-trace): bounce_payload's xla sweep + shade_bounce, with the full-u32
    RNG stream of the reference renderer."""
    feats = TriFeatures.build(scene.tri_wa, scene.tri_wb, scene.tri_wc)
    draw_env = 1.0 if cfg.draw_environment else 0.0
    n = o.shape[0]
    color = torch.zeros((n, 3), device=o.device)
    contrib = torch.ones((n, 3), device=o.device)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    sd = seed
    for b in range(cfg.max_bounces):
        sd = (sd + b) & rng.U32_MASK
        p = bounce_payload(scene, feats, o, d, chunk=chunk)
        o, d, sd, color, contrib, alive = shade_bounce(
            scene, cfg, draw_env, o, d, sd, color, contrib, alive, p)
    return color
