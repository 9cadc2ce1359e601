"""The XLA-style reference renderer, the record-replay path, backend
resolution and the full-frame dispatch.

Port of rtm_tpu/ops/trace_ref.py.  Every pixel is a lane of dense (N, ...)
tensors and the bounce recursion is a Python loop; SIMT branch divergence
is masked selects, and the per-thread RNG streams follow ops/rng.py.  One
call is one dispatch of `max_frames` samples per pixel, returning radiance
already divided by `max_frames` (shader:711).

This is also the differentiable path: autograd flows through the bounce
loop (material gradients exactly; geometry gradients with the hit topology
detached: every sweep is an argmin oracle run without autograd, and the
winner's distance is recomputed from its plane).  `remat` recomputes each
bounce in the backward pass (`torch.utils.checkpoint`) instead of keeping
its residuals.

`render_dispatch` routes as rtm_tpu does: mxu inside its tables, else
trav inside its own, else the megakernel where its tables and outputs fit
the device, else wavefront2 (ops/wavefront2.py); `xla` and `pallas`
through `render_pixels`, which also takes the max_bounces == 1 flat-shade
preview for every backend.
"""
from __future__ import annotations

import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig
from ..utils.tracing import span
from . import rng
from .intersect import (FLT_MAX, TriFeatures, _mm3, cross3, dot3,
                        nearest_sphere, nearest_triangle, normalize,
                        safe_normalize)
from .shade import (flat_shade, sample_texture_quads, scatter, sky_tap,
                    sphere_uv)

def pixel_grid(width: int, height: int, device="cpu"):
    """Row-major pixel ids: x (N,), y (N,) with N = W*H; image[y, x]."""
    lin = torch.arange(width * height, dtype=torch.int64, device=device)
    return lin % width, lin // width


def camera_ray_basis(cam, cfg: RenderConfig, x, y):
    """Per-pixel focus points + camera frame (shader:684-691), on x's
    device.  Returns (focus_point (N,3), right (3,), up (3,),
    position (3,))."""
    dev = x.device
    inv_p = cam.inv_projection.to(dev)
    inv_v = cam.inv_view.to(dev)
    pos = cam.position.to(dev)
    px = x.to(torch.float32) / float(cfg.width)
    py = y.to(torch.float32) / float(cfg.height)
    one = torch.ones_like(px)
    ndc = torch.stack([2.0 * px - 1.0, 2.0 * py - 1.0, one, one], dim=-1)
    coord = _mm3(ndc, inv_p)                                   # (N,4)
    c3 = coord[:, :3] / coord[:, 3:4]
    d4 = torch.cat([c3, torch.zeros_like(c3[:, :1])], dim=-1)
    direction = _mm3(d4, inv_v)[:, :3] * cam.focus_distance.to(dev)
    focus_point = pos[None, :] + direction
    return focus_point, inv_v[:3, 0], inv_v[:3, 1], pos


def _triangle_t_from_idx(scene, origin, direction, idx):
    """Differentiable hit distance for a known winning triangle: the
    sweeps return only the argmin index (detached topology), and the
    distance is recomputed by gathering that triangle, so gradients flow
    to ray and vertex parameters."""
    ti = torch.clamp(idx, 0, scene.num_triangles - 1).long()
    a = scene.tri_wa[ti]
    b = scene.tri_wb[ti]
    c = scene.tri_wc[ti]
    n = cross3(b - a, c - a)
    det = -dot3(direction, n)
    t = dot3(origin - a, n) / torch.where(det == 0.0, 1.0, det)
    return torch.where(idx >= 0, t, FLT_MAX)


def _zeros(n, k, dev, dtype=torch.float32):
    return torch.zeros((n, k) if k else (n,), dtype=dtype, device=dev)


def bounce_payload(scene, feats, origin, direction, chunk: int,
                   backend: str = "xla", tri_hit=None):
    """bounceRay + closestHit (shader:510-548, 235-283) over all lanes.

    Returns a dict of per-lane hit data.  A sphere wins distance ties (the
    reference checks triangles with strict `<` after spheres).
    backend: 'xla' (chunked sweep) | 'pallas' (the intersect kernel on the
    card, its plain version on the CPU).  tri_hit: an optional precomputed
    (t_t, i_t) nearest-triangle result (the wavefront renderer runs its own
    sweep)."""
    if backend not in ("xla", "pallas"):
        raise ValueError(
            f"bounce_payload backend {backend!r} not in ('xla', 'pallas'); "
            "fused backends (mxu/trav/megakernel/wavefront2) are dispatched "
            "by render_dispatch, not the per-bounce path")
    dev = origin.device
    t_s, i_s = nearest_sphere(origin, direction, scene.sph_pos,
                              scene.sph_radius)
    if tri_hit is not None:
        t_t, i_t = tri_hit
    elif backend == "xla" or scene.num_triangles == 0:
        t_t, i_t = nearest_triangle(origin, direction, feats, chunk=chunk)
    else:
        from .kernels.intersect_kernel import nearest_triangle_pallas
        _, i_t = nearest_triangle_pallas(origin, direction, scene.tri_wa,
                                         scene.tri_wb, scene.tri_wc)
        t_t = _triangle_t_from_idx(scene, origin, direction, i_t)
    use_tri = t_t < t_s
    t = torch.where(use_tri, t_t, t_s)
    hit = t < FLT_MAX
    # masked lanes: FLT_MAX * direction overflows to inf and poisons grads
    t_safe = torch.where(hit, t, 0.0)
    hit_pos = origin + t_safe[:, None] * direction

    n = origin.shape[0]
    if scene.num_spheres > 0:
        si = torch.clamp(i_s, 0, scene.num_spheres - 1).long()
        s_normal = safe_normalize(hit_pos - scene.sph_pos[si])
        s_u, s_v = sphere_uv(s_normal)
        s_mat = scene.sph_mat[si]
    else:
        s_normal = _zeros(n, 3, dev)
        s_u = s_v = _zeros(n, 0, dev)
        s_mat = _zeros(n, 0, dev, torch.int32)

    if scene.num_triangles > 0:
        ti = torch.clamp(i_t, 0, scene.num_triangles - 1).long()
        t_normal = scene.tri_normal[ti]
        t_mat = scene.tri_mat[ti]
        # reference UV quirk (shader:257-268): barycentrics from the WORLD
        # ray against LOCAL vertices/edges, reproduced exactly
        la = scene.tri_la[ti]
        lab = scene.tri_lab[ti]
        lac = scene.tri_lac[ti]
        uvs = scene.tri_uv[ti]                                   # (N,3,2)
        dao = cross3(origin - la, direction)
        det = -dot3(direction, cross3(lab, lac))
        inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
        u = dot3(lac, dao) * inv_det
        v = -dot3(lab, dao) * inv_det
        w = 1.0 - u - v
        t_uv = (uvs[:, 0] * w[:, None] + uvs[:, 1] * u[:, None]
                + uvs[:, 2] * v[:, None])
        t_u, t_v = t_uv[:, 0], t_uv[:, 1]
    else:
        t_normal = _zeros(n, 3, dev)
        t_u = t_v = _zeros(n, 0, dev)
        t_mat = _zeros(n, 0, dev, torch.int32)

    return dict(
        t=t, hit=hit, hit_pos=hit_pos,
        normal=torch.where(use_tri[:, None], t_normal, s_normal),
        u=torch.where(use_tri, t_u, s_u),
        v=torch.where(use_tri, t_v, s_v),
        mat=torch.where(use_tri, t_mat, s_mat),
    )


# ---------------------------------------------------------------------------
# Record-replay payload: the differentiable path for the mxu forward.  The
# kernel emits per-(ray, bounce) packed winner identities (mxu_kernel.HR_*);
# hit distance, normal, uv, material attributes, shading and scatter are
# recomputed here from the scene parameters, so autograd flows through the
# whole shading / geometry graph with the hit topology detached.  One
# wide-row gather fetches primitive + material attributes together.
# ---------------------------------------------------------------------------

_RP_W = 40
_RP_MAT = dict(albedo=slice(28, 31), emc=slice(31, 34), emp=34, rough=35,
               metal=36, refr=37, tex=38)


def build_replay_table(scene):
    """(T + S + 1, 40) unified primitive+material rows, built from the
    (possibly parameter-derived) scene tensors each call.
    Rows [0,T): triangles [wa wb wc normal la lab lac uv6 mat matattrs11];
    rows [T,T+S): spheres [pos radius 0*23 mat matattrs11];
    row T+S: the miss row (zeros, tex=-1)."""
    mats = scene.materials
    t_cnt = scene.num_triangles
    s_cnt = scene.num_spheres
    dev = scene.device

    def matcols(ids):
        ids = ids.long()
        return torch.cat([
            mats.albedo[ids], mats.emission_color[ids],
            mats.emission_power[ids][:, None], mats.roughness[ids][:, None],
            mats.metallic[ids][:, None], mats.refraction_ratio[ids][:, None],
            mats.texture_id[ids][:, None].to(torch.float32)], dim=-1)

    rows = []
    if t_cnt > 0:
        rows.append(torch.cat([
            scene.tri_wa, scene.tri_wb, scene.tri_wc, scene.tri_normal,
            scene.tri_la, scene.tri_lab, scene.tri_lac,
            scene.tri_uv.reshape(t_cnt, 6),
            scene.tri_mat[:, None].to(torch.float32),
            matcols(scene.tri_mat), _zeros(t_cnt, 1, dev)], dim=-1))
    if s_cnt > 0:
        rows.append(torch.cat([
            scene.sph_pos, scene.sph_radius[:, None], _zeros(s_cnt, 23, dev),
            scene.sph_mat[:, None].to(torch.float32),
            matcols(scene.sph_mat), _zeros(s_cnt, 1, dev)], dim=-1))
    miss_row = _zeros(1, _RP_W, dev)
    miss_row[0, _RP_MAT["tex"]] = -1.0
    rows.append(miss_row)
    return torch.cat(rows, dim=0)


def replay_payload(scene, rp_table, origin, direction, hr):
    """bounce_payload's contract, but the winner comes from the packed hit
    record `hr` instead of a sweep: topology detached, values recomputed
    differentiably.  Returns (payload dict, mat_attrs dict)."""
    from .kernels.mxu_kernel import HR_IDX, HR_SPH, HR_TRI
    from .kernels.row_grad import ReplayRowGather
    t_cnt = scene.num_triangles
    s_cnt = scene.num_spheres
    is_tri = (hr & HR_TRI) != 0
    is_sph = (hr & HR_SPH) != 0
    hit = is_tri | is_sph
    idx = hr & HR_IDX
    uidx = torch.where(is_tri, idx,
                       torch.where(is_sph, t_cnt + idx, t_cnt + s_cnt))
    uidx = torch.clamp(uidx, 0, t_cnt + s_cnt).long()  # defensive
    row = ReplayRowGather.apply(rp_table, uidx)                  # (N,40)

    # triangle t: plane recovery from the gathered verts (shader:274-276)
    a = row[:, 0:3]
    nvec_t = cross3(row[:, 3:6] - a, row[:, 6:9] - a)
    det_t = -dot3(direction, nvec_t)
    t_t = dot3(origin - a, nvec_t) / torch.where(det_t == 0.0, 1.0, det_t)
    # sphere t: nearest-positive-root (shader:486-508); the kernel already
    # gated, the records are authoritative
    oc = origin - row[:, 0:3]
    aq = dot3(direction, direction)
    bq = 2.0 * dot3(oc, direction)
    cq = dot3(oc, oc) - row[:, 3] * row[:, 3]
    delta = bq * bq - 4.0 * aq * cq
    delta_safe = torch.where(delta >= 0.0, torch.clamp(delta, min=1e-12),
                             1.0)
    t_s = (-bq - torch.sqrt(delta_safe)) / (2.0 * aq)

    t = torch.where(is_tri, t_t, torch.where(is_sph, t_s, FLT_MAX))
    t_safe = torch.where(hit, t, 0.0)
    hit_pos = origin + t_safe[:, None] * direction

    s_normal = safe_normalize(hit_pos - row[:, 0:3])
    s_u, s_v = sphere_uv(s_normal)
    # tri UV quirk (shader:257-268): world ray against local vertices
    la = row[:, 12:15]
    lab = row[:, 15:18]
    lac = row[:, 18:21]
    dao = cross3(origin - la, direction)
    det_l = -dot3(direction, cross3(lab, lac))
    inv_det = 1.0 / torch.where(det_l == 0.0, 1.0, det_l)
    u = dot3(lac, dao) * inv_det
    v = -dot3(lab, dao) * inv_det
    w = 1.0 - u - v
    uvs = row[:, 21:27].reshape(-1, 3, 2)
    t_uv = (uvs[:, 0] * w[:, None] + uvs[:, 1] * u[:, None]
            + uvs[:, 2] * v[:, None])

    p = dict(
        t=t, hit=hit, hit_pos=hit_pos,
        normal=torch.where(is_tri[:, None], row[:, 9:12], s_normal),
        u=torch.where(is_tri, t_uv[:, 0], s_u),
        v=torch.where(is_tri, t_uv[:, 1], s_v),
        mat=row[:, 27].detach().to(torch.int32),
    )
    m = _RP_MAT
    mat_attrs = dict(
        albedo=row[:, m["albedo"]], emission_color=row[:, m["emc"]],
        emission_power=row[:, m["emp"]], roughness=row[:, m["rough"]],
        metallic=row[:, m["metal"]], refraction_ratio=row[:, m["refr"]],
        texture_id=row[:, m["tex"]].detach().to(torch.int32),
    )
    return p, mat_attrs


def shade_bounce(scene, cfg: RenderConfig, draw_env: float,
                 o, d, sd, color, contrib, alive, p, mat_attrs=None,
                 defer_sky: bool = False):
    """Sky-on-miss, emission/texture accumulation and scatter for one
    bounce given its hit payload (shader:550-649 accumulateColor/scatter +
    :663-666 miss).  Returns the updated (o, d, sd, color, contrib, alive),
    plus miss_now when defer_sky is set.  Shared by the scan renderer, the
    sorted-wavefront renderer and the record-replay path (which prefetches
    mat_attrs in its wide-row gather and defers the sky tap to one
    end-of-path fetch)."""
    mats = scene.materials
    miss_now = alive & ~p["hit"]
    if not defer_sky:
        sky = sky_tap(scene, d, miss_now)
        color = torch.where(miss_now[:, None],
                            color + sky * contrib * draw_env, color)

    live = alive & p["hit"]
    if mat_attrs is None:
        mi = p["mat"].long()
        m_rough = mats.roughness[mi]
        m_metal = mats.metallic[mi]
        m_refr = mats.refraction_ratio[mi]
        m_albedo = mats.albedo[mi]
        m_emc = mats.emission_color[mi]
        m_emp = mats.emission_power[mi]
        m_tex = mats.texture_id[mi]
    else:
        m_rough = mat_attrs["roughness"]
        m_metal = mat_attrs["metallic"]
        m_refr = mat_attrs["refraction_ratio"]
        m_albedo = mat_attrs["albedo"]
        m_emc = mat_attrs["emission_color"]
        m_emp = mat_attrs["emission_power"]
        m_tex = mat_attrs["texture_id"]

    no, nd, nsd = scatter(o, d, sd, p["hit_pos"], p["normal"],
                          m_rough, m_metal, m_refr)

    if cfg.max_bounces == 1:
        shade_val = flat_shade(m_albedo, p["normal"])   # shader:566-571
        color = torch.where(live[:, None], shade_val, color)
    else:
        has_tex = m_tex >= 0
        # untextured lanes: collapse the (garbage-uv) tap onto row 0
        alb_tex = sample_texture_quads(
            scene.tex_quads, scene.tex_size, scene.textures.shape[1],
            scene.textures.shape[2], m_tex,
            torch.where(has_tex, p["u"], 0.0),
            torch.where(has_tex, p["v"], 0.0))
        emis = torch.where(has_tex[:, None], alb_tex * m_emp[:, None],
                           m_emc * m_emp[:, None])      # shader:575-585
        albedo = torch.where(has_tex[:, None], alb_tex, m_albedo)
        color = torch.where(live[:, None], color + emis * contrib, color)
        contrib = torch.where(live[:, None], contrib * albedo, contrib)

    o = torch.where(live[:, None], no, o)
    d = torch.where(live[:, None], nd, d)
    sd = torch.where(live, nsd, sd)
    if defer_sky:
        return o, d, sd, color, contrib, live, miss_now
    return o, d, sd, color, contrib, live


def camera_rays(cam, cfg: RenderConfig, x, y, frame: int, frame_index: int,
                basis=None):
    """Frame `frame`'s primary rays with both jitters (shader:695-706):
    (origin (N,3), direction (N,3), seed) with the bit-exact reference
    stream.  basis: camera_ray_basis(cam, cfg, x, y), when precomputed."""
    focus_point, right, up, position = (
        basis if basis is not None else camera_ray_basis(cam, cfg, x, y))
    dev = x.device
    # (width, height) by fill kernels: no host data to copy
    res = torch.full((2,), float(cfg.width), device=dev)
    res[1:].fill_(float(cfg.height))
    seed = rng.pixel_seed(x, y, cfg.width, frame, frame_index)
    focus_jitter, seed = rng.random_circle_point(seed)
    focus_jitter = focus_jitter / res * cam.defocus_strength.to(dev)
    dev_jitter, seed = rng.random_circle_point(seed)
    dev_jitter = dev_jitter / res * cam.blur_strength.to(dev)
    dev_focus = (focus_point + dev_jitter[:, :1] * right[None, :]
                 + dev_jitter[:, 1:2] * up[None, :])
    origin = (position[None, :] + focus_jitter[:, :1] * right[None, :]
              + focus_jitter[:, 1:2] * up[None, :])
    return origin, normalize(dev_focus - origin), seed


def _step(fn, remat: bool, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _check_finite(frame: int, bounce: int, p: dict, state) -> None:
    """Raise FloatingPointError naming the first payload or path-state
    tensor of this bounce that holds NaN/Inf (on any lane)."""
    named = [(f"payload {k!r}", p[k]) for k in ("t", "hit_pos", "normal",
                                                "u", "v")]
    named += list(zip(("origin", "direction", "seed", "color",
                       "contribution"), state[:5]))
    for name, t in named:
        if t.is_floating_point():
            bad = int((~torch.isfinite(t)).sum())
            if bad:
                raise FloatingPointError(
                    f"frame {frame} bounce {bounce}: {name} holds {bad} "
                    f"NaN/Inf values of {t.numel()}")


def render_pixels(scene, cam, x, y, frame_index: int, cfg: RenderConfig,
                  chunk: int = 512, backend: str = "xla",
                  remat: bool = False, hitrec=None,
                  check_finite: bool = False):
    """Trace an arbitrary set of pixels (x, y) on the scene's device: the
    core dispatch.  `remat` recomputes each bounce in the backward pass
    instead of storing its residuals.  `check_finite` (sweep mode only)
    checks every bounce's hit payload and path state and raises
    FloatingPointError at the first that holds NaN/Inf, naming the frame,
    the bounce and the tensor (utils/guards.py).

    hitrec: optional (max_frames * max_bounces, N) i32 packed winner
    records (mxu_kernel HR_*): record-REPLAY mode, no sweeps; the hit
    topology comes from the records, every value is recomputed
    differentiably, and the sky tap is deferred to one end-of-path fetch
    per frame.  The pixel order of `hitrec` must match (x, y).
    Returns (N, 3) radiance averaged over cfg.max_frames samples."""
    dev = scene.device
    x = x.to(dev)
    y = y.to(dev)
    if hitrec is None:
        feats = TriFeatures.build(scene.tri_wa, scene.tri_wb, scene.tri_wc)
    else:
        rp_table = build_replay_table(scene)
    basis = camera_ray_basis(cam, cfg, x, y)
    n = x.shape[0]
    draw_env = 1.0 if cfg.draw_environment else 0.0

    def bounce(i, o, d, sd, color, contrib, alive):
        sd = (sd + i) & rng.U32_MASK                            # shader:659
        p = bounce_payload(scene, feats, o, d, chunk, backend)
        out = shade_bounce(scene, cfg, draw_env, o, d, sd, color, contrib,
                           alive, p)
        if check_finite:
            _check_finite(frame, i, p, out)
        return out

    def replay(i, hr, o, d, sd, color, contrib, alive, m_dir, m_ctr, m_mask):
        sd = (sd + i) & rng.U32_MASK                            # shader:659
        p, mat_attrs = replay_payload(scene, rp_table, o, d, hr)
        no, nd, nsd, color, contrib, live, miss_now = shade_bounce(
            scene, cfg, draw_env, o, d, sd, color, contrib, alive, p,
            mat_attrs=mat_attrs, defer_sky=True)
        m_dir = torch.where(miss_now[:, None], d, m_dir)
        m_ctr = torch.where(miss_now[:, None], contrib, m_ctr)
        return (no, nd, nsd, color, contrib, live, m_dir, m_ctr,
                m_mask | miss_now)

    incoming = torch.zeros((n, 3), device=dev)
    for frame in range(1, cfg.max_frames + 1):
        o, d, sd = camera_rays(cam, cfg, x, y, frame, frame_index, basis)
        color = torch.zeros_like(o)
        contrib = torch.ones_like(o)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        if hitrec is None:
            state = (o, d, sd, color, contrib, alive)
            for i in range(cfg.max_bounces):
                state = _step(bounce, remat, i, *state)
            incoming = incoming + state[3]
        else:
            state = (o, d, sd, color, contrib, alive, torch.zeros_like(o),
                     torch.zeros_like(o), torch.zeros_like(alive))
            rows = hitrec[(frame - 1) * cfg.max_bounces:
                          frame * cfg.max_bounces]
            for i in range(cfg.max_bounces):
                state = _step(replay, remat, i, rows[i], *state)
            color, m_dir, m_ctr, m_mask = state[3], *state[6:]
            # deferred sky: one tap per frame for the recorded miss lanes
            sky = sky_tap(scene, m_dir, m_mask)
            color = torch.where(m_mask[:, None],
                                color + sky * m_ctr * draw_env, color)
            incoming = incoming + color
    return incoming / float(cfg.max_frames)                     # shader:711


def auto_backend(scene, platform: str) -> str:
    """Resolve backend='auto' for this scene on this platform.

    'cuda' resolves to the mxu kernel inside its table limits and to the
    trav kernel beyond them (as rtm_tpu does on the TPU).  'cpu' resolves
    the same way, to the kernels' plain versions, so that the CPU runs the
    path the card runs; the XLA-style renderer is `backend="xla"`.  Any
    other platform gets 'xla'."""
    if platform not in ("tpu", "cuda", "cpu"):
        return "xla"
    mm = scene.mxu_meta
    if mm is not None and mm.supported:
        return "mxu"
    return "trav"


_BACKENDS = ("auto", "mxu", "trav", "megakernel", "wavefront2", "xla",
             "pallas")


def resolve_route(scene, cfg: RenderConfig, backend: str) -> str:
    """The route a dispatch of `backend` takes on this scene: 'auto'
    resolved by auto_backend on the scene's device, then the table-limit
    fallbacks mxu -> trav -> megakernel -> wavefront2 (the last, loudly,
    when the dispatch does not fit the device: megakernel_fits).  The
    fused and wavefront routes fall to 'xla' for the max_bounces == 1
    flat-shade preview.  Raises ValueError on an unknown backend."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        backend = auto_backend(scene, scene.device.type)
    if cfg.max_bounces <= 1:
        return backend if backend in ("xla", "pallas") else "xla"
    if backend == "mxu" and not (scene.mxu_meta is not None
                                 and scene.mxu_meta.supported):
        backend = "trav"
    if backend == "trav" and not (scene.trav_meta is not None
                                  and scene.trav_meta.supported):
        backend = "megakernel"
    if backend == "megakernel":
        from .kernels.megakernel import megakernel_fits
        if not megakernel_fits(scene, cfg):
            warnings.warn(
                f"the megakernel's tables and outputs for a {cfg.width}x"
                f"{cfg.height} dispatch of {scene.num_triangles} triangles "
                f"do not fit the device; falling back to wavefront2",
                stacklevel=3)
            backend = "wavefront2"
    return backend


@span("rtm.dispatch")
def render_dispatch(scene, cam, frame_index: int, cfg: RenderConfig,
                    backend: str = "auto", chunk: int = 512,
                    remat: bool = False):
    """One full-frame dispatch (shader main :675-722, minus the
    accumulation-image I/O which lives in runtime/renderer.py).

    frame_index: the 1-based accumulation counter (Python int).
    backend: 'auto' (see auto_backend, on the scene's device) | 'mxu'
    (falls to trav beyond the mxu tables) | 'trav' (falls to the
    megakernel beyond its tables) | 'megakernel' (falls to wavefront2,
    loudly, when the dispatch does not fit the device: megakernel_fits) |
    'wavefront2' (sorted wavefront: the cluster-sweep kernel + torch
    shading) | 'xla' (chunked sweep) | 'pallas' (the intersect kernel per
    bounce).  The fused and wavefront paths fall to 'xla' for the
    max_bounces == 1 flat-shade preview.
    Returns (H, W, 3) f32 radiance averaged over cfg.max_frames samples,
    on the scene's device."""
    backend = resolve_route(scene, cfg, backend)
    if backend == "mxu":
        from .kernels.mxu_kernel import render_mxu
        return render_mxu(scene, cam, frame_index, cfg)
    if backend == "trav":
        from .kernels.trav_kernel import render_trav
        return render_trav(scene, cam, frame_index, cfg)
    if backend == "megakernel":
        from .kernels.megakernel import render_megakernel
        return render_megakernel(scene, cam, frame_index, cfg)
    if backend == "wavefront2":
        from .wavefront2 import render_wavefront2
        return render_wavefront2(scene, cam, frame_index, cfg)
    x, y = pixel_grid(cfg.width, cfg.height, scene.device)
    incoming = render_pixels(scene, cam, x, y, frame_index, cfg, chunk,
                             backend, remat)
    return incoming.reshape(cfg.height, cfg.width, 3)


def render_rays_mxu_replay(scene, cam, frame_index: int, cfg: RenderConfig,
                           pixel_offset: int, n_rays: int,
                           remat: bool = False):
    """Differentiable dispatch-slot band through the record-replay path:
    the mxu kernel runs once without autograd to emit packed winner
    records, and render_pixels(hitrec=...) replays the shading from them.
    Same [pixel_offset, pixel_offset + n_rays) contract as
    render_rays_mxu.  Returns (n_rays, 3) slot radiance."""
    mm = scene.mxu_meta
    if mm is None or not mm.supported:
        raise ValueError(
            "render_mxu_replay: scene exceeds the mxu table limits "
            "(<= 2047 triangles / <= 128 materials/textured-tris/spheres); "
            "use backend='wavefront2' or 'xla' for gradients here")
    if cfg.max_bounces <= 1:
        raise ValueError(
            "render_mxu_replay: MaxBounces==1 is the flat-shade preview; "
            "use backend='xla' (differentiable) for it")
    from .kernels.megakernel import slot_to_xy, use_block8
    from .kernels.mxu_kernel import render_rays_mxu
    with torch.no_grad():
        _, hitrec = render_rays_mxu(scene, cam, frame_index, cfg,
                                    pixel_offset=pixel_offset,
                                    n_rays=n_rays, skip_postpass=True,
                                    return_hitrec=True)
    lin = pixel_offset + torch.arange(n_rays, dtype=torch.int64,
                                      device=scene.device)
    if use_block8(cfg.width, cfg.height):
        x, y = slot_to_xy(lin, cfg.width)
    else:
        x, y = lin % cfg.width, lin // cfg.width
    return render_pixels(scene, cam, x, y, frame_index, cfg, remat=remat,
                         hitrec=hitrec)


def render_mxu_replay(scene, cam, frame_index: int, cfg: RenderConfig,
                      remat: bool = True):
    """The differentiable mxu forward: (H, W, 3), matching
    render_dispatch(backend='mxu') up to replay rounding.

    Triangle-vertex optimization sees the kernel's static geometry tables
    (scene.mxu_arrays) for the hit records only; values still
    differentiate against the live triangle tensors.  Callers optimizing
    vertices rebuild the scene between steps to refresh the topology."""
    from .kernels.megakernel import slots_to_image, use_block8
    color = render_rays_mxu_replay(scene, cam, frame_index, cfg,
                                   pixel_offset=0,
                                   n_rays=cfg.width * cfg.height,
                                   remat=remat)
    if use_block8(cfg.width, cfg.height):
        return slots_to_image(color, cfg.width, cfg.height)
    return color.reshape(cfg.height, cfg.width, 3)
