"""The plain reference path tracer: PyTorch, one lane per (pixel,
dispatch), written from the upstream shader's semantics.

A frozen copy of the arithmetic of the program's XLA-style route
(rtm_tpu_torch/ops/trace_ref.py `render_pixels`, ops/intersect.py,
ops/shade.py, ops/rng.py), kept here so that a later change to the
program cannot move the yardstick.  It imports nothing of the program and
takes nothing the program made: its tables come from
`reference.scene.build_tables`.

  * RNG: the PCG hash per thread (RayTracing.shader:123-151), the pixel
    seed `y*W + x + frame*frameIndex*735529` and `seed += bounce`.
  * Camera rays with both jitters (shader:684-706).
  * Intersection: spheres all-pairs (nearest positive root); triangles by
    the scalar-triple-product test with backface culling (det > eps) and
    first-in-order ties, by a chunked sweep or, for large scenes, through
    the reference's own cluster cull (a Morton cut into clusters of 64
    with padded boxes, clusters taken nearest entry first until none can
    hold a nearer hit).  Both give the nearest hit of the full sweep.
  * Shading: sky on miss, emission and albedo (bilinear texture taps with
    repeat wrap), the diffuse / specular / dielectric scatter.

`dtype` selects the float precision of everything but the RNG; float32
is the reference, bfloat16 the control.  The render is differentiable in
the material table (`mat`), which the fit cell's reference optimises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

U32 = 0xFFFFFFFF
SEED_STRIDE = 735529
UINT_MAX_F = float(np.float32(4294967295.0))
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))
OFFSET = float(np.float32(1.0e-4))
DET_EPS = 1e-12
CLUSTER = 64          # triangles per cluster of the cull
ROUND = 8             # clusters tested per lane per round


# --------------------------------------------------------------------- RNG

def pcg(seed):
    state = (seed * 747796405 + 2891336453) & U32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & U32
    return (word >> 22) ^ word


def rand(seed, dtype):
    seed = pcg(seed)
    return (seed.to(torch.float32) / UINT_MAX_F).to(dtype), seed


def rand_circle(seed, dtype):
    r1, seed = rand(seed, dtype)
    r2, seed = rand(seed, dtype)
    ang = r1 * TWO_PI
    rad = torch.sqrt(r2)
    return torch.stack([torch.cos(ang) * rad, torch.sin(ang) * rad], -1), seed


def rand_sphere(seed, dtype):
    x, seed = rand(seed, dtype)
    y, seed = rand(seed, dtype)
    z, seed = rand(seed, dtype)
    return 2.0 * torch.stack([x, y, z], -1) - 1.0, seed


# ------------------------------------------------------------------ camera

def camera_matrices(cam: dict, width: int, height: int):
    """(inv_projection (4,4), inv_view (4,4)) in float64: the inverse of
    glm::perspectiveFov (right-handed, clip z in [-1, 1]) and the
    closed-form inverse of glm::lookAt(pos, pos + dir, +y)."""
    fov = math.radians(cam["fov"])
    near, far = cam["near"], cam["far"]
    h = math.cos(0.5 * fov) / math.sin(0.5 * fov)
    proj = np.zeros((4, 4))
    proj[0, 0] = h * height / width
    proj[1, 1] = h
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    eye = np.asarray(cam["position"], np.float64)
    f = (eye + np.asarray(cam["direction"], np.float64)) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, [0.0, 1.0, 0.0])
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    inv_view = np.eye(4)
    inv_view[:3, 0], inv_view[:3, 1], inv_view[:3, 2] = s, u, -f
    inv_view[:3, 3] = eye
    return np.linalg.inv(proj), inv_view


def _mv(a, m):
    """a (N,K) times m (R,K) transposed, summed over k in order."""
    out = a[:, 0:1] * m[:, 0][None, :]
    for k in range(1, a.shape[1]):
        out = out + a[:, k:k + 1] * m[:, k][None, :]
    return out


def camera_rays(cam: dict, width: int, height: int, x, y, seed, dtype):
    """Primary rays (origin, direction, seed) of lanes at pixels (x, y)."""
    dev = x.device
    ip, iv = camera_matrices(cam, width, height)
    ip = torch.tensor(ip, dtype=torch.float32).to(dev, dtype)
    iv = torch.tensor(iv, dtype=torch.float32).to(dev, dtype)
    pos = torch.tensor(cam["position"], dtype=torch.float32).to(dev, dtype)

    def scalar(k):
        return float(np.float32(cam[k]))

    px = (x.to(torch.float32) / float(width)).to(dtype)
    py = (y.to(torch.float32) / float(height)).to(dtype)
    one = torch.ones_like(px)
    coord = _mv(torch.stack([2.0 * px - 1.0, 2.0 * py - 1.0, one, one], -1),
                ip)
    c3 = coord[:, :3] / coord[:, 3:4]
    d4 = torch.cat([c3, torch.zeros_like(c3[:, :1])], -1)
    focus = pos[None, :] + _mv(d4, iv)[:, :3] * scalar("focus_distance")
    right, up = iv[:3, 0], iv[:3, 1]
    res = torch.tensor([float(width), float(height)], device=dev).to(dtype)
    fj, seed = rand_circle(seed, dtype)
    fj = fj / res * scalar("defocus_strength")
    dj, seed = rand_circle(seed, dtype)
    dj = dj / res * scalar("blur_strength")
    dev_focus = focus + dj[:, :1] * right[None, :] + dj[:, 1:2] * up[None, :]
    origin = (pos[None, :] + fj[:, :1] * right[None, :]
              + fj[:, 1:2] * up[None, :])
    return origin, normalize(dev_focus - origin), seed


# ------------------------------------------------------------- geometry

def dot(a, b):
    return (a * b).sum(-1)


def dot_seq(a, b):
    """a . b summed x, y, z in order (the sweep's contraction)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def safe_normalize(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-20))


class Scene:
    """The reference's scene on one device, in one precision."""

    def __init__(self, tables, device, dtype=torch.float32):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def f(a):
            return t(a).to(dtype)

        self.dtype = dtype
        self.wa, self.wb, self.wc = f(tables.wa), f(tables.wb), f(tables.wc)
        self.la, self.lab, self.lac = (f(tables.la), f(tables.lab),
                                       f(tables.lac))
        self.normal, self.uv = f(tables.normal), f(tables.uv)
        self.tri_mat = t(tables.tri_mat).long()
        self.sph_pos, self.sph_radius = f(tables.sph_pos), f(tables.sph_radius)
        self.sph_mat = t(tables.sph_mat).long()
        self.mat = f(tables.mat)
        self.tex_id = t(tables.mat[:, 10].astype(np.int64))
        self.textures = [f(x) for x in tables.textures]
        self.sky = f(tables.sky)
        ab = self.wb - self.wa
        ac = self.wc - self.wa
        n = cross(ab, ac)
        # per-triangle features: n, A.n, AB, AC, AC x A, AB x A
        self.feat = torch.cat([n, dot(self.wa, n)[:, None], ab, ac,
                               cross(ac, self.wa), cross(ab, self.wa)], -1)
        self.clusters = None
        if len(tables.wa) > 4 * CLUSTER:
            self.clusters = self._cluster_boxes(tables)

    @property
    def num_triangles(self) -> int:
        return self.wa.shape[0]

    def _cluster_boxes(self, tables):
        """Morton order of the centroids cut into CLUSTER-triangle
        clusters: (order (T_pad,) with -1 padding, boxes (C, 2, 3))."""
        cen = (tables.wa + tables.wb + tables.wc).astype(np.float64) / 3.0
        lo = cen.min(0)
        span = np.maximum(cen.max(0) - lo, 1e-12)
        q = np.clip((cen - lo) / span * 1023.0, 0, 1023).astype(np.int64)
        code = np.zeros(len(q), np.int64)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
        order = np.argsort(code, kind="stable")
        n_cl = -(-len(order) // CLUSTER)
        pad = np.full(n_cl * CLUSTER, -1, np.int64)
        pad[:len(order)] = order
        tri = np.stack([tables.wa, tables.wb, tables.wc], 1).astype(
            np.float64)
        boxes = np.zeros((n_cl, 2, 3))
        for c in range(n_cl):
            ids = pad[c * CLUSTER:(c + 1) * CLUSTER]
            pts = tri[ids[ids >= 0]].reshape(-1, 3)
            lo_c, hi_c = pts.min(0), pts.max(0)
            eps = 1e-4 * (hi_c - lo_c).max() + 1e-5
            boxes[c, 0], boxes[c, 1] = lo_c - eps, hi_c + eps
        dev = self.wa.device
        return (torch.from_numpy(pad).to(dev),
                torch.from_numpy(boxes.astype(np.float32)).to(dev))


def _tri_t(o, d, w, feat):
    """t of each (lane, triangle) pair, +inf where missed.  o, d, w
    (N,1,3) or (N,3) broadcast against feat (...,16)."""
    n, an, ab, ac, g1, g2 = (feat[..., 0:3], feat[..., 3], feat[..., 4:7],
                             feat[..., 7:10], feat[..., 10:13],
                             feat[..., 13:16])
    det = -dot_seq(d, n)
    tdet = dot_seq(o, n) - an
    udet = dot_seq(w, ac) - dot_seq(d, g1)
    vdet = dot_seq(d, g2) - dot_seq(w, ab)
    wdet = det - udet - vdet
    ok = ((det > DET_EPS) & (tdet >= 0) & (udet >= 0) & (vdet >= 0)
          & (wdet >= 0))
    return torch.where(ok, tdet / torch.where(ok, det, 1.0), math.inf)


def _nearest_sweep(sc, o, d, chunk=256):
    n = o.shape[0]
    best_t = torch.full((n,), math.inf, device=o.device, dtype=o.dtype)
    best_i = torch.full((n,), -1, device=o.device, dtype=torch.int64)
    w = cross(o, d)
    for c0 in range(0, sc.num_triangles, chunk):
        t = _tri_t(o[:, None], d[:, None], w[:, None],
                   sc.feat[c0:c0 + chunk][None])
        tmin, imin = torch.min(t, 1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin + c0, best_i)
    return best_t, best_i


def _nearest_culled(sc, o, d):
    order, boxes = sc.clusters
    n = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(d == 0, 1e-30, d).float()
    lo = (boxes[None, :, 0] - o.float()[:, None]) * inv[:, None]
    hi = (boxes[None, :, 1] - o.float()[:, None]) * inv[:, None]
    t_in = torch.minimum(lo, hi).amax(-1).clamp(min=0.0)
    t_out = torch.maximum(lo, hi).amin(-1)
    entry = torch.where(t_in <= t_out, t_in, math.inf)        # (N, C)
    entry, cl = torch.sort(entry, 1)
    best_t = torch.full((n,), math.inf, device=dev, dtype=o.dtype)
    best_i = torch.full((n,), -1, device=dev, dtype=torch.int64)
    w = cross(o, d)
    lane_ar = torch.arange(CLUSTER, device=dev)
    for r in range(0, entry.shape[1], ROUND):
        act = torch.nonzero(entry[:, r] < best_t.float())[:, 0]
        if act.numel() == 0:
            break
        ids = order[(cl[act, r:r + ROUND, None] * CLUSTER
                     + lane_ar).reshape(len(act), -1)]          # (na, R*64)
        t = _tri_t(o[act, None], d[act, None], w[act, None],
                   sc.feat[ids.clamp(min=0)])
        t = torch.where(ids >= 0, t, math.inf)
        tmin = t.amin(1)
        imin = torch.where(t == tmin[:, None], ids,
                           torch.iinfo(torch.int64).max).amin(1)
        bt, bi = best_t[act], best_i[act]
        better = (tmin < bt) | ((tmin == bt) & (imin < bi) & (tmin < math.inf))
        best_t[act] = torch.where(better, tmin, bt)
        best_i[act] = torch.where(better, imin, bi)
    return best_t, best_i


def nearest_triangle(sc, o, d):
    """(t, index) of the nearest triangle hit per lane (-1, +inf on a
    miss), found without autograd; t recomputed from the winner's plane
    so gradients reach the ray."""
    if sc.num_triangles == 0:
        n = o.shape[0]
        return (torch.full((n,), math.inf, device=o.device, dtype=o.dtype),
                torch.full((n,), -1, device=o.device, dtype=torch.int64))
    with torch.no_grad():
        if sc.clusters is None:
            _, idx = _nearest_sweep(sc, o.detach(), d.detach())
        else:
            _, idx = _nearest_culled(sc, o.detach(), d.detach())
    fw = sc.feat[idx.clamp(min=0)]
    n = fw[:, 0:3]
    det = -dot_seq(d, n)
    t = (dot_seq(o, n) - fw[:, 3]) / torch.where(idx >= 0, det, 1.0)
    return torch.where(idx >= 0, t, math.inf), idx


def nearest_sphere(sc, o, d):
    n = o.shape[0]
    if sc.sph_pos.shape[0] == 0:
        return (torch.full((n,), math.inf, device=o.device, dtype=o.dtype),
                torch.full((n,), -1, device=o.device, dtype=torch.int64))
    oc = o[:, None, :] - sc.sph_pos[None]
    a = dot(d, d)[:, None]
    b = 2.0 * (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - (sc.sph_radius * sc.sph_radius)[None]
    delta = b * b - 4.0 * a * c
    hit = delta >= 0
    t = (-b - torch.sqrt(torch.where(hit, delta.clamp(min=1e-12), 1.0))) / (
        2.0 * a)
    t = torch.where(hit & (t >= 0), t, math.inf)
    tmin, idx = torch.min(t, 1)
    return tmin, torch.where(tmin < math.inf, idx, -1)


# ---------------------------------------------------------------- shading

def bilinear(img, u, v, repeat: bool):
    """GPU-convention bilinear tap (texel centres at +0.5): repeat wrap,
    or clamp-to-edge with the lower edge collapsed onto texel 0."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[:, None], (y - y0f)[:, None]
    x0, y0 = x0f.long(), y0f.long()
    if repeat:
        x0, y0 = torch.remainder(x0, w), torch.remainder(y0, h)
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    else:
        fx = torch.where((x0f < 0)[:, None], 0.0, fx)
        fy = torch.where((y0f < 0)[:, None], 0.0, fy)
        x0, y0 = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
        x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    top = img[y0, x0] * (1.0 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1.0 - fx) + img[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def equirect_uv(n):
    u = torch.atan2(n[:, 2], n[:, 0]) / TWO_PI + 0.5
    v = torch.asin(torch.clamp(n[:, 1], -1.0 + 1e-6, 1.0 - 1e-6)) / PI + 0.5
    return u, v


def texture(sc, tex, u, v):
    out = torch.zeros(u.shape + (3,), device=u.device, dtype=u.dtype)
    for k, img in enumerate(sc.textures):
        sel = tex == k
        out = torch.where(sel[:, None],
                          bilinear(img, torch.where(sel, u, 0.0),
                                   torch.where(sel, v, 0.0), True), out)
    return out


def reflect(d, n):
    return d - 2.0 * dot(d, n)[:, None] * n


def refract(i, n, eta):
    ndi = dot(n, i)[:, None]
    k = 1.0 - eta[:, None] ** 2 * (1.0 - ndi * ndi)
    out = eta[:, None] * i - (eta[:, None] * ndi
                              + torch.sqrt(torch.clamp(k, min=1e-12))) * n
    return torch.where(k >= 0.0, out, 0.0)


def scatter(d, seed, pos, nrm, rough, metal, refr, dtype):
    """The dielectric branch (1 draw) where refraction > 1, else the
    diffuse / specular mix (6 draws), both from the same seed."""
    is_refr = refr > 1.0
    front = dot(d, nrm) < 0.0
    rt = torch.where(front, 1.0 / torch.where(refr == 0.0, 1.0, refr), refr)
    hn = torch.where(front[:, None], nrm, -nrm)
    cos_t = torch.clamp(dot(-d, hn), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    r0 = ((1.0 - rt) / (1.0 + rt)) ** 2
    r0p = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    rr, seed_refr = rand(seed, dtype)
    do_refl = (rt * sin_t > 1.0) | (r0p > rr)
    o_refr = torch.where(do_refl[:, None], pos + hn * OFFSET,
                         pos - hn * OFFSET)
    d_refr = torch.where(do_refl[:, None], reflect(d, hn),
                         refract(d, hn, rt))
    r3a, s1 = rand_sphere(seed, dtype)
    diffuse = safe_normalize(nrm + r3a)
    r3b, s2 = rand_sphere(s1, dtype)
    spec = safe_normalize(reflect(d, nrm) + r3b * (1.0 - metal)[:, None])
    d_refl = safe_normalize(diffuse * (1.0 - rough[:, None])
                            + spec * rough[:, None])
    m = is_refr[:, None]
    return (torch.where(m, o_refr, pos + nrm * OFFSET),
            torch.where(m, d_refr, d_refl),
            torch.where(is_refr, seed_refr, s2))


def trace(sc: Scene, cam: dict, width: int, height: int, x, y, frame_index,
          spp: int, bounces: int, draw_env: bool, mat=None):
    """Radiance of each lane averaged over `spp` samples: lane j is pixel
    (x[j], y[j]) of the dispatch whose accumulation counter is
    frame_index[j] (int64 tensors on the scene's device).  `mat`
    replaces the material table (differentiable)."""
    dt = sc.dtype
    mat = sc.mat if mat is None else mat
    x, y, fi = x.long(), y.long(), frame_index.long() & U32
    n = x.shape[0]
    dev = x.device
    env = 1.0 if draw_env else 0.0
    total = torch.zeros((n, 3), device=dev, dtype=dt)
    lin = (y * width + x) & U32
    for frame in range(1, spp + 1):
        seed = (lin + ((frame * fi * SEED_STRIDE) & U32)) & U32
        o, d, seed = camera_rays(cam, width, height, x, y, seed, dt)
        color = torch.zeros((n, 3), device=dev, dtype=dt)
        contrib = torch.ones((n, 3), device=dev, dtype=dt)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for b in range(bounces):
            seed = (seed + b) & U32
            t_s, i_s = nearest_sphere(sc, o, d)
            t_t, i_t = nearest_triangle(sc, o, d)
            use_tri = t_t < t_s
            t = torch.where(use_tri, t_t, t_s)
            hit = t < math.inf
            pos = o + torch.where(hit, t, 0.0)[:, None] * d
            si = i_s.clamp(min=0)
            ti = i_t.clamp(min=0)
            if sc.sph_pos.shape[0]:
                s_nrm = safe_normalize(pos - sc.sph_pos[si])
                s_u, s_v = equirect_uv(s_nrm)
                s_mat = sc.sph_mat[si]
            else:
                s_nrm = torch.zeros_like(pos)
                s_u = s_v = torch.zeros_like(t)
                s_mat = torch.zeros_like(si)
            if sc.num_triangles:
                # texture UV from the world ray against the local vertex
                # and edges (the upstream shader's mix, shader:257-268)
                lab, lac = sc.lab[ti], sc.lac[ti]
                dao = cross(o - sc.la[ti], d)
                det = -dot(d, cross(lab, lac))
                inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
                u = dot(lac, dao) * inv_det
                v = -dot(lab, dao) * inv_det
                uvs = sc.uv[ti]
                t_uv = (uvs[:, 0] * (1.0 - u - v)[:, None]
                        + uvs[:, 1] * u[:, None] + uvs[:, 2] * v[:, None])
                t_nrm, t_mat = sc.normal[ti], sc.tri_mat[ti]
            else:
                t_nrm = torch.zeros_like(pos)
                t_uv = torch.zeros_like(pos[:, :2])
                t_mat = torch.zeros_like(ti)
            nrm = torch.where(use_tri[:, None], t_nrm, s_nrm)
            hu = torch.where(use_tri, t_uv[:, 0], s_u)
            hv = torch.where(use_tri, t_uv[:, 1], s_v)
            mi = torch.where(use_tri, t_mat, s_mat)

            miss = alive & ~hit
            sky_dir = torch.where(miss[:, None], d,
                                  torch.eye(1, 3, device=dev, dtype=dt))
            su, sv = equirect_uv(sky_dir)
            sky = bilinear(sc.sky, su, sv, False)
            color = torch.where(miss[:, None], color + sky * contrib * env,
                                color)
            live = alive & hit
            m = mat[mi]
            tex = sc.tex_id[mi]
            no, nd, ns = scatter(d, seed, pos, nrm, m[:, 6], m[:, 7],
                                 m[:, 9], dt)
            has_tex = tex >= 0
            alb_tex = texture(sc, tex, torch.where(has_tex, hu, 0.0),
                              torch.where(has_tex, hv, 0.0))
            emp = m[:, 8:9]
            emis = torch.where(has_tex[:, None], alb_tex * emp,
                               m[:, 3:6] * emp)
            albedo = torch.where(has_tex[:, None], alb_tex, m[:, 0:3])
            color = torch.where(live[:, None], color + emis * contrib, color)
            contrib = torch.where(live[:, None], contrib * albedo, contrib)
            o = torch.where(live[:, None], no, o)
            d = torch.where(live[:, None], nd, d)
            seed = torch.where(live, ns, seed)
            alive = live
        total = total + color
    return total / float(spp)


def trace_blocked(sc, cam, width, height, x, y, frame_index, spp, bounces,
                  draw_env):
    """`trace` without autograd in blocks of lanes, float32 results."""
    block = 1 << (16 if sc.clusters is not None else 18)
    out = []
    with torch.no_grad():
        for s in range(0, x.shape[0], block):
            out.append(trace(sc, cam, width, height, x[s:s + block],
                             y[s:s + block], frame_index[s:s + block], spp,
                             bounces, draw_env).float())
    return torch.cat(out) if out else torch.zeros((0, 3))
