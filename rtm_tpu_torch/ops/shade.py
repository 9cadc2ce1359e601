"""Shading: sky/texture sampling and the XLA-style path's scatter.

Reference device code: getSkyColor (RayTracing.shader:197-220), scatter /
reflectRay / refractRay / reflectance (shader:590-649), accumulateColor
(shader:550-588).  The quad tables are built on the host in NumPy
(`build_quad_flat`); the samplers and `scatter` are torch functions
vectorised over a leading lane axis and run on whatever device the tables
live on, under autograd too (the texture tap carries gradients to u, v
through its bilinear weights).  The kernels' scatter step lives in
ops/kernels/vreg_common.py (and its CUDA twin in csrc/bounce_common.cuh).
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .intersect import dot3, safe_normalize

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))
OFFSET = float(np.float32(1.0e-4))  # hit-point normal offset (shader:616,621,628)


# ---------------------------------------------------------------------------
# Quad tables (host side)
# ---------------------------------------------------------------------------

def build_quad_flat(img, wrap: str, dtype=np.float32) -> np.ndarray:
    """Pack (H,W,3) into a (H*W,12) quad table: row (y,x) holds the 2x2
    bilinear footprint [c(y,x), c(y,x+1), c(y+1,x), c(y+1,x+1)] with the
    wrap mode baked into the +1 neighbours, so one bilinear sample is one
    row fetch.

    dtype=np.int32 packs one i32 per texel, (r,g,b) in bytes 0..2: 16-byte
    rows, EXACT for u8-sourced images (callers check quad_exact_u8 first);
    `sample_quads` decodes with the same /255 division as the loaders.
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape[0], img.shape[1]
    if wrap == "repeat":
        xn = (np.arange(w) + 1) % w
        yn = (np.arange(h) + 1) % h
    else:                                     # clamp-to-edge
        xn = np.minimum(np.arange(w) + 1, w - 1)
        yn = np.minimum(np.arange(h) + 1, h - 1)
    quads = np.concatenate([img, img[:, xn], img[yn], img[yn][:, xn]],
                           axis=-1).reshape(h * w, 12)
    if dtype == np.int32:
        q = np.round(np.clip(quads, 0.0, 1.0) * np.float32(255.0)).astype(
            np.int32).reshape(h * w, 4, 3)
        return q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16)
    return quads.astype(dtype)


def quad_exact_u8(img) -> bool:
    """True when every texel is exactly byte/255 — i.e. the i32-packed quad
    table reproduces the f32 table bit-for-bit.  DIVISION by 255, not
    multiplication by 1/255: the loaders and sample_quads' decode divide,
    and the two differ in f32 for 126 of 256 byte values."""
    v = np.asarray(img, np.float32)
    if v.size == 0:
        return True
    if v.min() < 0.0 or v.max() > 1.0:
        return False
    q = np.round(v * np.float32(255.0)) / np.float32(255.0)
    return bool(np.array_equal(q.astype(np.float32), v))


# ---------------------------------------------------------------------------
# Samplers (device side)
# ---------------------------------------------------------------------------

def _bilinear_gather(img, yi, xi):
    """img (H,W,3); yi/xi (...,) int already wrapped/clamped: the texels,
    gathered through a flattened (H*W, 3) view with linear indices."""
    w = img.shape[1]
    return img.reshape(-1, img.shape[-1])[(yi * w + xi).long()]


def sample_bilinear(img, u, v, wrap: str):
    """GPU-convention bilinear sample of img (H,W,3) at normalized (u,v),
    four texel taps.

    texel center convention: x = u*W - 0.5.  wrap: 'repeat' (Vulkan
    REPEAT, scene textures) or 'clamp' (CLAMP_TO_EDGE, sky map) — matches
    the sampler modes the reference creates (VulkanTexture.cpp:338-343,
    RayTracing.cpp:843 sky = Linear+ClampToEdge, scene textures default
    Linear+Repeat per Texture.h:32-35).  The renderer samples through the
    quad tables (`sample_quads`) instead.  Returns (...,3).
    """
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap == "repeat":
        x0, x1 = torch.remainder(x0, w), torch.remainder(x1, w)
        y0, y1 = torch.remainder(y0, h), torch.remainder(y1, h)
    else:
        x0, x1 = torch.clamp(x0, 0, w - 1), torch.clamp(x1, 0, w - 1)
        y0, y1 = torch.clamp(y0, 0, h - 1), torch.clamp(y1, 0, h - 1)
    c00 = _bilinear_gather(img, y0, x0)
    c01 = _bilinear_gather(img, y0, x1)
    c10 = _bilinear_gather(img, y1, x0)
    c11 = _bilinear_gather(img, y1, x1)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_quads(flat_quads, h, w, u, v, wrap: str, base=0, row_w=None):
    """Bilinear sample via the quad table (ONE row gather per sample).

    h/w: true texture extent (python ints or per-lane tensors); row_w:
    padded row stride of the flattened table (defaults to w); base: per-lane
    row offset of the texture within a stacked table.  Returns (..., 3).
    """
    if row_w is None:
        row_w = w
    hf = h.float() if torch.is_tensor(h) else float(h)
    wf = w.float() if torch.is_tensor(w) else float(w)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if wrap == "repeat":
        x0 = torch.remainder(x0, w)
        y0 = torch.remainder(y0, h)
    else:
        # lower-edge clamp: the original clamps BOTH taps to texel 0, so the
        # interpolation weight must collapse to the c00 corner
        fx = torch.where((x0f < 0)[..., None], 0.0, fx)
        fy = torch.where((y0f < 0)[..., None], 0.0, fy)
        x0 = torch.clamp(x0, 0, w - 1)
        y0 = torch.clamp(y0, 0, h - 1)
    # element gather from the flat table: a gather of whole rows launches
    # one CUDA block per row in PyTorch, nearly idle for a 16-byte row
    qw = flat_quads.shape[1]
    idx = (base + y0 * row_w + x0).long()[..., None] * qw
    q = flat_quads.reshape(-1)[idx + torch.arange(qw, device=idx.device)]
    if flat_quads.dtype == torch.int32:
        t = []
        for c in range(4):
            wrd = q[..., c]
            t.append(torch.stack([(wrd & 0xFF).float(),
                                  ((wrd >> 8) & 0xFF).float(),
                                  ((wrd >> 16) & 0xFF).float()],
                                 dim=-1) / 255.0)
        top = t[0] * (1.0 - fx) + t[1] * fx
        bot = t[2] * (1.0 - fx) + t[3] * fx
        return top * (1.0 - fy) + bot * fy
    q = q.float()
    top = q[..., 0:3] * (1.0 - fx) + q[..., 3:6] * fx
    bot = q[..., 6:9] * (1.0 - fx) + q[..., 9:12] * fx
    return top * (1.0 - fy) + bot * fy


def sample_texture_quads(tex_quads, tex_size, th: int, tw: int, tex_id, u,
                         v):
    """Bindless texture sample via the stacked quad table: ONE row gather.

    `tex_quads` is the (K*TH*TW, 4|12) stacked table built by
    models/scene.py; th/tw are the padded per-texture extents (python
    ints); tex_size (K,2) the true extents.  Repeat wrap is baked into the
    quad rows at build, so only the base tap is wrapped here.
    """
    k = tex_size.shape[0]
    tid = torch.clamp(tex_id, 0, k - 1)                  # <0 lanes masked out
    hw = tex_size[tid.long()]
    return sample_quads(tex_quads, hw[..., 0], hw[..., 1], u, v,
                        wrap="repeat", base=tid * (th * tw), row_w=tw)


def sample_texture_array(textures, tex_size, tex_id, u, v):
    """Sample the bindless texture array (shader:578) for per-lane tex_id,
    four texel taps.

    textures: (K,TH,TW,3) padded stack; tex_size: (K,2) actual (H,W).
    Wrap = repeat within each texture's true extent.  tex_id < 0 lanes
    sample texture 0 (callers mask them out).  The renderer samples
    through the quad table (`sample_texture_quads`) instead.
    """
    k = textures.shape[0]
    tid = torch.clamp(tex_id, 0, k - 1).long()
    hw = tex_size[tid]                                   # (...,2)
    hi = hw[..., 0]
    wi = hw[..., 1]
    x = u * wi.float() - 0.5
    y = v * hi.float() - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int32), wi)
    x1 = torch.remainder(x0f.to(torch.int32) + 1, wi)
    y0 = torch.remainder(y0f.to(torch.int32), hi)
    y1 = torch.remainder(y0f.to(torch.int32) + 1, hi)
    th, tw = textures.shape[1], textures.shape[2]
    flat = textures.reshape(-1, textures.shape[-1])
    base = tid * (th * tw)
    c00 = flat[base + y0 * tw + x0]
    c01 = flat[base + y0 * tw + x1]
    c10 = flat[base + y1 * tw + x0]
    c11 = flat[base + y1 * tw + x1]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sky_color(direction, sky):
    """Equirect sky sample (shader:216-218) of the (H,W,3) map by four
    texel taps: uv = (atan2(z,x)/2pi, asin(y)/pi) + 0.5, Linear +
    ClampToEdge (`sky_color_quads` is the renderer's one-row form)."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) / TWO_PI + 0.5
    v = torch.asin(torch.clamp(direction[..., 1], -1.0 + 1e-6,
                               1.0 - 1e-6)) / PI + 0.5
    return sample_bilinear(sky, u, v, wrap="clamp")


def sky_color_quads(direction, sky_quads, h: int, w: int):
    """Equirect sky sample (shader:216-218) through the quad table:
    uv = (atan2(z,x)/2pi, asin(y)/pi) + 0.5, Linear + ClampToEdge."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) / TWO_PI + 0.5
    v = torch.asin(torch.clamp(direction[..., 1], -1.0 + 1e-6,
                               1.0 - 1e-6)) / PI + 0.5
    return sample_quads(sky_quads, h, w, u, v, wrap="clamp")


def sphere_uv(normal):
    """Sphere UV from the unit normal (shader:245)."""
    u = torch.atan2(normal[..., 2], normal[..., 0]) / TWO_PI + 0.5
    v = torch.asin(torch.clamp(normal[..., 1], -1.0 + 1e-6,
                               1.0 - 1e-6)) / PI + 0.5
    return u, v


# ---------------------------------------------------------------------------
# Scatter (the XLA-style path; the kernels' twin is vreg_common.scatter_step)
# ---------------------------------------------------------------------------

def reflect(d, n):
    """GLSL reflect."""
    return d - 2.0 * dot3(d, n)[..., None] * n


def refract(i, n, eta):
    """GLSL refract incl. the zero-vector total-internal-reflection result;
    the square root's argument is floored so its gradient stays finite."""
    ndi = dot3(n, i)[..., None]
    k = 1.0 - eta[..., None] ** 2 * (1.0 - ndi * ndi)
    out = (eta[..., None] * i
           - (eta[..., None] * ndi + torch.sqrt(torch.clamp(k, min=1e-12)))
           * n)
    return torch.where(k >= 0.0, out, 0.0)


def scatter(origin, direction, seed, hit_pos, hit_normal,
            m_roughness, m_metallic, m_refraction):
    """One scatter step for every lane; returns (new_origin, new_direction,
    new_seed).  Lanes where refraction_ratio > 1 take the dielectric path
    (1 RNG draw), others the diffuse/specular path (6 draws); both streams
    are evaluated from the same incoming seed and masked, reproducing
    per-thread SIMT seed evolution exactly (shader:637-649)."""
    is_refract = m_refraction > 1.0

    # --- dielectric branch (shader:590-624) -------------------------------
    is_front = dot3(direction, hit_normal) < 0.0
    rt = torch.where(is_front,
                     1.0 / torch.where(m_refraction == 0.0, 1.0, m_refraction),
                     m_refraction)
    hn = torch.where(is_front[..., None], hit_normal, -hit_normal)
    cos_theta = torch.clamp(dot3(-direction, hn), max=1.0)
    # grad-safe sqrt: at exact normal incidence sqrt(0) has infinite slope,
    # and this branch is evaluated (then masked) for every lane
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=1e-12))
    cannot_refract = rt * sin_theta > 1.0
    r0 = ((1.0 - rt) / (1.0 + rt)) ** 2
    r0p = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    rand_refl, seed_refr = rng.fast_random(seed)
    do_reflect = cannot_refract | (r0p > rand_refl)
    o_refr = torch.where(do_reflect[..., None], hit_pos + hn * OFFSET,
                         hit_pos - hn * OFFSET)
    d_refr = torch.where(do_reflect[..., None], reflect(direction, hn),
                         refract(direction, hn, rt))

    # --- diffuse/specular branch (shader:626-635) --------------------------
    o_refl = hit_pos + hit_normal * OFFSET
    r3a, s1 = rng.random_unit_sphere(seed)
    diffuse_dir = safe_normalize(hit_normal + r3a)
    r3b, s2 = rng.random_unit_sphere(s1)
    spec_dir = safe_normalize(reflect(direction, hit_normal)
                              + r3b * (1.0 - m_metallic)[..., None])
    rough = m_roughness[..., None]
    d_refl = safe_normalize(diffuse_dir * (1.0 - rough) + spec_dir * rough)

    mask = is_refract[..., None]
    new_origin = torch.where(mask, o_refr, o_refl)
    new_direction = torch.where(mask, d_refr, d_refl)
    new_seed = torch.where(is_refract, seed_refr, s2)
    return new_origin, new_direction, new_seed


FLAT_LIGHT_DIR = (np.array([-1.0, -1.0, -1.0], np.float32)
                  / np.float32(np.sqrt(3.0)))


def flat_shade(albedo, normal):
    """MaxBounces==1 preview mode (shader:566-571).  The reference calls
    clamp(0.0, 0.5, dot(-N, L)) with swapped min/max arguments, which in
    GLSL resolves to min(0.5, dot(-N, L)); preserved exactly."""
    light = torch.from_numpy(FLAT_LIGHT_DIR).to(normal.device)
    d = dot3(-normal, light)
    return albedo * (torch.clamp(d, max=0.5) + 0.5)[..., None]


# ---------------------------------------------------------------------------
# Procedural sun/sky environment (C28 parity)
# ---------------------------------------------------------------------------

SUN_DIR = np.array([1.0, 1.0, 1.0], np.float32) / np.float32(np.sqrt(3.0))
_GROUND = np.array([0.3, 0.3, 0.3], np.float32)
_ZENITH = np.array([0.5, 0.7, 1.0], np.float32)
_HORIZON = np.array([0.6, 0.4, 0.4], np.float32)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sun_sky_constants(device) -> torch.Tensor:
    """(4, 3) f32 rows horizon, zenith, ground, sun direction on
    `device`, for `procedural_sun_sky`."""
    return torch.from_numpy(np.stack([_HORIZON, _ZENITH, _GROUND,
                                      SUN_DIR])).to(device)


def procedural_sun_sky(direction, consts=None):
    """The legacy kernel's procedural environment, exactly
    (OldRayTracing.shader:119-136): horizon->zenith gradient over a ground
    color with a pow-500 sun disk along -LightDir = (1,1,1)/sqrt(3); the
    sun only shows where groundToSky saturates (d.y >= 0).
    direction (...,3) -> (...,3).  consts: `sun_sky_constants` on
    direction's device, when the caller keeps them (else built here)."""
    if consts is None:
        consts = sun_sky_constants(direction.device)
    horizon, zenith, ground, sun_dir = consts
    dy = direction[..., 1]
    sky_lerp = _smoothstep(0.0, 0.4, dy) ** float(np.float32(0.35))
    ground_to_sky = _smoothstep(-0.01, 0.0, dy)
    grad = horizon + (zenith - horizon) * sky_lerp[..., None]
    sun = torch.clamp(direction @ sun_dir, min=0.0) ** 500.0 * 100.0
    col = ground + (grad - ground) * ground_to_sky[..., None]
    return col + (sun * (ground_to_sky >= 1.0))[..., None]


def env_radiance(scene, direction):
    """Environment lookup at miss (shader:663-666): the scene's equirect
    sky map, or the procedural sun/sky when the scene selects it (its
    constants uploaded once per scene)."""
    if scene.env_sun:
        return procedural_sun_sky(direction, scene.derived(
            "sun_sky", lambda: sun_sky_constants(scene.device)))
    return sky_color_quads(direction, scene.sky_quads,
                           scene.sky.shape[0], scene.sky.shape[1])


def sky_tap(scene, d, miss):
    """env_radiance at the miss lanes; the other lanes are collapsed onto
    the direction +x (their tap is discarded), a constant made on d's
    device, with no host data."""
    x_axis = torch.eye(1, 3, dtype=d.dtype, device=d.device)
    return env_radiance(scene, torch.where(miss[..., None], d, x_axis))

