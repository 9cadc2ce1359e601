"""Post-pass inputs made with numpy, shared by the CPU tests
(tests/test_torch_postpass.py, which imports JAX) and the on-card tests
(tests/test_torch_cuda.py, which must not).

`records` follows the tracing kernels' layout: rows per frame and bounce
s_rgb, uv or sphere normal, texid or -1, sphere flag; per frame miss
direction, contribution, valid.  `variant_scene` builds the scenes that
take each of csrc/postpass.cu's variants."""
from __future__ import annotations

import numpy as np

import rtm_tpu_torch
from rtm_tpu_torch.ops.shade import SUN_DIR

N = 512
BOUNCES = 4
FRAMES = 2


def records(seed: int, n=N, bounces=BOUNCES, frames=FRAMES, pad=0,
            near_sun=0.0):
    """(color (n,3), miss (8F, n + pad), rec (8FB, n + pad)) like the
    kernels emit; the `pad` columns past n hold NaN.  near_sun: the share
    of miss directions drawn within a few degrees of the sun."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((frames * bounces, 8, n), np.float32)
    emissive = rng.random((frames * bounces, n)) < 0.25
    rec[:, 0:3] = rng.uniform(0, 2, (frames * bounces, 3, n)) \
        * emissive[:, None]
    textured = rng.random((frames * bounces, n)) < 0.3
    sphere = textured & (rng.random((frames * bounces, n)) < 0.4)
    nrm = rng.normal(size=(frames * bounces, 3, n))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(-3, 10, (frames * bounces, 2, n))
    rec[:, 3:5] = np.where(sphere[:, None], nrm[:, :2], uv)
    rec[:, 5] = np.where(sphere, nrm[:, 2], 0.0)
    rec[:, 6] = np.where(textured, 0.0, -1.0)
    rec[:, 7] = sphere
    miss = np.zeros((frames, 8, n), np.float32)
    valid = rng.random((frames, n)) < 0.6
    d = rng.normal(size=(frames, 3, n))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if near_sun:
        sun = SUN_DIR[None, :, None] + 0.03 * rng.normal(size=(frames, 3, n))
        sun /= np.linalg.norm(sun, axis=1, keepdims=True)
        d = np.where(rng.random((frames, 1, n)) < near_sun, sun, d)
    miss[:, 0:3] = d * valid[:, None]
    miss[:, 3:6] = rng.uniform(0, 1, (frames, 3, n))
    miss[:, 6] = valid
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    miss = miss.reshape(8 * frames, n)
    rec = rec.reshape(8 * frames * bounces, n)
    if pad:
        miss, rec = (np.pad(a, ((0, 0), (0, pad)), constant_values=np.nan)
                     for a in (miss, rec))
    return color, miss, rec


# name: (scene, environment, f32 quad tables) -> the kernel's variant:
# textured or not, spheres or not, sky map or sun, packed or f32 quads
VARIANTS = {
    "tex": (3, "map", False),
    "tex_sph": (2, "map", False),
    "plain_sph": (1, "map", False),
    "tex_sph_f32": (2, "map", True),
    "tex_sun": (3, "sun", False),
    "plain_sun": (4, "sun", False),
}


def variant_scene(name: str, device):
    """The TracerScene of VARIANTS[name] on `device`.  f32: the texture
    and sky scaled off the byte grid (and the sky above 1), so
    build_tracer_scene keeps their quad tables in f32."""
    sid, env, f32 = VARIANTS[name]
    host = rtm_tpu_torch.load_scene(sid)
    if f32:
        host.textures = [np.asarray(t, np.float32) * np.float32(0.77)
                         for t in host.textures]
        host.sky = np.asarray(host.sky, np.float32) * np.float32(1.7)
    return rtm_tpu_torch.build_tracer_scene(host, env_model=env,
                                            device=device)
