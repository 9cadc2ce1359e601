"""Exact pair-test cases of the mxu kernel and a lane model of its pair
pass, shared by the CPU tests (tests/test_torch_mxu.py) and the on-card
tests (tests/test_torch_cuda.py).  This module holds no tests and imports
neither JAX nor rtm_tpu.

On integer rows and features every product of the pair test is exact and
so is every sum, in any order: the tensor cores, the lane model and the
plain version's f32 matmul must then agree bitwise, winners and packed t.
On fractional rays (`frac_rays`) each feature splits into three non-zero
bf16 parts, which the plain version's bf16x3 does not take, so there the
tensor cores are held to the lane model (`model_nearest`); small integer
tables keep every product and sum of those parts on a 2^-18 grid below
2^6, exact in f32 in any order.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from rtm_tpu_torch.ops.kernels import mxu_kernel as tmk

# chunk and group edges: 1 group, 7 / 8 / 9 rows, the Cornell scene's 34,
# 127 / 128 / 129 around one chunk, and the table's 2047 (16 chunks)
N_TRIS_EDGES = (1, 7, 8, 9, 34, 127, 128, 129, 2047)


def int_tables(n_tris, seed, dup=False, span=4):
    """MxuArrays (CPU) of integer-valued triangles (vertices in [-span,
    span]): at span 4 every pair row is an integer the bf16 split holds
    exactly as hi + lo (the edge rows' A_lo is 0; span 16 makes it
    non-zero).  dup: each odd triangle repeats the even one before it."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-span, span + 1, size=(n_tris, 3, 3)).astype(np.float32)
    if dup:
        v[1::2] = v[0:n_tris - 1:2]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return tmk.build_mxu_tables(v[:, 0], v[:, 1], v[:, 2], n,
                                np.zeros(n_tris, np.int32),
                                np.full(1, -1, np.int32), 1, 0).arrays


def int_rays(n, seed):
    """Integer rays, (6, N) rows o, d: origins in [-8, 8], directions in
    [-3, 3] (so o x d and the constant 1 are bf16-exact: b_lo = 0), every
    7th ray axis-aligned, and NaN and inf rays among them; no direction is
    zero."""
    rng = np.random.default_rng(seed)
    o = rng.integers(-8, 9, size=(n, 3)).astype(np.float32)
    d = rng.integers(-3, 4, size=(n, 3)).astype(np.float32)
    d[(d == 0).all(axis=1)] = (1.0, -2.0, 1.0)
    axis = np.arange(0, n, 7)
    d[axis] = 0.0
    d[axis, axis % 3] = rng.choice([-2.0, 1.0, 3.0], size=len(axis))
    d[5::97, 1] = np.nan
    d[11::89, 2] = np.inf
    o[13::101, 0] = -np.inf
    return torch.from_numpy(np.concatenate([o, d], axis=1).T.copy())


def frac_rays(n, seed):
    """Rays whose features split into three non-zero bf16 parts, (6, N)
    rows o, d.  A split value is s (H / 2^7 + M / 2^16 + L / 2^18), H in
    [129, 254], |M| in [129, 255], L = +-1, whose parts are those three
    terms; the first half of the rays has such origins and directions in
    {-1, 0, 1}, the second half integer origins in [-2, 2] and such
    directions, so o x d splits in both.  Every 7th direction is
    axis-aligned; NaN and inf rays are among them.  Against
    `int_tables(span=1)` every sum of products stays below 2^6 on the
    2^-18 grid."""
    rng = np.random.default_rng(seed)

    def split(size):
        sign = lambda: rng.choice([-1.0, 1.0], size=size)  # noqa: E731
        return sign() * (rng.integers(129, 255, size=size) / 2.0 ** 7
                         + sign() * rng.integers(129, 256, size=size)
                         / 2.0 ** 16 + sign() / 2.0 ** 18)

    h = n // 2
    o = rng.integers(-2, 3, size=(n, 3)).astype(np.float64)
    d = rng.integers(-1, 2, size=(n, 3)).astype(np.float64)
    o[:h] = split((h, 3))
    d[h:] = split((n - h, 3))
    d[(d == 0).all(axis=1)] = (1.0, -1.0, 1.0)
    axis = np.arange(0, n, 7)
    keep = d[axis, axis % 3]
    d[axis] = 0.0
    d[axis, axis % 3] = np.where(keep == 0, 1.0, keep)
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[5::97, 1] = np.nan
    d[11::89, 2] = np.inf
    o[13::101, 0] = -np.inf
    return torch.from_numpy(np.concatenate([o, d], axis=1).T.copy())


def table_scene(ma, n_tris, device):
    """What mxu_nearest reads of a scene, around bare tables."""
    arrays = ma.to(device)
    return types.SimpleNamespace(
        mxu_arrays=arrays, device=arrays.pair.device,
        mxu_meta=tmk.MxuMeta(n_tris, ma.pair.shape[0], True, ()))


def plain_key(ma, n_tris, rays):
    """The plain version's least packed key per ray (bf16x3)."""
    return tmk.nearest_packed_plain(ma, *rays)


def model_key(ma, n_tris, rays):
    """The lane model's least packed key per ray (the tensor cores')."""
    return model_nearest(ma, n_tris, rays,
                         torch.ones(rays.shape[1], dtype=torch.bool))


def nearest_culled(ma, n_tris, rays, alive, key=plain_key):
    """The pair pass's contract on given rays: `key`'s least packed key
    over the chunks the kernel's block-uniform cull passes for the ray's
    block of BLOCK slots (`chunk_passes`), BIG for a dead ray.  It differs
    from the all-pairs key only for a ray that lies in a triangle's plane
    (every edge product 0, a "hit" at t = 0 that the retest rejects) while
    no live ray of its block enters that chunk."""
    passed = tmk.chunk_passes(ma, alive, *rays)            # (blocks, NC)
    block = torch.arange(rays.shape[1]) // tmk.BLOCK
    best = torch.full_like(rays[0], tmk.BIG)
    for c in range(ma.pair.shape[0]):
        one = dataclasses.replace(ma, pair=ma.pair[c:c + 1],
                                  cbox=ma.cbox[c:c + 1])
        key_c = key(one, min(tmk.CHUNK, n_tris - c * tmk.CHUNK), rays)
        bits = key_c.view(torch.int32)
        key_c = torch.where(key_c < tmk.BIG, (bits + c * tmk.CHUNK).view(
            torch.float32), key_c)                          # chunk c's rows
        best = torch.where(passed[block, c], torch.minimum(best, key_c),
                           best)
    return torch.where(alive, best, tmk.BIG)


# ---------------------------------------------------------------------------
# The CUDA kernel's pair pass, modelled lane by lane (csrc/mxu_trace.cu
# nearest_tri / sweep_chunk): a warp's 32 rays are two m16 tiles; each
# 8-triangle group of a chunk's real rows is four n8 tiles (the s1, s2, s3
# and tdet rows q * 128 + t0 .. + 7).  K holds the table's A_hi, A_lo
# against the ray's hi, md, lo parts: two K=16 steps for the edge rows
# (EDGE_RAY / EDGE_TRI), a K=16 and a K=8 step for the tdet row (TDET_*),
# as (part, feature) per K slot.  Lane (g, t) = (lane >> 2, lane & 3)
# holds, per m-tile, rays g and g + 8 against triangles t0 + 2t and
# t0 + 2t + 1; it tests and packs each pair, keeps one packed min per ray
# slot (mt * 2 + row half), the quad reduces with fminf, and ray r takes
# slot r >> 3 of lane (r & 7) * 4.
# ---------------------------------------------------------------------------

def _words(*ws):
    """K slots of bf16 pairs: (part, k) -> features 2k, 2k + 1; None: 0."""
    return [x for w in ws for x in ((None, None) if w is None else
                                    ((w[0], 2 * w[1]), (w[0], 2 * w[1] + 1)))]


HI, MD, LO = 0, 1, 2          # ray parts
W, L = 0, 1                   # table parts: A_hi, A_lo
EDGE_RAY = (_words((HI, 0), (HI, 1), (HI, 2), (MD, 0),
                   (MD, 1), (MD, 2), (LO, 0), (LO, 1)),
            _words((LO, 2), (HI, 0), (HI, 1), (HI, 2),
                   (MD, 0), (MD, 1), (MD, 2), None))
EDGE_TRI = (_words((W, 0), (W, 1), (W, 2), (W, 0),
                   (W, 1), (W, 2), (W, 0), (W, 1)),
            _words((W, 2), (L, 0), (L, 1), (L, 2),
                   (L, 0), (L, 1), (L, 2), None))
TDET_RAY = (_words((HI, 3), (HI, 4), (MD, 3), (MD, 4),
                   (LO, 3), (LO, 4), (HI, 3), (HI, 4)),
            _words((MD, 3), (MD, 4), None, None))
TDET_TRI = (_words((W, 3), (W, 4), (W, 3), (W, 4),
                   (W, 3), (W, 4), (L, 3), (L, 4)),
            _words((L, 3), (L, 4), None, None))


def _gather_k(parts, slots):
    """(..., K) slot values of one step from a tuple of (..., 16) feature
    parts."""
    zero = torch.zeros_like(parts[0][..., 0])
    return torch.stack([zero if s is None else parts[s[0]][..., s[1]]
                        for s in slots], dim=-1)


def _bf16_rn_bits(x):
    """__float2bfloat16_rn as uint16 bits: round to nearest even, NaN kept
    a (quiet) NaN."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(np.asarray(x, np.float32))
    r[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
    return r


def _bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def model_features(rays):
    """f = [d, o x d, o, 1, 0...] (N, 16) f32, as each lane forms it."""
    ox, oy, oz, dx, dy, dz = (r.numpy() for r in rays)
    with np.errstate(invalid="ignore", over="ignore"):
        m = [oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx]
    f = np.zeros((len(ox), tmk.K), np.float32)
    for k, v in enumerate([dx, dy, dz, *m, ox, oy, oz]):
        f[:, k] = v
    f[:, 9] = 1.0
    return f


def model_split(rays):
    """Each lane's ray tile row: (N, 16) values of the hi, md and lo parts
    of its features, split by the device's conversion."""
    f = model_features(rays)
    hi = _bits_to_f32(_bf16_rn_bits(f))
    with np.errstate(invalid="ignore"):
        r1 = f - hi
        md = _bits_to_f32(_bf16_rn_bits(r1))
        lo = _bits_to_f32(_bf16_rn_bits(r1 - md))
    return hi, md, lo


def model_nearest(ma, n_tris, rays, alive):
    """The kernel's packed best per ray (BIG for a dead ray or no pair)."""
    n = rays.shape[1]
    warps = -(-n // 32)
    pad = warps * 32 - n
    f = [torch.from_numpy(np.pad(x, ((0, pad), (0, 0))))
         for x in model_split(rays)]
    steps = [[_gather_k(f, r) for r in kind] for kind in (EDGE_RAY, TDET_RAY)]
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    # lane, slot s = mt * 2 + half -> ray of the warp; lane, e & 1 -> column
    ray_of = torch.stack([(s >> 1) * 16 + (s & 1) * 8 + g
                          for s in range(4)], dim=1)        # (32, 4)
    best = torch.full((warps, 32, 4), tmk.BIG)
    for c in range(ma.pair.shape[0]):
        real = min(tmk.CHUNK, n_tris - c * tmk.CHUNK)
        for g8 in range((real + 7) // 8):
            rows = [q * tmk.CHUNK + g8 * 8 + torch.arange(8)
                    for q in range(tmk.Q)]
            acc = []
            for q, r in enumerate(rows):
                tri = (ma.pair[c, r, 0:tmk.K].float(),         # (8, 16)
                       ma.pair[c, r, 2 * tmk.K:].float())
                kind = 1 if q == 3 else 0
                tri_steps = (EDGE_TRI, TDET_TRI)[kind]
                s = steps[kind][0] @ _gather_k(tri, tri_steps[0]).T
                s = s + steps[kind][1] @ _gather_k(tri, tri_steps[1]).T
                acc.append(s.view(warps, 32, 8))
            for p in range(2):
                col = 2 * t + p                                  # (32,)
                idx = c * tmk.CHUNK + g8 * 8 + col
                for s in range(4):
                    ri, ci = ray_of[:, s], col
                    s1, s2, s3, td = (a[:, ri, ci] for a in acc)
                    ok = (s1 >= 0) & (s2 >= 0) & (s3 >= 0) & (td >= 0)
                    det = s1 + s2 + s3
                    tt = torch.clamp(td / torch.clamp(det,
                                                      min=tmk.DET_EPS),
                                     max=1e28)
                    packed = torch.where(ok, tmk.pack_t(tt, idx.int()),
                                         tmk.BIG)
                    best[:, :, s] = torch.fmin(best[:, :, s], packed)
    for x in (1, 2):                                            # quad fminf
        best = torch.fmin(best, best[:, lane ^ x])
    r = torch.arange(32)
    res = best[:, (r & 7) * 4, r >> 3].reshape(-1)[:n]
    return torch.where(alive, res, tmk.BIG)
