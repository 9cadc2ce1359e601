"""Intersection primitives of the XLA-style reference renderer, vectorised
over rays.

Port of rtm_tpu/ops/intersect.py: sphereHit (RayTracing.shader:486-508) and
triangleHit (shader:285-303, f64 in the shader, f32 here as in rtm_tpu)
as dense (rays x primitives) sweeps.  The ray-triangle test uses the
scalar-triple-product identity, so every ray x triangle term is an inner
product of precomputed per-triangle features:

    det      = -D.n                 n  = cross(B-A, C-A)
    t * det  =  O.n - (A.n)
    u * det  =  W.AC - D.g1         W  = cross(O, D)   g1 = cross(AC, A)
    v * det  =  D.g2 - W.AB                            g2 = cross(AB, A)
    w * det  =  det - u*det - v*det

rtm_tpu pins these K=3 contractions to full f32 (`_mm`, Precision.HIGHEST)
because the TPU's default matmul precision is bf16.  On the card a float32
matmul may run in TF32 depending on the caller's `torch.backends` flags, so
the port computes them elementwise (`_mm3`): full f32 whatever the flags.
`aabb_hit` is the slab test of the BVH-traversal path
(ops/bvh_traverse.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FLT_MAX = float(np.float32(3.402823466e38))
DET_EPS = 1e-12   # f32 stand-in for the reference's DBL_EPS gate (rounded
#                   to f32 wherever it meets an f32 tensor)


def _mm3(a, bt):
    """a (N,K) @ bt.T (K,M) -> (N,M) as an elementwise sum over k in order:
    full f32 on any device (no TF32 path)."""
    out = a[:, 0:1] * bt[:, 0][None, :]
    for k in range(1, a.shape[1]):
        out = out + a[:, k:k + 1] * bt[:, k][None, :]
    return out


def dot3(a, b):
    return (a * b).sum(dim=-1)


def cross3(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v, dim=-1):
    return v / torch.linalg.norm(v, dim=dim, keepdim=True)


def safe_normalize(v, eps=1e-20):
    """normalize() whose gradient stays finite at ||v|| -> 0.

    Used wherever masked-out lanes can carry degenerate vectors: with plain
    normalize, a NaN produced on a lane that torch.where later discards
    still poisons the backward pass (0 * NaN = NaN)."""
    sq = (v * v).sum(dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(sq, min=eps))


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def sphere_hits(origin, direction, sph_pos, sph_radius):
    """All-pairs sphere distances (shader sphereHit, :486-508): (N,S) f32,
    FLT_MAX where missed.  Nearest-positive-root semantics, in the
    shader's op order (oc = O - C first)."""
    oc3 = origin[:, None, :] - sph_pos[None, :, :]              # (N,S,3)
    a = dot3(direction, direction)[:, None]                     # (N,1)
    b = 2.0 * (oc3 * direction[:, None, :]).sum(dim=-1)         # (N,S)
    c = (oc3 * oc3).sum(dim=-1) - (sph_radius * sph_radius)[None, :]
    delta = b * b - 4.0 * a * c
    # double-where: sqrt has infinite slope at 0, so missed pairs
    # (delta < 0) must never reach sqrt's gradient (0 * inf = NaN); exact
    # tangents are floored so gradients stay finite
    hit_delta = delta >= 0.0
    delta_safe = torch.where(hit_delta, torch.clamp(delta, min=1e-12), 1.0)
    t = (-b - torch.sqrt(delta_safe)) / (2.0 * a)
    valid = hit_delta & (t >= 0.0)
    return torch.where(valid, t, FLT_MAX)


def nearest_sphere(origin, direction, sph_pos, sph_radius):
    """Nearest sphere per ray: (t (N,), idx (N,) i32).  First-min-wins tie
    order matches the reference's strict `<` update loop (shader:516-524)."""
    n = origin.shape[0]
    dev = origin.device
    if sph_pos.shape[0] == 0:
        return (torch.full((n,), FLT_MAX, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    t = sphere_hits(origin, direction, sph_pos, sph_radius)
    idx = torch.argmin(t, dim=1).to(torch.int32)
    tmin = torch.amin(t, dim=1)
    return tmin, torch.where(tmin < FLT_MAX, idx, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

@dataclass
class TriFeatures:
    """Precomputed per-triangle intersection features (all (T,3)/(T,))."""

    n: torch.Tensor    # geometric normal cross(AB, AC), unnormalized
    an: torch.Tensor   # dot(A, n)
    ab: torch.Tensor   # edge B-A
    ac: torch.Tensor   # edge C-A
    g1: torch.Tensor   # cross(AC, A)
    g2: torch.Tensor   # cross(AB, A)

    @staticmethod
    def build(a, b, c) -> "TriFeatures":
        ab = b - a
        ac = c - a
        n = cross3(ab, ac)
        return TriFeatures(n=n, an=dot3(a, n), ab=ab, ac=ac,
                           g1=cross3(ac, a), g2=cross3(ab, a))

    @property
    def count(self) -> int:
        return self.n.shape[0]

    def take(self, idx) -> "TriFeatures":
        return TriFeatures(*(getattr(self, k)[idx]
                             for k in ("n", "an", "ab", "ac", "g1", "g2")))


def _tri_dets(origin, direction, w_cross, f: TriFeatures):
    """(det, tdet, udet, vdet) of every (ray, triangle) pair: (N,T) each."""
    det = -_mm3(direction, f.n)
    tdet = _mm3(origin, f.n) - f.an[None, :]
    udet = _mm3(w_cross, f.ac) - _mm3(direction, f.g1)
    vdet = _mm3(direction, f.g2) - _mm3(w_cross, f.ab)
    return det, tdet, udet, vdet


def triangle_hits(origin, direction, f: TriFeatures, w_cross=None):
    """All-pairs ray-triangle distances: (N,T) f32, FLT_MAX on miss.

    Backface-culled det>eps + t,u,v,w >= 0 (shader triangleHit :285-303).
    `w_cross` = cross(origin, direction) may be passed to amortize.
    """
    if w_cross is None:
        w_cross = cross3(origin, direction)
    det, tdet, udet, vdet = _tri_dets(origin, direction, w_cross, f)
    wdet = det - udet - vdet
    valid = ((det > DET_EPS) & (tdet >= 0.0) & (udet >= 0.0) & (vdet >= 0.0)
             & (wdet >= 0.0))
    return torch.where(valid, tdet / torch.where(valid, det, 1.0), FLT_MAX)


def nearest_triangle(origin, direction, feats: TriFeatures, chunk: int = 512):
    """Nearest triangle per ray via a chunked sweep: (t (N,), idx (N,) i32).

    Chunks the triangle axis so peak memory is O(N*chunk), not O(N*T).
    First-min-wins across and within chunks, matching the strict-`<`
    traversal order of the reference (triangles in buffer order).

    The sweep runs without autograd; the winner's t is then recomputed
    from its gathered features with the same operations (so it is bitwise
    the swept value), and gradients flow through that: the gradient of
    rtm_tpu's min over the chunk, without keeping O(N*chunk) residuals.
    """
    n = origin.shape[0]
    dev = origin.device
    if feats.count == 0:
        return (torch.full((n,), FLT_MAX, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    with torch.no_grad():
        o, d = origin.detach(), direction.detach()
        w_cross = cross3(o, d)
        best_t = torch.full((n,), FLT_MAX, device=dev)
        best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, feats.count, chunk):
            fc = TriFeatures(*(getattr(feats, k)[c0:c0 + chunk].detach()
                               for k in ("n", "an", "ab", "ac", "g1", "g2")))
            t = triangle_hits(o, d, fc, w_cross)
            tmin, imin = torch.min(t, dim=1)     # first occurrence
            better = tmin < best_t
            best_t = torch.where(better, tmin, best_t)
            best_i = torch.where(better, imin + c0, best_i)
    hit = best_t < FLT_MAX
    best_i = torch.where(hit, best_i, -1)
    if not (torch.is_grad_enabled() and (origin.requires_grad
                                         or direction.requires_grad
                                         or feats.n.requires_grad)):
        return best_t, best_i.to(torch.int32)
    fw = feats.take(torch.clamp(best_i, min=0))
    det = -(direction[:, 0] * fw.n[:, 0] + direction[:, 1] * fw.n[:, 1]
            + direction[:, 2] * fw.n[:, 2])
    tdet = (origin[:, 0] * fw.n[:, 0] + origin[:, 1] * fw.n[:, 1]
            + origin[:, 2] * fw.n[:, 2]) - fw.an
    t = tdet / torch.where(hit, det, 1.0)
    return torch.where(hit, t, FLT_MAX), best_i.to(torch.int32)


# ---------------------------------------------------------------------------
# AABB (the BVH-traversal path)
# ---------------------------------------------------------------------------

def aabb_hit(origin, direction, bmin, bmax):
    """Slab test (shader hitBox :305-318): entry distance or FLT_MAX.

    origin/direction (...,3) broadcast against bmin/bmax (...,3).
    Returns tNear where 0 <= tFar and tNear <= tFar, else FLT_MAX (a
    negative tNear when the origin is inside the box, as the reference
    returns it)."""
    inv = 1.0 / direction
    lbf = (bmin - origin) * inv
    rtb = (bmax - origin) * inv
    t_near = torch.minimum(lbf, rtb).amax(dim=-1)
    t_far = torch.maximum(lbf, rtb).amin(dim=-1)
    hit = (0.0 <= t_far) & (t_near <= t_far)
    return torch.where(hit, t_near, FLT_MAX)
