"""BVH traversal: the shader-parity validation path.

Port of rtm_tpu/ops/bvh_traverse.py.  Mirrors the reference's iterative
stack traversal (RayTracing.shader:324-484) and the instance loop of
bounceRay (shader:526-542): rays are transformed by each instance's
world-to-local matrix (direction NOT renormalized, so t stays in world
units), the per-mesh hierarchy is walked with an explicit 32-deep stack,
ordered near/far child descent and t-pruning, and leaves test their
triangle range in buffer order.

This is not a render path (the kernels use their own tables); it validates
the SAH builder end to end against the dense sweep and documents the
reference algorithm in runnable form.  All rays step in lockstep, one
node per ray per step, vectorised over rays, until every stack is empty:
fine at validation sizes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .intersect import FLT_MAX, _mm3, aabb_hit, cross3, dot3

MAX_STACK = 32  # shader:341


@dataclass
class BvhArrays:
    """Device copy of accel.bvh.BvhScene buffers (indices as int64)."""

    box_min: torch.Tensor          # (B,3) f32
    box_max: torch.Tensor          # (B,3) f32
    buffer_region: torch.Tensor    # (B,2) i64 (u32 values)
    tri_a: torch.Tensor            # (T,3) local, reordered
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    mesh_bvh_root: list            # (M,) python ints
    mesh_model_root: list          # (M,)
    inst_world_to_local: torch.Tensor  # (I,4,4) f32
    inst_mesh_id: list             # (I,)

    @staticmethod
    def from_scene(bs, device=None) -> "BvhArrays":
        """`bs` (accel.bvh.BvhScene) on `device`; None means the card, and
        raises without one (as build_tracer_scene does)."""
        from ..models.scene import _resolve_device

        dev = _resolve_device(device)
        v = np.asarray(bs.tri_verts, np.float32)

        def t(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(dev)

        return BvhArrays(
            box_min=t(bs.box_min), box_max=t(bs.box_max),
            buffer_region=t(bs.buffer_region, np.int64),
            tri_a=t(v[:, 0]), tri_b=t(v[:, 1]), tri_c=t(v[:, 2]),
            mesh_bvh_root=[int(r) for r in bs.mesh_bvh_root],
            mesh_model_root=[int(r) for r in bs.mesh_model_root],
            inst_world_to_local=t(bs.inst_world_to_local),
            inst_mesh_id=[int(m) for m in bs.inst_mesh_id],
        )


def _triangle_hit_single(o, d, a, b, c):
    """shader triangleHit :285-303 (f32 here; the reference is f64)."""
    eab = b - a
    eac = c - a
    ao = o - a
    n = cross3(eab, eac)
    dao = cross3(ao, d)
    det = -dot3(d, n)
    inv_det = 1.0 / det
    t = dot3(ao, n) * inv_det
    u = dot3(eac, dao) * inv_det
    v = -dot3(eab, dao) * inv_det
    w = 1.0 - u - v
    hit = (det > 1e-12) & (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
    return torch.where(hit, t, FLT_MAX)


@torch.no_grad()
def bvh_traverse(bvh: BvhArrays, bvh_root: int, model_root: int, origin,
                 direction, max_leaf_tris: int = 16):
    """Vectorized shader bvhTraverse (:324-484) over N rays.

    bvh_root / model_root: the mesh-local roots.  Returns (t (N,) f32,
    tri_idx (N,) i32) with tri_idx global into the reordered triangle
    buffer, -1 on a miss."""
    n = origin.shape[0]
    dev = origin.device
    rows = torch.arange(n, device=dev)
    n_tri = bvh.tri_a.shape[0]
    root_hit = aabb_hit(origin, direction, bvh.box_min[bvh_root],
                        bvh.box_max[bvh_root])
    stack = torch.full((n, MAX_STACK), bvh_root, dtype=torch.int64,
                       device=dev)
    sp = (root_hit < FLT_MAX).to(torch.int64)
    best_t = torch.full((n,), FLT_MAX, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def push(stack, sp, do, node):
        slot = sp.clamp(0, MAX_STACK - 1)
        stack[rows, slot] = torch.where(do, node, stack[rows, slot])
        return torch.where(do, sp + 1, sp)

    while bool((sp > 0).any()):
        active = sp > 0
        sp = torch.where(active, sp - 1, sp)
        node = torch.where(active, stack[rows, sp.clamp(min=0)], bvh_root)
        region = bvh.buffer_region[node]                    # (N,2)
        is_leaf = region[:, 1] > 0

        # leaf: test the triangle range in order (shader:376-407)
        lo = region[:, 0] + model_root
        hi = region[:, 1] + model_root
        leaf_t = torch.full((n,), FLT_MAX, device=dev)
        leaf_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        for k in range(max_leaf_tris):
            ti = lo + k
            valid = active & is_leaf & (ti < hi)
            tid = ti.clamp(0, max(n_tri - 1, 0))
            t = _triangle_hit_single(origin, direction, bvh.tri_a[tid],
                                     bvh.tri_b[tid], bvh.tri_c[tid])
            upd = valid & (t < leaf_t)
            leaf_t = torch.where(upd, t, leaf_t)
            leaf_i = torch.where(upd, tid, leaf_i)
        upd = active & is_leaf & (leaf_t < best_t)
        best_t = torch.where(upd, leaf_t, best_t)
        best_i = torch.where(upd, leaf_i, best_i)

        # internal: ordered near/far push with pruning (shader:438-479)
        left = bvh_root + region[:, 0]
        right = left + 1
        nb = bvh.box_min.shape[0] - 1
        lt = aabb_hit(origin, direction, bvh.box_min[left.clamp(max=nb)],
                      bvh.box_max[left.clamp(max=nb)])
        rt = aabb_hit(origin, direction, bvh.box_min[right.clamp(max=nb)],
                      bvh.box_max[right.clamp(max=nb)])
        left_closest = lt < rt
        near = torch.where(left_closest, left, right)
        far = torch.where(left_closest, right, left)
        near_d = torch.where(left_closest, lt, rt)
        far_d = torch.where(left_closest, rt, lt)
        inner = active & ~is_leaf
        sp = push(stack, sp, inner & (far_d < best_t), far)
        sp = push(stack, sp, inner & (near_d < best_t), near)
    return best_t, best_i.to(torch.int32)


@torch.no_grad()
def bounce_ray_bvh(bvh: BvhArrays, origin, direction,
                   max_leaf_tris: int = 16):
    """Instance loop of bounceRay (shader:526-542): returns (t,
    global_tri_idx, instance_idx) for the nearest mesh hit, t in world
    units."""
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), FLT_MAX, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for ii, mesh_id in enumerate(bvh.inst_mesh_id):
        w2l = bvh.inst_world_to_local[ii]
        o_local = _mm3(origin, w2l[:3, :3]) + w2l[:3, 3]
        d_local = _mm3(direction, w2l[:3, :3])  # not renormalized (:532)
        t, tri = bvh_traverse(bvh, bvh.mesh_bvh_root[mesh_id],
                              bvh.mesh_model_root[mesh_id], o_local,
                              d_local, max_leaf_tris)
        upd = (tri >= 0) & (t < best_t)
        best_t = torch.where(upd, t, best_t)
        best_tri = torch.where(upd, tri, best_tri)
        best_inst = torch.where(upd, ii, best_inst)
    return best_t, best_tri, best_inst
