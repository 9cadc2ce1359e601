"""SAH-BVH-subtree clustering: the acceleration structure of the
production TPU sweep kernels.

The reference's speed asset is a per-mesh binned-SAH BVH traversed
divergently per GPU thread (RayTracing/src/BVH.cpp:96-152,
RayTracing/assets/shaders/RayTracing.shader:324-484).  Per-lane stack
traversal is hostile to the TPU vector unit, so the Pallas kernels instead
sweep *clusters* of triangles (all lanes visit the same cluster) and cull
whole clusters with a tile-uniform AABB test.  Round 1 formed clusters by
slicing a global Morton order into fixed 128-triangle runs — which mixes
the huge Cornell-wall triangles into dragon clusters and produced 4/14
clusters with whole-scene AABBs that can never be culled.

This module cuts the *same binned-SAH hierarchy the reference builds*
(accel/bvh.py, bit-parity builder) into treelets of <= max_tris triangles
and uses those as the kernel clusters:

  * the BVH's in-place partition already makes every subtree a contiguous
    triangle range, so a treelet cut IS a triangle permutation plus a list
    of (lo, hi) slices — no re-grouping pass needed;
  * SAH splits isolate large-area triangles early, so wall triangles get
    their own (admittedly large) clusters instead of poisoning dragon
    clusters; dragon treelets get leaf-tight boxes;
  * cluster widths are variable (padded to the 8-sublane granule by the
    kernel packers), so a 6-triangle wall cluster costs a (8, R) sweep,
    not a (128, R) one.

This is how the SAH builder feeds the production path (it previously served
only the validation traversal in ops/bvh_traverse.py).
"""
from __future__ import annotations

import numpy as np

from ..models.mesh import Mesh
from .bvh import build_bvh


def _node_ranges(buffer_region: np.ndarray):
    """Per-node triangle range [lo, hi) + leaf flags for a flat BVH.

    buffer_region: (B,2) u32 — internal -> (child_offset, 0); leaf ->
    (lo, hi) with hi > 0 (BVH.cpp:121,145-151).  (0,0) is an empty leaf
    (an all-one-side SAH partition produced a zero-triangle child).
    """
    b = len(buffer_region)
    region = buffer_region.astype(np.int64).tolist()
    lo = [0] * b
    hi = [0] * b
    is_leaf = [False] * b
    # children are appended after their parent, so a reverse scan sees both
    # children resolved before the parent needs them
    for nid in range(b - 1, -1, -1):
        r0, r1 = region[nid]
        if r1 > 0 or (r0 == 0 and r1 == 0):
            lo[nid], hi[nid] = r0, r1
            is_leaf[nid] = True
        else:
            lo[nid] = lo[r0]
            hi[nid] = hi[r0 + 1]
    return (np.array(lo, np.int64), np.array(hi, np.int64),
            np.array(is_leaf, bool))


def bvh_cluster_slices(world_verts: np.ndarray, max_tris: int = 128,
                       use_native: bool = True):
    """Cluster a world-space triangle soup by SAH-BVH treelet cut.

    world_verts: (T,3,3) f32.  Returns (perm (T,) int64 triangle
    permutation, slices tuple[(lo, hi), ...], the BVH) where the slices
    partition [0, T) of the *permuted* order and every slice has <=
    max_tris triangles.  Oversized SAH leaves (the cost rule can keep large
    flat regions as one leaf) are chunked.
    use_native: build the hierarchy with the native builder (else the
    NumPy one; the same arrays either way).
    """
    t = len(world_verts)
    if t == 0:
        return np.zeros(0, np.int64), (), None
    bvh = build_bvh(Mesh(world_verts, None), use_native)
    lo, hi, is_leaf = _node_ranges(bvh.buffer_region)

    slices: list[tuple[int, int]] = []
    stack = [0]
    while stack:
        nid = stack.pop()
        n_lo, n_hi = int(lo[nid]), int(hi[nid])
        if n_hi - n_lo == 0:
            continue
        if n_hi - n_lo <= max_tris or is_leaf[nid]:
            for s in range(n_lo, n_hi, max_tris):
                slices.append((s, min(s + max_tris, n_hi)))
        else:
            child = int(bvh.buffer_region[nid, 0])
            stack.append(child + 1)
            stack.append(child)

    slices.sort()
    # the cut must tile [0, T) exactly
    assert slices[0][0] == 0 and slices[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    return bvh.order.astype(np.int64), tuple(slices), bvh
