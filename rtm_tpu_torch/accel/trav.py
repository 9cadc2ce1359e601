"""Per-ray traversal structure: a skip-link ("threaded") BVH over a SAH
leaf cut, the acceleration structure of the trav kernel
(ops/kernels/trav_kernel.py, csrc/trav_trace.cu).

Port of rtm_tpu/accel/trav.py, NumPy only.  The reference traces a
binned-SAH BVH per GPU thread (RayTracing/assets/shaders/
RayTracing.shader:324-484); this structure is that hierarchy made
stackless:

  * the SAME binned-SAH hierarchy the reference builds (accel/bvh.py,
    bit-parity builder) is cut into leaves of <= max_leaf_tris triangles
    (contiguous ranges of the BVH triangle order, like accel/clusters.py);
  * the tree ABOVE the cut is re-emitted in DFS preorder with a SKIP link
    per node (next subtree in DFS) - stackless traversal per ray:
    `cur = hit ? cur+1 : skip[cur]`, leaves test their triangles and
    continue at skip[cur]; the ray's best t prunes boxes like the
    reference's ordered descent, minus the near-child-first ordering;
  * oversized SAH leaves (the cost rule keeps large flat regions as one
    leaf) become chains of chunk leaves under one internal node.

All arrays are host NumPy; device packing lives with the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.mesh import Mesh
from ..ops.intersect import DET_EPS
from .bvh import build_bvh
from .clusters import _node_ranges

BIG = np.float32(1e30)


@dataclass
class TravBVH:
    """Flat skip-link BVH over a leaf cut (DFS preorder).

    Node n: box [lo[n], hi[n]]; skip[n] = next DFS subtree (num_nodes =
    "done"); leaf_id[n] = index into `slices` for leaf nodes, -1 internal.
    A hit internal node continues at n+1 (its first child is next in
    preorder); a leaf tests slices[leaf_id] then continues at skip[n].
    """

    lo: np.ndarray          # (N,3) f32
    hi: np.ndarray          # (N,3) f32
    skip: np.ndarray        # (N,) i32
    leaf_id: np.ndarray     # (N,) i32
    order: np.ndarray       # (T,) i64 triangle permutation (BVH order)
    slices: tuple           # ((lo,hi), ...) triangle ranges per leaf

    @property
    def num_nodes(self) -> int:
        return len(self.skip)

    @property
    def num_leaves(self) -> int:
        return len(self.slices)


def build_trav(world_verts: np.ndarray, max_leaf_tris: int = 16,
               merge: bool = False, bvh=None) -> TravBVH:
    """Build the traversal BVH for a world-space triangle soup (T,3,3).

    merge=True: adjacent cut leaves are greedily merged into FULL
    max_leaf_tris-wide leaves and the skip tree is rebuilt as a median
    split over the merged slice list (off by default: its boxes prune
    worse than the SAH subtree cut).

    bvh: a prebuilt accel.bvh BVH over `world_verts`; the binned-SAH build
    dominates this function, and the adaptive leaf-size loop of
    trav_kernel.build_trav_tables re-cuts the same hierarchy many times."""
    t = len(world_verts)
    if t == 0:
        return TravBVH(np.zeros((0, 3), np.float32),
                       np.zeros((0, 3), np.float32),
                       np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.int64), ())
    if bvh is None:
        bvh = build_bvh(Mesh(world_verts, None))
    lo_r, hi_r, is_leaf = _node_ranges(bvh.buffer_region)
    order = bvh.order.astype(np.int64)
    v = world_verts[order]                                  # (T,3,3)
    vmin = v.min(axis=1)
    vmax = v.max(axis=1)

    nodes_lo: list = []
    nodes_hi: list = []
    nodes_leaf: list = []
    children: list = []          # per emitted node: list of child node ids
    slices: list = []

    def tight(lo, hi):
        return vmin[lo:hi].min(axis=0), vmax[lo:hi].max(axis=0)

    def emit(lo, hi, leaf):
        nid = len(nodes_lo)
        bl, bh = tight(lo, hi)
        nodes_lo.append(bl)
        nodes_hi.append(bh)
        nodes_leaf.append(leaf)
        children.append([])
        return nid

    def walk(nid) -> int:
        """Emit the cut subtree of original node nid; return emitted id."""
        n_lo, n_hi = int(lo_r[nid]), int(hi_r[nid])
        if n_hi - n_lo <= max_leaf_tris:
            slices.append((n_lo, n_hi))
            return emit(n_lo, n_hi, len(slices) - 1)
        if is_leaf[nid]:
            # oversized SAH leaf: chain of chunk leaves under one internal
            me = emit(n_lo, n_hi, -1)
            for s in range(n_lo, n_hi, max_leaf_tris):
                e = min(s + max_leaf_tris, n_hi)
                slices.append((s, e))
                children[me].append(emit(s, e, len(slices) - 1))
            return me
        me = emit(n_lo, n_hi, -1)
        child = int(bvh.buffer_region[nid, 0])
        # skip empty children (an all-one-side SAH partition)
        for c in (child, child + 1):
            if hi_r[c] - lo_r[c] > 0:
                children[me].append(walk(c))
        return me

    # walk() emits a parent before descending into its children, so the
    # emission order is DFS preorder; skip[n] = first node after n's
    # whole subtree.
    if merge:
        # cut only (discard the walk's nodes): collect slices, then merge
        cut = []
        stack = [0]
        # cut at a finer granule than the leaf budget so the greedy merge
        # packs leaves near-full (cutting and merging at the same size
        # leaves ~70% fill)
        granule = max(4, max_leaf_tris // 3)
        while stack:
            nid = stack.pop()
            n_lo, n_hi = int(lo_r[nid]), int(hi_r[nid])
            if n_hi - n_lo == 0:
                continue
            if n_hi - n_lo <= granule or is_leaf[nid]:
                for s in range(n_lo, n_hi, max_leaf_tris):
                    cut.append((s, min(s + max_leaf_tris, n_hi)))
            else:
                child = int(bvh.buffer_region[nid, 0])
                stack.append(child + 1)
                stack.append(child)
        cut.sort()
        merged = []
        cs, ce = cut[0]
        for s, e in cut[1:]:
            if e - cs <= max_leaf_tris:
                ce = e
            else:
                merged.append((cs, ce))
                cs, ce = s, e
        merged.append((cs, ce))
        slices.extend(merged)

        def split(i, j):
            """Median-split skip tree over merged slices [i, j)."""
            if j - i == 1:
                return emit(slices[i][0], slices[i][1], i)
            me = emit(slices[i][0], slices[j - 1][1], -1)
            m = (i + j) // 2
            children[me].append(split(i, m))
            children[me].append(split(m, j))
            return me

        root = split(0, len(slices))
    else:
        root = walk(0)
    assert root == 0
    n = len(nodes_lo)
    leaf_id = np.asarray(nodes_leaf, np.int32)

    ends = np.zeros(n, np.int64)

    def fill(nid):
        end = nid + 1
        for c in children[nid]:
            fill(c)
            end = max(end, ends[c])
        ends[nid] = end

    fill(0)
    skip = ends.astype(np.int32)
    # the "hit internal -> cur+1" rule needs every internal node's first
    # child at nid+1 (both tree builders emit in preorder)
    for nid in range(n):
        if leaf_id[nid] < 0 and children[nid]:
            assert children[nid][0] == nid + 1, (nid, children[nid])

    # the cut must tile [0, T)
    ss = sorted(slices)
    assert ss[0][0] == 0 and ss[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(ss, ss[1:]))

    return TravBVH(np.asarray(nodes_lo, np.float32),
                   np.asarray(nodes_hi, np.float32),
                   skip, leaf_id, order, tuple(slices))


def traverse_ref(trav: TravBVH, verts_bvh_order: np.ndarray,
                 o: np.ndarray, d: np.ndarray, init_t=None):
    """NumPy reference of the kernel's traversal for ONE ray: returns
    (t, triangle index in BVH order or -1, leaves_visited, nodes_visited).

    The skip-link semantics the kernel implements: slab box test pruned
    by the carried best t (strict <), leaves tested front-to-back in
    slice order, first strictly better hit wins (Moller-Trumbore with the
    DET_EPS backface gate).  Boxes are the tight f32 ones; the kernel's
    bf16-pair boxes are looser, so its visit counts are higher while its
    winners are the same.
    """
    best = np.float64(init_t if init_t is not None else BIG)
    best_i = -1
    cur = 0
    leaves = nodes = 0
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.where(d >= 0, 1e-12, -1e-12),
                         d)
    while cur < trav.num_nodes:
        nodes += 1
        t1 = (trav.lo[cur] - o) * inv
        t2 = (trav.hi[cur] - o) * inv
        tn = np.minimum(t1, t2).max()
        tf = np.maximum(t1, t2).min()
        hit = (tf >= 0.0) and (tn <= tf) and (tn < best)
        if not hit:
            cur = trav.skip[cur]
            continue
        li = trav.leaf_id[cur]
        if li < 0:
            cur += 1
            continue
        leaves += 1
        s, e = trav.slices[li]
        for ti in range(s, e):
            a, b, c = verts_bvh_order[ti]
            ab = b - a
            ac = c - a
            nrm = np.cross(ab, ac)
            det = -np.dot(d, nrm)
            if det < DET_EPS:        # kernel gate: min-chain det-EPS >= 0
                continue
            ao = o - a
            dao = np.cross(ao, d)
            u = np.dot(ac, dao)
            vv = -np.dot(ab, dao)
            tt = np.dot(ao, nrm)
            if u < 0 or vv < 0 or tt < 0 or det - u - vv < 0:
                continue
            tval = tt / det
            if tval < best:
                best = tval
                best_i = ti
        cur = trav.skip[cur]
    return float(best), best_i, leaves, nodes
