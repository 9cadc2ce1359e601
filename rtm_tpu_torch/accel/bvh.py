"""Per-mesh binary BVH builder — binned SAH, exact reference semantics.

Parity with the reference builder (RayTracing/src/BVH.{h,cpp}):
  * per-triangle nodes: AABB + centroid (A+B+C)/3         (BVH.cpp:77-94)
  * root box = the mesh *volume* (glTF accessor min/max!)  (BVH.cpp:96-108)
  * binned SAH: 3 axes x 6 buckets over centroid bounds; bucket index
    min(5, (c-lo)*6/(hi-lo)); split position lo + (hi-lo)/6*(i+1)
                                                           (BVH.cpp:181-225)
  * area() quirk: half surface area (no *2), 0 for empty boxes
                                                           (BVH.cpp:35-45)
  * leaf rule: depth==32 or best plane cost >= area(parent)*count
                                                           (BVH.cpp:110-123)
  * in-place swap partition by centroid <= splitPos (left side keeps scan
    order, right side gets the swap permutation — preserved exactly, since
    leaf ranges index the *reordered* triangle buffer and first-hit-wins ties
    depend on order)                                       (BVH.cpp:128-143)
  * children appended contiguously; parent.bufferRegion = (child_offset, 0);
    leaf.bufferRegion = (lo, hi) with hi > 0 as the leaf flag
                                                           (BVH.cpp:145-151)
  * Stats{buildTime, triCnt, nodeCnt, leafCnt, leafDepth, leafTris, SAH}
                                                           (BVH.cpp:240-258)

`build_bvh` runs the native C++ builder (accel/native, built with g++ at
first use) unless asked for this NumPy builder, whose per-axis bucket sweep
and partition are vectorized (same splits, same triangle order as
rtm_tpu's NumPy builder).  Both give bitwise the same arrays; a failed
native build raises, it never falls back.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..models.mesh import Mesh

MAX_DEPTH = 32          # BVH.h:71
NR_SUBPLANES = 6        # BVH.h:72
FMAX = np.float32(np.finfo(np.float32).max)


def _area(vmin, vmax) -> np.float32:
    """Reference area(): half surface area; 0 for inverted/empty boxes."""
    if np.any(vmin > vmax):
        return np.float32(0.0)
    size = (vmin - vmax).astype(np.float32)
    return np.float32(size[0] * size[1] + size[1] * size[2] + size[0] * size[2])


def _areas(vmin, vmax) -> np.ndarray:
    """_area over the leading axes of (..., 3) boxes."""
    with np.errstate(over="ignore", invalid="ignore"):
        size = vmin - vmax
        a = (size[..., 0] * size[..., 1] + size[..., 1] * size[..., 2]
             + size[..., 0] * size[..., 2])
    return np.where((vmin > vmax).any(axis=-1), np.float32(0.0), a)


def _bounds(mins, maxs):
    """(min, max) over rows of (n, 3) triangle boxes; (FMAX, -FMAX) empty."""
    if len(mins) == 0:
        return np.full(3, FMAX, np.float32), np.full(3, -FMAX, np.float32)
    return mins.min(axis=0), maxs.max(axis=0)


@dataclass
class BvhStats:
    """BVH::Stats parity (BVH.h:33-49)."""

    build_time_ms: float = 0.0
    tri_cnt: int = 0
    node_cnt: int = 0
    leaf_cnt: int = 0
    leaf_depth_min: int = 100
    leaf_depth_max: int = 0
    leaf_depth_sum: float = 0.0
    leaf_tris_min: int = 1000000
    leaf_tris_max: int = 0
    leaf_tris_sum: float = 0.0
    sah: float = 0.0

    def measure(self, depth: int, tri_count: int, cost: float) -> None:
        self.leaf_cnt += 1
        self.leaf_depth_min = min(self.leaf_depth_min, depth)
        self.leaf_depth_max = max(self.leaf_depth_max, depth)
        self.leaf_depth_sum += depth
        self.leaf_tris_min = min(self.leaf_tris_min, tri_count)
        self.leaf_tris_max = max(self.leaf_tris_max, tri_count)
        self.leaf_tris_sum += tri_count
        self.sah += cost

    @property
    def mean_depth(self) -> float:
        return self.leaf_depth_sum / max(self.leaf_cnt, 1)

    @property
    def mean_tris(self) -> float:
        return self.leaf_tris_sum / max(self.leaf_cnt, 1)

    def validate(self) -> None:
        """Instrumented invariants, promoted from logs to assertions
        (SURVEY.md §4(e))."""
        assert self.leaf_cnt >= 1
        assert self.node_cnt == 2 * self.leaf_cnt - 1 or self.tri_cnt == 0
        assert self.leaf_tris_sum == self.tri_cnt
        assert self.leaf_depth_max <= MAX_DEPTH


@dataclass
class BVH:
    """Built hierarchy for one mesh (flat arrays, GPU layout)."""

    box_min: np.ndarray       # (B,3) f32
    box_max: np.ndarray       # (B,3) f32
    buffer_region: np.ndarray  # (B,2) u32: internal -> (child_off, 0);
    #                                      leaf -> (lo, hi) into reordered tris
    order: np.ndarray         # (T,) u32 triangle permutation (indices)
    stats: BvhStats = field(default_factory=BvhStats)

    @property
    def num_nodes(self) -> int:
        return len(self.box_min)


def build_bvh(mesh: Mesh, use_native: bool = True) -> BVH:
    """The SAH hierarchy of `mesh`: by the native builder, or by the NumPy
    builder when use_native=False (bitwise the same arrays)."""
    t0 = time.perf_counter()
    if use_native:
        from .native import bvh_native
        result = bvh_native.build(mesh)
    else:
        result = _build_python(mesh)
    result.stats.build_time_ms = (time.perf_counter() - t0) * 1e3
    return result


def _build_python(mesh: Mesh) -> BVH:
    verts = mesh.verts.astype(np.float32)          # (T,3,3)
    t_count = len(verts)
    node_min = verts.min(axis=1)
    node_max = verts.max(axis=1)
    centers = (verts[:, 0] + verts[:, 1] + verts[:, 2]) / np.float32(3.0)

    indices = np.arange(t_count, dtype=np.uint32)
    hier_min: list = [np.asarray(mesh.volume_min, np.float32)]
    hier_max: list = [np.asarray(mesh.volume_max, np.float32)]
    hier_region: list = [np.zeros(2, np.uint32)]
    stats = BvhStats(tri_cnt=t_count)

    bins = np.arange(NR_SUBPLANES)[None, :, None]

    def split_box(lo: int, hi: int):
        """BVH.cpp:154-225 over the three axes at once, in the reference's
        float32 arithmetic.  Returns (cost, position, axis)."""
        best = (FMAX, np.float32(0.0), 0)
        if hi - lo == 0:
            return best
        idx = indices[lo:hi]
        c = centers[idx].T                                 # (3, n)
        blo, bhi = c.min(axis=1), c.max(axis=1)
        live = blo != bhi
        if not live.any():
            return best
        span = np.where(live, bhi - blo, np.float32(1.0))
        interval = np.float32(NR_SUBPLANES) / span
        bucket = np.minimum(NR_SUBPLANES - 1,
                            ((c - blo[:, None]) * interval[:, None])
                            .astype(np.uint32))
        m = bucket[:, None, :] == bins                     # (3, 6, n)
        b_cnt = m.sum(axis=2)
        m = m[..., None]
        b_min = np.where(m, node_min[idx], FMAX).min(axis=2)   # (3, 6, 3)
        b_max = np.where(m, node_max[idx], -FMAX).max(axis=2)
        # planes i = 0..4: left = buckets 0..i, right = buckets i+1..5
        l_cnt = np.cumsum(b_cnt, axis=1)[:, :-1]
        r_cnt = np.cumsum(b_cnt[:, ::-1], axis=1)[:, ::-1][:, 1:]
        l_area = _areas(np.minimum.accumulate(b_min, axis=1)[:, :-1],
                        np.maximum.accumulate(b_max, axis=1)[:, :-1])
        r_area = _areas(
            np.minimum.accumulate(b_min[:, ::-1], axis=1)[:, ::-1][:, 1:],
            np.maximum.accumulate(b_max[:, ::-1], axis=1)[:, ::-1][:, 1:])
        # counts times f32 areas promote to f64 and round once, as
        # u32 * f32 does in the reference's scalar loop
        cost = (l_cnt * l_area + r_cnt * r_area).astype(np.float32)
        subplane_size = span / np.float32(NR_SUBPLANES)
        for axis in np.nonzero(live)[0]:
            # the first plane strictly below FMAX and every earlier plane
            ok = cost[axis] < FMAX
            if not ok.any():
                continue
            i = int(np.argmin(np.where(ok, cost[axis], np.inf)))
            if cost[axis, i] < best[0]:
                best = (cost[axis, i],
                        np.float32(blo[axis] + subplane_size[axis]
                                   * np.float32(i + 1.0)), int(axis))
        return best

    def split(parent: int, lo: int, hi: int, depth: int = 0) -> None:
        tri_count = hi - lo
        cost, pos, axis = split_box(lo, hi)
        parent_cost = _area(hier_min[parent], hier_max[parent]) * np.float32(tri_count)

        if depth == MAX_DEPTH or cost >= parent_cost:
            stats.measure(depth, tri_count, float(parent_cost))
            hier_region[parent] = np.array([lo, hi], np.uint32)
            return

        # in-place swap partition (BVH.cpp:128-143) — order-exact.  The
        # left side keeps scan order.  The right side is the block between
        # the swap cursor and the scan: a right triangle joins its back,
        # and a left one swaps with its front, which moves the front to
        # the back.
        idx = indices[lo:hi]
        go_left = centers[idx, axis] <= pos
        left, right = idx[go_left], idx[~go_left]
        block: deque = deque()
        for node, is_left in zip(idx.tolist(), go_left.tolist()):
            if not is_left:
                block.append(node)
            elif block:
                block.rotate(-1)
        center = lo + len(left)
        indices[lo:center] = left
        indices[center:hi] = np.fromiter(block, np.uint32, len(right))
        lmin, lmax = _bounds(node_min[left], node_max[left])
        rmin, rmax = _bounds(node_min[right], node_max[right])

        child = len(hier_min)
        hier_region[parent] = np.array([child, 0], np.uint32)
        hier_min.append(lmin); hier_max.append(lmax)
        hier_region.append(np.zeros(2, np.uint32))
        hier_min.append(rmin); hier_max.append(rmax)
        hier_region.append(np.zeros(2, np.uint32))
        split(child, lo, center, depth + 1)
        split(child + 1, center, hi, depth + 1)

    if t_count > 0:
        import sys
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            split(0, 0, t_count)
        finally:
            sys.setrecursionlimit(old_limit)
    else:
        hier_region[0] = np.array([0, 0], np.uint32)
        stats.measure(0, 0, 0.0)

    stats.node_cnt = len(hier_min)
    return BVH(
        box_min=np.stack(hier_min), box_max=np.stack(hier_max),
        buffer_region=np.stack(hier_region), order=indices, stats=stats)


# ---------------------------------------------------------------------------
# Scene-level flattening: SceneWrapper parity (SceneWrapper.cpp:10-46)
# ---------------------------------------------------------------------------

@dataclass
class BvhScene:
    """Concatenated per-mesh BVHs + reordered triangles + instance
    wrappers: the buffer layout the reference binds (SURVEY C25), host
    NumPy arrays.  Used by the traversal validation path
    (ops/bvh_traverse.py)."""

    box_min: np.ndarray          # (B,3)
    box_max: np.ndarray          # (B,3)
    buffer_region: np.ndarray    # (B,2) u32 mesh-local semantics as in shader
    tri_verts: np.ndarray        # (T,3,3) reordered, local space
    tri_uvs: np.ndarray          # (T,3,2) reordered
    mesh_bvh_root: np.ndarray    # (M,) u32  (MeshWrapper.bvhRoot)
    mesh_model_root: np.ndarray  # (M,) u32  (MeshWrapper.modelRoot)
    inst_world_to_local: np.ndarray  # (I,4,4) f32
    inst_mesh_id: np.ndarray     # (I,) i32
    inst_material_id: np.ndarray  # (I,) i32
    stats: list = field(default_factory=list)


def build_bvh_scene(scene) -> BvhScene:
    """One hierarchy per mesh (local space), concatenated, with each
    instance's world-to-local matrix."""
    box_min, box_max, region = [], [], []
    tv, tu = [], []
    roots, model_roots = [], []
    stats = []
    box_off = tri_off = 0
    for mesh in scene.meshes:
        bvh = build_bvh(mesh)
        roots.append(box_off)
        model_roots.append(tri_off)
        box_off += bvh.num_nodes
        tri_off += mesh.num_triangles
        box_min.append(bvh.box_min)
        box_max.append(bvh.box_max)
        region.append(bvh.buffer_region)
        tv.append(mesh.verts[bvh.order])
        tu.append(mesh.uvs[bvh.order])
        stats.append(bvh.stats)

    def cat(parts, shape, dtype=np.float32):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros(shape, dtype))

    objs = scene.objects
    return BvhScene(
        box_min=cat(box_min, (0, 3)), box_max=cat(box_max, (0, 3)),
        buffer_region=cat(region, (0, 2), np.uint32),
        tri_verts=cat(tv, (0, 3, 3)), tri_uvs=cat(tu, (0, 3, 2)),
        mesh_bvh_root=np.asarray(roots, np.uint32),
        mesh_model_root=np.asarray(model_roots, np.uint32),
        inst_world_to_local=(
            np.stack([o.inv_model_matrix() for o in objs]).astype(np.float32)
            if objs else np.zeros((0, 4, 4), np.float32)),
        inst_mesh_id=np.asarray([o.mesh_id for o in objs], np.int32),
        inst_material_id=np.asarray([o.material_id for o in objs], np.int32),
        stats=stats,
    )
