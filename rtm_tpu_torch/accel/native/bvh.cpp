// Native binned-SAH BVH builder — the host-side hot loop of scene builds.
//
// rtm_tpu_torch's copy of rtm_tpu/accel/native/bvh.cpp.  It follows the
// build semantics of accel/bvh.py (which reproduces the reference builder
// RayTracing/src/BVH.cpp:49-258):
//   * 3 axes x 6 buckets binned SAH over centroid bounds (BVH.cpp:154-225)
//   * area() = HALF surface area, 0 for inverted boxes   (BVH.cpp:35-45)
//   * leaf when depth==32 or best cost >= area(parent)*count (BVH.cpp:110-123)
//   * in-place swap partition by centroid <= splitPos    (BVH.cpp:128-143)
//   * children contiguous; parent.bufferRegion=(child,0); leaf=(lo,hi), hi>0
//     flags a leaf                                       (BVH.cpp:145-151)
//
// One line differs from rtm_tpu's copy: a plane's split cost
// l_cnt * l_area + r_cnt * r_area.  Both NumPy builders (rtm_tpu's and this
// package's) multiply a u32 / i64 count by an f32 area, which NumPy
// promotes to f64, add in f64 and round to f32 once; rtm_tpu's native
// builder computes the sum in f32, so tied and near-tied planes of
// instanced copies pick differently there.  Here the cost is computed in
// double and rounded once, as NumPy does.  Everything else is f32 in the
// NumPy builders' operation order, and the library is built with
// -ffp-contract=off so no multiply-add is fused; so the native build is
// bitwise the NumPy builds (tests/test_torch_native_bvh.py).
//
// C ABI only (consumed via ctypes: accel/native/bvh_native.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <limits>

namespace {

constexpr int kMaxDepth = 32;     // BVH.h:71
constexpr int kSubplanes = 6;     // BVH.h:72
constexpr float kFMax = std::numeric_limits<float>::max();

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float axis_of(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

// Reference area() quirk: half surface area via (min-max) products; 0 for
// empty/inverted boxes (BVH.cpp:35-45).
inline float area(const Vec3 &lo, const Vec3 &hi) {
  if (lo.x > hi.x || lo.y > hi.y || lo.z > hi.z) return 0.0f;
  const float sx = lo.x - hi.x, sy = lo.y - hi.y, sz = lo.z - hi.z;
  return sx * sy + sy * sz + sx * sz;
}

struct Stats {
  double tri_cnt = 0, node_cnt = 0, leaf_cnt = 0;
  double depth_min = 100, depth_max = 0, depth_sum = 0;
  double tris_min = 1000000, tris_max = 0, tris_sum = 0;
  double sah = 0;
  void measure(int depth, int tris, float cost) {
    leaf_cnt += 1;
    depth_min = std::min(depth_min, double(depth));
    depth_max = std::max(depth_max, double(depth));
    depth_sum += depth;
    tris_min = std::min(tris_min, double(tris));
    tris_max = std::max(tris_max, double(tris));
    tris_sum += tris;
    sah += cost;
  }
};

struct Builder {
  const Vec3 *tmin;       // per-triangle AABB
  const Vec3 *tmax;
  const Vec3 *center;     // per-triangle centroid
  uint32_t *order;        // triangle permutation, mutated in place
  Vec3 *nmin;             // node arrays (capacity-checked by caller)
  Vec3 *nmax;
  uint32_t *region;       // (B,2)
  int node_count = 0;
  int capacity = 0;
  bool overflow = false;
  Stats stats;

  // BVH.cpp:181-225 — returns best (cost, split position) on one axis
  void split_axis(int axis, int lo, int hi, float blo, float bhi,
                  float *best_cost, float *best_pos) const {
    const float interval = float(kSubplanes) / (bhi - blo);
    uint32_t b_cnt[kSubplanes] = {0};
    Vec3 b_min[kSubplanes], b_max[kSubplanes];
    for (int i = 0; i < kSubplanes; ++i) {
      b_min[i] = {kFMax, kFMax, kFMax};
      b_max[i] = {-kFMax, -kFMax, -kFMax};
    }
    for (int i = lo; i < hi; ++i) {
      const uint32_t n = order[i];
      const float c = axis_of(center[n], axis);
      uint32_t b = uint32_t((c - blo) * interval);
      if (b > kSubplanes - 1) b = kSubplanes - 1;
      b_cnt[b] += 1;
      b_min[b] = vmin(b_min[b], tmin[n]);
      b_max[b] = vmax(b_max[b], tmax[n]);
    }

    float l_area[kSubplanes - 1], r_area[kSubplanes - 1];
    uint32_t l_cnt[kSubplanes - 1], r_cnt[kSubplanes - 1];
    Vec3 lmin = {kFMax, kFMax, kFMax}, lmax = {-kFMax, -kFMax, -kFMax};
    Vec3 rmin = lmin, rmax = lmax;
    uint32_t lc = 0, rc = 0;
    for (int li = 0; li < kSubplanes - 1; ++li) {
      lc += b_cnt[li];
      l_cnt[li] = lc;
      lmin = vmin(lmin, b_min[li]);
      lmax = vmax(lmax, b_max[li]);
      l_area[li] = area(lmin, lmax);
      const int ri = kSubplanes - 1 - li;
      rc += b_cnt[ri];
      r_cnt[ri - 1] = rc;
      rmin = vmin(rmin, b_min[ri]);
      rmax = vmax(rmax, b_max[ri]);
      r_area[ri - 1] = area(rmin, rmax);
    }

    const float subplane_size = (bhi - blo) / float(kSubplanes);
    *best_cost = kFMax;
    *best_pos = 0.0f;
    for (int i = 0; i < kSubplanes - 1; ++i) {
      // NumPy's promotion: count x f32 area in f64, one rounding to f32
      const float cost = float(double(l_cnt[i]) * double(l_area[i]) +
                               double(r_cnt[i]) * double(r_area[i]));
      if (cost < *best_cost) {
        *best_cost = cost;
        *best_pos = blo + subplane_size * float(i + 1);
      }
    }
  }

  // BVH.cpp:154-179 — best (cost, pos, axis) over the three axes
  void split_box(int lo, int hi, float *cost, float *pos, int *axis) const {
    *cost = kFMax;
    *pos = 0.0f;
    *axis = 0;
    if (hi - lo == 0) return;
    for (int a = 0; a < 3; ++a) {
      float blo = kFMax, bhi = -kFMax;
      for (int i = lo; i < hi; ++i) {
        const float c = axis_of(center[order[i]], a);
        blo = std::min(blo, c);
        bhi = std::max(bhi, c);
      }
      if (blo == bhi) continue;
      float c, p;
      split_axis(a, lo, hi, blo, bhi, &c, &p);
      if (c < *cost) {
        *cost = c;
        *pos = p;
        *axis = a;
      }
    }
  }

  // BVH.cpp:96-152
  void split(int parent, int lo, int hi, int depth) {
    if (overflow) return;
    const int tri_count = hi - lo;
    float cost, pos;
    int axis;
    split_box(lo, hi, &cost, &pos, &axis);
    const float parent_cost =
        area(nmin[parent], nmax[parent]) * float(tri_count);

    if (depth == kMaxDepth || cost >= parent_cost) {
      stats.measure(depth, tri_count, parent_cost);
      region[2 * parent] = uint32_t(lo);
      region[2 * parent + 1] = uint32_t(hi);
      return;
    }

    // in-place swap partition (BVH.cpp:128-143) — order-exact
    Vec3 lmin = {kFMax, kFMax, kFMax}, lmax = {-kFMax, -kFMax, -kFMax};
    Vec3 rmin = lmin, rmax = lmax;
    int mid = lo;
    for (int i = lo; i < hi; ++i) {
      const uint32_t n = order[i];
      if (axis_of(center[n], axis) <= pos) {
        lmin = vmin(lmin, tmin[n]);
        lmax = vmax(lmax, tmax[n]);
        std::swap(order[mid], order[i]);
        ++mid;
      } else {
        rmin = vmin(rmin, tmin[n]);
        rmax = vmax(rmax, tmax[n]);
      }
    }

    const int child = node_count;
    if (child + 2 > capacity) {
      overflow = true;
      return;
    }
    node_count += 2;
    region[2 * parent] = uint32_t(child);
    region[2 * parent + 1] = 0;
    nmin[child] = lmin;
    nmax[child] = lmax;
    nmin[child + 1] = rmin;
    nmax[child + 1] = rmax;
    split(child, lo, mid, depth + 1);
    split(child + 1, mid, hi, depth + 1);
  }
};

}  // namespace

extern "C" {

// Builds the BVH for one mesh.
//   verts:    (t_count, 3, 3) f32 triangle vertices
//   vol:      (6,) f32 mesh volume min/max (root box, glTF accessor parity)
//   box_min/box_max: (capacity, 3) f32 out
//   region:   (capacity, 2) u32 out
//   order:    (t_count,) u32 out (triangle permutation)
//   stats10:  (10,) f64 out: tri,node,leaf,dmin,dmax,dsum,tmin,tmax,tsum,sah
// Returns node count, or -1 if capacity is too small.
int rtm_bvh_build(const float *verts, int t_count, const float *vol,
                  float *box_min, float *box_max, uint32_t *region,
                  uint32_t *order, int capacity, double *stats10) {
  if (capacity < 1) return -1;

  Builder b;
  b.nmin = reinterpret_cast<Vec3 *>(box_min);
  b.nmax = reinterpret_cast<Vec3 *>(box_max);
  b.region = region;
  b.order = order;
  b.capacity = capacity;
  b.node_count = 1;
  b.nmin[0] = {vol[0], vol[1], vol[2]};
  b.nmax[0] = {vol[3], vol[4], vol[5]};
  b.region[0] = 0;
  b.region[1] = 0;
  b.stats.tri_cnt = t_count;

  if (t_count == 0) {
    b.stats.measure(0, 0, 0.0f);
  } else {
    // per-triangle AABBs + centroids (BVH.cpp:77-94)
    Vec3 *tmin = new Vec3[t_count];
    Vec3 *tmax = new Vec3[t_count];
    Vec3 *center = new Vec3[t_count];
    for (int i = 0; i < t_count; ++i) {
      const float *v = verts + i * 9;
      Vec3 a = {v[0], v[1], v[2]}, bb = {v[3], v[4], v[5]},
           c = {v[6], v[7], v[8]};
      tmin[i] = vmin(vmin(a, bb), c);
      tmax[i] = vmax(vmax(a, bb), c);
      center[i] = {(a.x + bb.x + c.x) / 3.0f, (a.y + bb.y + c.y) / 3.0f,
                   (a.z + bb.z + c.z) / 3.0f};
      order[i] = uint32_t(i);
    }
    b.tmin = tmin;
    b.tmax = tmax;
    b.center = center;
    b.split(0, 0, t_count, 0);
    delete[] tmin;
    delete[] tmax;
    delete[] center;
  }

  if (b.overflow) return -1;
  b.stats.node_cnt = b.node_count;
  stats10[0] = b.stats.tri_cnt;
  stats10[1] = b.stats.node_cnt;
  stats10[2] = b.stats.leaf_cnt;
  stats10[3] = b.stats.depth_min;
  stats10[4] = b.stats.depth_max;
  stats10[5] = b.stats.depth_sum;
  stats10[6] = b.stats.tris_min;
  stats10[7] = b.stats.tris_max;
  stats10[8] = b.stats.tris_sum;
  stats10[9] = b.stats.sah;
  return b.node_count;
}

}  // extern "C"
