// Nearest-triangle sweep over precomputed 16-feature triangle rows, shared by
// the cluster-sweep kernel (cluster_sweep.cu), the intersect kernel
// (intersect_sweep.cu) and the megakernel (mega_trace.cu).
//
// __device__ counterpart of rtm_tpu/ops/pallas/megakernel.py `_tri_sweep`
// (:414-485: the per-pair test with its min-chain validity gate, :446-458),
// `_tri_sweep_ordered` (:491-595), `_safe_inv_dirs` (:380) and `_slab_near`
// (:394), and of the round-1 test of rtm_tpu/ops/pallas/intersect_kernel.py
// `_kernel` (:92-186).  The plain versions are in
// rtm_tpu_torch/ops/kernels/{megakernel,sweep_kernel,intersect_kernel}.py
// and keep the same operation order; with --fmad=false each operation rounds
// alike.
//
// Feature row layout (16 f32, ops/intersect.py factoring):
//   n.xyz, a.n, ab.xyz, ac.xyz, g1 = cross(ac, a).xyz, g2 = cross(ab, a).xyz
//
// A cluster's rows are staged in shared memory by the whole block (STAGE rows
// per pass) and every thread reads them as broadcasts.  Min and max
// propagate NaN as XLA's and PyTorch's do (fminf / fmaxf would drop it), so a
// slab test that produces NaN rejects the box exactly as the plain versions
// do.
#pragma once

#include <cstdint>

namespace rtm {

constexpr int NFEAT = 16;
constexpr int STAGE = 128;            // rows staged per shared-memory pass
constexpr float SWEEP_BIG = 1e30f;    // the sweep kernel's miss sentinel
constexpr float SWEEP_DET_EPS = 1e-12f;

enum { F_NX = 0, F_NY, F_NZ, F_AN, F_ABX, F_ABY, F_ABZ, F_ACX, F_ACY, F_ACZ,
       F_G1X, F_G1Y, F_G1Z, F_G2X, F_G2Y, F_G2Z };

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One ray in the sweep's terms: origin, direction, w = cross(o, d).
struct SweepRay {
  float ox, oy, oz, dx, dy, dz, wx, wy, wz;
};

__device__ __forceinline__ SweepRay make_sweep_ray(float ox, float oy,
                                                   float oz, float dx,
                                                   float dy, float dz) {
  // megakernel._cross(o, d)
  return {ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
          ox * dy - oy * dx};
}

// The four determinants of one (ray, triangle) pair from its feature row f;
// wdet = det - udet - vdet.
struct TriDets {
  float det, tdet, udet, vdet, wdet;
};

__device__ __forceinline__ TriDets tri_dets(const SweepRay& r,
                                            const float* __restrict__ f) {
  TriDets q;
  q.det = -(r.dx * f[F_NX] + r.dy * f[F_NY] + r.dz * f[F_NZ]);
  q.tdet = (r.ox * f[F_NX] + r.oy * f[F_NY] + r.oz * f[F_NZ]) - f[F_AN];
  q.udet = (r.wx * f[F_ACX] + r.wy * f[F_ACY] + r.wz * f[F_ACZ]) -
           (r.dx * f[F_G1X] + r.dy * f[F_G1Y] + r.dz * f[F_G1Z]);
  q.vdet = (r.dx * f[F_G2X] + r.dy * f[F_G2Y] + r.dz * f[F_G2Z]) -
           (r.wx * f[F_ABX] + r.wy * f[F_ABY] + r.wz * f[F_ABZ]);
  q.wdet = q.det - q.udet - q.vdet;
  return q;
}

// The sweep's pair test (megakernel.py:454-462): valid when the min-chain
// min(det - eps, tdet, udet, vdet, wdet) >= 0, ordered by the exact
// tdet / max(det, eps) (rtm_tpu orders by an approximate reciprocal);
// SWEEP_BIG when invalid.
__device__ __forceinline__ float sweep_pair_t(const SweepRay& r,
                                              const float* __restrict__ f) {
  const TriDets q = tri_dets(r, f);
  const float m = nan_min(nan_min(q.det - SWEEP_DET_EPS, q.tdet),
                          nan_min(nan_min(q.udet, q.vdet), q.wdet));
  return m >= 0.0f ? q.tdet / fmaxf(q.det, SWEEP_DET_EPS) : SWEEP_BIG;
}

// The round-1 intersect kernel's pair test (intersect_kernel.py:156-163):
// det > eps and every other determinant >= 0, t = tdet / det exactly;
// `miss` when invalid.
__device__ __forceinline__ float strict_pair_t(const SweepRay& r,
                                               const float* __restrict__ f,
                                               float miss) {
  const TriDets q = tri_dets(r, f);
  const bool valid = q.det > SWEEP_DET_EPS && q.tdet >= 0.0f &&
                     q.udet >= 0.0f && q.vdet >= 0.0f && q.wdet >= 0.0f;
  return valid ? q.tdet / q.det : miss;
}

// NaN-safe slab reciprocals (megakernel._safe_inv_dirs): |d| clamped away
// from 0, sign kept.
__device__ __forceinline__ float sweep_safe_inv(float d) {
  const float eps = 1e-12f;
  const float ds = fabsf(d) < eps ? (d >= 0.0f ? eps : -eps) : d;
  return 1.0f / ds;
}

// Slab entry distance of a ray to the box [lo, hi] given the reciprocal
// directions; `miss` when the ray misses it (megakernel._slab_near,
// intersect_kernel.py:120-131).
__device__ __forceinline__ float slab_near(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           const SweepRay& r, float inv_dx,
                                           float inv_dy, float inv_dz,
                                           float miss) {
  const float t1x = (lox - r.ox) * inv_dx;
  const float t2x = (hix - r.ox) * inv_dx;
  const float t1y = (loy - r.oy) * inv_dy;
  const float t2y = (hiy - r.oy) * inv_dy;
  const float t1z = (loz - r.oz) * inv_dz;
  const float t2z = (hiz - r.oz) * inv_dz;
  const float tn = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                           nan_min(t1z, t2z));
  const float tf = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                           nan_max(t1z, t2z));
  return (tf >= 0.0f && tn <= tf) ? tn : miss;
}

// Stage `rows` feature rows (row r at src + r * row_stride + j * feat_stride)
// into shared memory as [rows][NFEAT], the whole block cooperating.  The
// caller brackets it with barriers.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int rows, long row_stride,
                                           long feat_stride) {
  for (int i = threadIdx.x; i < rows * NFEAT; i += blockDim.x) {
    const int r = i / NFEAT;
    const int j = i - r * NFEAT;
    dst[i] = __ldg(src + r * row_stride + j * feat_stride);
  }
}

// One cluster pass of the sweep for this thread's ray: rows [0, rows) of the
// staged shared-memory block, table rows row0 + k.  A row replaces the best
// only when strictly below it, so the lowest row wins ties inside a cluster
// and an earlier cluster wins ties across clusters (megakernel.py:463-470).
template <bool STRICT>
__device__ __forceinline__ void sweep_block(const float* __restrict__ rows_sm,
                                            int rows, int row0,
                                            const SweepRay& r, float miss,
                                            float& best_t, int& best_i) {
  for (int k = 0; k < rows; ++k) {
    const float* f = rows_sm + k * NFEAT;
    const float t = STRICT ? strict_pair_t(r, f, miss) : sweep_pair_t(r, f);
    if (t < best_t) {
      best_t = t;
      best_i = row0 + k;
    }
  }
}

// Sweep rows [off, off + width) of the (T', 16) feature table for this
// thread's ray, staging STAGE rows at a time.  Every thread of the block
// calls it (it holds barriers).
__device__ __forceinline__ void sweep_cluster(const float* __restrict__ feats,
                                              int off, int width,
                                              const SweepRay& r,
                                              float* __restrict__ s_rows,
                                              float& best_t, int& best_i) {
  for (int base = 0; base < width; base += STAGE) {
    const int rows = min(STAGE, width - base);
    __syncthreads();  // the previous stage's rows are no longer read
    stage_rows(s_rows, feats + (long)(off + base) * NFEAT, rows, NFEAT, 1);
    __syncthreads();
    sweep_block<false>(s_rows, rows, off + base, r, SWEEP_BIG, best_t,
                       best_i);
  }
}

// The static-order sweep of one ray tile (one thread block) over the SAH
// clusters (megakernel.py `_tri_sweep`): clusters in table order; with
// `cull` the block sweeps a cluster only when an ALIVE ray of it enters the
// cluster's box nearer than its best t (__syncthreads_or, the counterpart
// of the TPU kernel's tile-uniform `pl.when`), and then every ray of the
// block, dead ones too, sweeps it.  Returns the clusters swept.  Every
// thread of the block calls it.
__device__ __forceinline__ int sweep_clusters(
    const float* __restrict__ feats, const float* __restrict__ boxes,
    const int* __restrict__ offsets, const int* __restrict__ widths, int nc,
    bool cull, const SweepRay& r, bool alive, float inv_dx, float inv_dy,
    float inv_dz, float* __restrict__ s_rows, float& best_t, int& best_i) {
  int n_pass = 0;
  for (int c = 0; c < nc; ++c) {
    if (cull) {
      const float* b = boxes + c * 8;
      const float near = slab_near(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                                   __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), r,
                                   inv_dx, inv_dy, inv_dz, SWEEP_BIG);
      if (!__syncthreads_or(alive && near < best_t)) continue;
    }
    ++n_pass;
    sweep_cluster(feats, __ldg(offsets + c), __ldg(widths + c), r, s_rows,
                  best_t, best_i);
  }
  return n_pass;
}

constexpr int KEY_LANES = 128;  // most clusters the nearest-first sweep takes

// Shared scratch of the nearest-first sweep.
struct NearScratch {
  float wmin[KEY_LANES * 32];  // per (cluster, warp) least alive entry
  float keys[KEY_LANES];
  int order[KEY_LANES];
};

// The nearest-first sweep of one ray tile (megakernel.py
// `_tri_sweep_ordered`), nc <= KEY_LANES: each cluster's key is the least
// slab entry over the block's alive rays (SWEEP_BIG when none enters); the
// clusters are visited in key order, the lowest index first on ties, until
// the keys reach SWEEP_BIG, and a visited cluster is swept when an alive ray
// enters it nearer than its best t.  rtm_tpu pops the least key nc times;
// since the keys are fixed within a bounce, that is their sorted order, so
// here each key's rank is counted once.  Returns the clusters swept.  Every
// thread of the block calls it; blockDim.x is a multiple of 32.
__device__ __forceinline__ int sweep_clusters_near(
    const float* __restrict__ feats, const float* __restrict__ boxes,
    const int* __restrict__ offsets, const int* __restrict__ widths, int nc,
    const SweepRay& r, bool alive, float inv_dx, float inv_dy, float inv_dz,
    float* __restrict__ s_rows, NearScratch& sc, float& best_t,
    int& best_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int c = 0; c < nc; ++c) {
    const float* b = boxes + c * 8;
    float v = alive ? slab_near(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                                __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), r,
                                inv_dx, inv_dy, inv_dz, SWEEP_BIG)
                    : SWEEP_BIG;
    for (int k = 16; k > 0; k >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, k));
    if (lane == 0) sc.wmin[c * 32 + warp] = v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    float k = sc.wmin[c * 32];
    for (int w = 1; w < warps; ++w) k = fminf(k, sc.wmin[c * 32 + w]);
    sc.keys[c] = k;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const float k = sc.keys[c];
    int rank = 0;
    for (int j = 0; j < nc; ++j) {
      const float kj = sc.keys[j];
      rank += (kj < k || (kj == k && j < c)) ? 1 : 0;
    }
    sc.order[rank] = c;
  }
  __syncthreads();
  int n_pass = 0;
  for (int i = 0; i < nc; ++i) {
    const int c = sc.order[i];
    if (!(sc.keys[c] < SWEEP_BIG)) break;  // the same for the whole block
    const float* b = boxes + c * 8;
    const float near = slab_near(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                                 __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), r,
                                 inv_dx, inv_dy, inv_dz, SWEEP_BIG);
    if (!__syncthreads_or(alive && near < best_t)) continue;
    ++n_pass;
    sweep_cluster(feats, __ldg(offsets + c), __ldg(widths + c), r, s_rows,
                  best_t, best_i);
  }
  return n_pass;
}

}  // namespace rtm
