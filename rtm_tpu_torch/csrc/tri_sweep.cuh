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
// propagate NaN as XLA's and PyTorch's do (fminf / fmaxf would drop it; the
// PTX min.NaN / max.NaN instructions keep it in one instruction), so a slab
// test that produces NaN rejects the box exactly as the plain versions do.
//
// What bounds the static-order sweep on the H100.  The work a tile needs is
// one 25-operation slab test per (alive ray, cluster) and one 45-operation
// pair test per (ray, row) of the few clusters it passes (1.5 to 2.5 of 768
// per tile-bounce on dragon_grid(56)).  A tile is one thread block, so its
// passes run one after another on one SM, every lane of them (a dead lane's
// t and row are outputs too): a tile that passes a hundred clusters takes
// milliseconds while the other SMs idle, and the heaviest tile of a launch
// sets its time (chip_smoke.py [wf2] per bounce and [mega-big]).  Walking
// every cluster with a block barrier each, as the TPU kernel's tile-uniform
// `pl.when` does per grid step, added 768 slab tests and barriers per
// tile-bounce, dead warps and dead tiles included.
//
// What the design does about it.  `sweep_clusters` stages the box table in
// shared memory a chunk of CB clusters at a time; each warp with an alive
// ray tests its rays against the chunk's boxes with no barrier and marks the
// clusters some alive ray enters at all (the candidates, a superset of the
// clusters that can pass); only those take the block barrier and the exact
// test of the walk they replace.  `sweep_block`, the pair pass, skips per
// warp the rows none of its lanes can hit and divides only behind the gate.
// What is left is the heavy tiles' pair passes on one SM each (PERF.md).
// The intersect kernel runs the same prefilter (`mark_candidates`, every
// ray of its tile counting) over its own (8, C) box table, and its strict
// pair pass `strict_block` skips rows per warp the same way.
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
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
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

// The four determinants of one (ray, triangle) pair from its feature row f,
// in two steps; wdet = det - udet - vdet.
__device__ __forceinline__ void det_tdet(const SweepRay& r,
                                         const float* __restrict__ f,
                                         float& det, float& tdet) {
  det = -(r.dx * f[F_NX] + r.dy * f[F_NY] + r.dz * f[F_NZ]);
  tdet = (r.ox * f[F_NX] + r.oy * f[F_NY] + r.oz * f[F_NZ]) - f[F_AN];
}

__device__ __forceinline__ void udet_vdet(const SweepRay& r,
                                          const float* __restrict__ f,
                                          float& udet, float& vdet) {
  udet = (r.wx * f[F_ACX] + r.wy * f[F_ACY] + r.wz * f[F_ACZ]) -
         (r.dx * f[F_G1X] + r.dy * f[F_G1Y] + r.dz * f[F_G1Z]);
  vdet = (r.dx * f[F_G2X] + r.dy * f[F_G2Y] + r.dz * f[F_G2Z]) -
         (r.wx * f[F_ABX] + r.wy * f[F_ABY] + r.wz * f[F_ABZ]);
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

// One cluster pass of the intersect kernel's sweep for this thread's ray:
// rows [0, rows) of the staged shared-memory block, table rows row0 + k.
// The pair test (intersect_kernel.py:156-163): det > eps and tdet, udet,
// vdet, wdet >= 0, t = tdet / det exactly; a row replaces the best only
// when strictly below it, so the lowest row wins ties.  A row whose gate
// fails has t = FLT_MAX in rtm_tpu, which never replaces the best (best <=
// FLT_MAX always), so two skips are exact: a warp in which no lane has
// det > eps and tdet >= 0 drops the row (the whole block calls this with
// the same rows), and the division runs only behind the gate.
__device__ __forceinline__ void strict_block(const float* __restrict__ rows_sm,
                                             int rows, int row0,
                                             const SweepRay& r, float& best_t,
                                             int& best_i) {
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    const float* f = rows_sm + k * NFEAT;
    float det, tdet, udet, vdet;
    det_tdet(r, f, det, tdet);
    const bool front = det > SWEEP_DET_EPS && tdet >= 0.0f;
    if (!__any_sync(0xffffffffu, front)) continue;
    udet_vdet(r, f, udet, vdet);
    const float wdet = det - udet - vdet;
    if (front && udet >= 0.0f && vdet >= 0.0f && wdet >= 0.0f) {
      const float t = tdet / det;
      if (t < best_t) {
        best_t = t;
        best_i = row0 + k;
      }
    }
  }
}

// One cluster pass of the static and nearest-first sweeps for this thread's
// ray, the same rows and tie rule (an earlier cluster also wins ties across
// clusters, megakernel.py:463-470).  The pair test (megakernel.py:454-462):
// valid when the min-chain min(det - eps, tdet, udet, vdet, wdet) >= 0,
// ordered by the exact tdet / max(det, eps) (rtm_tpu orders by an
// approximate reciprocal).  A row whose gate fails cannot replace the best
// (the best never exceeds SWEEP_BIG), so two skips are exact: a warp in
// which no lane has det - eps >= 0 and tdet >= 0 drops the rest of the row
// (the whole block calls this with the same rows, so the vote sees every
// lane), and the division runs only behind the gate.  On the big scenes this
// pass is where a tile's time goes.
__device__ __forceinline__ void sweep_block(const float* __restrict__ rows_sm,
                                            int rows, int row0,
                                            const SweepRay& r, float& best_t,
                                            int& best_i) {
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    const float* f = rows_sm + k * NFEAT;
    float det, tdet, udet, vdet;
    det_tdet(r, f, det, tdet);
    const float de = det - SWEEP_DET_EPS;
    if (!__any_sync(0xffffffffu, de >= 0.0f && tdet >= 0.0f)) continue;
    udet_vdet(r, f, udet, vdet);
    const float wdet = det - udet - vdet;
    const float m = nan_min(nan_min(de, tdet), nan_min(nan_min(udet, vdet),
                                                       wdet));
    if (m >= 0.0f) {
      const float t = tdet / fmaxf(det, SWEEP_DET_EPS);
      if (t < best_t) {
        best_t = t;
        best_i = row0 + k;
      }
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
    sweep_block(s_rows, rows, off + base, r, best_t, best_i);
  }
}

// Clusters per staged box chunk of the static-order sweep (a multiple of 32:
// one candidate word per 32 clusters).
constexpr int CB = 512;

// Shared scratch of the static-order sweep: one chunk of the (nc, 8) box
// table, cluster j at box[2j] = (lo.xyz, hi.x), box[2j + 1] = (hi.yz, 0, 0),
// and the chunk's candidate mask, bit j of mask[j / 32] for cluster j.
struct BoxScratch {
  float4 box[CB * 2];
  uint32_t mask[CB / 32];
};

// slab_near of this thread's ray to staged cluster j; `miss` on a miss.
__device__ __forceinline__ float staged_near(const BoxScratch& sc, int j,
                                             const SweepRay& r, float inv_dx,
                                             float inv_dy, float inv_dz,
                                             float miss) {
  const float4 a = sc.box[2 * j], b = sc.box[2 * j + 1];
  return slab_near(a.x, a.y, a.z, a.w, b.x, b.y, r, inv_dx, inv_dy, inv_dz,
                   miss);
}

// The prefilter over one staged chunk of `cnt` clusters: the lanes of this
// warp whose bit of `lane_bits` is set test their rays against every staged
// box, and lane 0 ORs the clusters some of them enter at all (slab_near
// below `miss`) into the block's candidate mask, one word per 32 clusters
// (__reduce_or_sync; no barrier per cluster).  The caller zeroes the mask
// and brackets this with barriers; every lane of the warp calls it.
__device__ __forceinline__ void mark_candidates(BoxScratch& sc, int cnt,
                                                const SweepRay& r,
                                                float inv_dx, float inv_dy,
                                                float inv_dz,
                                                uint32_t lane_bits,
                                                float miss) {
  const int words = (cnt + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    const int kn = min(32, cnt - w * 32);
    uint32_t bits = 0u;
#pragma unroll 4
    for (int k = 0; k < kn; ++k)
      bits |= (staged_near(sc, w * 32 + k, r, inv_dx, inv_dy, inv_dz, miss) <
                       miss
                   ? 1u
                   : 0u)
              << k;
    bits = __reduce_or_sync(0xffffffffu, bits & lane_bits);
    if ((threadIdx.x & 31) == 0 && bits != 0u) atomicOr(sc.mask + w, bits);
  }
}

// The static-order sweep of one ray tile (one thread block) over the SAH
// clusters (megakernel.py `_tri_sweep`): clusters in table order; with
// `cull` the block sweeps a cluster only when an ALIVE ray of it enters the
// cluster's box nearer than its best t (__syncthreads_or, the counterpart
// of the TPU kernel's tile-uniform `pl.when`), and then every ray of the
// block, dead ones too, sweeps it.  Returns the clusters swept.  Every
// thread of the block calls it; blockDim.x is a multiple of 32.
//
// The cull runs in two steps, chunk by chunk of CB clusters staged in
// shared memory.  best_t <= SWEEP_BIG always and slab_near returns
// SWEEP_BIG on a miss (NaN included), so a cluster can pass only if some
// alive ray of the tile enters its box at all: the tile's candidate set
// (sweep_kernel.py `sweep_candidates_plain`), which does not depend on
// best_t.  (1) The prefilter: every warp with an alive lane tests its rays
// against each staged box, ORs the alive lanes' hits into one word per 32
// clusters (__reduce_or_sync) and sets the block's candidate mask; no
// barrier per cluster.  (2) The serial loop walks the mask's set bits in
// table order and applies the exact test above (its own barrier), so the
// passes, the winners and their tie order are those of a walk over every
// cluster.
__device__ __forceinline__ int sweep_clusters(
    const float* __restrict__ feats, const float* __restrict__ boxes,
    const int* __restrict__ offsets, const int* __restrict__ widths, int nc,
    bool cull, const SweepRay& r, bool alive, float inv_dx, float inv_dy,
    float inv_dz, float* __restrict__ s_rows, BoxScratch& sc, float& best_t,
    int& best_i) {
  if (!cull) {
    for (int c = 0; c < nc; ++c)
      sweep_cluster(feats, __ldg(offsets + c), __ldg(widths + c), r, s_rows,
                    best_t, best_i);
    return nc;
  }
  const bool warp_alive = __any_sync(0xffffffffu, alive);
  const uint32_t alive_bits = alive ? 0xffffffffu : 0u;
  float* s_box = reinterpret_cast<float*>(sc.box);
  int n_pass = 0;
  for (int c0 = 0; c0 < nc; c0 += CB) {
    const int cnt = min(CB, nc - c0);
    const int words = (cnt + 31) >> 5;
    __syncthreads();  // the previous chunk's boxes and mask are no longer read
    for (int i = threadIdx.x; i < cnt * 8; i += blockDim.x)
      s_box[i] = __ldg(boxes + (long)c0 * 8 + i);
    for (int w = threadIdx.x; w < words; w += blockDim.x) sc.mask[w] = 0u;
    __syncthreads();
    if (warp_alive)
      mark_candidates(sc, cnt, r, inv_dx, inv_dy, inv_dz, alive_bits,
                      SWEEP_BIG);
    __syncthreads();
    for (int w = 0; w < words; ++w) {
      for (uint32_t bits = sc.mask[w]; bits != 0u; bits &= bits - 1u) {
        const int j = w * 32 + __ffs(bits) - 1;
        const float near =
            staged_near(sc, j, r, inv_dx, inv_dy, inv_dz, SWEEP_BIG);
        if (!__syncthreads_or(alive && near < best_t)) continue;
        ++n_pass;
        sweep_cluster(feats, __ldg(offsets + c0 + j), __ldg(widths + c0 + j),
                      r, s_rows, best_t, best_i);
      }
    }
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
