// Round-1 nearest-triangle sweep kernel for Hopper (sm_90a): the per-bounce
// intersection of the `pallas` backend.
//
// Replaces the TPU kernel rtm_tpu/ops/pallas/intersect_kernel.py:_kernel
// (launched by _sweep / nearest_triangle_pallas).  Plain version and wrapper:
// rtm_tpu_torch/ops/kernels/intersect_kernel.py (intersect_sweep_plain,
// intersect_sweep, nearest_triangle_pallas).
//
// What it computes, per ray tile (one thread block of `ray_tile` rays, 256 by
// default): the nearest triangle over fixed 128-triangle clusters in buffer
// order, the last one padded to 128 rows.  Before each cluster the tile
// decides together whether ANY of its rays (no alive mask: padding rays
// count) has its slab entry distance to the cluster's box below its running
// best t (intersect_kernel.py:177); the slab
// test divides by the raw direction (1/d, NaN where o sits on a bound with
// d = 0, and a NaN entry rejects the box, as in rtm_tpu).  Pairs pass when
// det > eps and t, u, v, w >= 0; t = tdet / det, the exact IEEE quotient as
// in rtm_tpu; strict < keeps the lowest triangle on ties.  Outputs: t
// (FLT_MAX on miss) and the triangle index (-1 on miss).
//
// What bounds it on the H100: 43 FP32 operations per (ray, triangle) pair of
// each passed cluster (tri_sweep.cuh) and 25 per (ray, cluster) slab test,
// against the rays (N, 16), the (16, C*128) features and the outputs in
// bytes; chip_smoke.py computes both from each run's passes.
//
// What the design does about it.  One thread per ray, the ray in
// registers.  (1) Real rows only: a passed cluster c sweeps rows
// [0, min(128, n_tris - 128c)) and stages only those; the padding rows of
// the last cluster have a zero normal, so det > eps fails for every ray
// (NaN rays included) and they can never win.  (2) The pair pass
// (tri_sweep.cuh strict_block) skips per warp a row on which no lane has
// det > eps and tdet >= 0, and divides only behind the gate.  (3) The cull
// is tri_sweep.cuh's candidate prefilter: the box table is staged in shared
// memory CB clusters at a time, every warp ORs the clusters its rays enter
// at all into a block candidate mask (a cluster can pass only then, since
// best t <= FLT_MAX and a miss gives FLT_MAX), and the exact
// __syncthreads_or walk runs over the set bits only, in table order, so
// the passes, the winners and their tie order are those of the walk over
// every cluster.  Unlike the sweeps' prefilter there is no alive mask:
// every ray of the tile counts (intersect_kernel.py:177).  A passed
// cluster's feature columns are staged as [row][16] (transposed from the
// (16, C*128) layout) and read as broadcasts.
#include <cuda_runtime.h>

#include <cstdint>

#include "tri_sweep.cuh"

using namespace rtm;

namespace {

constexpr int CLUSTER = 128;
constexpr float FLT_MAX_F = 3.402823466e38f;

__global__ void intersect_sweep_kernel(const float* __restrict__ rays,
                                       const float* __restrict__ feats,
                                       const float* __restrict__ boxes,
                                       int nc, int n_tris, int cull,
                                       float* __restrict__ t_out,
                                       int* __restrict__ i_out,
                                       int* __restrict__ passes) {
  __shared__ float s_rows[CLUSTER * NFEAT];
  __shared__ BoxScratch sc;

  const long ray = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* rp = reinterpret_cast<const float4*>(rays + ray * 16);
  const float4 q0 = __ldg(rp), q1 = __ldg(rp + 1), q2 = __ldg(rp + 2);
  // rays row: [ox oy oz dx dy dz wx wy wz 0...]
  SweepRay r;
  r.ox = q0.x; r.oy = q0.y; r.oz = q0.z;
  r.dx = q0.w; r.dy = q1.x; r.dz = q1.y;
  r.wx = q1.z; r.wy = q1.w; r.wz = q2.x;
  const float inv_dx = 1.0f / r.dx, inv_dy = 1.0f / r.dy,
              inv_dz = 1.0f / r.dz;
  const long fstride = (long)nc * CLUSTER;

  float best_t = FLT_MAX_F;
  int best_i = -1;
  int n_pass = 0;
  // sweep the real rows of cluster c; every thread of the block calls it
  auto sweep = [&](int c) {
    const int rows = max(0, min(CLUSTER, n_tris - c * CLUSTER));
    ++n_pass;
    __syncthreads();  // the previous cluster's rows are no longer read
    stage_rows(s_rows, feats + (long)c * CLUSTER, rows, 1, fstride);
    __syncthreads();
    strict_block(s_rows, rows, c * CLUSTER, r, best_t, best_i);
  };
  if (!cull) {
    for (int c = 0; c < nc; ++c) sweep(c);
  } else {
    float* s_box = reinterpret_cast<float*>(sc.box);
    for (int c0 = 0; c0 < nc; c0 += CB) {
      const int cnt = min(CB, nc - c0);
      const int words = (cnt + 31) >> 5;
      __syncthreads();  // the previous chunk's boxes and mask are read no more
      // the (8, nc) box table, cluster-major in shared memory as in the
      // sweeps' (nc, 8) one: lo.xyz, hi.xyz, 0, 0
      for (int i = threadIdx.x; i < cnt * 8; i += blockDim.x) {
        const int f = i / cnt, j = i - f * cnt;
        s_box[j * 8 + f] = __ldg(boxes + (long)f * nc + c0 + j);
      }
      for (int w = threadIdx.x; w < words; w += blockDim.x) sc.mask[w] = 0u;
      __syncthreads();
      mark_candidates(sc, cnt, r, inv_dx, inv_dy, inv_dz, 0xffffffffu,
                      FLT_MAX_F);
      __syncthreads();
      for (int w = 0; w < words; ++w) {
        for (uint32_t bits = sc.mask[w]; bits != 0u; bits &= bits - 1u) {
          const int j = w * 32 + __ffs(bits) - 1;
          const float near =
              staged_near(sc, j, r, inv_dx, inv_dy, inv_dz, FLT_MAX_F);
          if (__syncthreads_or(near < best_t)) sweep(c0 + j);
        }
      }
    }
  }
  t_out[ray] = best_t;
  i_out[ray] = best_t < FLT_MAX_F ? best_i : -1;
  if (passes != nullptr && threadIdx.x == 0) passes[blockIdx.x] = n_pass;
}

}  // namespace

extern "C" int intersect_sweep_launch(const float* rays, const float* feats,
                                      const float* boxes, int nc, int n_tris,
                                      long n, int ray_tile, int cull,
                                      float* t_out, int* i_out, int* passes,
                                      void* stream) {
  const int grid = (int)(n / ray_tile);
  if (grid > 0)
    intersect_sweep_kernel<<<grid, ray_tile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rays, feats, boxes, nc, n_tris, cull, t_out, i_out, passes);
  return (int)cudaGetLastError();
}
