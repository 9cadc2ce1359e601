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
// order.  Before each cluster the tile decides together whether ANY of its
// rays (no alive mask: padding rays count) has its slab entry distance to the
// cluster's box below its running best t (intersect_kernel.py:177); the slab
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
// What the design does about it: one thread per ray, the ray in registers; a
// passed cluster's 128 feature columns are staged in shared memory as
// [row][16] (transposed from the (16, C*128) layout) and read as broadcasts.
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
                                       int nc, int cull,
                                       float* __restrict__ t_out,
                                       int* __restrict__ i_out,
                                       int* __restrict__ passes) {
  __shared__ float s_rows[CLUSTER * NFEAT];

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
  for (int c = 0; c < nc; ++c) {
    if (cull) {
      const float near =
          slab_near(__ldg(boxes + 0 * nc + c), __ldg(boxes + 1 * nc + c),
                    __ldg(boxes + 2 * nc + c), __ldg(boxes + 3 * nc + c),
                    __ldg(boxes + 4 * nc + c), __ldg(boxes + 5 * nc + c), r,
                    inv_dx, inv_dy, inv_dz, FLT_MAX_F);
      if (!__syncthreads_or(near < best_t)) continue;
    }
    ++n_pass;
    __syncthreads();  // the previous cluster's rows are no longer read
    stage_rows(s_rows, feats + (long)c * CLUSTER, CLUSTER, 1, fstride);
    __syncthreads();
    strict_block(s_rows, CLUSTER, c * CLUSTER, r, FLT_MAX_F, best_t, best_i);
  }
  t_out[ray] = best_t;
  i_out[ray] = best_t < FLT_MAX_F ? best_i : -1;
  if (passes != nullptr && threadIdx.x == 0) passes[blockIdx.x] = n_pass;
}

}  // namespace

extern "C" int intersect_sweep_launch(const float* rays, const float* feats,
                                      const float* boxes, int nc, long n,
                                      int ray_tile, int cull, float* t_out,
                                      int* i_out, int* passes, void* stream) {
  const int grid = (int)(n / ray_tile);
  if (grid > 0)
    intersect_sweep_kernel<<<grid, ray_tile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rays, feats, boxes, nc, cull, t_out, i_out, passes);
  return (int)cudaGetLastError();
}
