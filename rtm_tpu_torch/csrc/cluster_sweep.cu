// Intersection-only cluster-sweep kernel for Hopper (sm_90a): the kernel half
// of the sorted-wavefront renderer.
//
// Replaces the TPU kernel rtm_tpu/ops/pallas/sweep_kernel.py:_make_kernel
// (launched by sweep_call), whose body is megakernel.py `_tri_sweep`.  Plain
// version and wrapper: rtm_tpu_torch/ops/kernels/sweep_kernel.py
// (cluster_sweep_plain, cluster_sweep, sweep_call).
//
// What it computes, per ray tile (one thread block of `ray_tile` slots, 512
// by default): for every cluster of the scene's SAH treelet cut (variable
// widths, rows [offset, offset + width) of the (T', 16) feature table), the
// tile decides together whether any ALIVE ray of it has its slab entry
// distance to the cluster's box below its running best t (__syncthreads_or,
// the counterpart of the TPU kernel's tile-uniform `pl.when`); if so every
// ray of the tile, dead ones too, sweeps the cluster's rows.  Outputs: the
// best t (SWEEP_BIG on miss), the winning row of the padded table (-1 on
// miss) and the cluster passes of each tile.  The tiling is part of the
// contract: another tile size changes the passes and their heatmap.
//
// Ordering: the exact tdet / max(det, eps), where rtm_tpu multiplies by an
// approximate reciprocal; strict < across rows and clusters, so the lowest
// row wins ties inside a cluster and the earlier cluster across clusters.
//
// What bounds it on the H100.  Each (ray, row) pair of a passed cluster costs
// 45 FP32 operations (tri_sweep.cuh det_tdet, udet_vdet, gate, division) and
// each (ray, cluster) slab test 25; the bytes are the (T', 16) table, the
// (8, N) ray band and the outputs.  chip_smoke.py computes both bounds from
// each run's alive rays and the real rows of the clusters each tile passed.
// On the 62,720-triangle wavefront2 cell a tile passes 1.5 of 768 clusters
// per bounce on average, but the sorted bands put the alive rays of bounces
// 1-7 into a few tiles that pass up to 181 clusters each; one thread block
// sweeps them one after another, so each band takes as long as its heaviest
// tile alone (chip_smoke.py [wf2] per bounce).
//
// What the design does about it.  One thread per slot, the ray in registers.
// A tile with no alive ray writes the miss and leaves at once.  Otherwise
// tri_sweep.cuh `sweep_clusters` stages the boxes in shared memory (512
// clusters per chunk), finds the tile's candidate clusters by per-warp
// slab tests with no barrier per cluster, and takes the block barrier only
// for those; a passed cluster's rows (<= 128 per stage, 8 KB) are staged in
// shared memory and read by every thread as broadcasts, and a warp skips the
// rows none of its lanes can hit.  At most 40 registers: three blocks of 512
// threads per SM.  The cluster offsets and widths are device arrays (rtm_tpu
// unrolls them as static Python tuples; dragon_grid(56) has hundreds).
#include <cuda_runtime.h>

#include <cstdint>

#include "tri_sweep.cuh"

using namespace rtm;

namespace {

__global__ void __maxnreg__(40)
    cluster_sweep_kernel(const float* __restrict__ feats,
                         const float* __restrict__ boxes,
                         const int* __restrict__ offsets,
                         const int* __restrict__ widths, int nc,
                         const float* __restrict__ state, long np, int cull,
                         float* __restrict__ t_out, int* __restrict__ i_out,
                         int* __restrict__ passes) {
  __shared__ float4 s_rows4[STAGE * NFEAT / 4];
  __shared__ BoxScratch s_box;
  float* s_rows = reinterpret_cast<float*>(s_rows4);

  const long slot = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = state[6 * np + slot] > 0.5f;
  if (cull && !__syncthreads_or(alive)) {
    // no alive ray: the walk would pass no cluster
    t_out[slot] = SWEEP_BIG;
    i_out[slot] = -1;
    if (threadIdx.x == 0) passes[blockIdx.x] = 0;
    return;
  }
  const SweepRay r = make_sweep_ray(
      state[0 * np + slot], state[1 * np + slot], state[2 * np + slot],
      state[3 * np + slot], state[4 * np + slot], state[5 * np + slot]);
  const float inv_dx = sweep_safe_inv(r.dx), inv_dy = sweep_safe_inv(r.dy),
              inv_dz = sweep_safe_inv(r.dz);

  float best_t = SWEEP_BIG;
  int best_i = -1;
  const int n_pass = sweep_clusters(feats, boxes, offsets, widths, nc,
                                    cull != 0, r, alive, inv_dx, inv_dy,
                                    inv_dz, s_rows, s_box, best_t, best_i);
  t_out[slot] = best_t;
  i_out[slot] = best_i;
  if (threadIdx.x == 0) passes[blockIdx.x] = n_pass;
}

}  // namespace

extern "C" int cluster_sweep_launch(const float* feats, const float* boxes,
                                    const int* offsets, const int* widths,
                                    int nc, const float* state, long np,
                                    int ray_tile, int cull, float* t_out,
                                    int* i_out, int* passes, void* stream) {
  const int grid = (int)(np / ray_tile);
  if (grid > 0)
    cluster_sweep_kernel<<<grid, ray_tile, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        feats, boxes, offsets, widths, nc, state, np, cull, t_out, i_out,
        passes);
  return (int)cudaGetLastError();
}
