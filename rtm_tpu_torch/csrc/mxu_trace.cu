// Brute-force pair-test path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rtm_tpu/ops/pallas/mxu_kernel.py:_make_mxu_kernel
// (launched by render_rays_mxu).  Plain version and wrapper:
// rtm_tpu_torch/ops/kernels/mxu_kernel.py (mxu_trace_plain, mxu_trace).
//
// What it computes, per dispatch slot: the whole frames x bounces loop of
// one ray — camera ray with both jitters, PCG draws, the sphere loop, the
// Pluecker pair test against every triangle of the Morton-ordered
// 128-triangle chunks (chunk bbox cull), the argmin with the table index
// packed into the low 11 bits of the ordering t, the exact f32 retest of the
// winner, attribute fetch, shading, scatter, and the deferred miss / texture
// records and optional packed winner records (hitrec), all written in slot
// order in the TPU kernel's row layouts so the post-pass is shared.  Color is
// written as 3 rows (the TPU kernel's rows 3-7 are always zero).
//
// What bounds it on the H100.  The pair test is ~74 FP32 operations per
// ray-triangle pair (four 10-term rows: 36 multiplies + 36 adds, 2 adds for
// det) plus a division for the few pairs that pass.  At 512^2 x 8 bounces x
// 2000 triangles that is ~3.1e11 operations, ~5 ms per frame at the data
// sheet's 67 TFLOP/s non-tensor FP32, before culling.  On the 34-triangle
// Cornell scene both bounds are small: ~4e9 pair operations per frame
// (~65 us) against ~79 MB of rec + miss + color rows written (~23 us at
// 3.35 TB/s); chip_smoke.py computes both from each run's rays.
//
// What the design does about it.  One thread per slot, 256 threads (four 8x8
// pixel blocks) per block; all ray state stays in registers for the whole
// loop, so device memory sees only the table reads and each output written
// once, coalesced (consecutive threads write consecutive columns).  The chunk
// rows (128 triangles x 40 f32 = 20 KB) are staged in shared memory once per
// block and chunk and read by every thread as broadcasts.  A chunk is skipped
// by the whole block when no live ray of the block passes its bbox slab test
// (__syncthreads_or), the counterpart of the TPU kernel's tile-uniform cull;
// dead and tail threads (slot >= n) stay in the loop so every barrier is
// reached by the whole block.  The pair test runs per thread in FP32 from the
// f32 rows (hi + lo of the TPU kernel's bf16 K-stack); the TPU layout devices
// (bf16x3 matmul, sublane replication, tile auto-pick, VMEM limits) do not
// carry over.
//
// Numerics that decide hits (the kernel's contract, mxu_kernel.py:398-432,
// 679-707): a pair passes when s1, s2, s3, tdet are all >= 0; it is ordered
// by tt = min(tdet / max(det, DET_EPS), 1e28) with an IEEE division; the
// table index is OR-ed into tt's low 11 bits and the packed float min wins;
// padding rows fail through their tdet = -1 constant.  The winner is retested
// from its plane (n, a.n) and t recovered exactly; if the retest fails the
// ray keeps its sphere or miss result; a sphere wins ties (strict <).
// hitrec = HR_TRI | scene row (info >> 16), or HR_SPH | sphere.
//
// Built with --fmad=false (rtm_tpu_torch/ops/kernels/build.py) so every
// operation rounds like the plain version; a later performance change may
// lift it once the comparison tolerance is restated.
#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_common.cuh"

using namespace rtm;

namespace {

constexpr int BLOCK = 256;
// Three blocks per SM caps the kernel at 80 registers (123 uncapped, with
// the shared shading tail).  On the H100 this is the faster choice on
// Cornell-size scenes, the slower on 2000-triangle ones (PERF.md).
constexpr int MIN_BLOCKS = 3;
constexpr int CHUNK = 128;
constexpr int ROW_W = 40;  // f32 per triangle: 4 rows x 10 ray features
constexpr int A_ROWS = 8;
constexpr uint32_t IDX_MASK = 0x7FFu;
constexpr int HR_TRI = 1 << 14;
constexpr int HR_SPH = 1 << 15;

struct Params {
  const float* camf;
  uint32_t frame_index;
  int pix0, n, width, height, block8, frames, bounces;
  const float* pair32;  // (nc*128, ROW_W)
  const float* attr;    // (nc*128, A_ROWS)
  const int* info;      // (nc*128,)
  const float* cbox;    // (nc, 8)
  int n_tris, nc;
  SideTabs tabs;
  int n_sph;
  float* color;         // (3, n)
  float* miss;          // (8F, n)
  float* rec;           // (8FB, n) or null (untextured)
  int* hitrec;          // (FB, n) or null
};

__device__ __forceinline__ float row_dot(const float* r, const float* f) {
  float s = r[0] * f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s = s + r[k] * f[k];
  return s + r[9];
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    mxu_trace_kernel(const Params p) {
  __shared__ float4 s_rows[CHUNK * ROW_W / 4];
  const float* rows = reinterpret_cast<const float*>(s_rows);

  const int slot = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = slot < p.n;
  const size_t n = (size_t)p.n;
  int xpix, ypix;
  slot_pixel(p.pix0 + slot, p.width, p.block8, xpix, ypix);
  const uint32_t lin_u = (uint32_t)(ypix * p.width + xpix);
  const CamBasis cb = camera_frame(p.camf, p.width, p.height, xpix, ypix);
  const bool have_tris = p.n_tris > 0;
  const bool have_sph = p.n_sph > 0;
  const bool textured = p.rec != nullptr;

  PathState s;
  s.col_r = s.col_g = s.col_b = 0.0f;
  for (int frame = 1; frame <= p.frames; ++frame) {
    s.seed = lin_u + (uint32_t)frame * p.frame_index * SEED_STRIDE;
    jittered_ray(s.seed, cb, s.o, s.d);
    s.ctr_r = s.ctr_g = s.ctr_b = 1.0f;
    s.alive = valid;
    s.m_d = {0.0f, 0.0f, 0.0f};
    s.m_cr = s.m_cg = s.m_cb = 0.0f;

    for (int b = 0; b < p.bounces; ++b) {
      s.seed = s.seed + (uint32_t)b;  // shader:659
      const V3 o = s.o, d = s.d;
      const bool alive = s.alive;
      float t_sph = BIG;
      int s_idx = 0;
      if (have_sph) sphere_nearest(p.tabs.sph, p.tabs.s_pad, o, d, t_sph, s_idx);

      bool use_tri = false;
      float t_hit = t_sph;
      int winfo = NO_TEX << 8;
      V3 w_sn = {0.0f, 0.0f, 0.0f};
      if (have_tris) {
        const V3 m = cross3(o, d);
        const float f[9] = {d.x, d.y, d.z, m.x, m.y, m.z, o.x, o.y, o.z};
        const float inv_dx = safe_inv(d.x), inv_dy = safe_inv(d.y),
                    inv_dz = safe_inv(d.z);
        float best = BIG;
        for (int c = 0; c < p.nc; ++c) {
          const float* bx = p.cbox + c * 8;
          const float t1x = (__ldg(bx + 0) - o.x) * inv_dx;
          const float t2x = (__ldg(bx + 3) - o.x) * inv_dx;
          const float t1y = (__ldg(bx + 1) - o.y) * inv_dy;
          const float t2y = (__ldg(bx + 4) - o.y) * inv_dy;
          const float t1z = (__ldg(bx + 2) - o.z) * inv_dz;
          const float t2z = (__ldg(bx + 5) - o.z) * inv_dz;
          const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
          const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                 fmaxf(t1z, t2z));
          const bool hit_c = alive && tf >= 0.0f && tn <= tf;
          if (!__syncthreads_or(hit_c)) continue;
          const float4* src =
              reinterpret_cast<const float4*>(p.pair32 + (size_t)c * CHUNK * ROW_W);
          for (int i = threadIdx.x; i < CHUNK * ROW_W / 4; i += BLOCK)
            s_rows[i] = __ldg(src + i);
          __syncthreads();
          if (alive) {
            const int t_end = min(CHUNK, p.n_tris - c * CHUNK);
            for (int t = 0; t < t_end; ++t) {
              const float* r = rows + t * ROW_W;
              const float s1 = row_dot(r, f);
              const float s2 = row_dot(r + 10, f);
              const float s3 = row_dot(r + 20, f);
              const float td = row_dot(r + 30, f);
              if (s1 >= 0.0f && s2 >= 0.0f && s3 >= 0.0f && td >= 0.0f) {
                const float det = s1 + s2 + s3;
                const float tt = fminf(td / fmaxf(det, DET_EPS), 1e28f);
                const uint32_t packed = (__float_as_uint(tt) & ~IDX_MASK) |
                                        (uint32_t)(c * CHUNK + t);
                best = fminf(best, __uint_as_float(packed));
              }
            }
          }
          __syncthreads();  // before the next chunk overwrites the rows
        }
        const bool got = best < 1e29f;
        const int win = min((int)(__float_as_uint(best) & IDX_MASK),
                            p.n_tris - 1);
        const float4* ar = reinterpret_cast<const float4*>(p.attr + (size_t)win * A_ROWS);
        const float4 a0 = __ldg(ar), a1 = __ldg(ar + 1);
        const int w_info = __ldg(p.info + win);
        // exact retest of the winner from its plane; t recovered exactly
        const float det_w = -(d.x * a0.x + d.y * a0.y + d.z * a0.z);
        const float tdet_w = o.x * a0.x + o.y * a0.y + o.z * a0.z - a0.w;
        const float t_ex = tdet_w / fmaxf(det_w, DET_EPS);
        use_tri = got && alive && det_w > DET_EPS && tdet_w >= 0.0f &&
                  t_ex < t_sph;  // sphere wins ties
        t_hit = use_tri ? t_ex : t_sph;
        winfo = use_tri ? w_info : (NO_TEX << 8);
        w_sn = {a1.x, a1.y, a1.z};
      }

      if (p.hitrec != nullptr && valid) {
        const bool hit = alive && t_hit < BIG;
        int hr = 0;
        if (have_tris && use_tri && alive) hr = HR_TRI | ((winfo >> 16) & 0x7FF);
        if (have_sph && hit && !use_tri) hr = HR_SPH | s_idx;
        p.hitrec[(size_t)((frame - 1) * p.bounces + b) * n + slot] = hr;
      }
      float rec[8];
      shade_tail(p.tabs, have_tris, have_sph, textured, use_tri, t_hit, winfo,
                 w_sn, s_idx, s, rec);
      if (textured && valid) {
        float* rr = p.rec + (size_t)(((frame - 1) * p.bounces + b) * 8) * n + slot;
#pragma unroll
        for (int j = 0; j < 8; ++j) rr[j * n] = rec[j];
      }
    }

    if (valid) write_miss(p.miss + (size_t)((frame - 1) * 8) * n + slot, n, s);
  }
  if (valid) {
    p.color[0 * n + slot] = s.col_r;
    p.color[1 * n + slot] = s.col_g;
    p.color[2 * n + slot] = s.col_b;
  }
}

}  // namespace

extern "C" int mxu_trace_launch(const float* camf, uint32_t frame_index,
                                int pix0, int n, int width, int height,
                                int frames, int bounces, const float* pair32,
                                const float* attr, const int* info,
                                const float* cbox, int n_tris, int nc,
                                const float* mat, const float* tex,
                                const float* sph, int s_pad, int n_sph,
                                float* color, float* miss, float* rec,
                                int* hitrec, void* stream) {
  Params p;
  p.camf = camf;
  p.frame_index = frame_index;
  p.pix0 = pix0;
  p.n = n;
  p.width = width;
  p.height = height;
  p.block8 = (width % 8 == 0 && height % 8 == 0) ? 1 : 0;
  p.frames = frames;
  p.bounces = bounces;
  p.pair32 = pair32;
  p.attr = attr;
  p.info = info;
  p.cbox = cbox;
  p.n_tris = n_tris;
  p.nc = nc;
  p.tabs = {mat, tex, sph, s_pad};
  p.n_sph = n_sph;
  p.color = color;
  p.miss = miss;
  p.rec = rec;
  p.hitrec = hitrec;
  const int grid = (n + BLOCK - 1) / BLOCK;
  mxu_trace_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
