// The path-tracing megakernel for Hopper (sm_90a): the fused bounce loop over
// SAH treelet clusters.
//
// Replaces the TPU kernel rtm_tpu/ops/pallas/megakernel.py:_make_kernel
// (launched by render_rays_megakernel).  Plain version and wrapper:
// rtm_tpu_torch/ops/kernels/megakernel.py (mega_trace_plain, mega_trace).
//
// What it computes, per dispatch slot: the whole frames x bounces loop of one
// ray — camera ray with both jitters, PCG draws, the nearest triangle by a
// sweep over the scene's SAH treelet clusters (tri_sweep.cuh: table order,
// or nearest-first), the sphere loop, the winner's 40 attributes, its exact
// t from its plane, shading, scatter, and the deferred miss / texture
// records in the TPU kernel's row layouts, so the post-pass is shared.
// Color is written as 3 rows (the TPU kernel's rows 3-7 are always zero).
//
// What bounds it on the H100.  Each (alive ray-bounce, cluster) costs a
// 25-operation slab test, and each (ray, row) of a swept cluster a
// 45-operation pair test (tri_sweep.cuh); shading is a few hundred FP32
// operations per alive ray-bounce.  The bytes are the tables (72 B per padded
// triangle plus the boxes and spheres) and the color / miss / rec rows
// written once.  chip_smoke.py computes both bounds from each run's alive
// rays and the clusters each tile swept.  On dragon_grid(56) a tile sweeps
// 2.5 of 768 clusters per bounce on average, but a block runs its tile's
// bounces one after another, and the tile that sweeps the most (270
// clusters over its 8 bounces) takes nearly the whole launch alone
// (chip_smoke.py [mega-big]): the time is the pair passes of a few tiles,
// each on one SM.  The TPU kernel is built around the VPU: tile-uniform
// culling, the one-hot MXU fetch of the winner's attributes and the deferred
// texture records all avoid a per-lane gather that Hopper has.
//
// What the design does about it.  One thread per slot and one thread block
// per ray tile (512 slots by default, rtm_tpu's tile); all ray state stays in
// registers for the whole loop.  The static-order sweep (tri_sweep.cuh
// `sweep_clusters`) stages the box table in shared memory a chunk at a time,
// finds the clusters some alive ray of the tile enters at all by per-warp
// slab tests (warps with no alive ray skip them), and only for those decides
// together whether to sweep (__syncthreads_or over its alive rays); a swept
// cluster's rows (<= 128 x 16 f32) are staged in shared memory and every
// thread reads them as broadcasts; a warp skips the rows none of its lanes
// can hit (tri_sweep.cuh `sweep_block`).  The box chunk shares its shared
// memory with the nearest-first sweep's scratch, since one launch runs only
// one of the two.  Dead rays keep sweeping with their last ray, as in rtm_tpu
// (their outputs are records no consumer reads), and no thread leaves the
// loops early, so every barrier sees the whole block; a block whose rays are
// all dead leaves the bounce loop together, and its remaining records keep
// the pre-fill (zeros, texid -1).  The winner's attributes are one row of
// the (T', 40) f32 table, read only for an alive triangle winner and zero
// otherwise, as rtm_tpu's one-hot product gives.
//
// Numerics: the hit is decided on the sweep's ordering t (exact
// tdet / max(det, eps); rtm_tpu multiplies by an approximate reciprocal),
// spheres win ties, and only then is t replaced by the plane's exact t on an
// alive triangle winner (megakernel.py:787-816).  Built with --fmad=false
// (rtm_tpu_torch/ops/kernels/build.py) so every operation rounds like the
// plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_common.cuh"
#include "tri_sweep.cuh"

using namespace rtm;

namespace {

constexpr int MAX_TILE = 512;
constexpr int NUM_ATTRS = 40;
// attribute-table columns (megakernel.py _A_*)
enum { A_NX = 0, A_NY, A_NZ, A_ALR, A_ALG, A_ALB, A_EMR, A_EMG, A_EMB, A_EMP,
       A_ROUGH, A_METAL, A_REFR, A_TEX, A_LAX, A_LAY, A_LAZ, A_ABX, A_ABY,
       A_ABZ, A_ACX, A_ACY, A_ACZ, A_U0, A_V0, A_U1, A_V1, A_U2, A_V2, A_GNX,
       A_GNY, A_GNZ, A_GAN };

struct Params {
  const float* camf;
  uint32_t frame_index;
  int pix0, n, width, height, block8, frames, bounces;
  const float* feats;   // (T', 16)
  const float* attrs;   // (T', NUM_ATTRS)
  const float* boxes;   // (nc, 8)
  const int* offsets;   // (nc,)
  const int* widths;    // (nc,)
  int nc, cull, ordered;
  const float* sph;     // (SP_ROWS, s_pad), rows as bounce_common.cuh SP_*
  int s_pad;
  float* color;         // (3, n)
  float* miss;          // (8F, n)
  float* rec;           // (8FB, n) or null (untextured)
  int* passes;          // (FB, tiles) or null
  int* winners;         // (FB, n) or null: the hit of each slot, as
                        // megakernel.MegaStats.winners
};

__global__ void __launch_bounds__(MAX_TILE) mega_trace_kernel(const Params p) {
  __shared__ float4 s_rows4[STAGE * NFEAT / 4];
  // the static and the nearest-first sweep never run in one launch
  __shared__ union {
    BoxScratch box;
    NearScratch near;
  } s_sc;
  float* s_rows = reinterpret_cast<float*>(s_rows4);

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = slot < p.n;
  const size_t n = (size_t)p.n;
  int xpix, ypix;
  slot_pixel(p.pix0 + slot, p.width, p.block8, xpix, ypix);
  const uint32_t lin_u = (uint32_t)(ypix * p.width + xpix);
  const CamBasis cb = camera_frame(p.camf, p.width, p.height, xpix, ypix);
  const bool have_tris = p.nc > 0;
  const bool have_sph = p.s_pad > 0;
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
      const int fb = (frame - 1) * p.bounces + b;
      if (!__syncthreads_or(s.alive)) {
        // every ray of the tile is dead: the remaining bounces keep the
        // pre-fill records and sweep nothing
        for (int k = fb; k < frame * p.bounces; ++k) {
          if (textured && valid) {
            float* rr = p.rec + (size_t)(k * 8) * n + slot;
#pragma unroll
            for (int j = 0; j < 8; ++j) rr[j * n] = j == 6 ? -1.0f : 0.0f;
          }
          if (p.passes != nullptr && threadIdx.x == 0)
            p.passes[(size_t)k * gridDim.x + blockIdx.x] = 0;
          if (p.winners != nullptr && valid)
            p.winners[(size_t)k * n + slot] = -1;
        }
        break;
      }
      s.seed = s.seed + (uint32_t)b;  // shader:659
      const V3 o = s.o, d = s.d;
      const bool alive = s.alive;

      // ---- nearest triangle: the cluster sweep -----------------------------
      float t_tri = BIG;
      int i_tri = -1;
      int n_pass = 0;
      if (have_tris) {
        const SweepRay r = make_sweep_ray(o.x, o.y, o.z, d.x, d.y, d.z);
        const float inv_dx = sweep_safe_inv(d.x), inv_dy = sweep_safe_inv(d.y),
                    inv_dz = sweep_safe_inv(d.z);
        n_pass = p.ordered
                     ? sweep_clusters_near(p.feats, p.boxes, p.offsets,
                                           p.widths, p.nc, r, alive, inv_dx,
                                           inv_dy, inv_dz, s_rows, s_sc.near,
                                           t_tri, i_tri)
                     : sweep_clusters(p.feats, p.boxes, p.offsets, p.widths,
                                      p.nc, p.cull != 0, r, alive, inv_dx,
                                      inv_dy, inv_dz, s_rows, s_sc.box, t_tri,
                                      i_tri);
      }
      if (p.passes != nullptr && threadIdx.x == 0)
        p.passes[(size_t)fb * gridDim.x + blockIdx.x] = n_pass;

      // ---- nearest sphere (shader:486-524) ---------------------------------
      float t_sph = BIG;
      int s_idx = 0;
      if (have_sph) sphere_nearest(p.sph, p.s_pad, o, d, t_sph, s_idx);

      // sphere wins ties; the hit is decided on the sweep's t
      const bool use_tri = t_tri < t_sph;
      float t_hit = use_tri ? t_tri : t_sph;
      const bool hit = t_hit < BIG;

      // ---- the winner's attributes: zero unless an alive triangle winner
      const bool fetch = use_tri && alive;
      const float* ar = p.attrs + (size_t)(fetch ? i_tri : 0) * NUM_ATTRS;
      auto E = [&](int j) { return fetch ? __ldg(ar + j) : 0.0f; };
      if (have_tris) {
        // exact hit distance of the winner from its plane
        const float gden =
            -(d.x * E(A_GNX) + d.y * E(A_GNY) + d.z * E(A_GNZ));
        const float t_ex =
            (o.x * E(A_GNX) + o.y * E(A_GNY) + o.z * E(A_GNZ) - E(A_GAN)) /
            (gden == 0.0f ? 1.0f : gden);
        if (fetch) t_hit = t_ex;
      }

      const float t_safe = hit ? t_hit : 0.0f;
      const V3 hp = {o.x + t_safe * d.x, o.y + t_safe * d.y,
                     o.z + t_safe * d.z};
      const float use_t = use_tri ? 1.0f : 0.0f;
      const float use_s = (hit && !use_tri) ? 1.0f : 0.0f;
      if (p.winners != nullptr && valid)
        p.winners[(size_t)fb * n + slot] =
            fetch ? i_tri : ((alive && use_s != 0.0f) ? -2 - s_idx : -1);
      const bool sph_win = have_sph && use_s != 0.0f;
      auto S = [&](int j) {
        return sph_win ? __ldg(p.sph + j * p.s_pad + s_idx) : 0.0f;
      };
      V3 sn = {0.0f, 0.0f, 0.0f};
      if (have_sph)
        sn = normalize3({hp.x - S(SP_CX), hp.y - S(SP_CY), hp.z - S(SP_CZ)});
      const V3 nh = {E(A_NX) * use_t + sn.x * use_s,
                     E(A_NY) * use_t + sn.y * use_s,
                     E(A_NZ) * use_t + sn.z * use_s};
      auto mix = [&](int a, int sr) { return E(a) * use_t + S(sr) * use_s; };
      const float alr = mix(A_ALR, SP_ALR), alg = mix(A_ALG, SP_ALG),
                  alb = mix(A_ALB, SP_ALB);
      const float emr = mix(A_EMR, SP_EMR), emg = mix(A_EMG, SP_EMG),
                  emb = mix(A_EMB, SP_EMB);
      const float emp = mix(A_EMP, SP_EMP);
      const float rough = mix(A_ROUGH, SP_ROUGH);
      const float metal = mix(A_METAL, SP_METAL);
      const float refr = mix(A_REFR, SP_REFR);
      const float texid = mix(A_TEX, SP_TEX) + (-1.0f) * (1.0f - use_t - use_s);

      const bool live = alive && hit;
      if (alive && !hit) {  // first (and only) miss: record for the sky
        s.m_d = d;
        s.m_cr = s.ctr_r;
        s.m_cg = s.ctr_g;
        s.m_cb = s.ctr_b;
      }
      const float livef = live ? 1.0f : 0.0f;
      if (textured) {
        const bool has_tex = texid > -0.5f && live;
        const float htf = has_tex ? 1.0f : 0.0f;
        // uv: the reference's space-mixed barycentrics (shader:257-268)
        const V3 ao = {o.x - E(A_LAX), o.y - E(A_LAY), o.z - E(A_LAZ)};
        const V3 ab = {E(A_ABX), E(A_ABY), E(A_ABZ)};
        const V3 ac = {E(A_ACX), E(A_ACY), E(A_ACZ)};
        const V3 da = cross3(ao, d);
        const V3 nv = cross3(ab, ac);
        const float detl = -(d.x * nv.x + d.y * nv.y + d.z * nv.z);
        const float invl = 1.0f / (detl == 0.0f ? 1.0f : detl);
        const float ub = (ac.x * da.x + ac.y * da.y + ac.z * da.z) * invl;
        const float vb = -(ab.x * da.x + ab.y * da.y + ab.z * da.z) * invl;
        const float wb = 1.0f - ub - vb;
        const float uu = E(A_U0) * wb + E(A_U1) * ub + E(A_U2) * vb;
        const float vv = E(A_V0) * wb + E(A_V1) * ub + E(A_V2) * vb;
        if (valid) {
          float* rr = p.rec + (size_t)(fb * 8) * n + slot;
          rr[0 * n] = s.ctr_r * (has_tex ? emp : emr * emp) * livef;
          rr[1 * n] = s.ctr_g * (has_tex ? emp : emg * emp) * livef;
          rr[2 * n] = s.ctr_b * (has_tex ? emp : emb * emp) * livef;
          rr[3 * n] = uu * use_t + sn.x * use_s;
          rr[4 * n] = vv * use_t + sn.y * use_s;
          rr[5 * n] = sn.z * use_s;
          rr[6 * n] = has_tex ? texid : -1.0f;
          rr[7 * n] = use_s * htf;
        }
        // P^m *= (tex ? 1 : albedo)
        const float keep = 1.0f - livef * (1.0f - htf);
        s.ctr_r = s.ctr_r * (keep + livef * (1.0f - htf) * alr);
        s.ctr_g = s.ctr_g * (keep + livef * (1.0f - htf) * alg);
        s.ctr_b = s.ctr_b * (keep + livef * (1.0f - htf) * alb);
      } else {
        s.col_r = s.col_r + emr * emp * s.ctr_r * livef;
        s.col_g = s.col_g + emg * emp * s.ctr_g * livef;
        s.col_b = s.col_b + emb * emp * s.ctr_b * livef;
        s.ctr_r = s.ctr_r * (1.0f - livef + livef * alr);
        s.ctr_g = s.ctr_g * (1.0f - livef + livef * alg);
        s.ctr_b = s.ctr_b * (1.0f - livef + livef * alb);
      }

      // ---- scatter (shader:590-649) ----------------------------------------
      if (live) {
        V3 n_o, n_d;
        scatter_step(d, nh, hp, rough, metal, refr, s.seed, n_o, n_d);
        s.o = n_o;
        s.d = n_d;
      }
      s.alive = live;
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

extern "C" int mega_trace_launch(const float* camf, uint32_t frame_index,
                                 int pix0, int n, int width, int height,
                                 int frames, int bounces, int ray_tile,
                                 const float* feats, const float* attrs,
                                 const float* boxes, const int* offsets,
                                 const int* widths, int nc, int cull,
                                 int ordered, const float* sph, int s_pad,
                                 float* color, float* miss, float* rec,
                                 int* passes, int* winners, void* stream) {
  if (ray_tile <= 0 || ray_tile > MAX_TILE || ray_tile % 32 != 0 ||
      (ordered && nc > KEY_LANES))
    return (int)cudaErrorInvalidValue;
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
  p.feats = feats;
  p.attrs = attrs;
  p.boxes = boxes;
  p.offsets = offsets;
  p.widths = widths;
  p.nc = nc;
  p.cull = cull;
  p.ordered = ordered;
  p.sph = sph;
  p.s_pad = s_pad;
  p.color = color;
  p.miss = miss;
  p.rec = rec;
  p.passes = passes;
  p.winners = winners;
  const int grid = (n + ray_tile - 1) / ray_tile;
  mega_trace_kernel<<<grid, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
