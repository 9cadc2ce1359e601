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
// What bounds it on the H100.  Per live ray-bounce and real triangle of a
// chunk its block passed, the pair test is a product on the tensor cores
// (counted as the non-zero products it needs, row_part below: 6 features x
// 5 parts for each edge row, 3 x 5 + 2 for the tdet row, 214 flop at 989
// TFLOP/s dense bf16; the kernel issues 240, whole K=16 and K=8 steps) and
// a selection of ~7 FP32 operations (67 TFLOP/s); per live ray-bounce the
// sphere tests and the shading tail add ~300 FP32 operations, and the
// kernel writes its rec + miss + color rows once (~79 MB per 512^2 x
// 8-bounce frame of the textured Cornell scene, ~23 us at 3.35 TB/s).
// On the 34-triangle Cornell scene the written bytes bound it; on 2000
// triangles the product does.  chip_smoke.py (mxu_bound) computes the
// three terms from each run's rays and the chunks each block passed.
//
// What the design does about it.  One thread per slot, 256 threads (four
// 8x8 pixel blocks) per block; the ray state stays in registers for the
// whole loop, and each output is written once, coalesced.  The pair pass
// runs on the tensor cores (mma.sync, bf16 in, f32 accumulate): M is a
// warp's 32 rays (two m16 tiles), N an 8-triangle group's s1, s2, s3 and
// tdet rows (four n8 tiles); K holds the table's A_hi and A_lo against the
// ray's features split into three bf16 parts, two K=16 steps for each edge
// row, a K=16 and a K=8 step for the tdet row (the layout at row_part
// below).  Each lane splits its features f = [d, o x d, o, 1] and writes
// them to its warp's ray tile in shared memory; the warp loads its A
// fragments once per bounce (ldmatrix) and keeps them in registers over
// every chunk.  A chunk's rows (64 B each) are staged with cp.async; a
// one-chunk scene's rows stay staged for the whole launch (one barrier per
// bounce), more chunks are double-buffered, and only the 8-triangle
// groups that hold real rows are staged and swept.  A lane's C fragment
// holds all four values of four (ray, triangle) pairs, so the test and the
// packing run per lane on the accumulators; the four lanes of a quad then
// reduce with fminf, and each ray's best reaches its owning lane by
// shuffles.  The chunk cull is block-uniform: each warp ORs the chunks its
// live rays enter, one barrier merges the warps' masks (__syncthreads_or
// for one chunk), and the block sweeps the chunks some live ray enters.  A
// warp with no live lane, and an m-tile of 16 dead rays, skips the sweep;
// every thread reaches every barrier, and dead and tail lanes of a sweeping
// m-tile supply rays and ignore the result.
//
// Numerics that decide hits (the kernel's contract, mxu_kernel.py:398-432,
// 679-707): a pair passes when s1, s2, s3, tdet are all >= 0 (a NaN fails);
// it is ordered by tt = min(tdet / max(det, DET_EPS), 1e28) with an IEEE
// division run only behind that gate; the table index is OR-ed into tt's
// low 11 bits and the packed float min (fminf, never NaN) wins; padding rows
// fail through their tdet = -1 constant.  The product is the f32 product of
// the table's 16-bit rows and the ray's f32 features (row_part below), the
// value the kernel's earlier per-thread FP32 dot products computed; the
// plain version keeps the TPU kernel's bf16x3, so a ray through an edge two
// triangles share may pick the other one.  The winner is retested from its
// plane (n, a.n) and t recovered exactly; if the retest fails the ray keeps
// its sphere or miss result; a sphere wins ties (strict <).
// hitrec = HR_TRI | scene row (info >> 16), or HR_SPH | sphere.
//
// Built with --fmad=false (rtm_tpu_torch/ops/kernels/build.py): everything
// outside the pair product rounds op by op like the plain version.
//
// mxu_nearest_launch runs the pair pass alone on given rays (the wrapper
// mxu_nearest, for tests and measurement).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_common.cuh"

using namespace rtm;

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MIN_BLOCKS = 3;
constexpr int CHUNK = 128;
constexpr int Q = 4;            // pair rows per triangle: s1, s2, s3, tdet
constexpr int KS = 48;          // bf16 per pair row: [A_hi | A_hi | A_lo]
constexpr int ROW_B = 64;       // staged bytes per pair row: 4 parts
constexpr int MAX_NC = 16;      // 2047 triangles: the 11-bit index pack
constexpr int RAY_B = 128;      // ray tile bytes per ray: 8 parts
constexpr int RAY_TILE_B = 32 * RAY_B;  // per warp
constexpr int A_ROWS = 8;
constexpr uint32_t IDX_MASK = 0x7FFu;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int HR_TRI = 1 << 14;
constexpr int HR_SPH = 1 << 15;

struct Params {
  const float* camf;
  uint32_t frame_index;
  int pix0, n, width, height, block8, frames, bounces;
  const __nv_bfloat16* pair;  // (nc, Q*128, KS)
  const float* attr;          // (nc*128, A_ROWS)
  const int* info;            // (nc*128,)
  const float* cbox;          // (nc, 8)
  int n_tris, nc;
  int rows_q;                 // staged rows per pair row kind (q)
  int buf_b;                  // bytes of one staging buffer
  SideTabs tabs;
  int n_sph;
  float* color;               // (3, n)
  float* miss;                // (8F, n)
  float* rec;                 // (8FB, n) or null (untextured)
  int* hitrec;                // (FB, n) or null
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every committed group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr) : "memory");
}

// d += A (16x16 row) * B (16x8 col), bf16 in, f32 accumulate; a0..a3 and
// b0, b1 in the PTX fragment layout
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A (16x8 row) * B (8x8 col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The product.  A pair row holds 16 bits of each f32 coefficient as A_hi +
// A_lo (the table's bf16 K-stack); the ray's f32 features split exactly
// into three bf16 parts, hi = bf16(f), md = bf16(f - hi) (the plain
// version's b_lo) and lo = bf16(f - hi - md).  The kernel takes every
// product of (A_hi + A_lo) . (hi + md + lo) but A_lo . lo (2^-24 of the
// term), the f32 product of the table's values.  The edge rows s1..s3 use
// features 0-5 only, the tdet row features 6-9 only, so each kind sums
// just its own: in bf16 pairs (words) W_k = A_hi[2k, 2k+1], L_k = A_lo[..]
// and HI_k, MD_k, LO_k of the ray (k = 0..4; feature 9, the constant 1,
// has md = lo = 0):
//   edge rows, two K=16 steps:
//     [W0 W1 W2 W0 | W1 W2 W0 W1] . [HI0 HI1 HI2 MD0 | MD1 MD2 LO0 LO1]
//     [W2 L0 L1 L2 | L0 L1 L2 0 ] . [LO2 HI0 HI1 HI2 | MD0 MD1 MD2 0  ]
//   tdet row, one K=16 and one K=8 step:
//     [W3 W4 W3 W4 | W3 W4 L3 L4] . [HI3 HI4 MD3 MD4 | LO3 LO4 HI3 HI4]
//     [L3 L4 0  0 ]               . [MD3 MD4 0   0  ]
//
// Staged pair row r: 64 B, four 16-byte parts j (the two steps' k-halves,
// as above), part j at j ^ ((r >> 1) & 3) so the 8 rows an ldmatrix reads
// fall in distinct banks.
__device__ __forceinline__ uint32_t row_part(uint32_t buf, int r, int j) {
  return buf + r * ROW_B + ((j ^ ((r >> 1) & 3)) << 4);
}

// Ray tile of a warp: ray i, 16-byte part j (the edge steps' four
// k-halves, the tdet steps' three, then zero) at part j ^ (i & 7).
__device__ __forceinline__ uint32_t ray_part(uint32_t tile, int i, int j) {
  return tile + i * RAY_B + ((j ^ (i & 7)) << 4);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void st_zero(uint32_t dst) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(dst), "r"(0u) : "memory");
}

// cp.async the real 8-triangle groups of chunk c into a staging buffer:
// rows q * rows_q + t for t < 8 * groups, in the word order above.  A
// global row is 96 B: A_hi's words W0-W7 at byte 0, A_lo's L0-L7 at 64.
__device__ __forceinline__ void stage_chunk(const Params& p, int c, int groups,
                                            uint32_t buf) {
  const int rows = groups * 8;
  const char* base = reinterpret_cast<const char*>(p.pair) +
                     (size_t)c * Q * CHUNK * KS * 2;
  for (int i = threadIdx.x; i < Q * rows; i += BLOCK) {
    const int q = i / rows, t = i - q * rows;
    const int r = q * p.rows_q + t;
    const char* w = base + (size_t)(q * CHUNK + t) * KS * 2;  // W0 at w
    const char* l = w + 64;                                    // L0 at l
    const uint32_t p0 = row_part(buf, r, 0), p1 = row_part(buf, r, 1),
                   p2 = row_part(buf, r, 2), p3 = row_part(buf, r, 3);
    if (q < 3) {
      cp_async8(p0, w);              // W0 W1 W2 W0
      cp_async4(p0 + 8, w + 8);
      cp_async4(p0 + 12, w);
      cp_async4(p1, w + 4);          // W1 W2 W0 W1
      cp_async4(p1 + 4, w + 8);
      cp_async8(p1 + 8, w);
      cp_async4(p2, w + 8);          // W2 L0 L1 L2
      cp_async4(p2 + 4, l);
      cp_async4(p2 + 8, l + 4);
      cp_async4(p2 + 12, l + 8);
      cp_async8(p3, l);              // L0 L1 L2 0
      cp_async4(p3 + 8, l + 8);
      st_zero(p3 + 12);
    } else {
      cp_async4(p0, w + 12);         // W3 W4 W3 W4
      cp_async4(p0 + 4, w + 16);
      cp_async4(p0 + 8, w + 12);
      cp_async4(p0 + 12, w + 16);
      cp_async4(p1, w + 12);         // W3 W4 L3 L4
      cp_async4(p1 + 4, w + 16);
      cp_async4(p1 + 8, l + 12);
      cp_async4(p1 + 12, l + 16);
      cp_async4(p2, l + 12);         // L3 L4 0 0
      cp_async4(p2 + 4, l + 16);
      st_zero(p2 + 8);
      st_zero(p2 + 12);
    }
  }
}

// One lane's best packed t per (ray, triangle) pair slot: rays g, g+8 of
// m-tile 0 and g+16, g+24 of m-tile 1 (g = lane >> 2).
struct Best {
  float v[4];
};

// A fragments of a warp's rays per m-tile: the edge steps' e[2][4], the
// tdet K=16 step's d[4] and K=8 step's d8[2] (PTX a0..a3 / a0, a1).
struct RayFrags {
  uint32_t e[2][2][4];
  uint32_t d[2][4];
  uint32_t d8[2][2];
};

// Sweep the real groups of staged chunk c for the warp's 32 rays; an m-tile
// whose 16 rays are all dead (bit mt of mt_live clear) is skipped.
__device__ __forceinline__ void sweep_chunk(const Params& p, int c,
                                            uint32_t buf, const RayFrags& a,
                                            uint32_t mt_live, Best& best) {
  const int lane = threadIdx.x & 31;
  const int real = min(CHUNK, p.n_tris - c * CHUNK);
  const int groups = (real + 7) >> 3;
  for (int g8 = 0; g8 < groups; ++g8) {
    // B fragments of the group's four n8 tiles: parts 0-3 of tile q
    uint32_t b[Q][4];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      ldsm_x4(row_part(buf, q * p.rows_q + g8 * 8 + (lane & 7), lane >> 3),
              b[q][0], b[q][1], b[q][2], b[q][3]);
    const uint32_t idx0 = (uint32_t)(c * CHUNK + g8 * 8 + 2 * (lane & 3));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!(mt_live >> mt & 1u)) continue;
      float acc[Q][4];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
        if (q < 3) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t(&e)[4] = a.e[mt][h];
            mma_bf16(acc[q], e[0], e[1], e[2], e[3], b[q][2 * h],
                     b[q][2 * h + 1]);
          }
        } else {
          const uint32_t(&d)[4] = a.d[mt];
          mma_bf16(acc[q], d[0], d[1], d[2], d[3], b[q][0], b[q][1]);
          mma_bf16_k8(acc[q], a.d8[mt][0], a.d8[mt][1], b[q][2]);
        }
      }
      // c0, c1: ray g, triangles idx0, idx0 + 1; c2, c3: ray g + 8
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s1 = acc[0][e], s2 = acc[1][e], s3 = acc[2][e],
                    td = acc[3][e];
        if (s1 >= 0.0f && s2 >= 0.0f && s3 >= 0.0f && td >= 0.0f) {
          const float det = s1 + s2 + s3;
          const float tt = fminf(td / fmaxf(det, DET_EPS), 1e28f);
          const uint32_t packed =
              (__float_as_uint(tt) & ~IDX_MASK) | (idx0 + (e & 1));
          float& bv = best.v[mt * 2 + (e >> 1)];
          bv = fminf(bv, __uint_as_float(packed));
        }
      }
    }
  }
}

// A one-chunk scene (kOne) keeps its chunk staged for the whole launch,
// beside the ray tiles; every thread calls this once before its first
// nearest_tri.
template <bool kOne>
__device__ __forceinline__ void resident_chunk(const Params& p,
                                               unsigned char* smem) {
  if (!kOne || p.n_tris <= 0) return;
  stage_chunk(p, 0, (p.n_tris + 7) >> 3,
              smem_addr(smem) + WARPS * RAY_TILE_B);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The nearest triangle of each lane's ray (packed t, BIG for none or a dead
// lane).  Called by every thread of the block; `pass_no` counts the calls.
template <bool kOne>
__device__ float nearest_tri(const Params& p, unsigned char* smem,
                             uint32_t* s_wmask, uint32_t pass_no, V3 o, V3 d,
                             bool alive) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t rows0 = smem_addr(smem);

  // the ray tile (with more than one chunk it aliases staging buffer 0,
  // free until the mask barrier)
  const uint32_t tile = rows0 + warp * RAY_TILE_B;
  {
    const V3 m = cross3(o, d);
    const float f[10] = {d.x, d.y, d.z, m.x, m.y, m.z, o.x, o.y, o.z, 1.0f};
    uint32_t hi[5], md[5], lo[5];
#pragma unroll
    for (int w = 0; w < 5; ++w) {
      __nv_bfloat16 h[2], e[2], l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float x = f[2 * w + u];
        h[u] = __float2bfloat16_rn(x);
        const float r1 = x - __bfloat162float(h[u]);
        e[u] = __float2bfloat16_rn(r1);
        l[u] = __float2bfloat16_rn(r1 - __bfloat162float(e[u]));
      }
      hi[w] = pack_bf16x2(h[0], h[1]);
      md[w] = pack_bf16x2(e[0], e[1]);
      lo[w] = pack_bf16x2(l[0], l[1]);
    }
    const uint32_t part[8][4] = {
        {hi[0], hi[1], hi[2], md[0]}, {md[1], md[2], lo[0], lo[1]},
        {lo[2], hi[0], hi[1], hi[2]}, {md[0], md[1], md[2], 0u},
        {hi[3], hi[4], md[3], md[4]}, {lo[3], lo[4], hi[3], hi[4]},
        {md[3], md[4], 0u, 0u},       {0u, 0u, 0u, 0u}};
#pragma unroll
    for (int j = 0; j < 7; ++j)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "r"(ray_part(tile, lane, j)), "r"(part[j][0]),
                      "r"(part[j][1]), "r"(part[j][2]), "r"(part[j][3])
                   : "memory");
  }
  __syncwarp();
  // ldmatrix matrix i = lane >> 3 (of x4; i < 2 of x2): rays mt * 16 +
  // (i & 1) * 8 + (lane & 7), the step's k-half i >> 1
  RayFrags a;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ray = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int half = (lane >> 4) & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_x4(ray_part(tile, ray, 2 * h + half), a.e[mt][h][0],
              a.e[mt][h][1], a.e[mt][h][2], a.e[mt][h][3]);
    ldsm_x4(ray_part(tile, ray, 4 + half), a.d[mt][0], a.d[mt][1],
            a.d[mt][2], a.d[mt][3]);
    ldsm_x2(ray_part(tile, ray, 6), a.d8[mt][0], a.d8[mt][1]);
  }

  const uint32_t live_lanes = __ballot_sync(FULL, alive);
  const bool warp_live = live_lanes != 0u;
  const uint32_t mt_live = (live_lanes & 0xFFFFu ? 1u : 0u) |
                           (live_lanes >> 16 ? 2u : 0u);
  Best best;
#pragma unroll
  for (int i = 0; i < 4; ++i) best.v[i] = BIG;

  // block-uniform chunk cull: the chunks some live ray of the block enters
  const float inv_dx = safe_inv(d.x), inv_dy = safe_inv(d.y),
              inv_dz = safe_inv(d.z);
  auto enters = [&](int c) {
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
    return tf >= 0.0f && tn <= tf;
  };
  if constexpr (kOne) {
    // the one chunk stays staged beside the ray tiles (resident_chunk)
    if (__syncthreads_or(alive && enters(0)) && warp_live)
      sweep_chunk(p, 0, rows0 + WARPS * RAY_TILE_B, a, mt_live, best);
  } else {
    uint32_t mine = 0;
    if (alive)
      for (int c = 0; c < p.nc; ++c)
        if (enters(c)) mine |= 1u << c;
    uint32_t* wm = s_wmask + (pass_no & 1) * WARPS;
    const uint32_t warp_mask = __reduce_or_sync(FULL, mine);
    if (lane == 0) wm[warp] = warp_mask;
    __syncthreads();
    uint32_t cmask = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) cmask |= wm[w];

    int c = cmask ? __ffs(cmask) - 1 : -1;
    if (c >= 0) stage_chunk(p, c, (min(CHUNK, p.n_tris - c * CHUNK) + 7) >> 3,
                            rows0);
    cp_async_commit();
    for (int k = 0; c >= 0; ++k) {
      const uint32_t later = cmask & ~((2u << c) - 1u);
      const int cn = later ? __ffs(later) - 1 : -1;
      if (cn >= 0)
        stage_chunk(p, cn, (min(CHUNK, p.n_tris - cn * CHUNK) + 7) >> 3,
                    rows0 + ((k + 1) & 1) * p.buf_b);
      cp_async_commit();
      cp_async_wait_prior();  // chunk c has landed
      __syncthreads();
      if (warp_live)
        sweep_chunk(p, c, rows0 + (k & 1) * p.buf_b, a, mt_live, best);
      __syncthreads();  // before the buffer is staged again
      c = cn;
    }
  }

  // quad fminf, then ray r's best from lane (r & 7) * 4, slot r >> 3
  float res = BIG;
  if (warp_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best.v[i] = fminf(best.v[i], __shfl_xor_sync(FULL, best.v[i], 1));
      best.v[i] = fminf(best.v[i], __shfl_xor_sync(FULL, best.v[i], 2));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __shfl_sync(FULL, best.v[i], (lane & 7) * 4);
      if ((lane >> 3) == i) res = v;
    }
  }
  return alive ? res : BIG;
}

template <bool kOne>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    mxu_trace_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t s_wmask[2 * WARPS];

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
  resident_chunk<kOne>(p, smem);

  uint32_t pass_no = 0;
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
        const float best =
            nearest_tri<kOne>(p, smem, s_wmask, pass_no++, o, d, alive);
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

// The pair pass alone on given rays (tests and measurement): rays (6, n)
// rows o, d; alive (n,) bool; best (n,) the packed key nearest_tri returns.
template <bool kOne>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    mxu_nearest_kernel(const Params p, const float* rays, const bool* alive,
                       float* best) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t s_wmask[2 * WARPS];
  const int slot = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = slot < p.n;
  const size_t n = (size_t)p.n;
  resident_chunk<kOne>(p, smem);
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (valid) {
    o = {rays[slot], rays[n + slot], rays[2 * n + slot]};
    d = {rays[3 * n + slot], rays[4 * n + slot], rays[5 * n + slot]};
  }
  const float b =
      nearest_tri<kOne>(p, smem, s_wmask, 0, o, d, valid && alive[slot]);
  if (valid) best[slot] = b;
}

// Params of the geometry tables; returns the dynamic shared memory bytes.
int geometry_params(Params& p, const void* pair, const float* attr,
                    const int* info, const float* cbox, int n_tris, int nc) {
  p.pair = static_cast<const __nv_bfloat16*>(pair);
  p.attr = attr;
  p.info = info;
  p.cbox = cbox;
  p.n_tris = n_tris;
  p.nc = nc;
  // one chunk: its real groups, staged once beside the ray tiles; more:
  // two buffers of 128 rows per q, the ray tiles aliasing the first
  p.rows_q = nc == 1 ? ((n_tris + 7) / 8) * 8 : CHUNK;
  if (p.rows_q < 8) p.rows_q = 8;
  p.buf_b = Q * p.rows_q * ROW_B;
  if (nc == 1) return WARPS * RAY_TILE_B + p.buf_b;
  return 2 * p.buf_b < WARPS * RAY_TILE_B ? WARPS * RAY_TILE_B : 2 * p.buf_b;
}

}  // namespace

extern "C" int mxu_trace_launch(const float* camf, uint32_t frame_index,
                                int pix0, int n, int width, int height,
                                int frames, int bounces, const void* pair,
                                const float* attr, const int* info,
                                const float* cbox, int n_tris, int nc,
                                const float* mat, const float* tex,
                                const float* sph, int s_pad, int n_sph,
                                float* color, float* miss, float* rec,
                                int* hitrec, void* stream) {
  if (nc < 1 || nc > MAX_NC) return (int)cudaErrorInvalidValue;
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
  const int smem = geometry_params(p, pair, attr, info, cbox, n_tris, nc);
  p.tabs = {mat, tex, sph, s_pad};
  p.n_sph = n_sph;
  p.color = color;
  p.miss = miss;
  p.rec = rec;
  p.hitrec = hitrec;
  auto kernel = nc == 1 ? mxu_trace_kernel<true> : mxu_trace_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch over n_tris triangles in nc chunks.
// the slots per thread block, the granule of the chunk cull (the wrapper
// checks it against mxu_kernel.py's BLOCK)
extern "C" int mxu_trace_block() { return BLOCK; }

extern "C" int mxu_trace_smem_bytes(int n_tris, int nc) {
  Params p = {};
  return geometry_params(p, nullptr, nullptr, nullptr, nullptr, n_tris, nc);
}

extern "C" int mxu_nearest_launch(const float* rays, const bool* alive, int n,
                                  const void* pair, const float* attr,
                                  const int* info, const float* cbox,
                                  int n_tris, int nc, float* best,
                                  void* stream) {
  if (nc < 1 || nc > MAX_NC || n_tris < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.n = n;
  const int smem = geometry_params(p, pair, attr, info, cbox, n_tris, nc);
  auto kernel = nc == 1 ? mxu_nearest_kernel<true> : mxu_nearest_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(p, rays,
                                                                   alive, best);
  return (int)cudaGetLastError();
}
