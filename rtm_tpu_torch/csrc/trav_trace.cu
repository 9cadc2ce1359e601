// Per-ray skip-link BVH traversal path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rtm_tpu/ops/pallas/trav_kernel.py:_make_trav_kernel
// (launched by render_rays_trav).  Plain version and wrapper:
// rtm_tpu_torch/ops/kernels/trav_kernel.py (trav_trace_plain, trav_trace).
//
// What it computes, per dispatch slot: the whole frames x bounces loop of
// one ray, as the mxu kernel does, with the triangle search done by the
// reference shader's own algorithm (RayTracing.shader:324-484): a
// stackless descent of a skip-link BVH over a SAH leaf cut,
// cur = hit ? cur + 1 : skip[cur], a node entered only when its slab entry
// distance is strictly below the ray's best t (which starts at the nearest
// sphere's), and every triangle of an entered leaf tested by Moller-Trumbore
// in slice order.  Shading, scatter and the deferred miss / texture records
// are the shared tail (bounce_common.cuh shade_tail), written in slot order
// in the mxu kernel's row layouts, so the post-pass is shared.  Optional
// per-slot stats: node visits and triangle tests, summed over frames and
// bounces.
//
// What bounds it on the H100.  Per node visit about 25 FP32 operations (the
// slab test: 6 subtractions, 6 multiplies, 10 min/max, 3 compares; the bf16
// unpack is integer work); per triangle test about 54 (the edge cross
// product, det, tdet, the second cross product, u, v, w, the min-chain gate,
// one division and the compares).  Bytes are small: the tables are read
// once (dragon_grid(56): 12 KB of node records, 4.7 MB of triangle rows)
// and each output written once (color + miss rows, 44 B a slot at one
// sample), ~17 MB a 512^2 frame, ~5 us at 3.35 TB/s.  So operations bound
// it: on dragon_grid(56) a leaf holds up to 256 triangles, and the leaf
// tests dominate.  chip_smoke.py counts both from each run's stats.
//
// What the design does about it.  One thread per slot, 128 threads per
// block.  All path state stays in registers for the whole loop.  The node
// table (at most 1024 16-byte records) is staged into shared memory at
// block entry, and a node visit reads it from there.  The descent stays
// per lane, but a lane that enters a leaf does not test it alone: it posts
// (base, count) and stops, the warp drains the posted leaves in lane order
// (lowest set bit of a ballot first), and for each one the owner's ray and
// best t are broadcast and lane j tests rows j, j + 32, ... with the same
// formulas, keeping its first strict minimum; a butterfly reduction takes
// the least t, the lower row on equal t.  So a lone live lane's 256-row
// leaf costs 8 warp steps instead of 256 while its warp's other lanes are
// done, dead or past the slot count, and a step reads 32 consecutive rows.
// Tail slots and dead rays take part as lanes that post nothing (they trace
// the last slot's ray and write nothing), so every lane reaches the warp
// collectives; the frame and bounce loops are uniform.  A triangle row is
// three 16-byte loads (vertex A and both edges); the shading normal and
// the packed material are fetched once, for the winner.
//
// A warp's time is then the sum of its lanes' leaf work, and that work is
// lopsided: on dragon_grid(56) a primary ray that grazes the instances
// toward the horizon enters tens of leaves (thousands of triangle tests)
// while a ray into the sky enters none, so a warp of neighbouring pixels
// may hold tens of times the mean work and run on alone at the end of the
// launch.  So threads take slots transposed (trav_trace_kernel): a warp's
// 32 slots lie across the whole dispatch and every warp gets near the mean
// work.  Each slot's result depends on its own ray only, so the outputs,
// written in slot order, do not change.
//
// The TPU's devices (a persistent per-lane bounce schedule, fixed node
// bursts, chunked per-lane gathers, VMEM scratch refs) exist for a vector
// unit and do not carry over.  Left for later: a leaf size chosen for this
// card (rtm_tpu's rule grows leaves to 256 triangles to keep TPU gathers
// few).
//
// Exactness of the drain: the serial loop keeps the least t below best
// (strict <, so the lowest row wins ties), and so does the reduction, since
// each lane keeps its own first strict minimum and the lexicographic
// (t, row) order is total on the values that can be kept (a NaN t is never
// below anything); the owner takes the result only if it is strictly below
// its best, so a sphere and earlier leaves win ties as before.
//
// Numerics (the contract with rtm_tpu's kernel, trav_kernel.py:546-639):
// a triangle passes when min(det - DET_EPS, tdet, udet, vdet, det - udet -
// vdet) >= 0 and is ordered by tdet / max(det, DET_EPS) with an IEEE
// division (the TPU multiplies by an approximate reciprocal); it replaces
// the winner only when strictly nearer, so a sphere wins ties and the first
// triangle in DFS-leaf then k order wins among equals; the winner's t is
// that same quotient.  Built with --fmad=false (build.py) so every operation
// rounds like the plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_common.cuh"

using namespace rtm;

namespace {

constexpr int BLOCK = 128;
constexpr int TF = 12;           // f32 per triangle row: A, AB, AC, normal
constexpr int MAX_NODES = 1024;  // the 10-bit skip links (trav_kernel.py)
constexpr uint32_t FULL = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;

struct Params {
  const float* camf;
  uint32_t frame_index;
  int pix0, n, width, height, block8, frames, bounces;
  const int4* node;      // (n_nodes, 4): x, y, z bf16 (lo | hi<<16), info
  const float* tri_feat; // (n_leaves * leaf_k, TF)
  const int* tri_info;   // (n_leaves * leaf_k,) mat | texslot<<8
  int n_nodes, leaf_k;
  SideTabs tabs;
  int n_sph;
  float* color;          // (3, n)
  float* miss;           // (8F, n)
  float* rec;            // (8FB, n) or null (untextured)
  int* stats;            // (2, n) or null
};

__device__ __forceinline__ float bf16_lo(int w) {
  return __uint_as_float((uint32_t)w << 16);
}

__device__ __forceinline__ float bf16_hi(int w) {
  return __uint_as_float((uint32_t)w & 0xFFFF0000u);
}

// The posted leaf of lane `owner` (rows base .. base + cnt - 1), tested by
// the whole warp: lane j takes rows k = j, j + 32, ... and keeps its first
// strict minimum below the owner's best; the reduction keeps the least t,
// the lower k on equal t.  The owner takes it when strictly below its best.
// Every lane of the warp calls this with the same owner.
__device__ __forceinline__ void drain_leaf(const Params& p, int owner,
                                           int base, int cnt, V3 o, V3 d,
                                           float& best, int& win) {
  const int lane = threadIdx.x & 31;
  const int lb = __shfl_sync(FULL, base, owner);
  const int lc = __shfl_sync(FULL, cnt, owner);
  const float ox = __shfl_sync(FULL, o.x, owner);
  const float oy = __shfl_sync(FULL, o.y, owner);
  const float oz = __shfl_sync(FULL, o.z, owner);
  const float dx = __shfl_sync(FULL, d.x, owner);
  const float dy = __shfl_sync(FULL, d.y, owner);
  const float dz = __shfl_sync(FULL, d.z, owner);
  float tl = __shfl_sync(FULL, best, owner);
  int kl = NO_ROW;
  for (int k = lane; k < lc; k += 32) {
    const float4* f =
        reinterpret_cast<const float4*>(p.tri_feat + (size_t)(lb + k) * TF);
    const float4 f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2);
    const float abx = f0.w, aby = f1.x, abz = f1.y;
    const float acx = f1.z, acy = f1.w, acz = f2.x;
    const float aox = ox - f0.x;
    const float aoy = oy - f0.y;
    const float aoz = oz - f0.z;
    const float nx = aby * acz - abz * acy;
    const float ny = abz * acx - abx * acz;
    const float nz = abx * acy - aby * acx;
    const float det = -(dx * nx + dy * ny + dz * nz);
    const float tdet = aox * nx + aoy * ny + aoz * nz;
    const float dax = aoy * dz - aoz * dy;
    const float day = aoz * dx - aox * dz;
    const float daz = aox * dy - aoy * dx;
    const float udet = acx * dax + acy * day + acz * daz;
    const float vdet = -(abx * dax + aby * day + abz * daz);
    const float wdet = det - udet - vdet;
    const float mm = fminf(fminf(det - DET_EPS, tdet),
                           fminf(fminf(udet, vdet), wdet));
    if (mm >= 0.0f) {
      const float t = tdet / fmaxf(det, DET_EPS);
      if (t < tl) {
        tl = t;
        kl = k;
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float t2 = __shfl_xor_sync(FULL, tl, m);
    const int k2 = __shfl_xor_sync(FULL, kl, m);
    if (t2 < tl || (t2 == tl && k2 < kl)) {
      tl = t2;
      kl = k2;
    }
  }
  if (lane == owner && tl < best) {
    best = tl;
    win = lb + kl;
  }
}

// Skip-link descent for one ray over the staged node table: on return
// `best` is the nearest accepted t (unchanged when no triangle beats its
// start value) and `win` the winner's tri_feat row, or -1.  A lane that is
// not `live` walks no node but joins the warp's leaf tests; every lane of
// the warp calls this.
__device__ __forceinline__ void trav_nearest(const Params& p,
                                             const int4* __restrict__ nodes,
                                             bool live, V3 o, V3 d,
                                             float& best, int& win,
                                             int& visits, int& tests) {
  const float inv_dx = safe_inv(d.x), inv_dy = safe_inv(d.y),
              inv_dz = safe_inv(d.z);
  int cur = live ? 0 : p.n_nodes;
  for (;;) {
    bool posted = false;
    int base = 0, cnt = 0;
    while (cur < p.n_nodes) {
      const int4 nd = nodes[cur];
      const float t1x = (bf16_lo(nd.x) - o.x) * inv_dx;
      const float t2x = (bf16_hi(nd.x) - o.x) * inv_dx;
      const float t1y = (bf16_lo(nd.y) - o.y) * inv_dy;
      const float t2y = (bf16_hi(nd.y) - o.y) * inv_dy;
      const float t1z = (bf16_lo(nd.z) - o.z) * inv_dz;
      const float t2z = (bf16_hi(nd.z) - o.z) * inv_dz;
      const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                             fminf(t1z, t2z));
      const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                             fmaxf(t1z, t2z));
      const float near = (tf >= 0.0f && tn <= tf) ? tn : BIG;
      ++visits;
      const uint32_t info = (uint32_t)nd.w;
      const int leaf1 = (int)((info >> 10) & 0x3FFu);
      if (near < best && leaf1 == 0) {  // internal: first child is next
        ++cur;
        continue;
      }
      cur = (int)(info & 0x3FFu);
      if (near < best) {  // a leaf: post it and wait for the warp
        cnt = (int)((info >> 20) & 0xFFFu);
        base = (leaf1 - 1) * p.leaf_k;
        tests += cnt;
        posted = true;
        break;
      }
    }
    uint32_t todo = __ballot_sync(FULL, posted);
    if (todo == 0u) return;  // every lane is past its last node
    do {
      const int owner = __ffs(todo) - 1;
      todo &= todo - 1u;
      drain_leaf(p, owner, base, cnt, o, d, best, win);
    } while (todo != 0u);
  }
}

__global__ void __launch_bounds__(BLOCK) trav_trace_kernel(const Params p) {
  __shared__ int4 s_node[MAX_NODES];
  for (int i = threadIdx.x; i < p.n_nodes; i += BLOCK)
    s_node[i] = __ldg(p.node + i);
  __syncthreads();

  // Thread t of the first 32 * cols threads traces slot (t % 32) * cols +
  // t / 32 (a transpose: a warp's 32 slots lie cols apart), the rest slot
  // t.  A tail thread traces the last slot's ray and writes nothing, so
  // that every lane reaches the warp's leaf tests.
  const int t = (int)(blockIdx.x * BLOCK + threadIdx.x);
  const int full = p.n & ~31, cols = full >> 5;
  const bool real = t < p.n;
  const int slot =
      t < full ? (t & 31) * cols + (t >> 5) : (real ? t : p.n - 1);
  const size_t n = (size_t)p.n;
  int xpix, ypix;
  slot_pixel(p.pix0 + slot, p.width, p.block8, xpix, ypix);
  const uint32_t lin_u = (uint32_t)(ypix * p.width + xpix);
  const CamBasis cb = camera_frame(p.camf, p.width, p.height, xpix, ypix);
  const bool have_tris = p.n_nodes > 0;
  const bool have_sph = p.n_sph > 0;
  const bool textured = p.rec != nullptr;

  int visits = 0, tests = 0;
  PathState s;
  s.col_r = s.col_g = s.col_b = 0.0f;
  for (int frame = 1; frame <= p.frames; ++frame) {
    s.seed = lin_u + (uint32_t)frame * p.frame_index * SEED_STRIDE;
    jittered_ray(s.seed, cb, s.o, s.d);
    s.ctr_r = s.ctr_g = s.ctr_b = 1.0f;
    s.alive = true;
    s.m_d = {0.0f, 0.0f, 0.0f};
    s.m_cr = s.m_cg = s.m_cb = 0.0f;

    for (int b = 0; b < p.bounces; ++b) {
      s.seed = s.seed + (uint32_t)b;  // shader:659
      float t_sph = BIG;
      int s_idx = 0;
      if (have_sph)
        sphere_nearest(p.tabs.sph, p.tabs.s_pad, s.o, s.d, t_sph, s_idx);

      bool use_tri = false;
      float t_hit = t_sph;
      int winfo = NO_TEX << 8;
      V3 w_sn = {0.0f, 0.0f, 0.0f};
      if (have_tris) {  // uniform: the whole warp walks together
        float best = t_sph;
        int win = -1;
        trav_nearest(p, s_node, real && s.alive, s.o, s.d, best, win,
                     visits, tests);
        if (win >= 0) {
          use_tri = true;
          t_hit = best;
          winfo = __ldg(p.tri_info + win);
          const float* f = p.tri_feat + (size_t)win * TF;
          w_sn = {__ldg(f + 9), __ldg(f + 10), __ldg(f + 11)};
        }
      }

      float rec[8];
      shade_tail(p.tabs, have_tris, have_sph, textured, use_tri, t_hit, winfo,
                 w_sn, s_idx, s, rec);
      if (textured && real) {
        float* rr = p.rec + (size_t)(((frame - 1) * p.bounces + b) * 8) * n + slot;
#pragma unroll
        for (int j = 0; j < 8; ++j) rr[j * n] = rec[j];
      }
    }
    if (real) write_miss(p.miss + (size_t)((frame - 1) * 8) * n + slot, n, s);
  }
  if (!real) return;
  p.color[0 * n + slot] = s.col_r;
  p.color[1 * n + slot] = s.col_g;
  p.color[2 * n + slot] = s.col_b;
  if (p.stats != nullptr) {
    p.stats[slot] = visits;
    p.stats[n + slot] = tests;
  }
}

}  // namespace

extern "C" int trav_trace_launch(const float* camf, uint32_t frame_index,
                                 int pix0, int n, int width, int height,
                                 int frames, int bounces, const int* node,
                                 const float* tri_feat, const int* tri_info,
                                 int n_nodes, int leaf_k, const float* mat,
                                 const float* tex, const float* sph, int s_pad,
                                 int n_sph, float* color, float* miss,
                                 float* rec, int* stats, void* stream) {
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
  p.node = reinterpret_cast<const int4*>(node);
  p.tri_feat = tri_feat;
  p.tri_info = tri_info;
  p.n_nodes = n_nodes;
  p.leaf_k = leaf_k;
  p.tabs = {mat, tex, sph, s_pad};
  p.n_sph = n_sph;
  p.color = color;
  p.miss = miss;
  p.rec = rec;
  p.stats = stats;
  if (n_nodes > MAX_NODES) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  trav_trace_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
