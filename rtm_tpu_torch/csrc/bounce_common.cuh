// Per-ray bounce semantics shared by the path-tracing kernels.
//
// __device__ counterparts of rtm_tpu_torch/ops/kernels/vreg_common.py (the
// plain versions), which port rtm_tpu/ops/pallas/vreg_common.py and the
// in-kernel helpers of rtm_tpu/ops/pallas/megakernel.py:345-391: PCG draws,
// vector helpers, NaN-safe slab reciprocals, camera ray generation with both
// jitters (shader:684-706), the sphere loop (shader:486-524), the textured-UV
// recovery (shader:257-268), the scatter step (shader:590-649), and the
// per-bounce shading tail both kernels run after their hit decision.
//
// Every expression keeps the plain version's operation order.  Built with
// --fmad=false and IEEE division / square root, so each operation rounds as
// the plain version's does; only the transcendental functions (cosf, sinf)
// differ from PyTorch's in the last place.
//
// The material, texture and sphere side tables are plain (rows, entries)
// f32 tables (ops/kernels/trav_kernel.py), read with ordinary indexed loads.
#pragma once

#include <cstddef>
#include <cstdint>

namespace rtm {

constexpr float BIG = 1e30f;                       // "miss" sentinel
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi)
constexpr float U2F = 5.9604644775390625e-08f;     // f32(256/4294967295) = 2^-24
constexpr float OFFSET = 1e-4f;                    // hit-point normal offset
constexpr float DET_EPS = 1e-12f;                  // backface gate
constexpr uint32_t SEED_STRIDE = 735529u;          // shader:697
constexpr int NO_TEX = 255;                        // texslot sentinel
constexpr int TAB_W = 128;                         // side-table entries

// material table rows (traced_mat_tab)
enum { M_ALR = 0, M_ALG, M_ALB, M_EMR, M_EMG, M_EMB, M_EMP, M_ROUGH, M_METAL,
       M_REFR, M_TEX };
// textured-triangle table rows (traced_tex_tab)
enum { X_LAX = 0, X_LAY, X_LAZ, X_ABX, X_ABY, X_ABZ, X_ACX, X_ACY, X_ACZ,
       X_U0, X_V0, X_U1, X_V1, X_U2, X_V2 };
// sphere table rows (traced_sph_tabs)
enum { SP_CX = 0, SP_CY, SP_CZ, SP_R, SP_ALR, SP_ALG, SP_ALB, SP_EMR, SP_EMG,
       SP_EMB, SP_EMP, SP_ROUGH, SP_METAL, SP_REFR, SP_TEX };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv = 1.0f / sqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z,
                                       1e-20f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

// PCG output hash (shader:123-128).
__device__ __forceinline__ uint32_t pcg(uint32_t s) {
  const uint32_t state = s * 747796405u + 2891336453u;
  const uint32_t shift = (state >> 28) + 4u;
  const uint32_t word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// fastRandom (shader:130-134) with the kernels' conversion: the top 24 bits.
// Advances the seed.
__device__ __forceinline__ float rand01(uint32_t& s) {
  s = pcg(s);
  return (float)(int)(s >> 8) * U2F;
}

// NaN-safe slab reciprocals: |d| clamped away from 0, sign kept.
__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  const float ds = fabsf(d) < eps ? (d >= 0.0f ? eps : -eps) : d;
  return 1.0f / ds;
}

struct CamBasis {
  V3 pos, fp, rt, up;
  float defocus, blur, wf, hf;
};

// Per-ray camera basis (shader:684-691).  camf is the 64-float row of
// megakernel._pack_camera: matrices column-major, m[i][j] at j*4+i.
__device__ __forceinline__ CamBasis camera_frame(const float* __restrict__ camf,
                                                 int width, int height,
                                                 int xpix, int ypix) {
  auto P = [&](int i, int j) { return __ldg(camf + j * 4 + i); };
  auto V = [&](int i, int j) { return __ldg(camf + 16 + j * 4 + i); };
  CamBasis cb;
  cb.pos = {__ldg(camf + 32), __ldg(camf + 33), __ldg(camf + 34)};
  const float focus_d = __ldg(camf + 35);
  cb.defocus = __ldg(camf + 36);
  cb.blur = __ldg(camf + 37);
  cb.wf = (float)width;
  cb.hf = (float)height;
  const float px = (float)xpix / cb.wf;
  const float py = (float)ypix / cb.hf;
  const float nx = 2.0f * px - 1.0f;
  const float ny = 2.0f * py - 1.0f;
  float cx = P(0, 0) * nx + P(0, 1) * ny + P(0, 2) + P(0, 3);
  float cy = P(1, 0) * nx + P(1, 1) * ny + P(1, 2) + P(1, 3);
  float cz = P(2, 0) * nx + P(2, 1) * ny + P(2, 2) + P(2, 3);
  const float cw = P(3, 0) * nx + P(3, 1) * ny + P(3, 2) + P(3, 3);
  const float inv_w = 1.0f / cw;
  cx = cx * inv_w;
  cy = cy * inv_w;
  cz = cz * inv_w;
  const float dx0 = (V(0, 0) * cx + V(0, 1) * cy + V(0, 2) * cz) * focus_d;
  const float dy0 = (V(1, 0) * cx + V(1, 1) * cy + V(1, 2) * cz) * focus_d;
  const float dz0 = (V(2, 0) * cx + V(2, 1) * cy + V(2, 2) * cz) * focus_d;
  cb.fp = {cb.pos.x + dx0, cb.pos.y + dy0, cb.pos.z + dz0};
  cb.rt = {V(0, 0), V(1, 0), V(2, 0)};
  cb.up = {V(0, 1), V(1, 1), V(2, 1)};
  return cb;
}

// Defocus + blur disk jitters (shader:699-706); consumes 4 draws.
__device__ __forceinline__ void jittered_ray(uint32_t& seed,
                                             const CamBasis& cb, V3& o,
                                             V3& d) {
  const float r1 = rand01(seed);
  const float ang = r1 * TWO_PI;
  const float r2 = rand01(seed);
  const float rad = sqrtf(r2);
  const float fjx = cosf(ang) * rad / cb.wf * cb.defocus;
  const float fjy = sinf(ang) * rad / cb.hf * cb.defocus;
  const float r3 = rand01(seed);
  const float ang2 = r3 * TWO_PI;
  const float r4 = rand01(seed);
  const float rad2 = sqrtf(r4);
  const float djx = cosf(ang2) * rad2 / cb.wf * cb.blur;
  const float djy = sinf(ang2) * rad2 / cb.hf * cb.blur;
  o = {cb.pos.x + fjx * cb.rt.x + fjy * cb.up.x,
       cb.pos.y + fjx * cb.rt.y + fjy * cb.up.y,
       cb.pos.z + fjx * cb.rt.z + fjy * cb.up.z};
  const V3 t = {cb.fp.x + djx * cb.rt.x + djy * cb.up.x,
                cb.fp.y + djx * cb.rt.y + djy * cb.up.y,
                cb.fp.z + djx * cb.rt.z + djy * cb.up.z};
  d = normalize3({t.x - o.x, t.y - o.y, t.z - o.z});
}

// Nearest sphere over the (SP_ROWS, s_pad) table; a later sphere must be
// strictly nearer.  Padding spheres (centre BIG, r = 0) never pass.
__device__ __forceinline__ void sphere_nearest(const float* __restrict__ sph,
                                               int s_pad, V3 o, V3 d,
                                               float& t_sph, int& s_idx) {
  t_sph = BIG;
  s_idx = 0;
  for (int s = 0; s < s_pad; ++s) {
    const float ocx = o.x - __ldg(sph + SP_CX * s_pad + s);
    const float ocy = o.y - __ldg(sph + SP_CY * s_pad + s);
    const float ocz = o.z - __ldg(sph + SP_CZ * s_pad + s);
    const float rr = __ldg(sph + SP_R * s_pad + s);
    const float a_q = d.x * d.x + d.y * d.y + d.z * d.z;
    const float b_q = 2.0f * (ocx * d.x + ocy * d.y + ocz * d.z);
    const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr;
    const float delta = b_q * b_q - 4.0f * a_q * c_q;
    const bool okd = delta >= 0.0f;
    const float tq = (-b_q - sqrtf(okd ? delta : 0.0f)) / (2.0f * a_q);
    if (okd && tq >= 0.0f && tq < t_sph) {
      t_sph = tq;
      s_idx = s;
    }
  }
}

// Space-mixed barycentric UV of textured triangle `slot` (shader:257-268).
__device__ __forceinline__ void tex_uv(const float* __restrict__ tex,
                                       int slot, V3 o, V3 d, float& uu,
                                       float& vv) {
  auto X = [&](int row) { return __ldg(tex + row * TAB_W + slot); };
  const V3 ao = {o.x - X(X_LAX), o.y - X(X_LAY), o.z - X(X_LAZ)};
  const V3 ab = {X(X_ABX), X(X_ABY), X(X_ABZ)};
  const V3 ac = {X(X_ACX), X(X_ACY), X(X_ACZ)};
  const V3 da = cross3(ao, d);
  const V3 nv = cross3(ab, ac);
  const float detl = -(d.x * nv.x + d.y * nv.y + d.z * nv.z);
  const float invl = 1.0f / (detl == 0.0f ? 1.0f : detl);
  const float ub = (ac.x * da.x + ac.y * da.y + ac.z * da.z) * invl;
  const float vb = -(ab.x * da.x + ab.y * da.y + ab.z * da.z) * invl;
  const float wb = 1.0f - ub - vb;
  uu = X(X_U0) * wb + X(X_U1) * ub + X(X_U2) * vb;
  vv = X(X_V0) * wb + X(X_V1) * ub + X(X_V2) * vb;
}

// Scatter (shader:590-649).  The dielectric branch consumes 1 draw, the
// diffuse/specular branch 6; both are evaluated from the incoming seed and
// the chosen branch's seed is kept.  Returns the new origin and direction.
__device__ __forceinline__ void scatter_step(V3 d, V3 nh, V3 hp, float rough,
                                             float metal, float refr,
                                             uint32_t& seed, V3& n_o,
                                             V3& n_d) {
  const float d_dot_n = dot3(d, nh);
  const bool is_refract = refr > 1.0f;
  const bool is_front = d_dot_n < 0.0f;
  const float rt = is_front ? 1.0f / (refr == 0.0f ? 1.0f : refr) : refr;
  const V3 hn = is_front ? nh : V3{-nh.x, -nh.y, -nh.z};
  const float cos_t = fminf(-dot3(d, hn), 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
  const bool cannot = rt * sin_t > 1.0f;
  float r0 = (1.0f - rt) / (1.0f + rt);
  r0 = r0 * r0;
  const float omc = 1.0f - cos_t;
  const float r0p = r0 + (1.0f - r0) * omc * omc * omc * omc * omc;

  if (is_refract) {
    uint32_t s = seed;
    const float rr = rand01(s);
    const bool do_refl = cannot || (r0p > rr);
    const float ddh = dot3(d, hn);
    if (do_refl) {
      n_o = {hp.x + hn.x * OFFSET, hp.y + hn.y * OFFSET,
             hp.z + hn.z * OFFSET};
      n_d = {d.x - 2.0f * ddh * hn.x, d.y - 2.0f * ddh * hn.y,
             d.z - 2.0f * ddh * hn.z};
    } else {
      const float kk = 1.0f - rt * rt * (1.0f - ddh * ddh);
      const float sq = sqrtf(fmaxf(kk, 1e-12f));
      n_o = {hp.x - hn.x * OFFSET, hp.y - hn.y * OFFSET,
             hp.z - hn.z * OFFSET};
      if (kk >= 0.0f) {
        n_d = {rt * d.x - (rt * ddh + sq) * hn.x,
               rt * d.y - (rt * ddh + sq) * hn.y,
               rt * d.z - (rt * ddh + sq) * hn.z};
      } else {
        n_d = {0.0f, 0.0f, 0.0f};
      }
    }
    seed = s;
    return;
  }

  uint32_t s = seed;
  const float u1 = rand01(s);
  const float u2 = rand01(s);
  const float u3 = rand01(s);
  const V3 dd = normalize3({nh.x + 2.0f * u1 - 1.0f, nh.y + 2.0f * u2 - 1.0f,
                            nh.z + 2.0f * u3 - 1.0f});
  const float u4 = rand01(s);
  const float u5 = rand01(s);
  const float u6 = rand01(s);
  const float ddn2 = dot3(d, nh);
  const V3 sp = normalize3(
      {d.x - 2.0f * ddn2 * nh.x + (2.0f * u4 - 1.0f) * (1.0f - metal),
       d.y - 2.0f * ddn2 * nh.y + (2.0f * u5 - 1.0f) * (1.0f - metal),
       d.z - 2.0f * ddn2 * nh.z + (2.0f * u6 - 1.0f) * (1.0f - metal)});
  n_d = normalize3({dd.x * (1.0f - rough) + sp.x * rough,
                    dd.y * (1.0f - rough) + sp.y * rough,
                    dd.z * (1.0f - rough) + sp.z * rough});
  n_o = {hp.x + nh.x * OFFSET, hp.y + nh.y * OFFSET, hp.z + nh.z * OFFSET};
  seed = s;
}

// Dispatch slot -> pixel: 8x8 pixel blocks when both sides are multiples
// of 8 (megakernel.slot_to_xy), else row-major.
__device__ __forceinline__ void slot_pixel(int lin, int width, bool block8,
                                           int& xpix, int& ypix) {
  if (block8) {
    const int t = lin / 64, j = lin % 64, bw = width / 8;
    xpix = (t % bw) * 8 + j % 8;
    ypix = (t / bw) * 8 + j / 8;
  } else {
    xpix = lin % width;
    ypix = lin / width;
  }
}

// The material, texture and sphere side tables of a dispatch.
struct SideTabs {
  const float* mat;  // (M_ROWS, TAB_W)
  const float* tex;  // (X_ROWS, TAB_W) or null (untextured)
  const float* sph;  // (SP_ROWS, s_pad)
  int s_pad;
};

// One frame's path state of one ray (vreg_common.PathState); col sums over
// frames, the rest is reset at each frame's camera ray.
struct PathState {
  V3 o, d;
  uint32_t seed;
  bool alive;
  float ctr_r, ctr_g, ctr_b;
  float col_r, col_g, col_b;
  V3 m_d;
  float m_cr, m_cg, m_cb;
};

// Everything a bounce does after its hit decision (shader:545-666,
// vreg_common.shade_tail): material / sphere fetch, the triangle/sphere
// mix, the miss record, the texture record (rec[0..7], textured scenes) or
// the emission sum, the contribution update and the scatter.  The hit:
// use_tri, t_hit, winfo = mat | texslot<<8, w_sn = the winner's shading
// normal, s_idx = the nearest sphere.
__device__ __forceinline__ void shade_tail(const SideTabs& tb, bool have_tris,
                                           bool have_sph, bool textured,
                                           bool use_tri, float t_hit,
                                           int winfo, V3 w_sn, int s_idx,
                                           PathState& s, float rec[8]) {
  const V3 o = s.o, d = s.d;
  const bool hit = s.alive && t_hit < BIG;
  const float t_safe = hit ? t_hit : 0.0f;
  const V3 hp = {o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z};
  const float use_t = use_tri ? 1.0f : 0.0f;
  const float use_s = (hit && !use_tri) ? 1.0f : 0.0f;

  // triangle material (entry 0 on non-triangle lanes, weighted out)
  float tm[11];
  if (have_tris) {
    const int mid = winfo & 0xFF;
#pragma unroll
    for (int r = 0; r < 11; ++r) tm[r] = __ldg(tb.mat + r * TAB_W + mid);
  } else {
#pragma unroll
    for (int r = 0; r < 11; ++r) tm[r] = 0.0f;
    tm[M_TEX] = -1.0f;
  }
  float sm[15];
  V3 sn = {0.0f, 0.0f, 0.0f};
  if (have_sph) {
#pragma unroll
    for (int r = 0; r < 15; ++r) sm[r] = __ldg(tb.sph + r * tb.s_pad + s_idx);
    sn = normalize3({hp.x - sm[SP_CX], hp.y - sm[SP_CY], hp.z - sm[SP_CZ]});
  } else {
#pragma unroll
    for (int r = 0; r < 15; ++r) sm[r] = 0.0f;
    sm[SP_TEX] = -1.0f;
  }
  const V3 nh = have_tris
                    ? V3{w_sn.x * use_t + sn.x * use_s,
                         w_sn.y * use_t + sn.y * use_s,
                         w_sn.z * use_t + sn.z * use_s}
                    : V3{sn.x * use_s, sn.y * use_s, sn.z * use_s};
  auto mix = [&](int tr, int sr) { return tm[tr] * use_t + sm[sr] * use_s; };
  const float alr = mix(M_ALR, SP_ALR), alg = mix(M_ALG, SP_ALG),
              alb = mix(M_ALB, SP_ALB);
  const float emr = mix(M_EMR, SP_EMR), emg = mix(M_EMG, SP_EMG),
              emb = mix(M_EMB, SP_EMB);
  const float emp = mix(M_EMP, SP_EMP);
  const float rough = mix(M_ROUGH, SP_ROUGH);
  const float metal = mix(M_METAL, SP_METAL);
  const float refr = mix(M_REFR, SP_REFR);
  const float texid = mix(M_TEX, SP_TEX) + (-1.0f) * (1.0f - use_t - use_s);

  const bool live = s.alive && hit;
  if (s.alive && !hit) {
    s.m_d = d;
    s.m_cr = s.ctr_r;
    s.m_cg = s.ctr_g;
    s.m_cb = s.ctr_b;
  }
  const float livef = live ? 1.0f : 0.0f;
  if (textured) {
    const bool has_tex = texid > -0.5f && live;
    const float htf = has_tex ? 1.0f : 0.0f;
    rec[0] = s.ctr_r * (has_tex ? emp : emr * emp) * livef;
    rec[1] = s.ctr_g * (has_tex ? emp : emg * emp) * livef;
    rec[2] = s.ctr_b * (has_tex ? emp : emb * emp) * livef;
    float uu = 0.0f, vv = 0.0f;
    if (have_tris) {
      const int tslot = min(max((winfo >> 8) & 0xFF, 0), 127);
      tex_uv(tb.tex, tslot, o, d, uu, vv);
    }
    rec[3] = uu * use_t + sn.x * use_s;
    rec[4] = vv * use_t + sn.y * use_s;
    rec[5] = sn.z * use_s;
    rec[6] = has_tex ? texid : -1.0f;
    rec[7] = use_s * htf;
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

  if (live) {
    V3 n_o, n_d;
    scatter_step(d, nh, hp, rough, metal, refr, s.seed, n_o, n_d);
    s.o = n_o;
    s.d = n_d;
  }
  s.alive = live;
}

// Write one frame's 8 miss-record rows of slot `slot` (row stride n).
__device__ __forceinline__ void write_miss(float* mr, size_t n,
                                           const PathState& s) {
  mr[0 * n] = s.m_d.x;
  mr[1 * n] = s.m_d.y;
  mr[2 * n] = s.m_d.z;
  mr[3 * n] = s.m_cr;
  mr[4 * n] = s.m_cg;
  mr[5 * n] = s.m_cb;
  mr[6 * n] = (s.m_d.x * s.m_d.x + s.m_d.y * s.m_d.y + s.m_d.z * s.m_d.z) > 0.0f
                  ? 1.0f
                  : 0.0f;
  mr[7 * n] = 0.0f;
}

}  // namespace rtm
