// The dense texture/sky post-pass as one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: rtm_tpu's post-pass
// (rtm_tpu/ops/pallas/megakernel.py mega_postpass_dense) is plain XLA, and
// the port first ran it as a chain of torch ops.  That chain launched
// dozens of kernels per frame, each re-reading (bounces, n)-sized
// temporaries, and held the textured 1280x720, 4-sample, 8-bounce dispatch
// at ~24 ms on the H100 against the tracing kernel's ~2.5 ms; its
// launches were most of the host's work per interactive frame.  Plain
// version and wrapper: rtm_tpu_torch/ops/kernels/megakernel.py
// (mega_postpass_dense, mega_postpass).
//
// What it computes, per dispatch slot, in the dense form's order
// (_dense_frame, then _add_sky): for each frame f, for each bounce b, the
// record's emission-known term s times the running albedo product pt is
// added to the slot's color, times the record's bilinear texture tap where
// the record is textured (texid > -0.5), and pt takes the tap too; then
// the frame's miss record adds contribution * environment(direction) *
// draw_environment (* pt when the scene is textured).  The environment is
// the equirect sky map through its quad table (clamp-to-edge, the
// lower-edge weight collapse of shade.py sample_quads) or the procedural
// sun/sky (shade.py procedural_sun_sky).  A sphere record carries its
// normal, and its uv is (atan2(z, x) / 2pi + 0.5, asin(y) / pi + 0.5) as
// megakernel.py _tex_uv_of_records takes it.  Last, the sum over frames is
// divided by the frame count and written as (n, 3).
//
// Arithmetic: the plain version's float operations in its order, built with
// --fmad=false, so the kernel is bitwise the plain version run by PyTorch
// on the card.  PyTorch's CUDA division of a tensor by a host scalar (x /
// 255.0, u / TWO_PI, color / frames, the smoothstep spans) multiplies by
// the scalar's f32 reciprocal, and so does this kernel.  Where the plain
// version takes atan2, asin and pow, so does this kernel (CUDA's atan2f,
// asinf, powf); the sun's dot product, which PyTorch hands to cuBLAS, is
// summed in order here.
//
// What bounds it on the H100: bytes.  Each slot reads its 8 * frames *
// bounces record fields, 8 * frames miss fields and 3 color values once and
// writes 3: at 1280x720 with 4 samples and 8 bounces 1.08 GB, 0.32 ms at
// 3.35 TB/s.  The texture and sky tables (64x64 and 64x128 texels of 16
// bytes) stay in L1/L2.
//
// What the design does about it.  One thread per slot, 256 per block, the
// color and pt in registers; a record field row is read by neighbouring
// threads at neighbouring addresses, so every load is coalesced, and a
// record's uv and sphere-flag rows are read only where it is textured (a
// warp with no textured lane skips them).  A texture or sky tap is one
// 16-byte load of the packed quad row (or three of the 48-byte f32 row).
// No shared memory, no atomics, one pass.  The variants (textured or not,
// spheres or not, packed or f32 texture quads, sky map packed or f32 or
// sun) are template parameters chosen once per launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;

// PyTorch's x / c on the card is x * (1.0f / c) (the f32 reciprocal,
// rounded once); these are those reciprocals of the plain version's
// divisors (shade.py TWO_PI and PI are the f32 values of 2pi and pi).
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvTwoPi = 1.0f / kTwoPi;
constexpr float kInvPi = 1.0f / kPi;
constexpr float kInv255 = 1.0f / 255.0f;
// the asin argument's clamp, -1.0 + 1e-6 and 1.0 - 1e-6 in double as in
// Python, then to f32
constexpr float kAsinLo = (float)(-1.0 + 1e-6);
constexpr float kAsinHi = (float)(1.0 - 1e-6);
// procedural_sun_sky's smoothsteps: (0.0, 0.4) and (-0.01, 0.0); each span
// e1 - e0 is a double in Python, its f32 reciprocal on the card
constexpr float kSkyLerpInv = 1.0f / (float)(0.4 - 0.0);
constexpr float kGroundE0 = (float)(-0.01);
constexpr float kGroundInv = 1.0f / (float)(0.0 - (-0.01));
constexpr float kSkyPow = 0.35f;    // float(np.float32(0.35))

enum Env { ENV_MAP_F32 = 0, ENV_MAP_PACKED = 1, ENV_SUN = 2 };

struct SunSky {
  float horizon[3], zenith[3], ground[3], sun[3];
};

struct Args {
  const float* color;                 // (n, 3) view: element (s, c)
  long long color_s0, color_s1;       //   at color[s * s0 + c * s1]
  const float* miss;                  // (8F, >= n) rows of miss_ld
  long long miss_ld;
  const float* rec;                   // (8FB, >= n) rows of rec_ld
  long long rec_ld;
  const void* tex_quads;              // (K*TH*TW, 4) i32 / (.., 12) f32
  const int* tex_size;                // (K, 2) true (H, W)
  int n_tex, tex_th, tex_tw;
  const void* sky_quads;              // (Hs*Ws, 4) i32 / (.., 12) f32
  int sky_h, sky_w;
  SunSky sun_sky;
  float env_scale;                    // 1.0 draw_environment, else 0.0
  int n, frames, bounces;
  float* out;                         // (n, 3)
};

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.remainder of int32: the sign of the divisor
__device__ __forceinline__ int py_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// One bilinear tap of quad row `row`: fx, fy are the lerp weights.
template <bool kPacked>
__device__ __forceinline__ void quad_tap(const void* quads, int row,
                                         float fx, float fy, float rgb[3]) {
  float t[4][3];
  if (kPacked) {
    const int4 q = __ldg(static_cast<const int4*>(quads) + row);
    const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k][0] = (float)(w[k] & 0xFF) * kInv255;
      t[k][1] = (float)((w[k] >> 8) & 0xFF) * kInv255;
      t[k][2] = (float)((w[k] >> 16) & 0xFF) * kInv255;
    }
  } else {
    const float4* p = static_cast<const float4*>(quads) + 3 * (long long)row;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k][0] = v[3 * k];
      t[k][1] = v[3 * k + 1];
      t[k][2] = v[3 * k + 2];
    }
  }
  const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = t[0][c] * gx + t[1][c] * fx;
    const float bot = t[2][c] * gx + t[3][c] * fx;
    rgb[c] = top * gy + bot * fy;
  }
}

// sample_texture_quads: repeat wrap within the texture's true extent.
template <bool kPacked>
__device__ __forceinline__ void texture_tap(const Args& a, int tex_id,
                                            float u, float v, float rgb[3]) {
  const int tid = min(max(tex_id, 0), a.n_tex - 1);
  const int h = __ldg(a.tex_size + 2 * tid);
  const int w = __ldg(a.tex_size + 2 * tid + 1);
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = py_mod(__float2int_rz(x0f), w);
  const int y0 = py_mod(__float2int_rz(y0f), h);
  quad_tap<kPacked>(a.tex_quads, tid * (a.tex_th * a.tex_tw) +
                                     y0 * a.tex_tw + x0, fx, fy, rgb);
}

// sky_color_quads: equirect uv, clamp-to-edge with the lower-edge weight
// collapse.
template <bool kPacked>
__device__ __forceinline__ void sky_map(const Args& a, float dx, float dy,
                                        float dz, float rgb[3]) {
  const float u = atan2f(dz, dx) * kInvTwoPi + 0.5f;
  const float v = asinf(clamp_nan(dy, kAsinLo, kAsinHi)) * kInvPi + 0.5f;
  const float x = u * (float)a.sky_w - 0.5f;
  const float y = v * (float)a.sky_h - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  float fx = x - x0f, fy = y - y0f;
  if (x0f < 0.0f) fx = 0.0f;
  if (y0f < 0.0f) fy = 0.0f;
  const int x0 = min(max(__float2int_rz(x0f), 0), a.sky_w - 1);
  const int y0 = min(max(__float2int_rz(y0f), 0), a.sky_h - 1);
  quad_tap<kPacked>(a.sky_quads, y0 * a.sky_w + x0, fx, fy, rgb);
}

__device__ __forceinline__ float smoothstep_poly(float t) {
  return (t * t) * (3.0f - 2.0f * t);
}

// procedural_sun_sky
__device__ __forceinline__ void sun_sky(const SunSky& k, float dx, float dy,
                                        float dz, float rgb[3]) {
  const float sky_lerp =
      powf(smoothstep_poly(clamp_nan((dy - 0.0f) * kSkyLerpInv, 0.0f, 1.0f)),
           kSkyPow);
  const float ground_to_sky = smoothstep_poly(
      clamp_nan((dy - kGroundE0) * kGroundInv, 0.0f, 1.0f));
  const float dot = dx * k.sun[0] + dy * k.sun[1] + dz * k.sun[2];
  const float d0 = isnan(dot) ? dot : fmaxf(dot, 0.0f);
  const float sun = powf(d0, 500.0f) * 100.0f;
  const float sun_on = sun * (ground_to_sky >= 1.0f ? 1.0f : 0.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float grad =
        k.horizon[c] + (k.zenith[c] - k.horizon[c]) * sky_lerp;
    const float col = k.ground[c] + (grad - k.ground[c]) * ground_to_sky;
    rgb[c] = col + sun_on;
  }
}

template <bool kTex, bool kSph, bool kTexPacked, int kEnv>
__global__ void __launch_bounds__(BLOCK)
    postpass_dense_kernel(const Args a) {
  const int slot = blockIdx.x * BLOCK + threadIdx.x;
  if (slot >= a.n) return;
  const float* cp = a.color + (long long)slot * a.color_s0;
  float col[3] = {__ldg(cp), __ldg(cp + a.color_s1),
                  __ldg(cp + 2 * a.color_s1)};
  for (int f = 0; f < a.frames; ++f) {
    float pt[3] = {1.0f, 1.0f, 1.0f};
    if (kTex) {
      for (int b = 0; b < a.bounces; ++b) {
        const long long ld = a.rec_ld;
        const float* r =
            a.rec + (long long)((f * a.bounces + b) * 8) * ld + slot;
        const float term[3] = {__ldg(r) * pt[0], __ldg(r + ld) * pt[1],
                               __ldg(r + 2 * ld) * pt[2]};
        const float texid = __ldg(r + 6 * ld);
        if (texid > -0.5f) {
          float u = __ldg(r + 3 * ld), v = __ldg(r + 4 * ld);
          if (kSph && __ldg(r + 7 * ld) > 0.5f) {
            const float rc = __ldg(r + 5 * ld);
            const float nu = atan2f(rc, u) * kInvTwoPi + 0.5f;
            v = asinf(clamp_nan(v, kAsinLo, kAsinHi)) * kInvPi + 0.5f;
            u = nu;
          }
          float tex[3];
          texture_tap<kTexPacked>(a, __float2int_rz(texid), u, v, tex);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            col[c] = col[c] + term[c] * tex[c];
            pt[c] = pt[c] * tex[c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) col[c] = col[c] + term[c];
        }
      }
    }
    const long long ld = a.miss_ld;
    const float* m = a.miss + (long long)(f * 8) * ld + slot;
    if (__ldg(m + 6 * ld) > 0.5f) {
      const float dx = __ldg(m), dy = __ldg(m + ld), dz = __ldg(m + 2 * ld);
      float env[3];
      if (kEnv == ENV_SUN) {
        sun_sky(a.sun_sky, dx, dy, dz, env);
      } else {
        sky_map<kEnv == ENV_MAP_PACKED>(a, dx, dy, dz, env);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float term = __ldg(m + (3 + c) * ld) * env[c] * a.env_scale;
        if (kTex) term = term * pt[c];
        col[c] = col[c] + term;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) col[c] = col[c] + 0.0f;
    }
  }
  const float inv_frames = 1.0f / (float)a.frames;
  float* o = a.out + 3 * (long long)slot;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = col[c] * inv_frames;
}

template <bool kTex, bool kSph, bool kTexPacked>
cudaError_t launch_env(const Args& a, int env, cudaStream_t stream) {
  const int grid = (a.n + BLOCK - 1) / BLOCK;
  switch (env) {
    case ENV_MAP_F32:
      postpass_dense_kernel<kTex, kSph, kTexPacked, ENV_MAP_F32>
          <<<grid, BLOCK, 0, stream>>>(a);
      break;
    case ENV_MAP_PACKED:
      postpass_dense_kernel<kTex, kSph, kTexPacked, ENV_MAP_PACKED>
          <<<grid, BLOCK, 0, stream>>>(a);
      break;
    default:
      postpass_dense_kernel<kTex, kSph, kTexPacked, ENV_SUN>
          <<<grid, BLOCK, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// sun_sky: 12 host floats, horizon, zenith, ground and sun direction rows
// (shade.py sun_sky_constants); read only when env == ENV_SUN.
extern "C" int postpass_dense_launch(
    const float* color, long long color_s0, long long color_s1,
    const float* miss, long long miss_ld, const float* rec, long long rec_ld,
    const void* tex_quads, int tex_packed, const int* tex_size, int n_tex,
    int tex_th, int tex_tw, const void* sky_quads, int env, int sky_h,
    int sky_w, const float* sun_sky, float env_scale, int textured,
    int have_sph, int n, int frames, int bounces, float* out, void* stream) {
  Args a;
  a.color = color;
  a.color_s0 = color_s0;
  a.color_s1 = color_s1;
  a.miss = miss;
  a.miss_ld = miss_ld;
  a.rec = rec;
  a.rec_ld = rec_ld;
  a.tex_quads = tex_quads;
  a.tex_size = tex_size;
  a.n_tex = n_tex;
  a.tex_th = tex_th;
  a.tex_tw = tex_tw;
  a.sky_quads = sky_quads;
  a.sky_h = sky_h;
  a.sky_w = sky_w;
  for (int c = 0; c < 3; ++c) {
    a.sun_sky.horizon[c] = sun_sky[c];
    a.sun_sky.zenith[c] = sun_sky[3 + c];
    a.sun_sky.ground[c] = sun_sky[6 + c];
    a.sun_sky.sun[c] = sun_sky[9 + c];
  }
  a.env_scale = env_scale;
  a.n = n;
  a.frames = frames;
  a.bounces = bounces;
  a.out = out;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (!textured) return (int)launch_env<false, false, false>(a, env, s);
  if (have_sph)
    return (int)(tex_packed ? launch_env<true, true, true>(a, env, s)
                            : launch_env<true, true, false>(a, env, s));
  return (int)(tex_packed ? launch_env<true, false, true>(a, env, s)
                          : launch_env<true, false, false>(a, env, s));
}
