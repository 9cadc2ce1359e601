// The backward of a wide-row gather, out = table[idx], for Hopper (sm_90a):
// the table's gradient, one sum per (row, column) of the gathered rows'
// gradients, in a fixed order, with no float atomics.
//
// Replaces no TPU kernel: rtm_tpu gathers the replay's rows with jnp.take
// (rtm_tpu/ops/trace_ref.py _gather) and leaves the backward to XLA's
// scatter-add.  The port's replay (ops/trace_ref.py replay_payload) gathers
// one (N, 40) row a lane from the (T + S + 1, 40) primitive and material
// table each bounce; PyTorch's backward of that gather,
// index_put_(accumulate=True), sorts the indices and sums each distinct
// row's run in one sequential loop, so a table of a few dozen rows keeps
// only a few dozen warps busy: ~35 ms a bounce at 512x512 on the H100,
// most of the fit step.  Plain version and wrapper:
// rtm_tpu_torch/ops/kernels/row_grad.py (row_grad_plain, row_grad).
//
// What it computes.  The wrapper cuts the N lanes into `chunks` runs of
// `lanes_per_chunk` consecutive lanes (row_grad_plan).  Pass 1: block
// (chunk, tile) sums its chunk's lanes whose row lies in its tile of
// `tile_rows` rows into a private table in shared memory, lane by lane in
// lane order, and writes the table to its chunk's slice of `part` (chunks,
// rows, width).  Pass 2: one thread per (row, column) sums the chunks'
// partial tables in chunk order, from 0.  Each sum is a chain of f32 adds
// in that order (built with --fmad=false, there are only adds), so the
// kernel is bitwise its plain version and two runs are bitwise equal.
// Indices outside [0, rows) belong to no tile and are skipped; the gather
// whose backward this is has read every index it passes.
//
// What bounds it on the H100: bytes.  Each lane's gradient row (4 * width
// bytes) and its index (8 bytes) are read once and the table written once:
// at 512x512 and width 40, 262,144 * 168 B = 44 MB, 13 us at 3.35 TB/s.
//
// What the design does about it.  Thread c of a block's `width` threads
// owns column c: it alone reads and writes column c of the block's table,
// so no entry has two writers and no barrier is needed; neighbouring
// threads read neighbouring 4 B of a lane's row, so the loads coalesce,
// and they read one index (a broadcast).  Each thread loads the next
// UNROLL lanes while it adds the current UNROLL, so the global loads'
// latency hides behind the shared-memory adds.  The wrapper takes about
// four blocks per SM (`chunks` * tiles ~ 528), which keeps the partial
// tables small (3.0 MB at the Cornell box's 35 rows) and pass 2's sum of
// each entry short (528 adds).  A table larger than one tile's shared
// memory (48 KiB) is cut into tiles; each tile re-reads the lanes, so the
// bytes grow with the tile count there (8 tiles at the mxu tables' 2,176
// rows).
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 16;
constexpr int SUM_BLOCK = 64;
constexpr int SUM_UNROLL = 32;

// Lanes [lane, lane + UNROLL) of [.., hi): each one's row offset in the
// tile (-1 outside the tile or past hi) and column c of its gradient row.
__device__ __forceinline__ void load_lanes(
    const float* __restrict__ g, const long long* __restrict__ idx,
    long long lane, long long hi, int width, int c, long long r0, int nr,
    int (&r)[UNROLL], float (&v)[UNROLL]) {
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long l = lane + k;
    const bool ok = l < hi;
    const long long rr = ok ? __ldg(idx + l) - r0 : -1;
    r[k] = (rr >= 0 && rr < nr) ? (int)rr : -1;
    v[k] = ok ? __ldg(g + l * width + c) : 0.0f;
  }
}

// grid (chunks, tiles), `width` threads, tile_rows * width floats of
// dynamic shared memory.
__global__ void row_grad_partial_kernel(
    const float* __restrict__ g, const long long* __restrict__ idx, int n,
    int width, int rows, int tile_rows, int lanes_per_chunk,
    float* __restrict__ part) {
  extern __shared__ float table[];
  const int c = threadIdx.x;
  const long long r0 = (long long)blockIdx.y * tile_rows;
  const int nr = min(tile_rows, rows - (int)r0);
  for (int r = 0; r < nr; ++r) table[r * width + c] = 0.0f;
  const long long lo = (long long)blockIdx.x * lanes_per_chunk;
  const long long hi = min(lo + lanes_per_chunk, (long long)n);
  int r[UNROLL], rn[UNROLL];
  float v[UNROLL], vn[UNROLL];
  load_lanes(g, idx, lo, hi, width, c, r0, nr, r, v);
  for (long long lane = lo; lane < hi; lane += UNROLL) {
    load_lanes(g, idx, lane + UNROLL, hi, width, c, r0, nr, rn, vn);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (r[k] >= 0) table[r[k] * width + c] += v[k];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      r[k] = rn[k];
      v[k] = vn[k];
    }
  }
  float* dst = part + ((long long)blockIdx.x * rows + r0) * width + c;
  for (int r = 0; r < nr; ++r) {
    dst[(long long)r * width] = table[r * width + c];
  }
}

// One thread per entry (row * width + column) of the table's gradient:
// the chunks' partials summed in chunk order, from 0.
__global__ void row_grad_sum_kernel(const float* __restrict__ part,
                                    int chunks, int entries,
                                    float* __restrict__ out) {
  const int e = blockIdx.x * SUM_BLOCK + threadIdx.x;
  if (e >= entries) return;
  const float* p = part + e;
  float acc = 0.0f;
  int k = 0;
  for (; k + SUM_UNROLL <= chunks; k += SUM_UNROLL) {
    float v[SUM_UNROLL];
#pragma unroll
    for (int j = 0; j < SUM_UNROLL; ++j) {
      v[j] = __ldg(p + (long long)(k + j) * entries);
    }
#pragma unroll
    for (int j = 0; j < SUM_UNROLL; ++j) acc += v[j];
  }
  for (; k < chunks; ++k) acc += __ldg(p + (long long)k * entries);
  out[e] = acc;
}

}  // namespace

// g (n, width) f32 and idx (n,) i64 contiguous; part (chunks, rows, width)
// and out (rows, width) f32.  The wrapper checks the shapes and the plan
// (1 <= width <= 256, tile_rows * width * 4 <= 48 KiB, chunks *
// lanes_per_chunk >= n); both passes are launched on `stream`.  Returns the
// first launch error, or 0.
extern "C" int row_grad_launch(const float* g, const long long* idx, int n,
                               int width, int rows, int tile_rows,
                               int chunks, int lanes_per_chunk, float* part,
                               float* out, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, (rows + tile_rows - 1) / tile_rows);
  const size_t smem = (size_t)tile_rows * width * sizeof(float);
  row_grad_partial_kernel<<<grid, width, smem, s>>>(
      g, idx, n, width, rows, tile_rows, lanes_per_chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int entries = rows * width;
  row_grad_sum_kernel<<<(entries + SUM_BLOCK - 1) / SUM_BLOCK, SUM_BLOCK, 0,
                        s>>>(part, chunks, entries, out);
  return (int)cudaGetLastError();
}
