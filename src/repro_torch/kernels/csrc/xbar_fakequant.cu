// Fakequant crossbar read for Hopper (sm_90a): the QAT-style projection of
// analog_mode="fakequant" (digital weights, crossbar I/O quantisation).
//
// Replaces the TPU kernel _fakequant_kernel of src/repro/kernels/
// xbar_vmm.py:247 (launched by fakequant_read_pallas), forward only:
//   y[t] = sum over row tiles i, in tile order from 0.0, of
//          ADC_t,i( DAC(x[t, tile i]) @ W[tile i, :] )
// with x (T, K) and W (K, N) float32 and, stage by stage:
//   * DAC round trip against one global scale sc = max|x| / in_levels
//     (computed by the wrapper): x / sc, round half to even, clip to
//     +-in_levels, times sc;
//   * per row tile (rows x all N columns) the f32 product q;
//   * per token and tile the ADC fake quant over the full output width:
//     sat = sat_sigmas * sqrt(sum_N q^2 / N + 1e-12), lsb = sat /
//     out_levels, code = clip(round(q / lsb), +-out_levels), code * lsb;
//   * the tiles' dequantised outputs summed in tile order.
//
// Design for this card.  The per-token ADC range spans all N columns of a
// tile (up to 6,144 for lm100m's fused w_upgate), so a block that owns a
// column block cannot quantise its own outputs: the read is two kernels.
//   1. fakequant_partial_kernel: one block per (column block of 64, row
//      slice, token block).  It stages 32 rows of W and the matching DAC-
//      quantised drives at a time in shared memory (quantised as they are
//      staged, in the reference's order of operations) and keeps a VB x 4
//      register block of products per thread: 16 * VB tokens x 64 columns.
//      It writes the f32 partial products to a (T, tiles, slices, N)
//      scratch.  A row slice is the whole row tile, except when the grid
//      would hold too few blocks to fill the card (decode): then each tile
//      is cut into 64-row slices, whose partials the epilogue sums in
//      slice order.
//   2. fakequant_epilogue_kernel: one block per token.  Each thread owns a
//      fixed set of columns for the whole read, kept in registers.  For
//      each tile in order it forms q (the slices summed in order), reduces
//      sum_N q^2 in a fixed tree order (warp shuffles, then the warps in
//      order), forms sat and lsb, and accumulates code * lsb from 0.0.
//
// What bounds it.  At decode (T <= 16) the work is 2T flops per weight, so
// the bytes of W bound it: 37.7 MB per lm100m layer in f32, about 11.3 us
// at 3.35 TB/s.  The row slices give every projection at least a few
// hundred blocks, each keeping 8 loads of W in flight per thread, and
// the epilogue keeps a slice's loads for all of a thread's columns in
// flight together (it has only T blocks at decode).  At
// prefill (T = 2048) the f32 product bounds it: 38.7 GFLOP per layer,
// about 0.58 ms at 67 TFLOP/s; VB = 4 gives 16 FMAs per 8 shared loads.
// Plain FP32 FMAs (no TF32, no wgmma); no cuBLAS: the product is this
// kernel's own loop, as the TPU kernel computes it in its body.  The times
// against the bounds are in PERF.md.
//
// Arithmetic: x / sc, q / lsb, sum / N, sat / out_levels and sqrt are
// IEEE-rounded (__fdiv_rn, __fsqrt_rn) and the epilogue's products and
// sums use explicit round-to-nearest intrinsics, so nvcc cannot contract
// them into FMAs.  Where every partial q and every sum_N q^2 is an exact
// float32 integer, the result is then bit-equal to the plain torch
// version.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 64;          // output columns of a block (16 threads x 4)
constexpr int kRC = 32;          // weight rows staged per chunk
constexpr int kSliceRows = 64;   // row slice when a tile is split
constexpr int kMinBlocks = 264;  // two blocks per SM before splitting
// The epilogue keeps a token's N outputs in registers: 32 per thread.
constexpr int kMaxColumns = 32 * kThreads;

struct PartialArgs {
  const float* x;   // (T, K)
  const float* w;   // (K, N)
  const float* sc;  // (1,): the DAC scale
  float* part;      // (T, tiles, slices, N)
  int T, K, N;
  int rows, slice, n_slices;
  float in_levels;
};

template <int VB>
__global__ void __launch_bounds__(kThreads)
fakequant_partial_kernel(PartialArgs a) {
  constexpr int kBT = 16 * VB;
  __shared__ float xs[kRC][kBT + 1];
  __shared__ float ws[kRC][kCB];

  const int cb = blockIdx.x, tb = blockIdx.z;
  const int tile = blockIdx.y / a.n_slices, s = blockIdx.y % a.n_slices;
  const int tile_end = min((tile + 1) * a.rows, a.K);
  const int r_lo = tile * a.rows + s * a.slice;
  const int r_hi = min(r_lo + a.slice, tile_end);
  const int c0 = cb * kCB, t0 = tb * kBT;
  const int T = a.T, K = a.K, N = a.N;
  const float sc = a.sc[0];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float acc[VB][4];
#pragma unroll
  for (int v = 0; v < VB; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += kRC) {
    // W chunk: consecutive threads walk a row of W (coalesced loads).
    float wv[kRC * kCB / kThreads];
#pragma unroll
    for (int i = 0; i < kRC * kCB / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kCB, c = e % kCB;
      wv[i] = (r0 + j < r_hi && c0 + c < N)
                  ? a.w[(size_t)(r0 + j) * N + c0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRC * kCB / kThreads; ++i) {
      const int e = tid + i * kThreads;
      ws[e / kCB][e % kCB] = wv[i];
    }
    // DAC round trip of the drives, as they are staged.
    for (int e = tid; e < kBT * kRC; e += kThreads) {
      const int b = e / kRC, j = e - b * kRC;
      float v = 0.f;
      if (t0 + b < T && r0 + j < r_hi) {
        v = rintf(__fdiv_rn(a.x[(size_t)(t0 + b) * K + r0 + j], sc));
        v = __fmul_rn(fminf(fmaxf(v, -a.in_levels), a.in_levels), sc);
      }
      xs[j][b] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kRC; ++j) {
      float w[4], xv[VB];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = ws[j][tx + 16 * u];
#pragma unroll
      for (int v = 0; v < VB; ++v) xv[v] = xs[j][ty + 16 * v];
#pragma unroll
      for (int v = 0; v < VB; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[v][u] = fmaf(xv[v], w[u], acc[v][u]);
    }
    __syncthreads();
  }

  const int n_tiles = gridDim.y / a.n_slices;
#pragma unroll
  for (int v = 0; v < VB; ++v) {
    const int t = t0 + ty + 16 * v;
    if (t >= T) continue;
    float* p = a.part + (((size_t)t * n_tiles + tile) * a.n_slices + s) * N;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + tx + 16 * u;
      if (c < N) p[c] = acc[v][u];
    }
  }
}

// One block per token; thread tid owns columns tid + j * kThreads, j < J,
// for the whole read.
template <int J>
__global__ void __launch_bounds__(kThreads)
fakequant_epilogue_kernel(const float* __restrict__ part,
                          float* __restrict__ y, int N, int n_tiles,
                          int n_slices, float out_levels, float sat_sigmas) {
  constexpr int kW = kThreads / 32;
  __shared__ float red[kW];
  __shared__ float total;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float n_f = (float)N;
  const float* pt = part + (size_t)t * n_tiles * n_slices * N;

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // q of the thread's columns: the slices summed in slice order.  The
    // loads are unconditional (a column past N reads column N - 1 and is
    // zeroed after the sum), so all J loads of a slice are in flight
    // together.
    const float* pi = pt + (size_t)i * n_slices * N;
    float qv[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      qv[j] = pi[min(tid + j * kThreads, N - 1)];
    for (int s = 1; s < n_slices; ++s) {
      const float* ps = pi + (size_t)s * N;
      float v[J];
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = ps[min(tid + j * kThreads, N - 1)];
#pragma unroll
      for (int j = 0; j < J; ++j) qv[j] = __fadd_rn(qv[j], v[j]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (tid + j * kThreads >= N) qv[j] = 0.f;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) ss = __fadd_rn(ss, __fmul_rn(qv[j], qv[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float s = red[0];
      for (int w = 1; w < kW; ++w) s = __fadd_rn(s, red[w]);
      total = s;
    }
    __syncthreads();
    const float sat = __fmul_rn(
        sat_sigmas, __fsqrt_rn(__fadd_rn(__fdiv_rn(total, n_f), 1e-12f)));
    const float lsb = __fdiv_rn(sat, out_levels);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float code = rintf(__fdiv_rn(qv[j], lsb));
      code = fminf(fmaxf(code, -out_levels), out_levels);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(code, lsb));
    }
    __syncthreads();  // red and total are rewritten by the next tile
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int n = tid + j * kThreads;
    if (n < N) y[(size_t)t * N + n] = acc[j];
  }
}

struct Plan {
  int n_tiles, slice, n_slices, vb;
  long long col_blocks, token_blocks;
};

Plan plan(int T, int K, int N, int rows) {
  Plan p;
  p.n_tiles = (K + rows - 1) / rows;
  p.vb = T <= 16 ? 1 : 4;
  p.col_blocks = (N + kCB - 1) / kCB;
  p.token_blocks = (T + 16 * p.vb - 1) / (16 * p.vb);
  p.slice = rows;
  p.n_slices = 1;
  const int depth = rows < K ? rows : K;  // rows a tile can hold
  if (p.col_blocks * p.n_tiles * p.token_blocks < kMinBlocks &&
      depth > kSliceRows) {
    p.slice = kSliceRows;
    p.n_slices = (depth + kSliceRows - 1) / kSliceRows;
  }
  return p;
}

template <int J>
void launch_epilogue(const float* part, float* y, int T, int N,
                     const Plan& p, float out_levels, float sat_sigmas,
                     cudaStream_t st) {
  fakequant_epilogue_kernel<J><<<T, kThreads, 0, st>>>(
      part, y, N, p.n_tiles, p.n_slices, out_levels, sat_sigmas);
}

}  // namespace

extern "C" {

// Floats of scratch a read needs: the partial products (T, tiles, slices,
// N).
long long xbar_fakequant_scratch_floats(int T, int K, int N, int rows) {
  if (T <= 0 || K <= 0 || N <= 0 || rows <= 0) return 0;
  const Plan p = plan(T, K, N, rows);
  return (long long)T * p.n_tiles * p.n_slices * N;
}

// Launches one fakequant read on `stream`: x (T, K) and w (K, N) into
// y (T, N), N <= 8192, with sc (1,) the DAC scale; all contiguous float32
// device arrays.  scratch holds xbar_fakequant_scratch_floats() floats.
// Returns the CUDA error code of the launches (0 on success).
int xbar_fakequant(const float* x, const float* w, const float* sc,
                   float* y, float* scratch, int T, int K, int N, int rows,
                   float in_levels, float out_levels, float sat_sigmas,
                   void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || rows <= 0 || N > kMaxColumns)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(T, K, N, rows);
  if ((long long)p.n_tiles * p.n_slices > 65535 || p.token_blocks > 65535 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PartialArgs a;
  a.x = x; a.w = w; a.sc = sc; a.part = scratch;
  a.T = T; a.K = K; a.N = N;
  a.rows = rows; a.slice = p.slice; a.n_slices = p.n_slices;
  a.in_levels = in_levels;
  const dim3 grid((unsigned)p.col_blocks, (unsigned)(p.n_tiles * p.n_slices),
                  (unsigned)p.token_blocks);
  if (p.vb == 1)
    fakequant_partial_kernel<1><<<grid, kThreads, 0, st>>>(a);
  else
    fakequant_partial_kernel<4><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (N <= 256)
    launch_epilogue<1>(scratch, y, T, N, p, out_levels, sat_sigmas, st);
  else if (N <= 1024)
    launch_epilogue<4>(scratch, y, T, N, p, out_levels, sat_sigmas, st);
  else if (N <= 2048)
    launch_epilogue<8>(scratch, y, T, N, p, out_levels, sat_sigmas, st);
  else if (N <= 4096)
    launch_epilogue<16>(scratch, y, T, N, p, out_levels, sat_sigmas, st);
  else
    launch_epilogue<32>(scratch, y, T, N, p, out_levels, sat_sigmas, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
