// Fakequant crossbar read for Hopper (sm_90a): the QAT-style projection of
// analog_mode="fakequant" (digital weights, crossbar I/O quantisation).
//
// Replaces the TPU kernel _fakequant_kernel of src/repro/kernels/
// xbar_vmm.py:247 (launched by fakequant_read_pallas), forward only:
//   y[t] = sum over row tiles i, in tile order from 0.0, of
//          ADC_t,i( DAC(x[t, tile i]) @ W[tile i, :] )
// with x (T, K) and W (K, N) float32 and, stage by stage:
//   * DAC round trip against one global scale sc = max(max|x|, 1e-12) /
//     in_levels: x / sc, round half to even, clip to +-in_levels, times sc;
//   * per row tile (rows x all N columns) the f32 product q;
//   * per token and tile the ADC fake quant over the full output width:
//     sat = sat_sigmas * sqrt(sum_N q^2 / N + 1e-12), lsb = sat /
//     out_levels, code = clip(round(q / lsb), +-out_levels), code * lsb;
//   * the tiles' dequantised outputs summed in tile order.
//
// Expert stacks.  A read may carry a lead dim: x (L, T, K) through W
// (L, K, N) into y (L, T, N), every lead matrix with its own DAC scale (the
// reference vmaps its read over MoE's experts).  The lead dim rides every
// kernel's grid (the scale kernel's y, the FP32 product's z with the token
// blocks, the tensor-core product's z with the row tiles, the epilogue's
// tokens), so a stack is one read of three launches, not three per
// expert.  The tensor-core pre-pass is a cooperative grid whose size never
// depends on L: it is capped at the CTAs co-resident on the card and
// strides over all L matrices' work; its scales take a second grid
// barrier.  A stack whose grid dims exceed the launch limits is refused
// with cudaErrorInvalidValue before anything launches: no read falls back
// to the plain version.  L = 1 is the plain (T, K) read.
//
// Three launches per read, for either instance (the DAC scale included):
//   1. the pre-pass.  FP32 instance: fakequant_scale_kernel, each CTA's
//      max|x|, one CTA or the last to finish forming the scale (the
//      product quantises the drives as it stages them).  Tensor-core
//      instance: fakequant_prepare_kernel, a cooperative (co-resident)
//      grid: max|x| and W split into three bf16 planes, a grid barrier,
//      then the scale and the integer DAC codes in bf16.  max is exact in
//      any order.
//   2. the product, one of two instances, picked by fakequant_instance()
//      in kernels/xbar_vmm.py from the operands (never from a failure):
//      fakequant_fp32_kernel or fakequant_tc_kernel.  Each writes q per
//      (token, tile, column) to scratch and, per (token, tile, 64-column
//      block), the block's sum of q^2 in a fixed order.
//   3. fakequant_epilogue_kernel, shared: one CTA per (token, column
//      chunk).  It reduces the token's range partials per tile over all
//      column blocks in one fixed order (the same in every CTA), forms
//      sat and lsb, and sums the tiles' dequantised codes in tile order.
//      The range is taken from any number of columns: there is no cap on
//      N, and the chunks spread the epilogue over the card at decode.
//
// Split range (tensor parallelism over the output columns).  A rank that
// holds only some of W's columns reads them through xbar_fakequant_split:
// the pre-pass and the product as above, and a copy of its range partials
// (each token and tile's sum of q^2 over each 64-column block) out of
// scratch.  The ranks' partials are gathered in the whole width's column
// order (outside this source: an ordered gather, no arithmetic), and
// xbar_fakequant_finish runs the epilogue on them, N the whole width: it
// reduces every block of the whole width in the whole read's fixed order,
// so the range, and each code, is the whole read's bit for bit wherever
// the blocks' partials are (the rank's columns start on a block).  A
// row-split read (each rank its own row tiles) takes the whole drive's
// DAC scale as an operand (sc_in, the ranks' max|x| combined): the FP32
// pre-pass then copies it and the tensor cores' pre-pass skips its max.
// It also copies its tiles' q out (q_out); the ranks' q and range
// partials are gathered in tile order (outside this source), and
// xbar_fakequant_tiles runs the epilogue over every tile: the tiles are
// summed in the whole read's order, so each rank holds the whole read's
// output bit for bit.
//
// FP32 instance (decode, prefill chunks and short prompts, T < 144, or
// DACs wider than 9 bits).  What bounds it: the bytes of W (2T flops per weight; 37.7 MB per
// lm100m layer in f32, 11.3 us at 3.35 TB/s).  W stays f32 (a bf16 copy
// would cost a pre-pass reading more bytes than the bound).  A CTA owns
// 128 columns (32 lanes x float4) of one row slice for up to 16 tokens;
// its 8 warps take the slice's rows in turn, each lane keeping 16 16-byte
// loads of W in flight (8 for 16 tokens, whose sums take the registers)
// with no barrier between them, each pass's drives quantised and staged in
// shared memory and the T x 4 sums in registers.  The warps' sums meet in
// a fixed tree.  A tile is cut into slices of a pass (128 rows, or 64 for
// 16 tokens), at most 8 and fewer while the grid would exceed eight CTAs
// an SM; the slices of a tile form a thread-block cluster, each leaving
// its partial in shared memory, and slice 0 sums them from distributed
// shared memory in slice order into q and the range partials: no buffer
// of partials and no launch of its own.
//
// Tensor-core instance (T >= 144 and in_levels <= 256: long prefills).  What
// bounds it: the products (2 T K N flops; 38.7 GFLOP per lm100m layer at
// T = 2048, 0.577 ms at the 67 TFLOP/s FP32 rate).  The DAC codes are
// integers of magnitude <= in_levels <= 256, exact in bf16; W splits into
// hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), whose sum is
// w exactly (for |w| >= 2^-110, or 0; below that the lost tail is under
// 2^-133).  Each 16x8 block of q is three m16n8k16 bf16 mma.sync products
// with float32 accumulation, code.lo + code.mid + code.hi: every product
// is exact in float32, so only the order of the sums differs from the
// plain version (and in the exact class, mid = lo = 0 and every sum is an
// exact integer below 2^24), then q = sc x sum.  A CTA owns 128 (or 64)
// tokens x 128 columns of one row tile in warps of 64 x 32, walking the
// tile through a 3-stage cp.async ring of unmasked, padded 16-byte
// copies with ldmatrix fragments (the recipe of csrc/xbar_vmm.cu's
// tc_read_kernel, with twice its warp tile: fewer fragment loads and
// fewer staged bytes per product).  The per-token range needs all N
// columns of a tile: q goes to scratch in
// float32 (94 MB per lm100m layer at T = 2048, written and read once,
// about 0.056 ms at 3.35 TB/s) rather than recomputing the products in a
// second pass, which would double the 0.117 ms tensor-core floor.
//
// Arithmetic: x / sc, q / lsb, sum / N, sat / out_levels and sqrt are
// IEEE-rounded (__fdiv_rn, __fsqrt_rn) and the epilogue's products and
// sums use explicit round-to-nearest intrinsics, so nvcc cannot contract
// them into FMAs.  Where every partial q and every sum_N q^2 is an exact
// float32 integer, the result is bit-equal to the plain torch version on
// both instances.  Nothing uses atomics for sums: every reduction has one
// fixed order, so the read is deterministic.  Build without
// --use_fast_math.  No cuBLAS: the products are this source's own loops.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScaleThreads = 1024;  // the FP32 instance's scale kernel
constexpr int kQCols = 64;          // columns of one range partial
constexpr int kMaxPrepCtas = 2048;  // a pre-pass grid's partial maxima
// Scratch head: the L scales, then the read's own pre-pass counts (L + 2,
// zeroed on its stream before a pre-pass that needs them), then the
// pre-pass CTAs' maxima, (L, pre-pass CTAs).

// FP32 instance
constexpr int kFpCols = 128;     // a CTA's columns: 32 lanes x float4
constexpr int kFpMaxSlices = 8;  // a tile's slices: the portable cluster
constexpr int kFpMaxTokens = 16;

// Tensor-core instance
constexpr int kTcTokPad = 128;     // the codes' token padding
constexpr int kTcBN = 128;         // a CTA's columns
constexpr int kTcKC = 32;          // tile lines a chunk
constexpr int kTcLd = kTcKC + 8;   // codes rows in shared memory (bf16)
constexpr int kFwdLd = kTcBN + 8;  // plane rows in shared memory (bf16)
constexpr int kStages = 3;
constexpr int kTcMaxLevels = 256;  // codes exact in bf16 up to here

// Slots of the launch record xbar_fakequant fills, one per kernel, counted
// where it is launched.
enum LaunchSlot {
  kSlotScale, kSlotPrepare, kSlotFp32, kSlotTc, kSlotEpilogue, kSlots
};

__device__ __forceinline__ float dac_code(float x, float sc, float levels) {
  const float v = rintf(__fdiv_rn(x, sc));
  return fminf(fmaxf(v, -levels), levels);
}

// --------------------------------------------------------------------------
// 1. The pre-pass: DAC scale, drives, and (tensor cores) the planes of W
// --------------------------------------------------------------------------

struct PrepArgs {
  const float* x;         // (L, T, K)
  const float* w;         // (L, K, N)
  float* sc;              // (L,) out: the DAC scales
  const float* sc_in;     // (L,) given DAC scales, or null: computed
  float* maxp;            // (L, grid CTAs) the CTAs' max|x|
  __nv_bfloat16* codes;   // tensor cores: (Tp, L * tiles, Rp) DAC codes
  __nv_bfloat16* planes;  // tensor cores: (3, L * tiles * Rp, Np) hi, mid,
                          // lo
  unsigned* bar;          // this read's zeroed counts: the scale kernel's,
                          // one a lead matrix; the tensor cores' first
                          // grid barrier's arrivals (bar[0]) ...
  unsigned* bar2;         // ... and its second's
  int L, T, K, N, rows, tiles, Tp, Rp, Np;
  float in_levels;
};

// A barrier over the whole grid, whose CTAs are co-resident (cooperative
// launch), used once a launch on a count the read zeroed before it.  The
// count lies in the read's own scratch, so reads in flight together on
// other streams cannot mix their arrivals.  A wait of seconds can only
// mean a grid that is not co-resident: the kernel then traps (a launch
// error) rather than hang the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    volatile unsigned* count = bar;
    for (unsigned spins = 0; *count < gridDim.x; ++spins) {
      if (spins > (1u << 26)) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Two neighbouring weights split into the three planes (hi, mid, lo,
// `stride` pairs apart), a bf16 pair a plane.
__device__ __forceinline__ void split3x2(float d0, float d1,
                                         __nv_bfloat162* p, size_t stride) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(d0),
                      h1 = __float2bfloat16_rn(d1);
  const float r0 = __fsub_rn(d0, __bfloat162float(h0)),
              r1 = __fsub_rn(d1, __bfloat162float(h1));
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0),
                      m1 = __float2bfloat16_rn(r1);
  p[0] = __halves2bfloat162(h0, h1);
  p[stride] = __halves2bfloat162(m0, m1);
  p[2 * stride] = __halves2bfloat162(
      __float2bfloat16_rn(__fsub_rn(r0, __bfloat162float(m0))),
      __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m1))));
}

// max|x[i]| over i = first, first + stride, ... < n, four loads in
// flight.
__device__ __forceinline__ float abs_max(const float* x, size_t n,
                                         size_t first, size_t stride) {
  float m = 0.f;
  size_t i = first;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const float a = x[i], b = x[i + stride], c = x[i + 2 * stride],
                d = x[i + 3 * stride];
    m = fmaxf(fmaxf(m, fmaxf(fabsf(a), fabsf(b))),
              fmaxf(fabsf(c), fabsf(d)));
  }
  for (; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));
  return m;
}

// The CTA's max of m (every thread passes its own), at thread 0; red
// holds a float per warp.
__device__ __forceinline__ float block_max(float m, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, red[i]);
  return m;
}

// The scale from the grid's n CTA maxima (exact in any order), at thread
// 0; every thread of the CTA takes part.
__device__ __forceinline__ float scale_of(const float* maxp, int n,
                                          float in_levels, float* red) {
  float v = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    v = fmaxf(v, __ldcg(maxp + i));
  return __fdiv_rn(fmaxf(block_max(v, red), 1e-12f), in_levels);
}

// FP32 instance's pre-pass: the DAC scale only (its product quantises the
// drives as it stages them).
// Each CTA's max|x|; one CTA forms the scale itself, several leave it to
// the last to finish (the read's zeroed count, after a __threadfence).
// Grid (CTAs a lead matrix, L): lead matrix blockIdx.y.
__global__ void __launch_bounds__(kScaleThreads) fakequant_scale_kernel(
    PrepArgs a) {
  __shared__ float red[kScaleThreads / 32];
  __shared__ int is_last;
  const int lead = blockIdx.y;
  if (a.sc_in != nullptr) {  // a given scale: copied, nothing reduced
    if (blockIdx.x == 0 && threadIdx.x == 0) a.sc[lead] = a.sc_in[lead];
    return;
  }
  const size_t per = (size_t)a.T * a.K;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float m = block_max(abs_max(a.x + lead * per, per, first,
                                    (size_t)gridDim.x * blockDim.x), red);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0)
      a.sc[lead] = __fdiv_rn(fmaxf(m, 1e-12f), a.in_levels);
    return;
  }
  float* maxp = a.maxp + (size_t)lead * gridDim.x;
  if (threadIdx.x == 0) maxp[blockIdx.x] = m;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(a.bar + lead, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float sc = scale_of(maxp, gridDim.x, a.in_levels, red);
  if (threadIdx.x == 0) a.sc[lead] = sc;
}

// Tensor-core instance's pre-pass, a cooperative grid of at most the CTAs
// co-resident on the card (whatever L): each lead matrix's max|x| and all
// L matrices' planes of W, a grid barrier, the L scales (lead matrix l by
// CTA l mod grid), a second grid barrier, then the codes.
__global__ void __launch_bounds__(kThreads) fakequant_prepare_kernel(
    PrepArgs a) {
  __shared__ float red[kWarps];
  __shared__ float sc_s;
  const int tid = threadIdx.x;
  const size_t per = (size_t)a.T * a.K;
  for (int lead = 0; lead < (a.sc_in ? 0 : a.L); ++lead) {
    const float m = abs_max(a.x + lead * per, per,
                            (size_t)blockIdx.x * kThreads + tid,
                            (size_t)gridDim.x * kThreads);
    const float bm = block_max(m, red);
    if (tid == 0) a.maxp[(size_t)lead * gridDim.x + blockIdx.x] = bm;
    __syncthreads();  // red is free for the next lead matrix
  }
  // W's planes, padding zero (they need no scale), a line a CTA
  const int lines = a.tiles * a.Rp;
  const size_t per_part = (size_t)a.L * lines * a.Np;
  for (long long lp = blockIdx.x; lp < (long long)a.L * lines;
       lp += gridDim.x) {
    const int lead = (int)(lp / lines), rem = (int)(lp - (long long)lead *
                                                     lines);
    const int tile = rem / a.Rp, r = rem - tile * a.Rp;
    const int line = tile * a.rows + r;
    const bool live = r < a.rows && line < a.K;
    const float* wl = a.w + ((size_t)lead * a.K + line) * a.N;
    __nv_bfloat162* pl =
        reinterpret_cast<__nv_bfloat162*>(a.planes + (size_t)lp * a.Np);
#pragma unroll 4
    for (int n = 2 * tid; n < a.Np; n += 2 * kThreads)  // Np is even
      split3x2(live && n < a.N ? wl[n] : 0.f,
               live && n + 1 < a.N ? wl[n + 1] : 0.f, pl + n / 2,
               per_part / 2);
  }
  grid_barrier(a.bar);

  for (int lead = blockIdx.x; lead < a.L; lead += gridDim.x) {
    const float s0 = a.sc_in ? a.sc_in[lead]
                             : scale_of(a.maxp + (size_t)lead * gridDim.x,
                                        gridDim.x, a.in_levels, red);
    if (tid == 0) a.sc[lead] = s0;
    __syncthreads();  // red is free for the next lead matrix
  }
  grid_barrier(a.bar2);
  // the codes, a (token, lead matrix, tile) row a CTA
  const int gtiles = a.L * a.tiles;
  int lead_s = -1;
  for (long long row = blockIdx.x; row < (long long)a.Tp * gtiles;
       row += gridDim.x) {
    const int t = (int)(row / gtiles), gi = (int)(row % gtiles);
    const int lead = gi / a.tiles, tile = gi - lead * a.tiles;
    if (lead != lead_s) {  // uniform over the CTA
      __syncthreads();
      if (tid == 0) sc_s = __ldcg(a.sc + lead);
      __syncthreads();
      lead_s = lead;
    }
    const float sc = sc_s;
    const float* xl =
        a.x + ((size_t)lead * a.T + t) * a.K + (size_t)tile * a.rows;
    __nv_bfloat16* cl = a.codes + (size_t)row * a.Rp;
#pragma unroll 4
    for (int r = tid; r < a.Rp; r += kThreads) {
      float v = 0.f;
      if (t < a.T && r < a.rows && tile * a.rows + r < a.K)
        v = dac_code(xl[r], sc, a.in_levels);
      cl[r] = __float2bfloat16_rn(v);
    }
  }
}

// --------------------------------------------------------------------------
// 2a. FP32 instance: the product, W streamed once
// --------------------------------------------------------------------------

struct FpArgs {
  const float* w;    // (L, K, N)
  const float* x;    // (L, T, K)
  const float* sc;   // (L,) the DAC scales
  float* q;          // (L, T, tiles, N)
  float* ssq;        // (L, T, tiles, ncq) range partials
  int T, K, N, rows, tiles, slice, spt, ncq, ntb;
  float in_levels;
};

template <bool kVec>
__device__ __forceinline__ float4 load_w4(const float* w, size_t off, int c,
                                          int N) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(w + off));
  float4 v;
  v.x = c < N ? __ldg(w + off) : 0.f;
  v.y = c + 1 < N ? __ldg(w + off + 1) : 0.f;
  v.z = c + 2 < N ? __ldg(w + off + 2) : 0.f;
  v.w = c + 3 < N ? __ldg(w + off + 3) : 0.f;
  return v;
}

// One CTA: 128 columns of one row slice (rows of one tile) for TB tokens
// of one lead matrix (blockIdx.z: lead matrix x token blocks + token
// block), in passes of 8 * kLoads rows with kLoads 16-byte loads of W in
// flight a lane.  The slices of a tile form a thread-block cluster
// (cluster dims (1, spt, 1)); rank 0 sums their partials from distributed
// shared memory in rank (slice) order.  kVec: N % 4 == 0 and W 16-byte
// aligned.
template <int TB, int kLoads, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) fakequant_fp32_kernel(
    FpArgs a) {
  constexpr int kPass = 8 * kLoads;
  __shared__ __align__(16) float xs[TB * kPass];          // [t][row]
  __shared__ __align__(16) float red[4 * TB * kFpCols];   // [4][TB][128]
  cg::cluster_group cluster = cg::this_cluster();
  const int cb = blockIdx.x, s = blockIdx.y;
  const int lead = blockIdx.z / a.ntb, tb = blockIdx.z - lead * a.ntb;
  const float* w = a.w + (size_t)lead * a.K * a.N;
  const float* x = a.x + (size_t)lead * a.T * a.K;
  float* q = a.q + (size_t)lead * a.T * a.tiles * a.N;
  float* ssq = a.ssq + (size_t)lead * a.T * a.tiles * a.ncq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = s / a.spt, sl = s - tile * a.spt;
  const int tile_end = min((tile + 1) * a.rows, a.K);
  const int r_lo = tile * a.rows + sl * a.slice;
  const int nr = max(min(r_lo + a.slice, tile_end) - r_lo, 0);
  const int t0 = tb * TB;
  const int c = cb * kFpCols + lane * 4;
  const bool col_ok = c < a.N;
  const float sc = a.sc[lead];

  float acc[TB][4];
#pragma unroll
  for (int t = 0; t < TB; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[t][u] = 0.f;
  for (int p0 = 0; p0 < nr; p0 += kPass) {
    float4 wv[kLoads];  // in flight while the pass's drives are staged
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int row = p0 + warp + 8 * j;
      wv[j] = (row < nr && col_ok)
                  ? load_w4<kVec>(w, (size_t)(r_lo + row) * a.N + c, c,
                                  a.N)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the last pass's drives are read
    // the pass's drives through the DAC round trip (rows past the slice,
    // tokens past T: 0); a warp then reads one address at a time
    for (int e = tid; e < TB * kPass; e += kThreads) {
      const int t = e / kPass, j = e - t * kPass;
      xs[e] = (p0 + j < nr && t0 + t < a.T)
                  ? __fmul_rn(dac_code(x[(size_t)(t0 + t) * a.K + r_lo +
                                           p0 + j],
                                       sc, a.in_levels), sc)
                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const float* xr = xs + warp + 8 * j;
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        const float xv = xr[t * kPass];
        acc[t][0] = fmaf(xv, wv[j].x, acc[t][0]);
        acc[t][1] = fmaf(xv, wv[j].y, acc[t][1]);
        acc[t][2] = fmaf(xv, wv[j].z, acc[t][2]);
        acc[t][3] = fmaf(xv, wv[j].w, acc[t][3]);
      }
    }
  }

  // The warps' sums, in a fixed tree: 4-7 into 0-3, 2-3 into 0-1, 1 into
  // 0; warp 0 leaves the slice's partial in red[0] for the cluster.
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    __syncthreads();
    if (warp >= half && warp < 2 * half)
#pragma unroll
      for (int t = 0; t < TB; ++t)
        *reinterpret_cast<float4*>(red + ((warp - half) * TB + t) * kFpCols +
                                   lane * 4) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    __syncthreads();
    if (warp < half)
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(
            red + (warp * TB + t) * kFpCols + lane * 4);
        acc[t][0] = __fadd_rn(acc[t][0], v.x);
        acc[t][1] = __fadd_rn(acc[t][1], v.y);
        acc[t][2] = __fadd_rn(acc[t][2], v.z);
        acc[t][3] = __fadd_rn(acc[t][3], v.w);
      }
  }
  if (warp == 0)
#pragma unroll
    for (int t = 0; t < TB; ++t)
      *reinterpret_cast<float4*>(red + t * kFpCols + lane * 4) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  cluster.sync();  // every slice's partial is in its CTA's red

  // Rank 0 (slice 0) sums the slices in slice order: a warp a token, a
  // lane's columns lane + 32 k, k < 4; then q and the two 64-column range
  // partials of the block.
  if (sl == 0) {
    for (int tt = warp; tt < TB; tt += kWarps) {
      const int t = t0 + tt;
      if (t >= a.T) break;
      float v[kFpMaxSlices][4];
#pragma unroll
      for (int r = 0; r < kFpMaxSlices; ++r) {  // all loads in flight
        const float* pr = cluster.map_shared_rank(red, r < a.spt ? r : 0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[r][k] = r < a.spt ? pr[tt * kFpCols + lane + 32 * k] : 0.f;
      }
      float qv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kFpMaxSlices; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) qv[k] = __fadd_rn(qv[k], v[r][k]);
      float* qo = q + ((size_t)t * a.tiles + tile) * a.N;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = cb * kFpCols + lane + 32 * k;
        if (cc < a.N) qo[cc] = qv[k];
        else qv[k] = 0.f;
      }
      float h0 = __fadd_rn(__fmul_rn(qv[0], qv[0]), __fmul_rn(qv[1], qv[1]));
      float h1 = __fadd_rn(__fmul_rn(qv[2], qv[2]), __fmul_rn(qv[3], qv[3]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        h0 = __fadd_rn(h0, __shfl_down_sync(0xffffffffu, h0, off));
        h1 = __fadd_rn(h1, __shfl_down_sync(0xffffffffu, h1, off));
      }
      if (lane == 0) {
        float* so = ssq + ((size_t)t * a.tiles + tile) * a.ncq + 2 * cb;
        so[0] = h0;
        if (2 * cb + 1 < a.ncq) so[1] = h1;
      }
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

// --------------------------------------------------------------------------
// 2b. Tensor-core instance: the product on mma.sync
// --------------------------------------------------------------------------

struct TcArgs {
  const __nv_bfloat16* codes;   // (Tp, gtiles, Rp)
  const __nv_bfloat16* planes;  // (3, gtiles * Rp, Np)
  const float* sc;              // (L,)
  float* q;                     // (L, T, tiles, N)
  float* ssq;                   // (L, T, tiles, ncq)
  int T, N, tiles, gtiles, Rp, Np, ncq;  // gtiles = L * tiles
};

// A CTA of BM tokens x 128 columns, in warps of 64 x 32: BM / 64 warps
// down the tokens, four across the columns.
template <int BM>
struct Cta {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kStage = BM * kTcLd + 3 * kTcKC * kFwdLd;  // bf16
  static constexpr int kSmemBytes = kStages * kStage * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i..8i+7 address matrix i); kTrans transposes each.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const __nv_bfloat16* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col): bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies one chunk (32 lines from line r0 of tile i, counted over the L
// lead matrices' tiles: lead matrix i / tiles) into a stage: the
// codes of BM tokens from b0 and the three planes' 32 x 128 block at
// column c0, all as 16-byte cp.async (the padded layouts keep every copy
// aligned and in bounds).  Planes land as [line][column] rows of kFwdLd.
template <int BM>
__device__ __forceinline__ void load_stage(const TcArgs& a, int i, int r0,
                                           int b0, int c0,
                                           __nv_bfloat16* stage) {
#pragma unroll
  for (int k = 0; k < BM * kTcKC / 8 / Cta<BM>::kThreads; ++k) {
    const int e = threadIdx.x + k * Cta<BM>::kThreads;
    const int row = e >> 2, q = e & 3;
    cp_async16(stage + row * kTcLd + q * 8,
               a.codes + ((size_t)(b0 + row) * a.gtiles + i) * a.Rp + r0 +
                   q * 8);
  }
  const size_t per_part = (size_t)a.gtiles * a.Rp * a.Np;
  const size_t line0 = (size_t)i * a.Rp + r0;
  __nv_bfloat16* sd = stage + BM * kTcLd;
  constexpr int kRowCopies = kTcBN / 8;                  // a line's copies
  constexpr int kPartCopies = kTcKC * kRowCopies;
#pragma unroll
  for (int e = threadIdx.x; e < 3 * kPartCopies; e += Cta<BM>::kThreads) {
    const int part = e / kPartCopies, rem = e - part * kPartCopies;
    const int j = rem / kRowCopies, q = rem - j * kRowCopies;
    cp_async16(sd + part * kTcKC * kFwdLd + j * kFwdLd + q * 8,
               a.planes + part * per_part + (line0 + j) * a.Np + c0 + q * 8);
  }
}

// acc += the chunk's products: each warp a 64 x 32 block, 4 x 4 tiles of
// m16n8, two k16 steps, three bf16 parts of W (lo, mid, hi).
template <int BM>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* stage,
                                          float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp % (BM / 64)) * 64, wn = (warp / (BM / 64)) * 32;
  const __nv_bfloat16* sd = stage + BM * kTcLd;
#pragma unroll
  for (int ks = 0; ks < kTcKC / 16; ++ks) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4<false>(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                         stage + (wm + mt * 16 + (lane & 15)) * kTcLd +
                             ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int part = 2; part >= 0; --part) {
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np)  // the transposed load gives k-pairs
        ldmatrix_x4<true>(
            bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
            bf[2 * np + 1][1],
            sd + part * kTcKC * kFwdLd + (ks * 16 + (lane & 15)) * kFwdLd +
                wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}

// One CTA: BM tokens x 128 columns of row tile blockIdx.z (over the L lead
// matrices' tiles: lead matrix blockIdx.z / tiles).
template <int BM>
__global__ void __launch_bounds__(Cta<BM>::kThreads, 2) fakequant_tc_kernel(
    TcArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __shared__ float ssq_s[4][BM];
  const int b0 = blockIdx.x * BM, cb = blockIdx.y, i = blockIdx.z;
  const int c0 = cb * kTcBN;
  const int steps = a.Rp / kTcKC;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<BM>(a, i, s * kTcKC, b0, c0, ring + s * Cta<BM>::kStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    const int ahead = s + kStages - 1;
    if (ahead < steps)
      load_stage<BM>(a, i, ahead * kTcKC, b0, c0,
                     ring + (ahead % kStages) * Cta<BM>::kStage);
    cp_async_commit();
    mma_chunk<BM>(ring + (s % kStages) * Cta<BM>::kStage, acc);
  }
  cp_async_wait<0>();

  // q = sc x sum to scratch; each row's sum of q^2 over each 64-column
  // block: a thread's 8 in order, the quad by xor shuffles, then the two
  // warps of the block in order.  Tokens past T and columns past N hold
  // exact zeros (zero codes, zero planes).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp % (BM / 64)) * 64, wn = (warp / (BM / 64)) * 32;
  const int lead = i / a.tiles, tile = i - lead * a.tiles;
  const float sc = a.sc[lead];
  float* q = a.q + (size_t)lead * a.T * a.tiles * a.N;
  float* ssq = a.ssq + (size_t)lead * a.T * a.tiles * a.ncq;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mt * 16 + g + 8 * h;
      const int t = b0 + row;
      float* qo = q + ((size_t)t * a.tiles + tile) * a.N;
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __fmul_rn(sc, acc[mt][nt][2 * h + e]);
          const int c = c0 + wn + nt * 8 + 2 * tg + e;
          if (t < a.T && c < a.N) qo[c] = v;
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      if (tg == 0) ssq_s[wn / 32][row] = s;
    }
  __syncthreads();
  for (int row = threadIdx.x; row < BM; row += Cta<BM>::kThreads) {
    const int t = b0 + row;
    if (t >= a.T) continue;
    float* so = ssq + ((size_t)t * a.tiles + tile) * a.ncq + 2 * cb;
    so[0] = __fadd_rn(ssq_s[0][row], ssq_s[1][row]);
    if (2 * cb + 1 < a.ncq) so[1] = __fadd_rn(ssq_s[2][row], ssq_s[3][row]);
  }
}

// --------------------------------------------------------------------------
// 3. The per-token ADC epilogue (both instances)
// --------------------------------------------------------------------------

struct EpiArgs {
  const float* q;    // (T, tiles, N)
  const float* ssq;  // (T, tiles, ncq): ncq blocks of the range's width
  float* y;          // (T, N)
  int T, N, tiles, ncq, chunk;
  float n_range;     // the range's width: N, or the whole width's
  float out_levels, sat_sigmas;
};

// One CTA per (token blockIdx.x, column chunk blockIdx.y); a stack's tokens
// are its L x T rows of q, in lead-matrix order.  Every CTA of a
// token reduces the token's range partials in the same order: lane l sums
// blocks l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads) fakequant_epilogue_kernel(
    EpiArgs a) {
  extern __shared__ float lsb_s[];  // (tiles,)
  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float n_f = a.n_range;
  for (int i = warp; i < a.tiles; i += kWarps) {
    const float* s = a.ssq + ((size_t)t * a.tiles + i) * a.ncq;
    float v = 0.f;
    for (int j = lane; j < a.ncq; j += 32) v = __fadd_rn(v, s[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) {
      const float sat = __fmul_rn(
          a.sat_sigmas, __fsqrt_rn(__fadd_rn(__fdiv_rn(v, n_f), 1e-12f)));
      lsb_s[i] = __fdiv_rn(sat, a.out_levels);
    }
  }
  __syncthreads();
  const int c_end = min((blockIdx.y + 1) * a.chunk, a.N);
  const float* qt = a.q + (size_t)t * a.tiles * a.N;
  for (int c0 = blockIdx.y * a.chunk + tid; c0 < c_end; c0 += 4 * kThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < a.tiles; ++i) {
      const float lsb = lsb_s[i];
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // four loads in flight
        const int c = c0 + u * kThreads;
        v[u] = c < c_end ? qt[(size_t)i * a.N + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float code = rintf(__fdiv_rn(v[u], lsb));
        code = fminf(fmaxf(code, -a.out_levels), a.out_levels);
        acc[u] = __fadd_rn(acc[u], __fmul_rn(code, lsb));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * kThreads;
      if (c < c_end) a.y[(size_t)t * a.N + c] = acc[u];
    }
  }
}

// --------------------------------------------------------------------------
// Geometry and launch
// --------------------------------------------------------------------------

long long round4(long long n) { return (n + 3) / 4 * 4; }

struct Plan {
  int tiles, reff, ncq, pre_ctas;     // pre_ctas: a lead matrix's (FP32
                                      // scale kernel) or the whole grid
  long long off_max;                  // the pre-pass CTAs' maxima
  int tb, loads, ntb, ncb, slice, spt, nsl;  // FP32 instance
  int Tp, Rp, Np, bm;                 // tensor-core instance
  int chunk, nchunks;                 // epilogue
  long long off_codes, off_planes, off_q, off_ssq, floats;
};

// Epilogue column chunks (multiples of 64): enough CTAs to fill the card
// four times over at decode, one chunk a token at prefill.
int epilogue_chunk(long long rows_q, int N, int sms) {
  const long long ncq = (N + kQCols - 1) / kQCols;
  long long splits = (4LL * sms + rows_q - 1) / rows_q;
  if (splits > ncq) splits = ncq;
  if (splits < 1) splits = 1;
  return (int)((ncq + splits - 1) / splits) * kQCols;
}

Plan plan(int L, int T, int K, int N, int rows, int tc, int sms,
          int prep_cap) {
  Plan p = {};
  p.tiles = (K + rows - 1) / rows;
  p.reff = rows < K ? rows : K;
  p.ncq = (N + kQCols - 1) / kQCols;
  long long pre = (long long)T * K;  // a lead matrix's pre-pass elements
  if (tc) {
    p.Tp = (T + kTcTokPad - 1) / kTcTokPad * kTcTokPad;
    p.Rp = (p.reff + kTcKC - 1) / kTcKC * kTcKC;
    p.Np = (N + kTcBN - 1) / kTcBN * kTcBN;
    // 128-token CTAs, or 64-token ones where 128-token CTAs would not
    // fill two CTAs an SM
    const long long ctas =
        (long long)(p.Np / kTcBN) * (p.Tp / 128) * p.tiles * L;
    p.bm = ctas < 2LL * sms ? 64 : 128;
    pre = L * (pre + (long long)p.tiles * p.Rp * p.Np);  // the whole grid's
  } else {
    p.tb = T <= 4 ? 4 : T <= 8 ? 8 : kFpMaxTokens;
    p.loads = p.tb <= 8 ? 16 : 8;  // as many as the registers allow
    p.ntb = (T + p.tb - 1) / p.tb;
    p.ncb = (N + kFpCols - 1) / kFpCols;
    // a pass a slice (8 rows a load), at most kFpMaxSlices a tile, fewer
    // while the grid would exceed eight CTAs an SM (many token blocks)
    const int pass = 8 * p.loads;
    p.spt = (p.reff + pass - 1) / pass;
    if (p.spt > kFpMaxSlices) p.spt = kFpMaxSlices;
    while (p.spt > 1 &&
           (long long)p.ncb * p.tiles * p.spt * p.ntb * L > 8LL * sms)
      p.spt = (p.spt + 1) / 2;
    p.slice = (p.reff + p.spt - 1) / p.spt;
    p.nsl = p.tiles * p.spt;

  }
  // pre-pass CTAs: the scale kernel takes 16 elements a thread (one CTA
  // up to 16K; this many CTAs for each lead matrix), the tensor cores'
  // pre-pass 8 over all L matrices, at most its co-resident grid; either
  // at most kMaxPrepCtas (the partial maxima of a lead matrix)
  const long long per = tc ? kThreads * 8LL : kScaleThreads * 16LL;
  const long long ctas = (pre + per - 1) / per;
  const long long cap = tc ? prep_cap : kMaxPrepCtas;
  p.pre_ctas = (int)(ctas < 1 ? 1 : ctas > cap ? cap : ctas);
  const long long rows_q = (long long)L * T;  // the epilogue's tokens
  p.chunk = epilogue_chunk(rows_q, N, sms);
  p.nchunks = (N + p.chunk - 1) / p.chunk;

  p.off_max = round4(2LL * L + 2);  // the scales and the counts
  long long off = p.off_max + round4((long long)L * p.pre_ctas);
  if (tc) {
    p.off_codes = off;
    off += round4(((long long)p.Tp * L * p.tiles * p.Rp + 1) / 2);
    p.off_planes = off;
    off += round4((3LL * L * p.tiles * p.Rp * p.Np + 1) / 2);
  }
  p.off_q = off;
  off += round4(rows_q * p.tiles * N);
  p.off_ssq = off;
  off += round4(rows_q * p.tiles * p.ncq);
  p.floats = off;
  return p;
}

// The slices of a tile as one cluster: cluster dims (1, spt, 1).
template <int TB, int kLoads>
cudaError_t launch_fp32(const FpArgs& f, const Plan& p, int L, bool vec,
                        cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)p.spt;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.ncb, (unsigned)p.nsl,
                     (unsigned)(p.ntb * L));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, fakequant_fp32_kernel<TB, kLoads, true>,
                               f)
          : cudaLaunchKernelEx(&cfg, fakequant_fp32_kernel<TB, kLoads, false>,
                               f);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// Token blocks fastest: the CTAs in flight together share the planes'
// column blocks.
template <int BM>
cudaError_t launch_tc(const TcArgs& t, const Plan& p, cudaStream_t st) {
  fakequant_tc_kernel<BM>
      <<<dim3((unsigned)(p.Tp / BM), (unsigned)(p.Np / kTcBN),
              (unsigned)t.gtiles),
         Cta<BM>::kThreads, Cta<BM>::kSmemBytes, st>>>(t);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// One-time setup for the current device, before its first read: raises the
// tensor-core kernel's dynamic shared-memory limit and stores the device's
// SM count in info[0] and the most tensor-core pre-pass CTAs that are
// co-resident (its cooperative grid's cap) in info[1].  Returns the CUDA
// error code.
int xbar_fakequant_setup(int* info) {
  int dev = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(info, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = allow_smem(fakequant_tc_kernel<64>, Cta<64>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(fakequant_tc_kernel<128>, Cta<128>::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, fakequant_prepare_kernel, kThreads, 0);
  if (err == cudaSuccess) {
    const long long cap = (long long)occ * info[0];
    info[1] = (int)(cap < kMaxPrepCtas ? cap : kMaxPrepCtas);
    if (info[1] < 1) err = cudaErrorInvalidConfiguration;
  }
  return (int)err;
}

// Floats of scratch a read needs: the L scales, the pre-pass counts and
// CTAs' maxima; the bf16 codes and planes of W (tensor cores, tc = 1); q
// (L, T, tiles, N) and the range partials (L, T, tiles, ceil(N / 64)).
// 0 for operands out of range.
long long xbar_fakequant_scratch_floats(int L, int T, int K, int N, int rows,
                                        int tc, int sms, int prep_cap) {
  if (L <= 0 || T <= 0 || K <= 0 || N <= 0 || rows <= 0 || sms <= 0 ||
      prep_cap <= 0)
    return 0;
  return plan(L, T, K, N, rows, tc, sms, prep_cap).floats;
}

}  // extern "C"

namespace {

// The pre-pass and the product of one read (everything but the epilogue):
// q and the range partials into scratch, lead matrix l's DAC scale into
// scratch[l] (from sc_in when given).  Returns the CUDA error code.
int launch_head(const float* x, const float* w, const float* sc_in,
                float* scratch, const Plan& p, int L, int T, int K, int N,
                int rows, int tc, float in_levels, cudaStream_t st,
                int* launched) {
  PrepArgs pa = {};
  pa.x = x; pa.w = w; pa.sc = scratch; pa.sc_in = sc_in;
  pa.maxp = scratch + p.off_max;
  pa.bar = reinterpret_cast<unsigned*>(scratch + L);
  pa.bar2 = pa.bar + 1;
  pa.L = L; pa.T = T; pa.K = K; pa.N = N; pa.rows = rows; pa.tiles = p.tiles;
  pa.Tp = p.Tp; pa.Rp = p.Rp; pa.Np = p.Np;
  pa.in_levels = in_levels;
  cudaError_t err = cudaSuccess;
  if (tc || p.pre_ctas > 1)
    err = cudaMemsetAsync(scratch, 0, p.off_max * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (tc) {
    pa.codes = reinterpret_cast<__nv_bfloat16*>(scratch + p.off_codes);
    pa.planes = reinterpret_cast<__nv_bfloat16*>(scratch + p.off_planes);
    void* args[] = {&pa};
    err = cudaLaunchCooperativeKernel((const void*)fakequant_prepare_kernel,
                                      dim3((unsigned)p.pre_ctas),
                                      dim3(kThreads), args, 0, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++launched[kSlotPrepare];

    TcArgs ta = {};
    ta.codes = pa.codes; ta.planes = pa.planes; ta.sc = scratch;
    ta.q = scratch + p.off_q; ta.ssq = scratch + p.off_ssq;
    ta.T = T; ta.N = N; ta.tiles = p.tiles; ta.gtiles = L * p.tiles;
    ta.Rp = p.Rp; ta.Np = p.Np; ta.ncq = p.ncq;
    err = p.bm == 64 ? launch_tc<64>(ta, p, st) : launch_tc<128>(ta, p, st);
    if (err != cudaSuccess) return (int)err;
    ++launched[kSlotTc];
  } else {
    fakequant_scale_kernel<<<dim3(sc_in ? 1u : (unsigned)p.pre_ctas,
                                  (unsigned)L),
                             kScaleThreads, 0, st>>>(pa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++launched[kSlotScale];

    FpArgs fa = {};
    fa.w = w; fa.x = x; fa.sc = scratch;
    fa.q = scratch + p.off_q; fa.ssq = scratch + p.off_ssq;
    fa.T = T; fa.K = K; fa.N = N; fa.rows = rows; fa.tiles = p.tiles;
    fa.slice = p.slice; fa.spt = p.spt; fa.ncq = p.ncq; fa.ntb = p.ntb;
    fa.in_levels = in_levels;
    const bool vec = N % 4 == 0 && ((uintptr_t)w & 15) == 0;
    err = p.tb == 4   ? launch_fp32<4, 16>(fa, p, L, vec, st)
          : p.tb == 8 ? launch_fp32<8, 16>(fa, p, L, vec, st)
                      : launch_fp32<kFpMaxTokens, 8>(fa, p, L, vec, st);
    if (err != cudaSuccess) return (int)err;
    ++launched[kSlotFp32];
  }
  return 0;
}

// The epilogue over the range partials ssq, (L * T, tiles, ncq) floats:
// the whole read's own (scratch, ncq its own) or a split read's gathered
// ones (ncq the whole width's blocks, n_range its columns).
int launch_epilogue(const float* q, const float* ssq, int ncq, float* y,
                    int rows_q, int tiles, int N, int chunk, float n_range,
                    float out_levels, float sat_sigmas, cudaStream_t st,
                    int* launched) {
  EpiArgs ea = {};
  ea.q = q; ea.ssq = ssq; ea.y = y;
  ea.T = rows_q; ea.N = N; ea.tiles = tiles; ea.ncq = ncq;
  ea.chunk = chunk; ea.n_range = n_range;
  ea.out_levels = out_levels; ea.sat_sigmas = sat_sigmas;
  fakequant_epilogue_kernel<<<dim3((unsigned)rows_q,
                                   (unsigned)((N + chunk - 1) / chunk)),
                              kThreads, tiles * sizeof(float), st>>>(ea);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kSlotEpilogue];
  return (int)err;
}

bool bad_args(int L, int T, int K, int N, int rows, int sms, int prep_cap,
              const float* scratch, const int* launched, int tc,
              float in_levels) {
  return L <= 0 || T <= 0 || K <= 0 || N <= 0 || rows <= 0 || sms <= 0 ||
         prep_cap <= 0 || scratch == nullptr || launched == nullptr ||
         (tc && in_levels > kTcMaxLevels);
}

bool out_of_range(const Plan& p, int L, int T, int tc) {
  return p.nchunks > 65535 || p.tiles > 12288 || L > 65535 ||
         (long long)L * T > 2147483647LL ||
         (tc ? (p.Np / kTcBN > 65535 || (long long)L * p.tiles > 65535)
             : (p.nsl > 65535 || (long long)p.ntb * L > 65535));
}

}  // namespace

extern "C" {

// Launches one fakequant read on `stream`: x (L, T, K) and w (L, K, N) into
// y (L, T, N), all contiguous float32 device arrays, with lead matrix l's
// DAC scale written to scratch[l] (L = 1: the (T, K) read), computed from
// x, or copied from sc_in (L floats on the device) when it is not null.
// tc = 1 takes the tensor-core instance (in_levels <= 256 only), tc = 0
// the FP32 one.
// scratch holds xbar_fakequant_scratch_floats() floats, this read's own: a
// pre-pass that counts its CTAs (the tensor cores' grid barriers, a scale
// kernel of several CTAs a lead matrix) has its counts zeroed first by a
// cudaMemsetAsync on the stream (a memset, not a kernel).  sms and
// prep_cap come from xbar_fakequant_setup on this device; the tensor
// cores' cooperative pre-pass takes at most prep_cap CTAs for any L (its
// loops stride over the L matrices), so a stack never exceeds the
// co-resident grid.  A stack whose other grid dims exceed the launch
// limits returns cudaErrorInvalidValue before anything launches.
// Adds one to launched[slot] (host array of kSlots ints, in LaunchSlot
// order) for each kernel launched.  Returns the CUDA error code of the
// launches (0 on success).
int xbar_fakequant(const float* x, const float* w, float* y, float* scratch,
                   int L, int T, int K, int N, int rows,
                   int tc, float in_levels, float out_levels,
                   float sat_sigmas, int sms, int prep_cap, void* stream,
                   int* launched, const float* sc_in) {
  if (bad_args(L, T, K, N, rows, sms, prep_cap, scratch, launched, tc,
               in_levels))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(L, T, K, N, rows, tc, sms, prep_cap);
  if (out_of_range(p, L, T, tc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_head(x, w, sc_in, scratch, p, L, T, K, N, rows, tc,
                              in_levels, st, launched);
  if (err != 0) return err;
  return launch_epilogue(scratch + p.off_q, scratch + p.off_ssq, p.ncq, y,
                         L * T, p.tiles, N, p.chunk, (float)N, out_levels,
                         sat_sigmas, st, launched);
}

// The first half of a split-range read of this rank's columns: the
// pre-pass and the product (as xbar_fakequant, sc_in likewise), then its
// range partials, (L * T, tiles, ceil(N / 64)) floats, copied into
// ssq_out (cudaMemcpyAsync, not a kernel).  q stays in scratch for
// xbar_fakequant_finish; with q_out (not null) it is copied there too,
// (L * T, tiles, N) floats, for xbar_fakequant_tiles.  Two launches.
int xbar_fakequant_split(const float* x, const float* w, float* ssq_out,
                         float* scratch, int L, int T, int K, int N,
                         int rows, int tc, float in_levels, int sms,
                         int prep_cap, void* stream, int* launched,
                         const float* sc_in, float* q_out) {
  if (ssq_out == nullptr ||
      bad_args(L, T, K, N, rows, sms, prep_cap, scratch, launched, tc,
               in_levels))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(L, T, K, N, rows, tc, sms, prep_cap);
  if (out_of_range(p, L, T, tc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_head(x, w, sc_in, scratch, p, L, T, K, N, rows, tc,
                              in_levels, st, launched);
  if (err != 0) return err;
  if (q_out != nullptr) {
    const cudaError_t e = cudaMemcpyAsync(
        q_out, scratch + p.off_q, (size_t)L * T * p.tiles * N * sizeof(float),
        cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaMemcpyAsync(
      ssq_out, scratch + p.off_ssq,
      (size_t)L * T * p.tiles * p.ncq * sizeof(float),
      cudaMemcpyDeviceToDevice, st);
}

// The second half: the epilogue on the scratch of xbar_fakequant_split
// (the same L, T, K, N, rows, tc, sms and prep_cap), with ssq_all, (L * T,
// tiles, ncq_all) floats, the range partials of every block of the whole
// width in its column order, and n_range the whole width's column count:
// y (L, T, N) for this rank's columns.  One launch.
int xbar_fakequant_finish(float* scratch, const float* ssq_all, int ncq_all,
                          float* y, int L, int T, int K, int N, int rows,
                          int tc, float n_range, float out_levels,
                          float sat_sigmas, int sms, int prep_cap,
                          void* stream, int* launched) {
  if (ssq_all == nullptr || y == nullptr || ncq_all <= 0 ||
      !(n_range > 0.f) ||
      bad_args(L, T, K, N, rows, sms, prep_cap, scratch, launched, tc, 0.f))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(L, T, K, N, rows, tc, sms, prep_cap);
  if (out_of_range(p, L, T, tc)) return (int)cudaErrorInvalidValue;
  return launch_epilogue(scratch + p.off_q, ssq_all, ncq_all, y, L * T,
                         p.tiles, N, p.chunk, n_range, out_levels,
                         sat_sigmas, (cudaStream_t)stream, launched);
}

// The epilogue alone over the row tiles of several ranks, gathered in
// tile order (a row-split read, each rank its own whole row tiles): q,
// (T, tiles, N), each tile's product, and ssq, (T, tiles, ceil(N / 64)),
// its range partials, as xbar_fakequant_split copies them out (q_out),
// into y (T, N).  The tiles are summed in tile order from 0, so y is the
// whole read's bit for bit.  One launch.
int xbar_fakequant_tiles(const float* q, const float* ssq, float* y, int T,
                         int tiles, int N, float out_levels,
                         float sat_sigmas, int sms, void* stream,
                         int* launched) {
  if (q == nullptr || ssq == nullptr || y == nullptr || launched == nullptr ||
      T <= 0 || tiles <= 0 || tiles > 12288 || N <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = epilogue_chunk(T, N, sms);
  if ((N + chunk - 1) / chunk > 65535) return (int)cudaErrorInvalidValue;
  return launch_epilogue(q, ssq, (N + kQCols - 1) / kQCols, y, T, tiles, N,
                         chunk, (float)N, out_levels, sat_sigmas,
                         (cudaStream_t)stream, launched);
}

}  // extern "C"
