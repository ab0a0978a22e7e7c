// Fused analog crossbar read (VMM, paper Fig. 3a) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/xbar_vmm.py::_fused_vmm_kernel
// (launched by _pallas_read).  For every lead matrix l (a layer of a
// scan-stacked container) it computes
//
//     y[l] = sc[l,1] * sum_kt ADC_kt( quant(x[l] / sc[l,0]) @ (G - G_ref)_kt )
//
// with the reference's semantics stage by stage:
//   * DAC: x / sc[l,0], round half to even, clip to +-in_levels;
//   * differential pair: G - G_ref on the tile, in shared memory;
//   * the f32 tile product of one rows x cols crossbar tile;
//   * integrator saturation + ramp ADC per tile.  In dynamic range mode
//     one range sat = max(sat_sigmas * rms, 1e-6) is calibrated per tile
//     over the WHOLE batch x tile columns, the rms counting only non-zero
//     charges.  The range is reduced before any element of the tile is
//     quantised, so every row of a continuous batch shares it, as in the
//     reference (block_b = B);
//   * digital accumulation over the K tiles, in tile order, then the
//     x_scale / w_scale rescale.
//
// Design for this card.  Blocks run in parallel and in no order, and a
// tile's ADC range depends only on that tile, so each CTA owns one
// (layer, k-tile, n-tile) crossbar tile for all B rows: it forms the tile's
// B x cols charges, reduces the range over all of them, quantises, and
// writes the tile's digital partial.  A second small kernel sums the
// partials of each output in K-tile order (the order of the TPU grid's
// sequential reduction, so the result does not depend on block
// scheduling) and applies the rescale; with one K tile the first kernel
// writes the output itself.  G and G_ref are read once each, unpadded:
// the ragged edge is masked here, so no padded copy of the conductances
// is ever made in device memory.  The charges live in shared memory when
// they fit, else in scratch the wrapper allocates; the quantised
// activations are staged in batch chunks.
//
// What bounds it.  At decode (B <= 16) the work is ~2*B flops per
// conductance pair, so the bytes of G and G_ref bound it: 75.5 MB per
// layer of lm100m (wqkv, wo, w_upgate, w_down), 906 MB per decode step at
// full width, about 270 us at 3.35 TB/s.  One CTA per tile puts 144 to
// 1152 CTAs of 256 threads in flight per read at lm100m's shapes (64x64
// tiles), each issuing 8 independent loads of G and of G_ref per thread
// per round, so enough bytes are in flight to approach the bound.  Plain
// FP32 FMAs (no TF32, no wgmma/TMA); the time on the card against the
// bound is in PERF.md.
//
// Arithmetic: x/sc, q/lsb, sat/out_levels and sqrt are IEEE-rounded
// (__fdiv_rn, __fsqrt_rn) and the ADC output is formed with explicit
// round-to-nearest multiply/add intrinsics so nvcc cannot contract them
// into FMAs: in the fixed-range power-of-two class the result is then
// bit-equal to the plain torch version.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXCapFloats = 8192;          // staged quantised-x chunk
constexpr int kSmemLimit = 200 * 1024;     // of the 227 KB a block may use
constexpr int kLoadUnroll = 8;

int x_chunk_rows(int B, int rows) {
  int xb = kXCapFloats / rows;
  if (xb < 1) xb = 1;
  return xb < B ? xb : B;
}

size_t base_smem_bytes(int B, int rows, int cols) {
  return sizeof(float) * ((size_t)rows * cols
                          + (size_t)x_chunk_rows(B, rows) * rows
                          + 2 * kWarps);
}

bool q_fits_smem(int B, int rows, int cols) {
  return base_smem_bytes(B, rows, cols) + sizeof(float) * (size_t)B * cols
         <= (size_t)kSmemLimit;
}

__global__ void __launch_bounds__(kThreads)
fused_vmm_tile_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ ref,
                      const float* __restrict__ sc, float* __restrict__ out,
                      float* __restrict__ scratch, int B, int K, int N,
                      int rows, int cols, int xb, int q_in_smem, int dynamic,
                      float in_levels, float out_levels, float sat_fixed,
                      float sat_sigmas) {
  // One CTA: one (layer, k-tile, n-tile) crossbar tile for all B rows.
  extern __shared__ float smem[];
  float* diff_s = smem;
  float* xi_s = diff_s + rows * cols;
  float* red_f = xi_s + xb * rows;
  int* red_i = reinterpret_cast<int*>(red_f + kWarps);
  const int nt = blockIdx.x, kt = blockIdx.y, l = blockIdx.z;
  const int tn = gridDim.x, tk = gridDim.y;
  const int n0 = nt * cols, k0 = kt * rows;
  float* q = q_in_smem
      ? reinterpret_cast<float*>(red_i + kWarps)
      : scratch + (((size_t)l * tk + kt) * tn + nt) * (size_t)B * cols;

  const float* xl = x + (size_t)l * B * K;
  const float* gl = g + (size_t)l * K * N;
  const float* rl = ref + (size_t)l * K * N;
  const float x_scale = sc[2 * l];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile = rows * cols;

  // Differential pair, masked at the ragged edge (zeros outside K x N).
  for (int e0 = tid; e0 < tile; e0 += kLoadUnroll * kThreads) {
    float gv[kLoadUnroll], rv[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int e = e0 + u * kThreads;
      gv[u] = 0.f;
      rv[u] = 0.f;
      if (e < tile) {
        const int r = e / cols, c = e - r * cols;
        const int kk = k0 + r, nn = n0 + c;
        if (kk < K && nn < N) {
          const size_t off = (size_t)kk * N + nn;
          gv[u] = gl[off];
          rv[u] = rl[off];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < tile) diff_s[e] = __fsub_rn(gv[u], rv[u]);
    }
  }

  // Column charges of the tile, batch chunk by batch chunk.
  float ssq = 0.f;
  int nz = 0;
  for (int b0 = 0; b0 < B; b0 += xb) {
    const int nb = min(xb, B - b0);
    __syncthreads();  // diff_s is loaded; the last chunk's xi_s is consumed
    for (int e = tid; e < nb * rows; e += kThreads) {
      const int bb = e / rows, r = e - bb * rows;
      const int kk = k0 + r;
      float v = 0.f;
      if (kk < K) {
        v = rintf(__fdiv_rn(xl[(size_t)(b0 + bb) * K + kk], x_scale));
        v = fminf(fmaxf(v, -in_levels), in_levels);
      }
      xi_s[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < nb * cols; e += kThreads) {
      const int bb = e / cols, c = e - bb * cols;
      const float* xr = xi_s + bb * rows;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc = fmaf(xr[r], diff_s[r * cols + c], acc);
      q[(size_t)(b0 + bb) * cols + c] = acc;
      ssq = __fadd_rn(ssq, __fmul_rn(acc, acc));
      nz += (acc != 0.f);
    }
  }

  // One integrator range per tile: reduce over batch x columns first.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ssq = __fadd_rn(ssq, __shfl_down_sync(0xffffffffu, ssq, off));
    nz += __shfl_down_sync(0xffffffffu, nz, off);
  }
  if (lane == 0) {
    red_f[warp] = ssq;
    red_i[warp] = nz;
  }
  __syncthreads();  // also publishes every thread's q to the block
  float sat = sat_fixed;
  if (dynamic) {
    float tot = 0.f;
    int tnz = 0;
    for (int w = 0; w < kWarps; ++w) {
      tot = __fadd_rn(tot, red_f[w]);
      tnz += red_i[w];
    }
    const float rms = __fsqrt_rn(__fdiv_rn(tot, fmaxf((float)tnz, 1.f)));
    sat = fmaxf(__fmul_rn(sat_sigmas, rms), 1e-6f);
  }
  const float lsb = __fdiv_rn(sat, out_levels);

  // Saturate and ramp-ADC.  With one K tile the output is final (rescaled
  // here); otherwise it is this tile's digital partial, summed in tile
  // order by reduce_tiles_kernel.
  const float out_scale = sc[2 * l + 1];
  float* ol = tk == 1 ? out + (size_t)l * B * N
                      : out + ((size_t)l * tk + kt) * (size_t)B * N;
  for (int e = tid; e < B * cols; e += kThreads) {
    const int b = e / cols, c = e - b * cols;
    const int nn = n0 + c;
    if (nn >= N) continue;
    const float v = fminf(fmaxf(q[e], -sat), sat);
    float code = rintf(__fdiv_rn(v, lsb));
    code = fminf(fmaxf(code, -out_levels), out_levels);
    const float a = __fmul_rn(code, lsb);
    ol[(size_t)b * N + nn] = tk == 1 ? __fmul_rn(a, out_scale) : a;
  }
}

// y[l, b, n] = sc[l, 1] * sum over K tiles, in tile order, of the partials.
__global__ void __launch_bounds__(kThreads)
reduce_tiles_kernel(const float* __restrict__ partial,
                    const float* __restrict__ sc, float* __restrict__ y,
                    int L, int tk, long long bn) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)L * bn) return;
  const long long l = i / bn, j = i - l * bn;
  const float* p = partial + (size_t)l * tk * bn + j;
  float a = p[0];
  for (int t = 1; t < tk; ++t) a = __fadd_rn(a, p[(size_t)t * bn]);
  y[i] = __fmul_rn(a, sc[2 * l + 1]);
}

}  // namespace

extern "C" {

// Floats of scratch the launch needs: the per-tile digital partials when
// K spans more than one tile, plus the tile charges when they do not fit
// in shared memory.
long long xbar_vmm_scratch_floats(int L, int B, int K, int N, int rows,
                                  int cols) {
  const long long tk = (K + rows - 1) / rows, tn = (N + cols - 1) / cols;
  long long n = tk > 1 ? (long long)L * tk * B * N : 0;
  if (!q_fits_smem(B, rows, cols)) n += (long long)L * tk * tn * B * cols;
  return n;
}

// Launches the fused read on `stream`.  x (L,B,K), g/ref (L,K,N), sc (L,2)
// and y (L,B,N) are contiguous float32 device arrays; scratch holds
// xbar_vmm_scratch_floats() floats.  Returns the CUDA error code of the
// launches (0 on success).
int xbar_vmm_forward(const float* x, const float* g, const float* ref,
                     const float* sc, float* y, float* scratch, int L, int B,
                     int K, int N, int rows, int cols, int dynamic,
                     float in_levels, float out_levels, float sat_fixed,
                     float sat_sigmas, void* stream) {
  if (L <= 0 || B <= 0 || K <= 0 || N <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const int tk = (K + rows - 1) / rows, tn = (N + cols - 1) / cols;
  if (tk > 65535 || L > 65535) return (int)cudaErrorInvalidValue;
  const bool q_smem = q_fits_smem(B, rows, cols);
  size_t smem = base_smem_bytes(B, rows, cols);
  if (q_smem) smem += sizeof(float) * (size_t)B * cols;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (xbar_vmm_scratch_floats(L, B, K, N, rows, cols) > 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  static size_t smem_opt_in = 48 * 1024;
  if (smem > smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_vmm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_opt_in = kSmemLimit;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* partial = tk > 1 ? scratch : y;
  float* q_scratch = tk > 1 ? scratch + (size_t)L * tk * B * N : scratch;
  fused_vmm_tile_kernel<<<dim3(tn, tk, L), kThreads, smem, st>>>(
      x, g, ref, sc, partial, q_smem ? nullptr : q_scratch, B, K, N, rows,
      cols, x_chunk_rows(B, rows), q_smem ? 1 : 0, dynamic, in_levels,
      out_levels, sat_fixed, sat_sigmas);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tk == 1) return (int)err;
  const long long bn = (long long)B * N;
  const long long blocks = ((long long)L * bn + kThreads - 1) / kThreads;
  reduce_tiles_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(partial, sc, y,
                                                            L, tk, bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
