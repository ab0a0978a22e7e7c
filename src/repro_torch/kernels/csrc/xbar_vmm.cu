// Fused analog crossbar reads for Hopper (sm_90a): the forward read (VMM,
// paper Fig. 3a) and the transpose read (MVM, Fig. 3b) of the same stored
// conductances.
//
// Replaces the TPU kernels of src/repro/kernels/xbar_vmm.py, both launched
// by _pallas_read:
//   * _fused_vmm_kernel (forward):  y[l] = sc[l,1] * sum_kt ADC_kt(
//         quant(x[l] / sc[l,0]) @ (G - G_ref)_(kt, nt) ),  x (L,B,K) -> (L,B,N)
//   * _fused_mvm_kernel (transpose): y[l] = sc[l,1] * sum_nt ADC_nt(
//         quant(d[l] / sc[l,0]) @ (G - G_ref)_(kt, nt)^T ), d (L,B,N) -> (L,B,K)
// with the reference's semantics stage by stage:
//   * DAC: x / sc[l,0], round half to even, clip to +-in_levels;
//   * differential pair: G - G_ref on the tile, as it is staged;
//   * the f32 product of one rows x cols crossbar tile.  The transpose read
//     contracts the stored tile's column dim: it stages the same rows of G
//     with the roles of the two tile dims swapped and never forms a
//     transposed copy;
//   * integrator saturation + ramp ADC per tile.  In dynamic range mode one
//     range sat = max(sat_sigmas * rms, 1e-6) is calibrated per tile over
//     the WHOLE batch x tile outputs, the rms counting only non-zero
//     charges; the range is reduced before any charge of the tile is
//     quantised, as in the reference (block_b = B);
//   * digital accumulation over the reduction tiles (K tiles forward, N
//     tiles transposed), in tile order, then the x_scale / w_scale rescale.
//
// Design for this card.  Blocks run in parallel and in no order, and a
// tile's ADC range depends only on that tile, so each CTA owns one
// (layer, k-tile, n-tile) crossbar tile for all B rows.  It walks the tile
// in 64-column output blocks and (16 * VB)-row batch blocks, staging the
// differential pair and the quantised drives 32 reduction lines at a time
// in shared memory (about 17 KB, whatever the tile geometry: any rows x
// cols the JAX package accepts launches), and keeps a VB x 4 block of
// charges per thread in registers.  Each charge is written raw into the
// tile's slice of the (L, reduction tiles, B, outputs) partial buffer
// while the range statistics accumulate; after the block-wide range
// reduction the CTA quantises its slice in place.  A second small kernel
// sums the partials of each output in reduction-tile order (the order of
// the TPU grid's sequential reduction, so the result does not depend on
// block scheduling) and applies the rescale; with one reduction tile the
// first kernel writes the output itself.  The charges thus need no
// scratch of their own: the partial buffer is the wrapper's only scratch,
// L x tiles x B x outputs floats (604 MB for w_upgate at B = 2048: 12 K
// tiles x 2048 x 6144 forward, 96 N tiles x 2048 x 768 transposed).  G
// and G_ref are read unpadded: the ragged edge is masked here, so no
// padded copy of the conductances is ever made in device memory.
//
// What bounds it.  At decode (B <= 16) the work is ~2B flops per
// conductance pair, so the bytes of G and G_ref bound it (75.5 MB per
// lm100m layer, about 22.5 us at 3.35 TB/s); VB = 1 there, and each thread
// keeps 16 loads of G / G_ref in flight per staged chunk.  At training
// (B = T = 2048) the FP32 FLOPs bound it: 38.7 GFLOP per lm100m layer per
// direction, 0.58 ms at 67 TFLOP/s; VB = 4 gives 16 FMAs per 8 shared
// loads.  Plain FP32 FMAs (no TF32, no wgmma/TMA); the time on the card
// against the bound is in PERF.md.
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
constexpr int kCB = 64;   // output columns of a block (16 threads x 4)
constexpr int kRC = 32;   // reduction lines staged per chunk

struct ReadArgs {
  const float* x;        // (L, B, D) drives
  const float* g;        // (L, K, N)
  const float* ref;      // (L, K, N)
  const float* sc;       // (L, 2): x_scale, x_scale / w_scale
  float* out;            // (L, tR, B, O) partials, or (L, B, O) if tR == 1
  int B, K, N;
  int R, C;              // tile reduction length, tile output width
  int D, O;              // drive features, output features
  int dynamic;
  float in_levels, out_levels, sat_fixed, sat_sigmas;
};

// One CTA: one (layer, reduction tile, output tile) crossbar tile for all
// B rows.  kTranspose selects the direction; VB is the batch rows of a
// thread's register block (the block then spans 16 * VB batch rows).
template <bool kTranspose, int VB>
__global__ void __launch_bounds__(kThreads)
fused_read_tile_kernel(ReadArgs a) {
  constexpr int kBB = 16 * VB;
  __shared__ float xs[kRC][kBB + 1];
  __shared__ float ds[kRC][kCB + 1];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];

  const int ot = blockIdx.x, rt = blockIdx.y, l = blockIdx.z;
  const int tR = gridDim.y;
  const int B = a.B, R = a.R, C = a.C, D = a.D, O = a.O, N = a.N;
  // Tile origin in the stored (K, N) array, and in drive/output features.
  const int red0 = rt * R, out0 = ot * C;
  const int k0 = kTranspose ? out0 : red0;
  const int n0 = kTranspose ? red0 : out0;
  const float* xl = a.x + (size_t)l * B * D;
  const float* gl = a.g + (size_t)l * a.K * N;
  const float* rl = a.ref + (size_t)l * a.K * N;
  float* ol = tR == 1 ? a.out + (size_t)l * B * O
                      : a.out + ((size_t)l * tR + rt) * (size_t)B * O;
  const float x_scale = a.sc[2 * l];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int r_end = min(R, D - red0);     // valid reduction lines
  const int c_end = min(C, O - out0);     // valid outputs of the tile

  float ssq = 0.f;
  int nz = 0;
  for (int b0 = 0; b0 < B; b0 += kBB) {
    for (int c0 = 0; c0 < c_end; c0 += kCB) {
      float acc[VB][4];
#pragma unroll
      for (int v = 0; v < VB; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;

      for (int r0 = 0; r0 < r_end; r0 += kRC) {
        // Differential pair of the chunk: ds[j][c] = (G - G_ref) at
        // reduction line r0 + j, output c0 + c; zero outside the tile.
        float gv[kRC * kCB / kThreads], rv[kRC * kCB / kThreads];
#pragma unroll
        for (int i = 0; i < kRC * kCB / kThreads; ++i) {
          const int e = tid + i * kThreads;
          // consecutive threads walk the stored row (coalesced loads)
          const int j = kTranspose ? e % kRC : e / kCB;
          const int c = kTranspose ? e / kRC : e % kCB;
          gv[i] = 0.f;
          rv[i] = 0.f;
          if (r0 + j < r_end && c0 + c < c_end) {
            const int kk = kTranspose ? k0 + c0 + c : k0 + r0 + j;
            const int nn = kTranspose ? n0 + r0 + j : n0 + c0 + c;
            const size_t off = (size_t)kk * N + nn;
            gv[i] = gl[off];
            rv[i] = rl[off];
          }
        }
#pragma unroll
        for (int i = 0; i < kRC * kCB / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int j = kTranspose ? e % kRC : e / kCB;
          const int c = kTranspose ? e / kRC : e % kCB;
          ds[j][c] = __fsub_rn(gv[i], rv[i]);
        }
        // Quantised drives of the chunk: xs[j][b].
        for (int e = tid; e < kBB * kRC; e += kThreads) {
          const int b = e / kRC, j = e - b * kRC;
          float v = 0.f;
          if (b0 + b < B && r0 + j < r_end) {
            v = rintf(__fdiv_rn(xl[(size_t)(b0 + b) * D + red0 + r0 + j],
                                x_scale));
            v = fminf(fmaxf(v, -a.in_levels), a.in_levels);
          }
          xs[j][b] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kRC; ++j) {
          float w[4], xv[VB];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = ds[j][tx + 16 * u];
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
      // Raw charges into the tile's slice; range statistics.
#pragma unroll
      for (int v = 0; v < VB; ++v) {
        const int b = b0 + ty + 16 * v;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + tx + 16 * u;
          if (b < B && c < c_end) {
            const float q = acc[v][u];
            ol[(size_t)b * O + out0 + c] = q;
            ssq = __fadd_rn(ssq, __fmul_rn(q, q));
            nz += (q != 0.f);
          }
        }
      }
    }
  }

  // One integrator range per tile: reduce over batch x outputs first.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ssq = __fadd_rn(ssq, __shfl_down_sync(0xffffffffu, ssq, off));
    nz += __shfl_down_sync(0xffffffffu, nz, off);
  }
  if (lane == 0) {
    red_f[warp] = ssq;
    red_i[warp] = nz;
  }
  __syncthreads();  // also publishes every thread's charges to the block
  float sat = a.sat_fixed;
  if (a.dynamic) {
    float tot = 0.f;
    int tnz = 0;
    for (int w = 0; w < kWarps; ++w) {
      tot = __fadd_rn(tot, red_f[w]);
      tnz += red_i[w];
    }
    const float rms = __fsqrt_rn(__fdiv_rn(tot, fmaxf((float)tnz, 1.f)));
    sat = fmaxf(__fmul_rn(a.sat_sigmas, rms), 1e-6f);
  }
  const float lsb = __fdiv_rn(sat, a.out_levels);

  // Saturate and ramp-ADC the slice in place.  With one reduction tile the
  // output is final (rescaled here); otherwise it is this tile's digital
  // partial, summed in tile order by reduce_tiles_kernel.
  const float out_scale = a.sc[2 * l + 1];
  for (int e = tid; e < B * c_end; e += kThreads) {
    const int b = e / c_end, c = e - b * c_end;
    float* p = ol + (size_t)b * O + out0 + c;
    const float v = fminf(fmaxf(*p, -sat), sat);
    float code = rintf(__fdiv_rn(v, lsb));
    code = fminf(fmaxf(code, -a.out_levels), a.out_levels);
    const float q = __fmul_rn(code, lsb);
    *p = tR == 1 ? __fmul_rn(q, out_scale) : q;
  }
}

// y[l, b, o] = sc[l, 1] * sum over reduction tiles, in tile order, of the
// partials.
__global__ void __launch_bounds__(kThreads)
reduce_tiles_kernel(const float* __restrict__ partial,
                    const float* __restrict__ sc, float* __restrict__ y,
                    int L, int tR, long long bo) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)L * bo) return;
  const long long l = i / bo, j = i - l * bo;
  const float* p = partial + (size_t)l * tR * bo + j;
  float acc = p[0];
  for (int t = 1; t < tR; ++t) acc = __fadd_rn(acc, p[(size_t)t * bo]);
  y[i] = __fmul_rn(acc, sc[2 * l + 1]);
}

template <bool kTranspose>
void launch_tiles(const ReadArgs& a, dim3 grid, cudaStream_t st) {
  if (a.B <= 16)
    fused_read_tile_kernel<kTranspose, 1><<<grid, kThreads, 0, st>>>(a);
  else
    fused_read_tile_kernel<kTranspose, 4><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// Floats of scratch a read needs: the per-tile digital partials when the
// reduction spans more than one tile (the tile charges live in the same
// slots until they are quantised).
long long xbar_read_scratch_floats(int L, int B, int K, int N, int rows,
                                   int cols, int transpose) {
  const int D = transpose ? N : K, O = transpose ? K : N;
  const int R = transpose ? cols : rows;
  const long long tR = (D + R - 1) / R;
  return tR > 1 ? (long long)L * tR * B * O : 0;
}

// Launches one read on `stream`: the forward read (transpose = 0) of
// x (L,B,K) into y (L,B,N), or the transpose read (transpose = 1) of
// x (L,B,N) into y (L,B,K), through g/ref (L,K,N) and sc (L,2); all
// contiguous float32 device arrays.  scratch holds
// xbar_read_scratch_floats() floats.  Returns the CUDA error code of the
// launches (0 on success).
int xbar_read(const float* x, const float* g, const float* ref,
              const float* sc, float* y, float* scratch, int L, int B, int K,
              int N, int rows, int cols, int transpose, int dynamic,
              float in_levels, float out_levels, float sat_fixed,
              float sat_sigmas, void* stream) {
  if (L <= 0 || B <= 0 || K <= 0 || N <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  ReadArgs a;
  a.x = x; a.g = g; a.ref = ref; a.sc = sc;
  a.B = B; a.K = K; a.N = N;
  a.R = transpose ? cols : rows;
  a.C = transpose ? rows : cols;
  a.D = transpose ? N : K;
  a.O = transpose ? K : N;
  a.dynamic = dynamic;
  a.in_levels = in_levels; a.out_levels = out_levels;
  a.sat_fixed = sat_fixed; a.sat_sigmas = sat_sigmas;
  const long long tR = (a.D + a.R - 1) / a.R, tO = (a.O + a.C - 1) / a.C;
  if (tR > 65535 || L > 65535 || tO > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (tR > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  a.out = tR > 1 ? scratch : y;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)tO, (unsigned)tR, (unsigned)L);
  if (transpose)
    launch_tiles<true>(a, grid, st);
  else
    launch_tiles<false>(a, grid, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tR == 1) return (int)err;
  const long long bo = (long long)B * a.O;
  const long long blocks = ((long long)L * bo + kThreads - 1) / kThreads;
  reduce_tiles_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      scratch, sc, y, L, (int)tR, bo);
  return (int)cudaGetLastError();
}

}  // extern "C"
