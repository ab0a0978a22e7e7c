// Rank-k crossbar write (paper Fig. 3c) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/xbar_update.py::_update_kernel
// (launched by _pallas_update) in both of its update modes.  For every
// lead matrix l (a layer of a scan-stacked container) it computes
//
//     acc        = sum_t x_q[l, t, :] (outer) d_q[l, t, :]        (K, N)
//
// and then, in update_mode="outer",
//
//     dg_req     = scale[l] * acc          (scale folds -lr * w_scale)
//     G'[l]      = device_epilogue(G[l], dg_req, noise)
//
// with the reference's _device_epilogue: the state-dependent SET/RESET
// factors of the TaOx model (_updown_factors), the random-walk write noise
// sigma = write_noise * pulse_dg * sqrt(|dg_req| / pulse_dg) times a
// standard normal, and a clip to [gmin, gmax].  In update_mode=
// "pulse_train" (the reference's second output block a_ref and
// _pulse_epilogue) it also accumulates the magnitude twin
//
//     a_abs      = sum_t |x_q[l, t, :]| (outer) |d_q[l, t, :]|
//
// and splits the request m * acc (m = scale[l]) into the SET and RESET
// rails S = (a_abs |m| + acc m) / 2 and R = (a_abs |m| - acc m) / 2, each
// fired as an integer number of pulse_dg events n = rint(max(mag, 0) /
// pulse_dg) (round half to even, as jnp.round); the cell moves by
// pulse_dg (n_set up - n_reset dn) and its write noise has
// sigma = write_noise * pulse_dg * sqrt(n_set + n_reset).
//
// Three noise modes: none, a host field (L, K, N), or the in-kernel
// counter PRNG: murmur fmix32 of (seed, layer, k-tile, n-tile) per tile
// (_tile_seed), then one 16-bit Box-Muller draw per pair of adjacent
// columns (_tile_normals; an odd tile width takes one draw per cell and
// keeps the cosine leg), in uint32 arithmetic bit-identical to the
// reference's hash words.  Both modes draw the same normals.  A block of a
// larger container (a shard of the sharded train step) is written with its
// (layer, row-tile, col-tile) base coordinates, which both instances add to
// each tile's coordinates before hashing: the block draws exactly its slice
// of the whole container's noise (the reference's tile_offsets).
//
// Two instances; update_instance() in kernels/xbar_update.py picks one
// from the operands, never from a failure.
//
// Tensor-core instance (operands that are integer codes times one scale
// per lead matrix, codes within 256 levels and |sum| < 2^24: the training
// step's tapes, 8-bit row codes and 4-bit column codes times the write
// drivers' per-call scales).  What bounds it: for lm100m's four
// containers at T = 2048 (12 layers, sum K N = 9.4 M cells a layer) the
// function reads the float32 tapes once (1.51 GB) and G in and out (0.91
// GB): 0.72 ms at 3.35 TB/s, above its 464 GFLOP at the 989 TFLOP/s bf16
// rate (0.47 ms); pulse-train does twice the products, 0.94 ms.  Design:
//   * update_prepare_kernel, once per write, turns the tapes into bf16
//     code planes c = clip(rint(x_q / s)) per lead matrix, (L, Tp, Kp) and
//     (L, Tp, Np) in the tapes' token-major layout, tokens padded with
//     zeros to a multiple of 32 and features to a multiple of 128, so that
//     every later copy is an aligned, unmasked 16-byte cp.async.  The
//     codes are exact in bf16, and for operands that are codes times the
//     scale, rint recovers them exactly.  The planes cost 0.755 GB written
//     and read again for lm100m, so this design's own bound is 3.92 GB,
//     1.17 ms.
//   * tc_update_kernel: one CTA per 128 x 128 block of cells (layer
//     outermost, then row block, then column block, so that one layer's
//     planes stay in L2), eight warps of 64 x 32 cells, m16n8k16 bf16
//     mma.sync with float32 accumulation over the whole token depth, both
//     operands token-major and loaded by ldmatrix.trans from rows padded
//     by 16 bytes (free of bank conflicts), fed by a 4-stage cp.async ring.
//     Every product of two codes and every partial sum is an integer below
//     2^24, so the accumulate is exact: sum_t cx cd, with no dependence on
//     the order.  Pulse-train runs a second product on the same staged
//     fragments with their sign bits cleared (|codes|).
//   * The epilogue is fused: the accumulators go through shared memory
//     (the ring is free by then) so that one copy of the epilogue code
//     walks the block in column pairs, coalesced on G; acc =
//     fl(sum) * fl(sx sd), then the same epilogue / pulse_epilogue as the
//     FP32 instance.  The noise seed is per cell from its tile (l, r /
//     rows, c / cols); a pair of cells at an even tile-local column shares
//     one Box-Muller draw (an even tile width never splits a pair), an odd
//     width takes one draw per cell.  Each cell has exactly one writer.
//   Where the reference's float32 sum is exact (power-of-two scales) the
//   result is bit-equal to it; elsewhere acc differs from the plain
//   version's float32 sum of x_q d_q by the rounding of that sum.
//
// FP32 instance (update_kernel; float operands with no scales, wider
// codes).  Each CTA owns one (layer, k-tile, n-tile) crossbar tile, so
// every conductance has exactly one writer and no cross-block reduction
// exists.  It walks the tile in 64 x 64 blocks; for each block it stages
// 32 tokens of x_q and d_q at a time in shared memory (16 KB) and
// accumulates a 4 x 4 block of the outer product per thread in FP32 FMAs
// over all T tokens (the pulse mode a second 4 x 4 block of |x| |d|, from
// the same staged values: the absolute value is an operand modifier of
// the FMA, so it costs no instruction), then applies the epilogue in
// registers and writes G' once (a thread's columns are adjacent pairs,
// which share one Box-Muller draw).  No (K, N) gradient, magnitude or
// noise field exists in device memory in kernel-noise mode.  What bounds
// it: 2 T K N flops against 8 K N bytes of G in and out: at T = 2048 that
// is 38.7 GFLOP per lm100m layer, 0.58 ms at 67 TFLOP/s FP32, against
// 0.11 ms for the bytes; the pulse mode does twice the FLOPs on the same
// bytes.  The times on the card against the bounds are in PERF.md.
//
// Arithmetic: the epilogues use round-to-nearest intrinsics for every
// multiply, add and divide (so nvcc contracts none of them into an FMA)
// and the libm logf/cosf/sinf/expf/sqrtf/rintf, not the __ intrinsics, so
// they match the plain torch version's elementwise operations one for
// one.  The constants the reference forms in Python doubles (exp(-nu), the
// centre normaliser, (1 - e) * mid, write_noise * pulse_dg, 2 pi) come in
// precomputed as float32.  Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The device model's constants, as the reference rounds them to float32
// (outside the unnamed namespace: the exported launcher takes it by value).
struct DeviceParams {
  int kind;              // 0: dg = dg_req (ideal, linearized);
                         // 1: TaOx, nu_set == nu_reset (one exp per cell);
                         // 2: TaOx, separate SET and RESET factors
  int noise_mode;        // 0: none, 1: host field, 2: counter PRNG
  float gmin, gmax, span;            // span = f32(gmax - gmin)
  float neg_nu, e, emid;             // kind 1: -nu, exp(-nu), (1-e)*mid
  float gain_set, gain_reset;
  int lin_set, lin_reset;            // kind 2: nu < 1e-6 -> 2 (1 - x)
  float neg_nu_set, e_set, ome_set, mid_set;
  float neg_nu_reset, e_reset, ome_reset, mid_reset;
  float pulse_dg, sigma_scale;       // sigma_scale = write_noise * pulse_dg
  float two_pi;
};

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 64;   // tile rows and columns of a block
constexpr int kTC = 32;    // tokens staged per chunk

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, uint32_t layer,
                                              uint32_t tk, uint32_t tn) {
  uint32_t h = mix32(seed ^ 0x9E3779B9u);
  h = mix32(h + 0x9E3779B1u * layer);
  h = mix32(h + 0x85EBCA77u * tk);
  h = mix32(h + 0xC2B2AE3Du * tn);
  return h;
}

// Both Box-Muller outputs of one hashed word (16 bits per uniform).
__device__ __forceinline__ void pair_normals(uint32_t h, float two_pi,
                                             float* z0, float* z1) {
  const float inv = 1.f / 65536.f;
  const float u1 = __fmul_rn(__fadd_rn((float)(h >> 16), 1.f), inv);
  const float u2 = __fmul_rn((float)(h & 0xFFFFu), inv);
  const float rad = __fsqrt_rn(__fmul_rn(-2.f, logf(u1)));
  const float ang = __fmul_rn(two_pi, u2);
  *z0 = __fmul_rn(rad, cosf(ang));
  *z1 = __fmul_rn(rad, sinf(ang));
}

__device__ __forceinline__ float factor(float xx, int lin, float neg_nu,
                                        float e, float ome, float mid) {
  if (lin) return __fmul_rn(2.f, __fsub_rn(1.f, xx));
  const float s = expf(__fmul_rn(neg_nu, xx));
  return __fdiv_rn(__fdiv_rn(__fsub_rn(s, e), ome), mid);
}

// The TaOx SET/RESET step factors at conductance g (p.kind 1 or 2).
__device__ __forceinline__ void updown_factors(float g,
                                               const DeviceParams& p,
                                               float* up, float* dn) {
  const float x = __fdiv_rn(__fsub_rn(g, p.gmin), p.span);
  if (p.kind == 1) {
    const float s = expf(__fmul_rn(p.neg_nu, x));
    *up = __fmul_rn(p.gain_set, __fdiv_rn(__fsub_rn(s, p.e), p.emid));
    *dn = __fmul_rn(p.gain_reset,
                    __fdiv_rn(__fsub_rn(__fdiv_rn(p.e, s), p.e), p.emid));
  } else {
    *up = __fmul_rn(p.gain_set, factor(x, p.lin_set, p.neg_nu_set, p.e_set,
                                       p.ome_set, p.mid_set));
    *dn = __fmul_rn(p.gain_reset,
                    factor(__fsub_rn(1.f, x), p.lin_reset, p.neg_nu_reset,
                           p.e_reset, p.ome_reset, p.mid_reset));
  }
}

// update_mode="outer": _device_epilogue.
__device__ __forceinline__ float epilogue(float g, float dg_req, float z,
                                          const DeviceParams& p) {
  float dg = dg_req;
  if (p.kind != 0) {
    float up, dn;
    updown_factors(g, p, &up, &dn);
    dg = dg_req >= 0.f ? __fmul_rn(dg_req, up) : __fmul_rn(dg_req, dn);
  }
  if (p.noise_mode != 0) {
    const float n_pulses = __fdiv_rn(fabsf(dg_req), p.pulse_dg);
    const float sigma = __fmul_rn(p.sigma_scale, __fsqrt_rn(n_pulses));
    dg = __fadd_rn(dg, __fmul_rn(sigma, z));
  }
  return fminf(fmaxf(__fadd_rn(g, dg), p.gmin), p.gmax);
}

// update_mode="pulse_train": _pulse_epilogue, operation for operation.
__device__ __forceinline__ float pulse_epilogue(float g, float acc,
                                                float a_abs, float m,
                                                float z,
                                                const DeviceParams& p) {
  const float fired = __fmul_rn(a_abs, fabsf(m));
  const float req = __fmul_rn(acc, m);
  const float s_mag = __fmul_rn(0.5f, __fadd_rn(fired, req));
  const float r_mag = __fmul_rn(0.5f, __fsub_rn(fired, req));
  const float n_set = rintf(__fdiv_rn(fmaxf(s_mag, 0.f), p.pulse_dg));
  const float n_reset = rintf(__fdiv_rn(fmaxf(r_mag, 0.f), p.pulse_dg));
  float up = 1.f, dn = 1.f;
  if (p.kind != 0) updown_factors(g, p, &up, &dn);
  float dg = __fmul_rn(p.pulse_dg, __fsub_rn(__fmul_rn(n_set, up),
                                             __fmul_rn(n_reset, dn)));
  if (p.noise_mode != 0) {
    const float sigma =
        __fmul_rn(p.sigma_scale, __fsqrt_rn(__fadd_rn(n_set, n_reset)));
    dg = __fadd_rn(dg, __fmul_rn(sigma, z));
  }
  return fminf(fmaxf(__fadd_rn(g, dg), p.gmin), p.gmax);
}

template <bool kPulse>
__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ g, const float* __restrict__ xq,
              const float* __restrict__ dq, const float* __restrict__ scale,
              const float* __restrict__ noise, float* __restrict__ out,
              int T, int K, int N, int rows, int cols, uint32_t seed,
              uint32_t l0, uint32_t k0t, uint32_t n0t, DeviceParams p) {
  __shared__ __align__(16) float xs[kTC][kBlk];
  __shared__ __align__(16) float ds[kTC][kBlk];
  const int nt = blockIdx.x, kt = blockIdx.y, l = blockIdx.z;
  const int k0 = kt * rows, n0 = nt * cols;
  const int r_end = min(rows, K - k0), c_end = min(cols, N - n0);
  const float* xl = xq + (size_t)l * T * K;
  const float* dl = dq + (size_t)l * T * N;
  const size_t gl = (size_t)l * K * N;
  const float sc = scale[l];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  uint32_t tseed = 0;
  if (p.noise_mode == 2)
    tseed = tile_seed(seed, (uint32_t)l + l0, (uint32_t)kt + k0t,
                      (uint32_t)nt + n0t);
  const bool pairs = (cols & 1) == 0;
  const uint32_t half = (uint32_t)cols >> 1;

  for (int rb = 0; rb < r_end; rb += kBlk) {
    for (int cb = 0; cb < c_end; cb += kBlk) {
      // thread block: rows rb + ty + 16 v, columns cb + 32 w + 2 tx + {0,1}
      // acc: sum_t x d; mag (pulse mode only): sum_t |x| |d|
      float acc[4][4], mag[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;
      if constexpr (kPulse) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 4; ++u) mag[v][u] = 0.f;
      }
      for (int t0 = 0; t0 < T; t0 += kTC) {
#pragma unroll
        for (int i = 0; i < kTC * kBlk / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int t = e / kBlk, c = e % kBlk;
          const bool tok = t0 + t < T;
          xs[t][c] = tok && rb + c < r_end
              ? xl[(size_t)(t0 + t) * K + k0 + rb + c] : 0.f;
          ds[t][c] = tok && cb + c < c_end
              ? dl[(size_t)(t0 + t) * N + n0 + cb + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int t = 0; t < kTC; ++t) {
          float xv[4], w[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) xv[v] = xs[t][ty + 16 * v];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 d2 =
                reinterpret_cast<const float2*>(&ds[t][32 * h])[tx];
            w[2 * h] = d2.x;
            w[2 * h + 1] = d2.y;
          }
#pragma unroll
          for (int v = 0; v < 4; ++v)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[v][u] = fmaf(xv[v], w[u], acc[v][u]);
          if constexpr (kPulse) {
#pragma unroll
            for (int v = 0; v < 4; ++v)
#pragma unroll
              for (int u = 0; u < 4; ++u)
                mag[v][u] = fmaf(fabsf(xv[v]), fabsf(w[u]), mag[v][u]);
          }
        }
        __syncthreads();
      }
      // Device epilogue in registers; one write of G' per cell.
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = rb + ty + 16 * v;
        if (r >= r_end) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = cb + 32 * h + 2 * tx;   // even, tile-local
          if (c >= c_end) continue;
          float z[2] = {0.f, 0.f};
          if (p.noise_mode == 2) {
            if (pairs) {
              pair_normals(mix32(((uint32_t)r * half + (uint32_t)(c >> 1))
                                 ^ tseed), p.two_pi, &z[0], &z[1]);
            } else {
              float unused;
              const uint32_t idx = (uint32_t)r * (uint32_t)cols + (uint32_t)c;
              pair_normals(mix32(idx ^ tseed), p.two_pi, &z[0], &unused);
              pair_normals(mix32((idx + 1u) ^ tseed), p.two_pi, &z[1],
                           &unused);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (c + q >= c_end) continue;
            const size_t off = gl + (size_t)(k0 + r) * N + n0 + c + q;
            if (p.noise_mode == 1) z[q] = noise[off];
            if constexpr (kPulse) {
              out[off] = pulse_epilogue(g[off], acc[v][2 * h + q],
                                        mag[v][2 * h + q], sc, z[q], p);
            } else {
              const float dg_req = __fmul_rn(sc, acc[v][2 * h + q]);
              out[off] = epilogue(g[off], dg_req, z[q], p);
            }
          }
        }
      }
    }
  }
}

template <bool kPulse>
int launch(const float* g, const float* xq, const float* dq,
           const float* scale, const float* noise, float* out, int L, int T,
           int K, int N, int rows, int cols, unsigned int seed,
           const unsigned int* offs, const DeviceParams& params,
           void* stream) {
  if (L <= 0 || T <= 0 || K <= 0 || N <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (params.noise_mode == 1 && noise == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tk = (K + rows - 1) / rows, tn = (N + cols - 1) / cols;
  if (tk > 65535 || L > 65535 || tn > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  update_kernel<kPulse><<<dim3((unsigned)tn, (unsigned)tk, (unsigned)L),
                          kThreads, 0, (cudaStream_t)stream>>>(
      g, xq, dq, scale, noise, out, T, K, N, rows, cols, seed, offs[0],
      offs[1], offs[2], params);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// Tensor-core instance
// --------------------------------------------------------------------------

constexpr int kTcThreads = 256;
constexpr int kTcBlock = 128;   // rows and columns of a CTA's block of cells
constexpr int kTcTok = 32;      // tokens of a stage
constexpr int kTcStages = 4;
constexpr int kTcLd = kTcBlock + 8;           // bf16 row of a staged plane
constexpr int kTcPlane = kTcTok * kTcLd;      // bf16 of one staged plane
constexpr int kTcStage = 2 * kTcPlane;        // x and d planes of a stage
constexpr int kAccLd = kTcBlock + 8;          // float row of the staged sums
constexpr int kRingBytes = kTcStages * kTcStage * 2;
constexpr int kAccBytes = kTcBlock * kAccLd * 4;
constexpr int kTcMaxLevels = 256;             // codes exact in bf16 up to here
static_assert(kTcBlock * kTcTok / 8 == 2 * kTcThreads, "two copies a plane");

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

// Four 8x8 bf16 matrices from shared memory, transposed, one row address a
// lane (lanes 8i..8i+7 address matrix i).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
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

// Once per write: the code planes cx[l, t, k] = clip(rint(x_q[l, t, k] /
// xs[l]), +-x_levels) and cd[l, t, n] likewise, as bf16, zero in the
// padding (t >= T, k >= K, n >= N).  Each thread writes 8 codes (16 bytes)
// of one plane row; one grid row per layer.
__global__ void __launch_bounds__(256)
update_prepare_kernel(const float* __restrict__ xq,
                      const float* __restrict__ dq,
                      const float* __restrict__ xs,
                      const float* __restrict__ ds,
                      __nv_bfloat16* __restrict__ cx,
                      __nv_bfloat16* __restrict__ cd, int T, int K, int N,
                      int Tp, int Kp, int Np, float x_levels,
                      float d_levels) {
  const int l = blockIdx.y;
  const int nx = Tp * Kp / 8, nd = Tp * Np / 8;  // < 2^28 (tc_dims_ok)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nx + nd;
       i += gridDim.x * blockDim.x) {
    const bool is_x = i < nx;
    const int j = 8 * (is_x ? i : i - nx);
    const int width = is_x ? Kp : Np, feat = is_x ? K : N;
    const int t = j / width, f = j - t * width;
    const float* src = is_x ? xq + ((size_t)l * T + t) * K
                            : dq + ((size_t)l * T + t) * N;
    const float s = is_x ? xs[l] : ds[l];
    const float lv = is_x ? x_levels : d_levels;
    float c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      c[u] = 0.f;
      if (t < T && f + u < feat)
        c[u] = fminf(fmaxf(rintf(__fdiv_rn(src[f + u], s)), -lv), lv);
    }
    uint32_t w[4];  // bf16 pairs, the lower address in the low half
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * u], c[2 * u + 1]);
      w[u] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __nv_bfloat16* dst = is_x ? cx + ((size_t)l * Tp + t) * Kp + f
                              : cd + ((size_t)l * Tp + t) * Np + f;
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct TcArgs {
  const float* g;            // (L, K, N)
  const __nv_bfloat16* cx;   // (L, Tp, Kp) row codes
  const __nv_bfloat16* cd;   // (L, Tp, Np) column codes
  const float* scale;        // (L,)
  const float* xs;           // (L,) row scale: x_q = cx * xs
  const float* ds;           // (L,) column scale: d_q = cd * ds
  const float* noise;        // (L, K, N) in host-noise mode, else null
  float* out;                // (L, K, N)
  int K, N, Tp, Kp, Np, rows, cols;
  uint32_t seed;
  uint32_t l0, k0t, n0t;     // the block's (layer, row-tile, col-tile) base
};

// Copies the 32 tokens from t0 of the CTA's 128 row codes and 128 column
// codes into a stage: [token][row] and [token][column] rows of kTcLd.
__device__ __forceinline__ void tc_load_stage(const __nv_bfloat16* xl,
                                              const __nv_bfloat16* dl,
                                              int Kp, int Np, int t0,
                                              __nv_bfloat16* st) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int t = e >> 4, q = e & 15;
    cp_async16(st + t * kTcLd + q * 8, xl + (size_t)(t0 + t) * Kp + q * 8);
    cp_async16(st + kTcPlane + t * kTcLd + q * 8,
               dl + (size_t)(t0 + t) * Np + q * 8);
  }
}

// acc += the stage's products: each warp a 64 x 32 block of cells, 4 x 4
// tiles of m16n8, two k16 steps; mag (pulse-train) the same on |codes|.
template <bool kPulse>
__device__ __forceinline__ void tc_mma_stage(const __nv_bfloat16* st,
                                             int wm, int wn,
                                             float (&acc)[4][4][4],
                                             float (&mag)[4][4][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* sx = st;
  const __nv_bfloat16* sd = st + kTcPlane;
#pragma unroll
  for (int ks = 0; ks < kTcTok / 16; ++ks) {
    // A = X^T (rows x tokens) from [token][row]: matrix i of the x4 load
    // is (rows 8 (i & 1), tokens 8 (i >> 1)) of the 16 x 16 fragment.
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4_trans(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                        sx + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 kTcLd +
                            wm + mt * 16 + ((lane >> 3) & 1) * 8);
    // B = D (tokens x columns) from [token][column]: the transposed load
    // gives token pairs
    uint32_t bf[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4_trans(bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
                        bf[2 * np + 1][1],
                        sd + (ks * 16 + (lane & 15)) * kTcLd + wn + np * 16 +
                            (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    if constexpr (kPulse) {
      // |codes|: clear the sign bit of both bf16 halves
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[mt][r] &= 0x7FFF7FFFu;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bf[nt][0] &= 0x7FFF7FFFu;
        bf[nt][1] &= 0x7FFF7FFFu;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_bf16(mag[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}

// One warp's accumulator fragments into the [row][column] float tile.
__device__ __forceinline__ void tc_stage_sums(float* tile, int wm, int wn,
                                              const float (&a)[4][4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm + mt * 16 + (lane >> 2);
      const int c = wn + nt * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(tile + r * kAccLd + c) =
          make_float2(a[mt][nt][0], a[mt][nt][1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * kAccLd + c) =
          make_float2(a[mt][nt][2], a[mt][nt][3]);
    }
}

// One CTA per (128-column block, 128-row block, layer): the exact integer
// sums over all tokens, then the device epilogue, one write of G' a cell.
template <bool kPulse>
__global__ void __launch_bounds__(kTcThreads, kPulse ? 1 : 2)
tc_update_kernel(TcArgs a, DeviceParams p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  const int n0 = blockIdx.x * kTcBlock, k0 = blockIdx.y * kTcBlock;
  const int l = blockIdx.z;
  const __nv_bfloat16* xl = a.cx + (size_t)l * a.Tp * a.Kp + k0;
  const __nv_bfloat16* dl = a.cd + (size_t)l * a.Tp * a.Np + n0;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  float acc[4][4][4], mag[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[mt][nt][r] = 0.f;
        mag[mt][nt][r] = 0.f;
      }
  const int steps = a.Tp / kTcTok;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps)
      tc_load_stage(xl, dl, a.Kp, a.Np, s * kTcTok, ring + s * kTcStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    const int ahead = s + kTcStages - 1;
    if (ahead < steps)
      tc_load_stage(xl, dl, a.Kp, a.Np, ahead * kTcTok,
                    ring + (ahead % kTcStages) * kTcStage);
    cp_async_commit();
    tc_mma_stage<kPulse>(ring + (s % kTcStages) * kTcStage, wm, wn, acc,
                         mag);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the sums from here on
  float* sacc = reinterpret_cast<float*>(tc_smem);
  float* smag = sacc + kTcBlock * kAccLd;
  tc_stage_sums(sacc, wm, wn, acc);
  if constexpr (kPulse) tc_stage_sums(smag, wm, wn, mag);
  __syncthreads();

  // Each thread takes one column pair c, c + 1 of the block, in every
  // kRowStep-th row: its tile column, its tile-local columns and (while
  // the tile row stays the same) its tile's noise seed are computed once.
  constexpr int kRowStep = kTcThreads / (kTcBlock / 2);
  const int cc = 2 * (threadIdx.x % (kTcBlock / 2));
  const int c = n0 + cc;
  if (c >= a.N) return;
  const float sxd = __fmul_rn(a.xs[l], a.ds[l]);
  const float sc = a.scale[l];
  const size_t gl = (size_t)l * a.K * a.N;
  const bool pairs = (a.cols & 1) == 0;
  const uint32_t half = (uint32_t)a.cols >> 1;
  const bool two = c + 1 < a.N;
  int tn[2], cl[2];  // tile column and tile-local column of c and c + 1
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    tn[q] = (c + q) / a.cols;
    cl[q] = c + q - tn[q] * a.cols;
  }
  int tk = -1, rl = 0;
  uint32_t ts[2] = {0u, 0u};
#pragma unroll 1
  for (int rr = threadIdx.x / (kTcBlock / 2); rr < kTcBlock;
       rr += kRowStep) {
    const int r = k0 + rr;
    if (r >= a.K) break;
    if (tk < 0 || rl + kRowStep >= a.rows) {  // a new tile row
      tk = r / a.rows;
      rl = r - tk * a.rows;
      if (p.noise_mode == 2) {
        ts[0] = tile_seed(a.seed, (uint32_t)l + a.l0, (uint32_t)tk + a.k0t,
                          (uint32_t)tn[0] + a.n0t);
        ts[1] = tn[1] == tn[0]
                    ? ts[0]
                    : tile_seed(a.seed, (uint32_t)l + a.l0,
                                (uint32_t)tk + a.k0t, (uint32_t)tn[1] + a.n0t);
      }
    } else {
      rl += kRowStep;
    }
    const float2 s2 =
        *reinterpret_cast<const float2*>(sacc + rr * kAccLd + cc);
    const float av[2] = {__fmul_rn(s2.x, sxd), __fmul_rn(s2.y, sxd)};
    float mv[2] = {0.f, 0.f};
    if constexpr (kPulse) {
      const float2 m2 =
          *reinterpret_cast<const float2*>(smag + rr * kAccLd + cc);
      mv[0] = __fmul_rn(m2.x, sxd);
      mv[1] = __fmul_rn(m2.y, sxd);
    }
    float z[2] = {0.f, 0.f};
    if (p.noise_mode == 2) {
      if (pairs) {  // c is even, so c and c + 1 share a tile and a draw
        pair_normals(
            mix32(((uint32_t)rl * half + (uint32_t)(cl[0] >> 1)) ^ ts[0]),
            p.two_pi, &z[0], &z[1]);
      } else {
        float unused;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (q == 0 || two)
            pair_normals(mix32(((uint32_t)rl * (uint32_t)a.cols +
                                (uint32_t)cl[q]) ^ ts[q]),
                         p.two_pi, &z[q], &unused);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) continue;
      const size_t off = gl + (size_t)r * a.N + c + q;
      if (p.noise_mode == 1) z[q] = a.noise[off];
      if constexpr (kPulse)
        a.out[off] = pulse_epilogue(a.g[off], av[q], mv[q], sc, z[q], p);
      else
        a.out[off] = epilogue(a.g[off], __fmul_rn(sc, av[q]), z[q], p);
    }
  }
}

template <bool kPulse>
int tc_launch(const TcArgs& a, int L, const DeviceParams& params,
              void* stream) {
  constexpr int smem = (kPulse ? 2 * kAccBytes : kAccBytes) > kRingBytes
                           ? (kPulse ? 2 * kAccBytes : kAccBytes)
                           : kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      tc_update_kernel<kPulse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  tc_update_kernel<kPulse><<<dim3((unsigned)(a.Np / kTcBlock),
                                  (unsigned)(a.Kp / kTcBlock), (unsigned)L),
                             kTcThreads, smem, (cudaStream_t)stream>>>(
      a, params);
  return (int)cudaGetLastError();
}

// The code planes' padded dims are the caller's; they must be what the
// kernels assume.
bool tc_dims_ok(int L, int T, int K, int N, int Tp, int Kp, int Np) {
  return L > 0 && T > 0 && K > 0 && N > 0 && Tp >= T && Kp >= K &&
         Np >= N && Tp % kTcTok == 0 && Kp % kTcBlock == 0 &&
         Np % kTcBlock == 0 && Kp / kTcBlock <= 65535 && L <= 65535 &&
         (long long)Tp * (Kp + Np) < (1LL << 31);
}

}  // namespace

extern "C" {

// Each launcher returns the CUDA error code of its launch (0 on success).

// FP32 instance.  Launch the rank-k write on `stream`: g/out (L,K,N), xq
// (L,T,K), dq (L,T,N), scale (L,) and, in host-noise mode, noise (L,K,N)
// are contiguous float32 device arrays; out must not alias g.  seed keys
// the counter PRNG in kernel-noise mode; l0, k0, n0 are the block's
// (layer, row-tile, col-tile) base coordinates in a larger container (0 for
// a whole container): tile (l, kt, nt) draws the stream of (l + l0, kt +
// k0, nt + n0), so a block written alone gets its slice of the whole write.

// update_mode="outer"
int xbar_outer_update(const float* g, const float* xq, const float* dq,
                      const float* scale, const float* noise, float* out,
                      int L, int T, int K, int N, int rows, int cols,
                      unsigned int seed, unsigned int l0, unsigned int k0,
                      unsigned int n0, DeviceParams params, void* stream) {
  const unsigned int offs[3] = {l0, k0, n0};
  return launch<false>(g, xq, dq, scale, noise, out, L, T, K, N, rows, cols,
                       seed, offs, params, stream);
}

// update_mode="pulse_train"
int xbar_pulse_update(const float* g, const float* xq, const float* dq,
                      const float* scale, const float* noise, float* out,
                      int L, int T, int K, int N, int rows, int cols,
                      unsigned int seed, unsigned int l0, unsigned int k0,
                      unsigned int n0, DeviceParams params, void* stream) {
  const unsigned int offs[3] = {l0, k0, n0};
  return launch<true>(g, xq, dq, scale, noise, out, L, T, K, N, rows, cols,
                      seed, offs, params, stream);
}


// Tensor-core instance.  The code planes live in one bf16 buffer of
// L Tp (Kp + Np) elements, the row codes (L, Tp, Kp) first; Tp is T
// padded to a multiple of 32, Kp and Np are K and N padded to multiples of
// 128 (kernels/xbar_update.update_code_dims).

// The pre-pass: xq (L,T,K), dq (L,T,N), xs/ds (L,) contiguous float32.
int xbar_update_prepare(const float* xq, const float* dq, const float* xs,
                        const float* ds, __nv_bfloat16* codes, int L, int T,
                        int K, int N, int Tp, int Kp, int Np, float x_levels,
                        float d_levels, void* stream) {
  if (!tc_dims_ok(L, T, K, N, Tp, Kp, Np) || x_levels > kTcMaxLevels ||
      d_levels > kTcMaxLevels)
    return (int)cudaErrorInvalidValue;
  const int groups = Tp * (Kp + Np) / 8;
  const int blocks = (groups + 255) / 256;
  update_prepare_kernel<<<dim3((unsigned)(blocks < 65535 ? blocks : 65535),
                               (unsigned)L),
                          256, 0, (cudaStream_t)stream>>>(
      xq, dq, xs, ds, codes, codes + (size_t)L * Tp * Kp, T, K, N, Tp, Kp,
      Np, x_levels, d_levels);
  return (int)cudaGetLastError();
}

// The write from the code planes: g/out (L,K,N), scale/xs/ds (L,) and, in
// host-noise mode, noise (L,K,N) contiguous float32; out must not alias g.
// pulse selects update_mode="pulse_train"; seed, l0, k0, n0 as for the FP32
// instance.
int xbar_tc_update(int pulse, const float* g, const __nv_bfloat16* codes,
                   const float* scale, const float* xs, const float* ds,
                   const float* noise, float* out, int L, int T, int K,
                   int N, int Tp, int Kp, int Np, int rows, int cols,
                   unsigned int seed, unsigned int l0, unsigned int k0,
                   unsigned int n0, DeviceParams params, void* stream) {
  if (!tc_dims_ok(L, T, K, N, Tp, Kp, Np) || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (params.noise_mode == 1 && noise == nullptr)
    return (int)cudaErrorInvalidValue;
  TcArgs a{g, codes, codes + (size_t)L * Tp * Kp, scale, xs, ds, noise,
           out, K, N, Tp, Kp, Np, rows, cols, seed, l0, k0, n0};
  return pulse ? tc_launch<true>(a, L, params, stream)
               : tc_launch<false>(a, L, params, stream);
}

}  // extern "C"
