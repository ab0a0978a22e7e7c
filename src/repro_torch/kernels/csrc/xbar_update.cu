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
// reference's hash words.  Both modes draw the same normals.
//
// Design for this card.  Each CTA owns one (layer, k-tile, n-tile) crossbar
// tile, so every conductance has exactly one writer and no cross-block
// reduction exists.  It walks the tile in 64 x 64 blocks; for each block
// it stages 32 tokens of x_q and d_q at a time in shared memory (16 KB)
// and accumulates a 4 x 4 block of the outer product per thread in FP32
// FMAs over all T tokens (the pulse mode a second 4 x 4 block of
// |x| |d|, from the same staged values: the absolute value is an operand
// modifier of the FMA, so it costs no instruction), then applies the
// epilogue in registers and writes G' once (a thread's columns are
// adjacent pairs, which share one Box-Muller draw).  No (K, N) gradient,
// magnitude or noise field exists in device memory in kernel-noise mode.
// The mode is a template parameter, so the outer instance compiles as it
// did before the pulse mode existed.
//
// What bounds it.  The outer accumulate is 2 T K N flops against 8 K N
// bytes of G in and out: at T = 2048 (lm100m training, 8 x 256 tokens)
// that is 38.7 GFLOP per layer, 0.58 ms at 67 TFLOP/s FP32, against 0.11
// ms for the bytes, so the FLOPs bound it; the pulse mode does twice the
// FLOPs on the same bytes.  Plain FP32 FMAs on CUDA cores (no TF32, no
// wgmma/TMA); the time on the card against the bound is in PERF.md.
//
// Arithmetic: the epilogues use round-to-nearest intrinsics for every
// multiply, add and divide (so nvcc contracts none of them into an FMA)
// and the libm logf/cosf/sinf/expf/sqrtf/rintf, not the __ intrinsics, so
// they match the plain torch version's elementwise operations one for
// one.  The constants the reference forms in Python doubles (exp(-nu), the
// centre normaliser, (1 - e) * mid, write_noise * pulse_dg, 2 pi) come in
// precomputed as float32.  Build without --use_fast_math.

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
              DeviceParams p) {
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
    tseed = tile_seed(seed, (uint32_t)l, (uint32_t)kt, (uint32_t)nt);
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
           const DeviceParams& params, void* stream) {
  if (L <= 0 || T <= 0 || K <= 0 || N <= 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (params.noise_mode == 1 && noise == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tk = (K + rows - 1) / rows, tn = (N + cols - 1) / cols;
  if (tk > 65535 || L > 65535 || tn > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  update_kernel<kPulse><<<dim3((unsigned)tn, (unsigned)tk, (unsigned)L),
                          kThreads, 0, (cudaStream_t)stream>>>(
      g, xq, dq, scale, noise, out, T, K, N, rows, cols, seed, params);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the rank-k write on `stream`: g/out (L,K,N), xq (L,T,K),
// dq (L,T,N), scale (L,) and, in host-noise mode, noise (L,K,N) are
// contiguous float32 device arrays; out must not alias g.  seed keys the
// counter PRNG in kernel-noise mode.  Each returns the CUDA error code of
// the launch (0 on success).

// update_mode="outer"
int xbar_outer_update(const float* g, const float* xq, const float* dq,
                      const float* scale, const float* noise, float* out,
                      int L, int T, int K, int N, int rows, int cols,
                      unsigned int seed, DeviceParams params, void* stream) {
  return launch<false>(g, xq, dq, scale, noise, out, L, T, K, N, rows, cols,
                       seed, params, stream);
}

// update_mode="pulse_train"
int xbar_pulse_update(const float* g, const float* xq, const float* dq,
                      const float* scale, const float* noise, float* out,
                      int L, int T, int K, int N, int rows, int cols,
                      unsigned int seed, DeviceParams params, void* stream) {
  return launch<true>(g, xq, dq, scale, noise, out, L, T, K, N, rows, cols,
                      seed, params, stream);
}

}  // extern "C"
