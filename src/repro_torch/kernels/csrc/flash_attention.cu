// Flash attention (forward) for Hopper (sm_90a): causal or full softmax
// attention with grouped-query heads, the score matrix never written to
// device memory.
//
// Replaces the TPU kernel _fa_kernel of src/repro/kernels/
// flash_attention.py:29 (launched by flash_attention), forward only:
//   o[b, s, h] = softmax_t( q[b, s, h] . k[b, t, g] * scale ) @ v[b, :, g]
// with g = h / (H / KVH) the key/value head of query head h, scale =
// 1 / sqrt(hd), and in causal mode the score of key t > s set to -1e30
// (never -inf; top-left alignment when Sq != Skv).  q is (B, Sq, H, hd),
// k and v (B, Skv, KVH, hd), float32 or bfloat16; everything is computed
// in float32 and the output is written in q's dtype.  As in the
// reference: running max m, running sum l and the accumulator are
// float32; each key block rescales them by corr = exp(m_old - m_new); the
// result is acc / max(l, 1e-30).
//
// Design for this card.  One block of 256 threads per (batch x head,
// 64-row query block).  The query block is staged once in shared memory
// (transposed, float32); the block then walks the key/value blocks of 32
// keys, staging each in shared memory, and keeps the running max, sum
// and the 64 x hd accumulator in registers: thread (tx, ty) of a 16 x 16
// layout owns query rows ty + 16 i (i < 4), score columns tx + 16 c
// (c < 2) and accumulator columns tx + 16 c (c < hd / 16).  Row maxima and
// sums are reduced over the 16 threads of a row with warp shuffles.  The
// probabilities go through shared memory to the P V product.  Key blocks
// wholly above the diagonal are skipped: in the reference they add
// exactly nothing (p = 0, corr = 1).  The (B, S, H, hd) layout is read in
// place with strides: no transposed copy is made.  hd is a template
// parameter (64, 80, 128, 256: the registry's head dims); the block's own
// tile sizes are internal, and the wrapper's block_q / block_k keep only
// their contract (the sequence lengths must divide them).
//
// What bounds it.  4 B H Sq Skv hd operations (halved when causal) against
// (q + k + v + o) bytes: at S = 2048 every case is bound by operations,
// by the FP32 rate (67 TFLOP/s) for float32 inputs and by the bf16 tensor
// cores (989 TFLOP/s) for bfloat16 ones.  This first version computes on
// the FP32 cores for both (no mma / wgmma), reading shared memory about
// once per two FMAs, so it runs far below either bound; the times are in
// PERF.md.  Build without --use_fast_math (expf, not __expf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows of a block
constexpr int kBK = 32;  // keys staged at a time
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (kBQ + 1) + (size_t)HD * (kBK + 1) +
         (size_t)kBK * HD + (size_t)kBK * (kBQ + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int KVH, int causal, float scale) {
  constexpr int kC = HD / 16;  // accumulator columns of a thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [HD][kBQ + 1]
  float* ks = qs + HD * (kBQ + 1);      // [HD][kBK + 1]
  float* vs = ks + HD * (kBK + 1);      // [kBK][HD]
  float* ps = vs + kBK * HD;            // [kBK][kBQ + 1]

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KVH * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Skv * KVH + g) * HD;
  const T* vb = v + ((size_t)b * Skv * KVH + g) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    qs[d * (kBQ + 1) + r] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  // Causal: keys after the block's last query row are masked for every
  // row of the block, so their blocks are skipped.
  const int kv_end = causal ? min(Skv, min(Sq, q0 + kBQ)) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous block's ks / vs / ps reads are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e - j * HD;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < Skv) {
        kv = to_f32(kb[(size_t)(k0 + j) * kv_row + d]);
        vv = to_f32(vb[(size_t)(k0 + j) * kv_row + d]);
      }
      ks[d * (kBK + 1) + j] = kv;
      vs[j * HD + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 2; ++c) kv[c] = ks[d * (kBK + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + tx + 16 * c;
        float sv = s[i][c] * scale;
        if (causal && kp > qp) sv = kNegInf;
        if (kp >= Skv) sv = -INFINITY;  // past the sequence: no weight
        s[i][c] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[i][c] - m_new);
        s[i][c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + rs;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ps[(tx + 16 * c) * (kBQ + 1) + ty + 16 * i] = s[i][c];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[j * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + ((size_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      store(ob + (size_t)r * q_row + tx + 16 * c, acc[i][c] / inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KVH, int causal, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KVH, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Skv, int H, int KVH, int causal,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, scale, st);
    case 80:
      return launch<T, 80>(q, k, v, o, B, Sq, Skv, H, KVH, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, scale,
                            st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KVH, causal, scale,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches flash attention on `stream`: q (B, Sq, H, hd), k and v
// (B, Skv, KVH, hd) into o (B, Sq, H, hd), all contiguous device arrays of
// one dtype (bf16 = 0: float32; bf16 = 1: bfloat16).  hd is 64, 80, 128 or
// 256 and H a multiple of KVH.  Returns the CUDA error code of the launch
// (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int KVH,
                        int hd, int causal, int bf16, float scale,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KVH <= 0 || H % KVH ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KVH,
                                         causal, scale, st)
              : launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                 scale, st);
}

}  // extern "C"
