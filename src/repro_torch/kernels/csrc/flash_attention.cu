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
// k and v (B, Skv, KVH, hd), float32 or bfloat16; the softmax runs in
// float32 and the output is written in q's dtype.  As in the reference:
// running max m, running sum l and the accumulator are float32; each key
// block rescales them by corr = exp(m_old - m_new); the result is
// acc / max(l, 1e-30).
//
// What bounds it.  4 B H Sq Skv hd operations (halved when causal) against
// (q + k + v + o) bytes: at S = 2048 every case is bound by operations, by
// the bf16 tensor cores (989 TFLOP/s) for bfloat16 inputs and by the FP32
// rate (67 TFLOP/s) for float32 ones; the float32 design's own floor is its
// three TF32 products at 495 TFLOP/s.
//
// Design for this card (FlashAttention-2 on warp-level mma.sync).  One CTA
// of four warps per (batch x head, 64 query rows); each warp owns 16 query
// rows.  The CTA walks the key/value blocks (64 keys; 32 at hd 256, where
// the 16 x 256 float32 accumulator takes 128 registers a thread), each
// copied into shared memory with cp.async while the previous block
// computes (two stages; rows zero-filled past the sequence).  Per block:
//   * S = Q K^T on the tensor cores into m16n8 float32 fragments;
//   * the online softmax on those fragments in registers, scores scaled by
//     scale * log2(e) and exponentiated with ex2.approx; the row max is
//     reduced over the four threads of a row with shuffles each block,
//     the row sum once at the end;
//   * O += P V with P taken straight from the score fragments as the A
//     operand (it never goes through shared memory).
// bfloat16: m16n8k16 bf16 products with float32 accumulation; Q's
// fragments are loaded once (ldmatrix-free 32-bit loads from padded rows)
// and kept in registers up to hd 128; V is read with ldmatrix.trans; P is
// rounded to bf16 for P V, as the reference's own float32 dot of p at the
// TPU's default precision does.
// float32: the same structure with 3xTF32 m16n8k8 products (a_lo b_hi +
// a_hi b_lo + a_hi b_hi, each operand split as hi = tf32(x), lo =
// tf32(x - hi)), which keeps about 2^-21 relative error per product, inside
// the float32 tolerance; P V takes the score fragment's key pairs in a
// permuted order (2t, 2t + 1 as logical keys t, t + 4) with V read in the
// same order, so no shuffle is needed.
// Causal: key blocks wholly above the diagonal are skipped (in the
// reference they add exactly nothing: p = 0, corr = 1) and only blocks that
// reach the diagonal are masked; the query blocks launch longest first so
// that the causal tail does not leave SMs idle.  The (B, S, H, hd) layout
// is read in place with strides: no transposed copy is made.  hd is a
// template parameter (64, 80, 128, 256: the registry's head dims); the
// block's tile sizes are internal, and the wrapper's block_q / block_k keep
// only their contract (the sequence lengths must divide them).  Build
// without --use_fast_math: the final division stays IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBQ = 64;        // query rows of a CTA, 16 per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// elements added to a shared-memory row: 16 bytes
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}
template <typename T, int HD>
__host__ __device__ constexpr int row_ld() {
  return HD + pad<T>();
}
template <int HD>
__host__ __device__ constexpr int key_block() {
  return HD == 256 ? 32 : 64;
}
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)row_ld<T, HD>() * (kBQ + 4 * key_block<HD>());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x HD elements from global (row stride gstride elements, rows past
// n_valid zero) into shared memory rows of row_ld elements.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* s, const T* g, size_t gstride,
                                          int row0, int rows, int n_valid) {
  constexpr int kEl = 16 / (int)sizeof(T);
  constexpr int kPer = HD / kEl;
  for (int e = threadIdx.x; e < rows * kPer; e += kThreads) {
    const int r = e / kPer, c = (e - r * kPer) * kEl;
    const bool ok = row0 + r < n_valid;
    cp_async16(s + r * row_ld<T, HD>() + c,
               g + (size_t)(ok ? row0 + r : 0) * gstride + c, ok);
  }
}

// 2^x by the SFU (ex2.approx: 2 ulp; results below the normal range
// flush to 0, where p adds nothing anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float (&a)[4],
                                           float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int KVH, int causal, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KB = key_block<HD>();
  constexpr int LD = row_ld<T, HD>();
  constexpr int NT = KB / 8;  // score n8 tiles of a key block
  constexpr int DT = HD / 8;  // accumulator n8 tiles
  constexpr bool kQRegs = kBf16 && HD <= 128;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* qs = reinterpret_cast<T*>(fa_smem);  // [kBQ][LD]
  T* ks = qs + kBQ * LD;                  // [2][KB][LD]
  T* vs = ks + 2 * KB * LD;               // [2][KB][LD]

  // longest causal query blocks first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KVH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the block
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KVH * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Skv * KVH + g) * HD;
  const T* vb = v + ((size_t)b * Skv * KVH + g) * HD;
  const float sl2 = scale * kLog2e;

  // Causal: keys after the block's last query row are masked for every
  // row of the block, so their blocks are skipped.
  const int kv_end = causal ? min(Skv, min(Sq, q0 + kBQ)) : Skv;
  const int n_blocks = (kv_end + KB - 1) / KB;

  load_rows<T, HD>(qs, qb, q_row, q0, kBQ, Sq);
  load_rows<T, HD>(ks, kb, kv_row, 0, KB, Skv);
  load_rows<T, HD>(vs, vb, kv_row, 0, KB, Skv);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[d][r] = 0.f;
  uint32_t qf[kQRegs ? HD / 16 : 1][4];

  for (int i = 0; i < n_blocks; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_blocks) {
      load_rows<T, HD>(ks + (cur ^ 1) * KB * LD, kb, kv_row, (i + 1) * KB,
                       KB, Skv);
      load_rows<T, HD>(vs + (cur ^ 1) * KB * LD, vb, kv_row, (i + 1) * KB,
                       KB, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kc = ks + cur * KB * LD;
    const T* vc = vs + cur * KB * LD;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
    if constexpr (kBf16) {
      const __nv_bfloat16* qw =
          reinterpret_cast<const __nv_bfloat16*>(qs) + (wrow + gq) * LD;
      const __nv_bfloat16* kw = reinterpret_cast<const __nv_bfloat16*>(kc);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * tg;
        uint32_t a[4];
        if constexpr (kQRegs) {
          if (i == 0) {
            qf[kk][0] = ld32(qw + c);
            qf[kk][1] = ld32(qw + 8 * LD + c);
            qf[kk][2] = ld32(qw + c + 8);
            qf[kk][3] = ld32(qw + 8 * LD + c + 8);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
        } else {
          a[0] = ld32(qw + c);
          a[1] = ld32(qw + 8 * LD + c);
          a[2] = ld32(qw + c + 8);
          a[3] = ld32(qw + 8 * LD + c + 8);
        }
        // K rows are [key][d]: ldmatrix gives the (d pair, key) fragments
        // of two key tiles at once
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(smem_addr(kw +
                              (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8)));
          mma_bf16(s[n], a, b0, b1);
          mma_bf16(s[n + 1], a, b2, b3);
        }
      }
    } else {
      const float* qw = reinterpret_cast<const float*>(qs) + (wrow + gq) * LD;
      const float* kw = reinterpret_cast<const float*>(kc);
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = kk * 8 + tg;
        const float a[4] = {qw[c], qw[8 * LD + c], qw[c + 4],
                            qw[8 * LD + c + 4]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* kp = kw + (n * 8 + gq) * LD + c;
          mma_3xtf32(s[n], a, kp[0], kp[4]);
        }
      }
    }

    // scale, mask, online softmax (rows gq and gq + 8 of the warp)
    const int k0 = i * KB;
    const bool mask = (causal && k0 + KB - 1 > q0 + wrow) || k0 + KB > Skv;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[n][r] * sl2;
        if (mask) {
          const int key = k0 + n * 8 + 2 * tg + (r & 1);
          const int row = q0 + wrow + gq + 8 * (r >> 1);
          if (causal && key > row) x = kNegInf;
          if (key >= Skv) x = -INFINITY;  // past the sequence: no weight
        }
        s[n][r] = x;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // this thread's share of the row sum; the quad's shares are added
      // once, after the last block
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = fast_exp2(s[n][2 * rr + u] - m_new);
          s[n][2 * rr + u] = p;
          rs += p;
        }
      const float corr = fast_exp2(m[rr] - m_new);
      l[rr] = corr * l[rr] + rs;
      m[rr] = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * rr] *= corr;
        acc[d][2 * rr + 1] *= corr;
      }
    }

    // O += P V
    if constexpr (kBf16) {
      const __nv_bfloat16* vw = reinterpret_cast<const __nv_bfloat16*>(vc);
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* vrow = vw + (kk * 16 + (lane & 15)) * LD +
                                    (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0,%1,%2,%3}, [%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(smem_addr(vrow + d * 8)));
          mma_bf16(acc[d], a, b0, b1);
          mma_bf16(acc[d + 1], a, b2, b3);
        }
      }
    } else {
      const float* vw = reinterpret_cast<const float*>(vc);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // logical key tg <-> key 2 tg, tg + 4 <-> 2 tg + 1 of the tile
        const float a[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
        const float* vp = vw + (n * 8 + 2 * tg) * LD + gq;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          mma_3xtf32(acc[d], a, vp[d * 8], vp[LD + d * 8]);
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }

  T* ob = o + ((size_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + wrow + gq + 8 * rr;
    if (row >= Sq) continue;
    const float inv = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(ob + (size_t)row * q_row + d * 8 + 2 * tg,
             acc[d][2 * rr] / inv, acc[d][2 * rr + 1] / inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KVH, int causal, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
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
      (long long)B * H > 2147483647LL || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KVH,
                                         causal, scale, st)
              : launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                 scale, st);
}

}  // extern "C"
