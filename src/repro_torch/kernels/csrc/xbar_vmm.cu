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
// Two instances; read_instance() in kernels/xbar_vmm.py picks one from the
// operands (batch B and in_levels), never from a failure.
//
// Tensor-core instance (B > 16 and in_levels <= 256: training batches and
// prefill).  What bounds it: the products, 2 B K N flops per read (38.7
// GFLOP per lm100m layer and direction at B = 2048: 0.577 ms at the 67
// TFLOP/s FP32 rate).  Design:
//   * read_prepare_kernel, once per read, writes the DAC codes into an
//     (L, Bp, tR, Rp) bf16 buffer (each reduction tile's lines padded to a
//     multiple of 32, the batch to a multiple of 128) and the differential
//     pair d = G - G_ref (float32, as in the plain version) split into
//     three bf16 planes hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi
//     - mid), whose sum is d exactly.  The planes keep G's orientation
//     (the transpose read makes no transposed copy), with every tile's
//     lines and outputs padded (outputs to a multiple of 64), so every
//     later copy is an unmasked, aligned 16-byte cp.async.  The codes are
//     integers of magnitude <= in_levels <= 256: exact in bf16.
//   * Each 16x8 block of charges is three m16n8k16 bf16 mma.sync products
//     with float32 accumulation, code.lo + code.mid + code.hi: every
//     product (an integer of <= 9 bits times an 8-bit significand) is
//     exact in float32, so only the order of the sums differs from the
//     plain version's einsum (the float class), and in the exact class
//     (1/256-grid conductances: mid = lo = 0) every partial sum is exact.
//     One bf16 pass (the TPU MXU's default precision) would put a 2^-9
//     relative error into every charge: not the float32 contract.
//   * No buffer of charges.  tc_range_kernel (dynamic range only) computes
//     each tile's charges over all B rows, one CTA per (layer, reduction
//     tile, 64-output slice of an output tile), and writes only the
//     slice's sum of squares and count of non-zero charges.
//     tc_read_kernel, one CTA per (layer, 64-output slice, 128 batch
//     rows; 64 where 128-row CTAs would not fill the card), walks the
//     reduction tiles in tile order: it recomputes each
//     tile's charges with the same products, reduces the tile's range
//     from its slices (the same order in every CTA), saturates and
//     ramp-ADC quantises them, and adds them to a float32 register sum
//     (acc = p_0, then acc + p_t), which it rescales and writes once.  The
//     products are computed twice: at the tensor-core rate that costs less
//     than writing, quantising and re-reading an (L, tR, B, O) buffer of
//     charges (1.2 GB per lm100m layer at B = 2048).
//   * Warps of 32 x 32 charges each (2 x 4 mma tiles); 32 reduction lines
//     per chunk through a 3-stage cp.async ring; fragments by ldmatrix
//     (.trans for the forward planes, stored [line][output]) from rows
//     padded by 16 bytes, free of bank conflicts.
//   The function's tensor-core floor is one pass of the 3 parts: 3 x 2 B K
//   N flops at the 989 TFLOP/s bf16 rate (0.117 ms per lm100m layer and
//   direction at B = 2048).  This design's own cost is twice that (the
//   range pass recomputes the products): 0.235 ms.
//
// FP32 instance (B <= 16, decode and prefill chunks, where the bytes of G
// and G_ref bound the read: 75.5 MB per lm100m layer, 22.5 us at 3.35
// TB/s; and in_levels > 256, whose codes are not exact in bf16).
// fused_read_tile_kernel: one CTA per (layer, reduction tile, output tile)
// for all B rows, a (16 * VB) x 64 block of charges per pass with a VB x 4
// register block per thread on the FP32 cores, the charges written raw
// into the tile's slice of an (L, tR, B, O) partial buffer and quantised
// in place after the block-wide range reduction; reduce_tiles_kernel sums
// the partials in tile order and rescales (with one reduction tile the
// first kernel writes the output itself).
//
// Partials form (partials = 1, both instances): the read stops before its
// tile sum and writes each reduction tile's quantised charges, unscaled, as
// (L, tR, B, O).  A read sharded over its reduction dim (the sharded train
// step) gathers the shards' partials in tile order and sums them with
// reduce_tiles_kernel (xbar_reduce_tiles): the same float32 adds in the
// same order as the whole read's register sum (tensor cores) or tile sum
// (FP32), so the result is bit-equal to the whole read.
//
// Arithmetic: x/sc, q/lsb, sat/out_levels and sqrt are IEEE-rounded
// (__fdiv_rn, __fsqrt_rn) and the ADC output is formed with explicit
// round-to-nearest multiply/add intrinsics so nvcc cannot contract them
// into FMAs: in the fixed-range power-of-two class the result is then
// bit-equal to the plain torch version.  Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCB = 64;   // output columns of a block (16 threads x 4)
constexpr int kRC = 32;   // reduction lines staged per chunk

// Tensor-core instance: a CTA's block of charges, the lines of a chunk and
// the padded shared-memory row (bf16 elements).
constexpr int kTcBatchPad = 128;  // the codes' batch padding
constexpr int kTcBN = 64;
constexpr int kTcKC = 32;
constexpr int kTcLd = kTcKC + 8;   // codes, transposed planes: [row][line]
constexpr int kFwdLd = kTcBN + 8;  // forward planes: [line][output]
constexpr int kStages = 3;
static_assert(kTcBN * kTcKC / 8 == 256, "a plane is 256 copies");
constexpr int kTcMaxLevels = 256;  // codes exact in bf16 up to here

// Slots of the launch record xbar_read fills: one per kernel, counted where
// it is launched.
enum LaunchSlot {
  kSlotReadTile, kSlotReduceTiles, kSlotPrepare, kSlotRange, kSlotTcRead,
  kSlots
};
static_assert(3 * kTcKC * kFwdLd <= 3 * kTcBN * kTcLd, "stage layout");

struct ReadArgs {
  const float* x;        // (L, B, D) drives
  const float* g;        // (L, K, N)
  const float* ref;      // (L, K, N)
  const float* sc;       // (L, 2): x_scale, x_scale / w_scale
  float* out;            // (L, tR, B, O) partials, or (L, B, O) if tR == 1
  int partials;          // write the (L, tR, B, O) partials, unscaled
  int B, K, N;
  int R, C;              // tile reduction length, tile output width
  int D, O;              // drive features, output features
  int dynamic;
  float in_levels, out_levels, sat_fixed, sat_sigmas;
  // tensor-core instance only
  const __nv_bfloat16* codes;  // (L, Bp, tR, Rp) DAC codes
  __nv_bfloat16* planes; // (L, 3, ...) hi, mid, lo of G - G_ref, padded
  float* ssq;            // (L, tR, tO, nbt) range sums of squares
  int* nz;               // (L, tR, tO, nbt) non-zero charge counts
  float* y;              // (L, B, O), or the (L, tR, B, O) partials
  int L, Bp, Rp, Cp, tR, tO, nbt;
};

// A CTA of the tensor-core kernels: BM batch rows x 64 outputs, in warps
// of 32 x 32 charges, two warps across the outputs.
template <int BM>
struct Cta {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStage = (BM + 3 * kTcBN) * kTcLd;  // bf16
  static constexpr int kSmemBytes = kStages * kStage * 2;
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
  // output is final (rescaled here); otherwise, or when the caller asks for
  // the partials, it is this tile's digital partial, summed in tile order
  // by reduce_tiles_kernel.
  const float out_scale = a.sc[2 * l + 1];
  for (int e = tid; e < B * c_end; e += kThreads) {
    const int b = e / c_end, c = e - b * c_end;
    float* p = ol + (size_t)b * O + out0 + c;
    const float v = fminf(fmaxf(*p, -sat), sat);
    float code = rintf(__fdiv_rn(v, lsb));
    code = fminf(fmaxf(code, -a.out_levels), a.out_levels);
    const float q = __fmul_rn(code, lsb);
    *p = tR == 1 && !a.partials ? __fmul_rn(q, out_scale) : q;
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
cudaError_t launch_tiles(const ReadArgs& a, dim3 grid, cudaStream_t st,
                         int* launched) {
  if (a.B <= 16)
    fused_read_tile_kernel<kTranspose, 1><<<grid, kThreads, 0, st>>>(a);
  else
    fused_read_tile_kernel<kTranspose, 4><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kSlotReadTile];
  return err;
}

// --------------------------------------------------------------------------
// Tensor-core instance
// --------------------------------------------------------------------------

__device__ __forceinline__ void split3(float d, __nv_bfloat16* p,
                                       long long stride) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(d);
  const float r1 = __fsub_rn(d, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  p[0] = hi;
  p[stride] = mid;
  p[2 * stride] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// Once per read: the DAC codes, codes[l, b, t, r] = clip(rint(x[l, b,
// t * R + r] / sc[l, 0])), and the differential pair d = G - G_ref split
// into three bf16 planes (hi, mid, lo) in G's orientation with every tile
// padded: forward planes[l, part, t * Rp + r, ot * Cp + c], transposed
// planes[l, part, ot * Cp + c, t * Rp + r].  Padding is zero.  One grid
// row per layer; per-layer indices fit 32 bits (checked by the caller).
template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
read_prepare_kernel(ReadArgs a, __nv_bfloat16* codes) {
  const int l = blockIdx.y;
  const int lines = a.tR * a.Rp, outs = a.tO * a.Cp;
  const int n_codes = a.Bp * lines, per_part = lines * outs;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_codes + per_part;
       i += gridDim.x * kThreads) {
    if (i < n_codes) {
      const int b = i / lines, t = (i - b * lines) / a.Rp;
      const int r = i - b * lines - t * a.Rp;
      const int line = t * a.R + r;
      float v = 0.f;
      if (b < a.B && r < a.R && line < a.D) {
        v = rintf(__fdiv_rn(a.x[((size_t)l * a.B + b) * a.D + line],
                            a.sc[2 * l]));
        v = fminf(fmaxf(v, -a.in_levels), a.in_levels);
      }
      codes[(size_t)l * n_codes + i] = __float2bfloat16_rn(v);
      continue;
    }
    const int f = i - n_codes;
    const int line = kTranspose ? f % lines : f / outs;
    const int out = kTranspose ? f / lines : f % outs;
    const int t = line / a.Rp, r = line - t * a.Rp;
    const int ot = out / a.Cp, c = out - ot * a.Cp;
    const int red = t * a.R + r, o = ot * a.C + c;
    float d = 0.f;
    if (r < a.R && red < a.D && c < a.C && o < a.O) {
      const size_t off = (size_t)l * a.K * a.N +
                         (kTranspose ? (size_t)o * a.N + red
                                     : (size_t)red * a.N + o);
      d = __fsub_rn(a.g[off], a.ref[off]);
    }
    split3(d, a.planes + (size_t)l * 3 * per_part + f, per_part);
  }
}

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

// One staged chunk of a CTA's work: 32 reduction lines of reduction tile
// rt (from line r0 of the tile) for the 128 batch rows from b0.
struct Chunk {
  int rt, r0, b0;
};

// Copies a chunk into a stage: the codes (128 rows x 32 lines) and the
// three planes of the CTA's 64 outputs x 32 lines, all as 16-byte
// cp.async (the padded layouts keep every copy aligned and in bounds).
// Forward planes land as [line][output] rows of kFwdLd, transposed ones
// as [output][line] rows of kTcLd.
template <bool kTranspose, int BM>
__device__ __forceinline__ void load_stage(const ReadArgs& a, int l,
                                           const Chunk& ch, int ot, int sub,
                                           __nv_bfloat16* stage) {
#pragma unroll
  for (int i = 0; i < BM * kTcKC / 8 / Cta<BM>::kThreads; ++i) {
    const int e = threadIdx.x + i * Cta<BM>::kThreads;
    const int row = e >> 2, q = e & 3;
    cp_async16(stage + row * kTcLd + q * 8,
               a.codes + (((size_t)l * a.Bp + ch.b0 + row) * a.tR + ch.rt) *
                             a.Rp + ch.r0 + q * 8);
  }
  const long long lines = (long long)a.tR * a.Rp;
  const long long outs = (long long)a.tO * a.Cp;
  const __nv_bfloat16* pl = a.planes + (size_t)l * 3 * lines * outs;
  const long long line0 = (long long)ch.rt * a.Rp + ch.r0;
  const long long out0 = (long long)ot * a.Cp + sub * kTcBN;
  __nv_bfloat16* sd = stage + BM * kTcLd;
  constexpr int kPlaneCopies = 3 * kTcBN * kTcKC / 8;  // 16-byte copies
#pragma unroll
  for (int e = threadIdx.x; e < kPlaneCopies; e += Cta<BM>::kThreads) {
    const int part = e >> 8, rem = e & 255;
    const __nv_bfloat16* pp = pl + (size_t)part * lines * outs;
    if (kTranspose) {
      const int c = rem >> 2, q = rem & 3;
      cp_async16(sd + part * kTcBN * kTcLd + c * kTcLd + q * 8,
                 pp + (size_t)(out0 + c) * lines + line0 + q * 8);
    } else {
      const int j = rem >> 3, q = rem & 7;
      cp_async16(sd + part * kTcKC * kFwdLd + j * kFwdLd + q * 8,
                 pp + (size_t)(line0 + j) * outs + out0 + q * 8);
    }
  }
}

// acc += the chunk's charges: each warp a 32 x 32 block, 2 x 4 tiles of
// m16n8, two k16 steps, three bf16 parts of d (lo, mid, hi).
template <bool kTranspose, int BM>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* stage,
                                          float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp % (BM / 32)) * 32, wn = (warp / (BM / 32)) * 32;
  const __nv_bfloat16* sd = stage + BM * kTcLd;
#pragma unroll
  for (int ks = 0; ks < kTcKC / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4<false>(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                         stage + (wm + mt * 16 + (lane & 15)) * kTcLd +
                             ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int part = 2; part >= 0; --part) {
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (kTranspose)  // [output][line] rows
          ldmatrix_x4<false>(
              bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
              bf[2 * np + 1][1],
              sd + part * kTcBN * kTcLd +
                  (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kTcLd +
                  ks * 16 + ((lane >> 3) & 1) * 8);
        else  // [line][output] rows: the transposed load gives k-pairs
          ldmatrix_x4<true>(
              bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
              bf[2 * np + 1][1],
              sd + part * kTcKC * kFwdLd + (ks * 16 + (lane & 15)) * kFwdLd +
                  wn + np * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}

// Runs a CTA's chunks in order through a kStages-deep cp.async ring:
// chunk(s) gives step s's chunk, last(s) whether step s ends a tile's (or
// a batch block's) charges, and done(s, acc) consumes them (acc is zeroed
// after it).  prepare(s) runs one step ahead of step s (for the read
// pass: a tile's range, before its charges are quantised).
template <bool kTranspose, int BM, typename ChunkOf, typename Last,
          typename Done, typename Prepare>
__device__ __forceinline__ void run_chunks(const ReadArgs& a, int l,
                                           int steps, int ot, int sub,
                                           ChunkOf chunk, Last last,
                                           Done done, Prepare prepare) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  prepare(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<kTranspose, BM>(a, l, chunk(s), ot, sub,
                                 ring + s * Cta<BM>::kStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    const int ahead = s + kStages - 1;
    if (ahead < steps)
      load_stage<kTranspose, BM>(a, l, chunk(ahead), ot, sub,
                                 ring + (ahead % kStages) * Cta<BM>::kStage);
    cp_async_commit();
    if (s + 1 < steps) prepare(s + 1);
    mma_chunk<kTranspose, BM>(ring + (s % kStages) * Cta<BM>::kStage, acc);
    if (last(s)) {
      done(s, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// The 64 outputs of a CTA: slice `sub` of output tile `ot`.
__device__ __forceinline__ int slice_len(const ReadArgs& a, int ot, int sub) {
  return min(min(kTcBN, a.C - sub * kTcBN), a.O - (ot * a.C + sub * kTcBN));
}

// Range pass: one CTA per (64-output slice of an output tile, reduction
// tile, layer) over all B rows; writes the slice's sum of squares and
// count of non-zero charges.
template <bool kTranspose>
__global__ void __launch_bounds__(Cta<kTcBatchPad>::kThreads)
tc_range_kernel(ReadArgs a) {
  using C = Cta<kTcBatchPad>;
  __shared__ float red_f[C::kWarps];
  __shared__ int red_i[C::kWarps];
  const int ot = blockIdx.x / a.nbt, sub = blockIdx.x - ot * a.nbt;
  const int rt = blockIdx.y, l = blockIdx.z;
  const size_t at = (((size_t)l * a.tR + rt) * a.tO + ot) * a.nbt + sub;
  if (slice_len(a, ot, sub) <= 0) {  // a slice past the last output
    if (threadIdx.x == 0) {
      a.ssq[at] = 0.f;
      a.nz[at] = 0;
    }
    return;
  }
  const int nch = a.Rp / kTcKC;
  float ssq = 0.f;
  int nz = 0;
  run_chunks<kTranspose, kTcBatchPad>(
      a, l, (a.Bp / kTcBatchPad) * nch, ot, sub,
      [&](int s) {
        return Chunk{rt, (s % nch) * kTcKC, (s / nch) * kTcBatchPad};
      },
      [&](int s) { return s % nch == nch - 1; },
      [&](int, float(&acc)[2][4][4]) {
        // rows past B and outputs outside the slice hold exact zeros
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float q = acc[mt][nt][r];
              ssq = __fadd_rn(ssq, __fmul_rn(q, q));
              nz += (q != 0.f);
            }
      },
      [](int) {});
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ssq = __fadd_rn(ssq, __shfl_down_sync(0xffffffffu, ssq, off));
    nz += __shfl_down_sync(0xffffffffu, nz, off);
  }
  if (lane == 0) {
    red_f[warp] = ssq;
    red_i[warp] = nz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    int tnz = 0;
    for (int w = 0; w < C::kWarps; ++w) {
      tot = __fadd_rn(tot, red_f[w]);
      tnz += red_i[w];
    }
    a.ssq[at] = tot;
    a.nz[at] = tnz;
  }
}

// Read pass: one CTA per (64-output slice of an output tile, BM batch
// rows, layer), walking the reduction tiles in tile order.
template <bool kTranspose, int BM>
__global__ void __launch_bounds__(Cta<BM>::kThreads)
tc_read_kernel(ReadArgs a) {
  __shared__ float sat_s[2], lsb_s[2];
  const int ot = blockIdx.x / a.nbt, sub = blockIdx.x - ot * a.nbt;
  const int b0 = blockIdx.y * BM, l = blockIdx.z;
  const int c_len = slice_len(a, ot, sub);
  if (c_len <= 0) return;  // a slice past the last output
  const int nch = a.Rp / kTcKC;
  float run[2][4][4];
  run_chunks<kTranspose, BM>(
      a, l, a.tR * nch, ot, sub,
      [&](int s) { return Chunk{s / nch, (s % nch) * kTcKC, b0}; },
      [&](int s) { return s % nch == nch - 1; },
      [&](int s, float(&acc)[2][4][4]) {
        const int rt = s / nch;
        const float sat = sat_s[rt & 1], lsb = lsb_s[rt & 1];
        // partials form: the tile's quantised charges go out unscaled,
        // to (l, rt, b, output) of y, and the caller sums them
        float* pl = a.partials ? a.y + ((size_t)l * a.tR + rt) * a.B * a.O +
                                     ot * a.C + sub * kTcBN
                               : nullptr;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int g = lane >> 2, tg = lane & 3;
        const int wm = (warp % (BM / 32)) * 32, wn = (warp / (BM / 32)) * 32;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float v = fminf(fmaxf(acc[mt][nt][r], -sat), sat);
              float code = rintf(__fdiv_rn(v, lsb));
              code = fminf(fmaxf(code, -a.out_levels), a.out_levels);
              const float p = __fmul_rn(code, lsb);
              if (pl != nullptr) {
                const int b = b0 + wm + mt * 16 + g + 8 * (r >> 1);
                const int c = wn + nt * 8 + 2 * tg + (r & 1);
                if (b < a.B && c < c_len) pl[(size_t)b * a.O + c] = p;
              } else {
                run[mt][nt][r] = rt == 0 ? p : __fadd_rn(run[mt][nt][r], p);
              }
            }
      },
      [&](int s) {
        // at a tile's first chunk: the tile's range, from its slices in
        // slice order (the same sum in every CTA)
        if (s % nch != 0 || threadIdx.x != 0) return;
        const int rt = s / nch;
        float sat = a.sat_fixed;
        if (a.dynamic) {
          const size_t at = (((size_t)l * a.tR + rt) * a.tO + ot) * a.nbt;
          float tot = 0.f;
          int tnz = 0;
          for (int i = 0; i < a.nbt; ++i) {
            tot = __fadd_rn(tot, a.ssq[at + i]);
            tnz += a.nz[at + i];
          }
          const float rms =
              __fsqrt_rn(__fdiv_rn(tot, fmaxf((float)tnz, 1.f)));
          sat = fmaxf(__fmul_rn(a.sat_sigmas, rms), 1e-6f);
        }
        sat_s[rt & 1] = sat;
        lsb_s[rt & 1] = __fdiv_rn(sat, a.out_levels);
      });
  if (a.partials) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp % (BM / 32)) * 32, wn = (warp / (BM / 32)) * 32;
  const float out_scale = a.sc[2 * l + 1];
  float* yl = a.y + (size_t)l * a.B * a.O + ot * a.C + sub * kTcBN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = b0 + wm + mt * 16 + g + 8 * (r >> 1);
        const int c = wn + nt * 8 + 2 * tg + (r & 1);
        if (b < a.B && c < c_len)
          yl[(size_t)b * a.O + c] = __fmul_rn(run[mt][nt][r], out_scale);
      }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Raises the dynamic shared-memory limit of the tensor-core kernels of one
// direction; done once per device by xbar_read_setup.
template <bool kTranspose>
cudaError_t allow_tc_smem() {
  cudaError_t err = allow_smem(tc_range_kernel<kTranspose>,
                               Cta<kTcBatchPad>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(tc_read_kernel<kTranspose, 64>, Cta<64>::kSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem(tc_read_kernel<kTranspose, 128>, Cta<128>::kSmemBytes);
  return err;
}

template <bool kTranspose, int BM>
cudaError_t launch_read_pass(const ReadArgs& a, cudaStream_t st,
                             int* launched) {
  tc_read_kernel<kTranspose, BM>
      <<<dim3((unsigned)(a.tO * a.nbt), (unsigned)(a.Bp / BM), (unsigned)a.L),
         Cta<BM>::kThreads, Cta<BM>::kSmemBytes, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kSlotTcRead];
  return err;
}

template <bool kTranspose>
cudaError_t launch_tc(const ReadArgs& a, int sms, cudaStream_t st,
                      int* launched) {
  const long long per_layer =
      (long long)a.tR * a.Rp * (a.Bp + (long long)a.tO * a.Cp);
  const long long blocks = (per_layer + kThreads - 1) / kThreads;
  read_prepare_kernel<kTranspose>
      <<<dim3((unsigned)(blocks < 65536 ? blocks : 65536), (unsigned)a.L),
         kThreads, 0, st>>>(a, const_cast<__nv_bfloat16*>(a.codes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++launched[kSlotPrepare];
  if (a.dynamic) {
    using C = Cta<kTcBatchPad>;
    tc_range_kernel<kTranspose>
        <<<dim3((unsigned)(a.tO * a.nbt), (unsigned)a.tR, (unsigned)a.L),
           C::kThreads, C::kSmemBytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launched[kSlotRange];
  }
  // 128-row CTAs, or 64-row ones where 128-row CTAs would not fill two
  // waves of two CTAs per SM (few outputs: the transposed reads of d_model
  // outputs, the forward reads of w_down and wo)
  const long long ctas = (long long)a.tO * a.nbt * (a.Bp / 128) * a.L;
  return ctas < 4LL * sms ? launch_read_pass<kTranspose, 64>(a, st, launched)
                          : launch_read_pass<kTranspose, 128>(a, st, launched);
}

// The tensor-core instance's geometry: the padded batch, tile lines and
// tile outputs, 64-output slices per tile, and the scratch regions (in
// floats, each a multiple of 4 so every region is 16-byte aligned).
struct TcGeometry {
  long long Bp, Rp, Cp, tR, tO, nbt, codes, code_floats, plane_floats,
      range_slots;
};

TcGeometry tc_geometry(int L, int B, int D, int O, int R, int C) {
  TcGeometry t;
  t.Bp = (B + kTcBatchPad - 1) / kTcBatchPad * kTcBatchPad;
  t.Rp = (R + kTcKC - 1) / kTcKC * kTcKC;
  t.Cp = (C + kTcBN - 1) / kTcBN * kTcBN;
  t.tR = (D + R - 1) / R;
  t.tO = (O + C - 1) / C;
  t.nbt = t.Cp / kTcBN;
  t.codes = (long long)L * t.Bp * t.tR * t.Rp;
  t.code_floats = ((t.codes + 1) / 2 + 3) / 4 * 4;
  t.plane_floats =
      (((long long)3 * L * t.tR * t.Rp * t.tO * t.Cp + 1) / 2 + 3) / 4 * 4;
  t.range_slots = (long long)L * t.tR * t.tO * t.nbt;
  return t;
}

}  // namespace

extern "C" {

// One-time setup for the current device, before its first read: raises the
// tensor-core kernels' dynamic shared-memory limit and stores the device's
// SM count (xbar_read's `sms`) in *sms.  Returns the CUDA error code.
int xbar_read_setup(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_tc_smem<false>();
  if (err == cudaSuccess) err = allow_tc_smem<true>();
  return (int)err;
}

// Floats of scratch a read needs.  Tensor-core instance (tc = 1): the DAC
// codes and the three planes of G - G_ref (bf16, two to a float), and
// each range slice's sum of squares and count: none of it scales with
// the batch's outputs.  FP32 instance: the per-tile digital partials when
// the reduction spans more than one tile (the tile charges live in the
// same slots until they are quantised).
long long xbar_read_scratch_floats(int L, int B, int K, int N, int rows,
                                   int cols, int transpose, int tc) {
  const int D = transpose ? N : K, O = transpose ? K : N;
  const int R = transpose ? cols : rows, C = transpose ? rows : cols;
  if (tc) {
    const TcGeometry t = tc_geometry(L, B, D, O, R, C);
    return t.code_floats + t.plane_floats + 2 * t.range_slots;
  }
  const long long tR = (D + R - 1) / R;
  return tR > 1 ? (long long)L * tR * B * O : 0;
}

// Launches one read on `stream`: the forward read (transpose = 0) of
// x (L,B,K) into y (L,B,N), or the transpose read (transpose = 1) of
// x (L,B,N) into y (L,B,K), through g/ref (L,K,N) and sc (L,2); all
// contiguous float32 device arrays.  tc = 1 takes the tensor-core instance
// (in_levels <= 256 only), tc = 0 the FP32 one.  scratch holds
// xbar_read_scratch_floats() floats; sms is the device's SM count and the
// device has had xbar_read_setup.  Adds one to launched[slot] (host array of
// kSlots ints, in LaunchSlot order) for each kernel launched.  With
// partials = 1 the read stops before its tile sum: y is (L, tR, B, O) and
// receives each reduction tile's quantised charges, unscaled (tR the
// reduction tiles), for xbar_reduce_tiles to sum in tile order and rescale
// (the FP32 instance then needs no scratch).  Returns the CUDA error code
// of the launches (0 on success).
int xbar_read(const float* x, const float* g, const float* ref,
              const float* sc, float* y, float* scratch, int L, int B, int K,
              int N, int rows, int cols, int transpose, int tc, int partials,
              int dynamic,
              float in_levels, float out_levels, float sat_fixed,
              float sat_sigmas, int sms, void* stream, int* launched) {
  if (L <= 0 || B <= 0 || K <= 0 || N <= 0 || rows <= 0 || cols <= 0 ||
      launched == nullptr)
    return (int)cudaErrorInvalidValue;
  ReadArgs a = {};
  a.x = x; a.g = g; a.ref = ref; a.sc = sc;
  a.partials = partials;
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
  cudaStream_t st = (cudaStream_t)stream;

  if (tc) {
    const TcGeometry t = tc_geometry(L, B, a.D, a.O, a.R, a.C);
    if (in_levels > kTcMaxLevels || scratch == nullptr ||
        t.Bp / 64 > 65535 || t.tO * t.nbt > 2147483647LL ||
        t.tR * t.Rp * (t.Bp + t.tO * t.Cp) > 2147483647LL)
      return (int)cudaErrorInvalidValue;
    a.L = L;
    a.Bp = (int)t.Bp; a.Rp = (int)t.Rp; a.Cp = (int)t.Cp;
    a.tR = (int)t.tR; a.tO = (int)t.tO; a.nbt = (int)t.nbt;
    a.codes = reinterpret_cast<const __nv_bfloat16*>(scratch);
    a.planes = reinterpret_cast<__nv_bfloat16*>(scratch + t.code_floats);
    a.ssq = scratch + t.code_floats + t.plane_floats;
    a.nz = reinterpret_cast<int*>(a.ssq + t.range_slots);
    a.y = y;
    return (int)(transpose ? launch_tc<true>(a, sms, st, launched)
                           : launch_tc<false>(a, sms, st, launched));
  }

  if (tR > 1 && !partials && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  a.out = tR > 1 && !partials ? scratch : y;
  const dim3 grid((unsigned)tO, (unsigned)tR, (unsigned)L);
  cudaError_t err = transpose ? launch_tiles<true>(a, grid, st, launched)
                              : launch_tiles<false>(a, grid, st, launched);
  if (err != cudaSuccess || tR == 1 || partials) return (int)err;
  const long long bo = (long long)B * a.O;
  const long long blocks = ((long long)L * bo + kThreads - 1) / kThreads;
  reduce_tiles_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      scratch, sc, y, L, (int)tR, bo);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kSlotReduceTiles];
  return (int)err;
}

// The tile sum of a read in partials form: y (L, B, O) = sc[l, 1] * the sum
// over tR tiles, in tile order, of partial (L, tR, B, O) (the same kernel
// and order as xbar_read's own FP32 tile sum).  Adds one to *launched.
int xbar_reduce_tiles(const float* partial, const float* sc, float* y, int L,
                      int tR, int B, int O, void* stream, int* launched) {
  if (L <= 0 || tR <= 0 || B <= 0 || O <= 0 || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long bo = (long long)B * O;
  const long long blocks = ((long long)L * bo + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  reduce_tiles_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(partial, sc, y, L, tR, bo);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // extern "C"
