// Building blocks shared by the fused BERT sub-block kernels (sm_90a):
// bert_block.cu (serving forward) and bert_block_train.cu (training forward
// and backward).
//
// * gemm_bf16_tc / gemm_f32_simt: C (M, N) = sum_k A(m, k) B(k, n) with a
//   fused epilogue. A is stored k-contiguous ("A[m * lda + k]") or, with
//   A_T, m-contiguous ("A[k * lda + m]"); B is stored k-contiguous (torch's
//   (out, in) weight, "B[n * ldb + k]") or, with B_T, n-contiguous
//   ("B[k * ldb + n]"). The transposed layouts serve the backward: dx = dy.W
//   reads W n-contiguous, a weight gradient dW = dY^T.X reads both operands
//   row by row over the B*S rows. blockIdx.z splits K (each split writes
//   its own float32 partial; a second pass sums them in a fixed order). In
//   bf16 every product takes gemm_bf16_tc only for operands TMA cannot
//   address; gemm_sm90.cuh runs the rest.
// * attention_core / attention_fwd_core_tc: softmax(q.k^T * scale + mask) . v
//   per (example, head), reading heads in the (B, S, 3H) layout, with the
//   training path's dropout on the probabilities; the second is the
//   persistent tensor-core core of bf16 at head_dim 64.
// * layer_norm_rows: the LayerNorm of an f32 pre-LN sum, one warp per row.
// * The dropout hash of realise_tpu/ops/pallas/bert_block_train.py
//   (_mix, _site_base, _keep_mask), bit for bit in uint32 arithmetic.
//
// Numerics are the Pallas kernels': a matmul accumulates in f32, its output
// rounds to the activation dtype T and the bias (rounded to T) is added in T;
// scores, softmax and LayerNorm run in f32; probabilities round to T before
// P.V; gelu is the exact erf form (erff here, where Mosaic needed a
// polynomial).
//
// The tensor-core GEMM: bf16 mma.sync m16n8k16 with f32 accumulation in a
// 128x128x32 block tile, 8 warps of 64x32, operands staged through a
// 3-stage cp.async ring in shared memory and read with ldmatrix (.trans for
// the transposed layouts); rows padded so fragment loads are free of bank
// conflicts. The f32 GEMM is a 64x64 CUDA-core FMA tile (no TF32), so
// float32 stays float32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------ dropout hash
enum { SITE_PROBS = 1, SITE_ATTN_OUT = 2, SITE_FFN_OUT = 3 };

// One dropout site: the layer's seed, the site id, the keep thresholds of
// the 16-bit (two samples per hash) and 24-bit (one sample) streams, and
// the survivors' scale float32(1 / keep). on == 0: no dropout.
struct Drop {
  uint32_t seed, site, thr16, thr24;
  float scale;
  int on;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Stream id of one (seed, site, example, head).
__device__ __forceinline__ uint32_t site_base(uint32_t seed, uint32_t site,
                                              uint32_t example, uint32_t head) {
  return fmix32(seed * 0x9E3779B1u + site * 0x85EBCA6Bu + example * 0xC2B2AE35u +
                head * 0x27D4EB2Fu);
}

// Multiplier (0 or 1/keep) of element (r, c) of a (rows, cols) site stream.
// cols % 256 == 0: two 16-bit samples per hash of index r * cols/2 + c mod
// cols/2, the left half of the columns from the low bits, the right half
// from the high bits; else one 24-bit sample of index r * cols + c.
__device__ __forceinline__ float keep_mult(const Drop& d, uint32_t base, int r,
                                           int c, int cols) {
  if ((cols & 255) == 0) {
    const int half = cols >> 1;
    const bool hi = c >= half;
    const uint32_t bits =
        fmix32(base ^ fmix32((uint32_t)r * (uint32_t)half + (uint32_t)(hi ? c - half : c)));
    return (hi ? bits >> 16 : bits & 0xFFFFu) < d.thr16 ? d.scale : 0.f;
  }
  const uint32_t bits = fmix32(base ^ fmix32((uint32_t)r * (uint32_t)cols + (uint32_t)c));
  return (bits >> 8) < d.thr24 ? d.scale : 0.f;
}

// Multiplier of element (m, c) of a hidden site over B*S rows of `cols`:
// one stream per example (m / S), row m % S of it.
__device__ __forceinline__ float hidden_keep(const Drop& d, int m, int c, int S,
                                             int cols) {
  const uint32_t base = site_base(d.seed, d.site, (uint32_t)(m / S), 0u);
  return keep_mult(d, base, m % S, c, cols);
}

// The dropout stream of one row of a hidden site: its example's stream id
// and the row's index in the example, computed once per row.
struct RowDrop {
  uint32_t base;
  int row;
};

// keep_mult of columns c, c + 1 (c even) of one row, the sample index and
// its half of the columns found once for the pair: both columns lie in the
// same half when cols % 256 == 0.
__device__ __forceinline__ float2 keep_mult2(const Drop& d, RowDrop rd, int c, int cols) {
  const int half = cols >> 1;
  const bool two = (cols & 255) == 0, hi = two && c >= half;
  const uint32_t i = two ? (uint32_t)rd.row * (uint32_t)half + (uint32_t)(hi ? c - half : c)
                         : (uint32_t)rd.row * (uint32_t)cols + (uint32_t)c;
  const uint32_t b0 = fmix32(rd.base ^ fmix32(i)), b1 = fmix32(rd.base ^ fmix32(i + 1u));
  if (two) {
    const uint32_t s0 = hi ? b0 >> 16 : b0 & 0xFFFFu, s1 = hi ? b1 >> 16 : b1 & 0xFFFFu;
    return make_float2(s0 < d.thr16 ? d.scale : 0.f, s1 < d.thr16 ? d.scale : 0.f);
  }
  return make_float2((b0 >> 8) < d.thr24 ? d.scale : 0.f, (b1 >> 8) < d.thr24 ? d.scale : 0.f);
}

// ---------------------------------------------------------------- epilogues
enum {
  EPI_BIAS = 0,         // out T = round(round(acc) + round(bias))
  EPI_BIAS_GELU = 1,    // out T = gelu(EPI_BIAS)
  EPI_RESID_ROUND = 2,  // out f32 = resid T + EPI_BIAS
  EPI_RESID_F32 = 3,    // out f32 = (resid T + bias) + acc
  EPI_RESID_ROUND_DROP = 4,  // out f32 = resid T + round(EPI_BIAS * keep)
  EPI_RESID_F32_DROP = 5,    // out f32 = resid T + (acc + bias) * keep
  EPI_STORE_F32 = 6,         // out f32 = acc (split z at out + z * M * N)
  EPI_ROUND = 7,             // out T = round(acc)
  EPI_ADD_F32_ROUND = 8,     // out T = round(resid f32 + acc)
  EPI_BIAS_T1_GELU = 9,      // out T = t = EPI_BIAS, out2 T = round(t * Phi(t))
  EPI_GELU_GRAD = 10,        // out T = round(acc * gelu'(resid T))
};

struct EpiArgs {
  const float* bias;  // (N,) f32
  const void* resid;  // (M, N)
  void* out;          // (M, N)
  void* out2;         // (M, N), EPI_BIAS_T1_GELU
  Drop drop;          // the *_DROP modes
  int S;              // rows per example, for the dropout streams
};

constexpr float INV_SQRT2 = 0.7071067811865476f;
constexpr float INV_SQRT2PI = 0.3989422804014327f;

// Phi(v) = 0.5 (1 + erf(v / sqrt 2)); the exact gelu is v * Phi(v) in every
// epilogue that computes it (EPI_BIAS_GELU, EPI_BIAS_T1_GELU), one expression,
// so that the FFN backward's replayed gelu(t1) is the forward's bit for bit.
// The Pallas kernel's (v * 0.5) * (1 + erf) is the same float32 value: the
// halving is exact either way.
__device__ __forceinline__ float gelu_cdf(float v) {
  return 0.5f * (1.0f + erff(v * INV_SQRT2));
}

// The modes whose f32 output is a residual sum (EPI_RESID_*), and those of
// them with a hidden-site dropout.
__host__ __device__ constexpr bool epi_resid(int epi) {
  return epi >= EPI_RESID_ROUND && epi <= EPI_RESID_F32_DROP;
}
__host__ __device__ constexpr bool epi_drops(int epi) {
  return epi == EPI_RESID_ROUND_DROP || epi == EPI_RESID_F32_DROP;
}

// One element z of the EPI_RESID_* modes from its residual x, accumulator,
// bias and keep multiplier (1 without dropout). EPI_RESID_F32_DROP's z = x +
// (acc + bias) * keep rounds each operation on its own (no fused
// multiply-add), as the plain version's float32 steps.
template <typename T, int EPI>
__device__ __forceinline__ float resid_out(float x, float acc, float bias, float keep) {
  if (EPI == EPI_RESID_F32) return (x + bias) + acc;
  if (EPI == EPI_RESID_F32_DROP) return __fadd_rn(x, __fmul_rn(__fadd_rn(acc, bias), keep));
  float v = round_to<T>(round_to<T>(acc) + round_to<T>(bias));
  if (EPI == EPI_RESID_ROUND_DROP) v = round_to<T>(v * keep);
  return x + v;
}

// out[m, n] from the f32 accumulator.
template <typename T, int EPI>
__device__ __forceinline__ void epi_store(const EpiArgs& e, int m, int n, int N,
                                          float acc) {
  const size_t idx = (size_t)m * N + n;
  if (EPI == EPI_STORE_F32) {
    static_cast<float*>(e.out)[idx] = acc;
  } else if (EPI == EPI_ROUND) {
    static_cast<T*>(e.out)[idx] = from_f<T>(acc);
  } else if (EPI == EPI_ADD_F32_ROUND) {
    static_cast<T*>(e.out)[idx] = from_f<T>(static_cast<const float*>(e.resid)[idx] + acc);
  } else if (EPI == EPI_GELU_GRAD) {
    const float t = to_f(static_cast<const T*>(e.resid)[idx]);
    const float cdf = gelu_cdf(t);
    const float phi = INV_SQRT2PI * expf(-0.5f * t * t);
    static_cast<T*>(e.out)[idx] = from_f<T>(acc * (cdf + t * phi));
  } else if (epi_resid(EPI)) {
    const float keep = epi_drops(EPI) && e.drop.on ? hidden_keep(e.drop, m, n, e.S, N) : 1.f;
    static_cast<float*>(e.out)[idx] =
        resid_out<T, EPI>(to_f(static_cast<const T*>(e.resid)[idx]), acc, e.bias[n], keep);
  } else {
    const float v = round_to<T>(round_to<T>(acc) + round_to<T>(e.bias[n]));
    if (EPI == EPI_BIAS) {
      static_cast<T*>(e.out)[idx] = from_f<T>(v);
    } else if (EPI == EPI_BIAS_GELU) {
      static_cast<T*>(e.out)[idx] = from_f<T>(v * gelu_cdf(v));
    } else {  // EPI_BIAS_T1_GELU
      static_cast<T*>(e.out)[idx] = from_f<T>(v);
      static_cast<T*>(e.out2)[idx] = from_f<T>(v * gelu_cdf(v));
    }
  }
}

// ------------------------------------------------ bf16 tensor-core GEMM
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_LDS = TC_BK + 8;
constexpr int TC_LDT = TC_BM + 8;  // row stride of a transposed (k-row) tile
constexpr int TC_THREADS = 256;

union Pack8 {
  uint4 u;
  uint16_t h[8];
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and register i receives matrix i in mma layout
// (.trans: each matrix transposed on the way).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const uint16_t* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const uint16_t* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

constexpr int TC_STAGES = 3;
constexpr int TC_TILE = TC_BM * TC_LDS;  // elements of one operand tile (>= TC_BK * TC_LDT)
constexpr size_t TC_SMEM = (size_t)TC_STAGES * 2 * TC_TILE * sizeof(uint16_t);
static_assert(TC_BK * TC_LDT <= TC_TILE, "transposed tile must fit a stage");

// Stage one operand's tile at k0 into shared memory: 128 rows (of M or N) x
// 32 k. K-contiguous: row-major [row][k]; transposed (TL): [k][row]. 16-byte
// cp.async copies (zero-filled past the edges) when vec, else element loads.
template <bool TL>
__device__ __forceinline__ void tc_load_operand(uint16_t* s, const bf16* g, int r0,
                                                int rows, int ld, int k0, int k_end,
                                                int vec, int tid) {
  const uint16_t* src = reinterpret_cast<const uint16_t*>(g);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = tid + c * TC_THREADS;
    if (!TL) {
      const int row = chunk >> 2, kc = (chunk & 3) * 8, k = k0 + kc, r = r0 + row;
      uint16_t* dst = s + row * TC_LDS + kc;
      if (vec) {
        const bool ok = k < k_end && r < rows;
        cp_async16(dst, ok ? src + (size_t)r * ld + k : src, ok ? 16 : 0);
      } else {
        Pack8 v;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v.h[i] = (r < rows && k + i < k_end) ? src[(size_t)r * ld + k + i] : (uint16_t)0;
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    } else {
      const int kr = chunk >> 4, rc = (chunk & 15) * 8, k = k0 + kr, r = r0 + rc;
      uint16_t* dst = s + kr * TC_LDT + rc;
      if (vec) {
        const bool ok = k < k_end && r < rows;
        cp_async16(dst, ok ? src + (size_t)k * ld + r : src, ok ? 16 : 0);
      } else {
        Pack8 v;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v.h[i] = (k < k_end && r + i < rows) ? src[(size_t)k * ld + r + i] : (uint16_t)0;
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
  }
}

// Both k-contiguous tiles at k0 in one pass (row and column shared): the
// layout of every forward product, where A and B have the same stride (the
// launcher checks it).
__device__ __forceinline__ void tc_load_tiles(uint16_t* as, uint16_t* ws, const bf16* A,
                                              const bf16* W, int bm, int bn, int M, int N,
                                              int ld, int k0, int k_end, int vec,
                                              int tid) {
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(A);
  const uint16_t* w16 = reinterpret_cast<const uint16_t*>(W);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = tid + c * TC_THREADS;
    const int row = chunk >> 2, kc = (chunk & 3) * 8, k = k0 + kc;
    uint16_t* da = as + row * TC_LDS + kc;
    uint16_t* dw = ws + row * TC_LDS + kc;
    if (vec) {
      const bool in_k = k < k_end;
      const bool a_ok = in_k && bm + row < M, w_ok = in_k && bn + row < N;
      cp_async16(da, a_ok ? a16 + (size_t)(bm + row) * ld + k : a16, a_ok ? 16 : 0);
      cp_async16(dw, w_ok ? w16 + (size_t)(bn + row) * ld + k : w16, w_ok ? 16 : 0);
    } else {
      Pack8 va, vw;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in_k = k + i < k_end;
        va.h[i] = (bm + row < M && in_k) ? a16[(size_t)(bm + row) * ld + k + i] : (uint16_t)0;
        vw.h[i] = (bn + row < N && in_k) ? w16[(size_t)(bn + row) * ld + k + i] : (uint16_t)0;
      }
      *reinterpret_cast<uint4*>(da) = va.u;
      *reinterpret_cast<uint4*>(dw) = vw.u;
    }
  }
}

// One stage of the A and B tiles at k0, in the layouts of A_T / B_T.
template <bool A_T, bool B_T>
__device__ __forceinline__ void tc_load_stage(uint16_t* base, const bf16* A, const bf16* B,
                                              int bm, int bn, int M, int N, int lda,
                                              int ldb, int k0, int k_end, int vec_a,
                                              int vec_b, int tid) {
  if constexpr (!A_T && !B_T) {
    tc_load_tiles(base, base + TC_TILE, A, B, bm, bn, M, N, lda, k0, k_end, vec_a && vec_b,
                  tid);
  } else {
    tc_load_operand<A_T>(base, A, bm, M, lda, k0, k_end, vec_a, tid);
    tc_load_operand<B_T>(base + TC_TILE, B, bn, N, ldb, k0, k_end, vec_b, tid);
  }
}

// Two adjacent outputs (columns c, c + 1 of row r) take the vector path when
// both exist and N is even.
__device__ __forceinline__ bool epi_pair(int c, int N) { return c + 1 < N && (N & 1) == 0; }

// The residual pair an epilogue reads at (r, c), c + 1 on the vector path
// (EPI_ADD_F32_ROUND: f32 dz; EPI_GELU_GRAD: t1; the EPI_RESID_* modes: x),
// zeros for the other modes: loaded apart from its use, so that a caller can
// start many loads before it needs the first.
template <int EPI>
__device__ __forceinline__ float2 epi_resid2(const EpiArgs& e, int r, int c, int M, int N) {
  if ((EPI == EPI_ADD_F32_ROUND || EPI == EPI_GELU_GRAD || epi_resid(EPI)) && r < M &&
      epi_pair(c, N)) {
    const size_t idx = (size_t)r * N + c;
    if (EPI == EPI_ADD_F32_ROUND)
      return *reinterpret_cast<const float2*>(static_cast<const float*>(e.resid) + idx);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(e.resid) + idx));
  }
  return make_float2(0.f, 0.f);
}

// The dropout stream of row r for the modes with a hidden-site dropout
// (EPI_RESID_ROUND_DROP, EPI_RESID_F32_DROP) when it is on.
template <int EPI>
__device__ __forceinline__ RowDrop epi_row(const EpiArgs& e, int r) {
  if (epi_drops(EPI) && e.drop.on) {
    const int ex = r / e.S;
    return RowDrop{site_base(e.drop.seed, e.drop.site, (uint32_t)ex, 0u), r - ex * e.S};
  }
  return RowDrop{0u, 0};
}

// Columns c, c + 1 of row r, `res` being epi_resid2 and `rd` epi_row at the
// same place; vector loads and stores on the pair path, with epi_store's
// arithmetic (the dropout keep multiplier per element).
template <int EPI>
__device__ __forceinline__ void epi_store2(const EpiArgs& e, int r, int c, int M, int N,
                                           float a0, float a1, float2 res, RowDrop rd) {
  if (r >= M) return;
  if (EPI >= EPI_STORE_F32 && epi_pair(c, N)) {
    const size_t idx = (size_t)r * N + c;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out) + idx);
    if (EPI == EPI_STORE_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) + idx) = make_float2(a0, a1);
    } else if (EPI == EPI_ROUND) {
      *out = __floats2bfloat162_rn(a0, a1);
    } else if (EPI == EPI_ADD_F32_ROUND) {
      *out = __floats2bfloat162_rn(res.x + a0, res.y + a1);
    } else if (EPI == EPI_GELU_GRAD) {
      const float t0 = res.x, t1 = res.y;
      const float cdf0 = gelu_cdf(t0), cdf1 = gelu_cdf(t1);
      const float phi0 = INV_SQRT2PI * expf(-0.5f * t0 * t0);
      const float phi1 = INV_SQRT2PI * expf(-0.5f * t1 * t1);
      *out = __floats2bfloat162_rn(a0 * (cdf0 + t0 * phi0), a1 * (cdf1 + t1 * phi1));
    } else {  // EPI_BIAS_T1_GELU
      const float v0 = round_to<bf16>(round_to<bf16>(a0) + round_to<bf16>(e.bias[c]));
      const float v1 = round_to<bf16>(round_to<bf16>(a1) + round_to<bf16>(e.bias[c + 1]));
      *out = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out2) + idx) =
          __floats2bfloat162_rn(v0 * gelu_cdf(v0), v1 * gelu_cdf(v1));
    }
    return;
  }
  if (epi_resid(EPI) && epi_pair(c, N)) {  // x preloaded by epi_resid2
    const float2 k = epi_drops(EPI) && e.drop.on ? keep_mult2(e.drop, rd, c, N)
                                                 : make_float2(1.f, 1.f);
    *reinterpret_cast<float2*>(static_cast<float*>(e.out) + (size_t)r * N + c) =
        make_float2(resid_out<bf16, EPI>(res.x, a0, e.bias[c], k.x),
                    resid_out<bf16, EPI>(res.y, a1, e.bias[c + 1], k.y));
    return;
  }
  if (EPI <= EPI_BIAS_GELU && epi_pair(c, N)) {
    float v0 = round_to<bf16>(round_to<bf16>(a0) + round_to<bf16>(e.bias[c]));
    float v1 = round_to<bf16>(round_to<bf16>(a1) + round_to<bf16>(e.bias[c + 1]));
    if (EPI == EPI_BIAS_GELU) {
      v0 *= gelu_cdf(v0);
      v1 *= gelu_cdf(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out) + (size_t)r * N + c) =
        __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (c < N) epi_store<bf16, EPI>(e, r, c, N, a0);
  if (c + 1 < N) epi_store<bf16, EPI>(e, r, c + 1, N, a1);
}

template <int EPI>
__device__ __forceinline__ void epi_store2(const EpiArgs& e, int r, int c, int M, int N,
                                           float a0, float a1) {
  epi_store2<EPI>(e, r, c, M, N, a0, a1, epi_resid2<EPI>(e, r, c, M, N), epi_row<EPI>(e, r));
}

template <int EPI, bool A_T, bool B_T>
__global__ void __launch_bounds__(TC_THREADS, 2)
gemm_bf16_tc(const bf16* __restrict__ A, const bf16* __restrict__ B, int M, int N,
             int K, int lda, int ldb, int k_chunk, int vec_a, int vec_b, EpiArgs e) {
  // TC_STAGES x {A tile, B tile}, bf16 bits as uint16_t.
  extern __shared__ __align__(16) unsigned char tc_smem[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(tc_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bm = blockIdx.y * TC_BM, bn = blockIdx.x * TC_BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // 2 x 4 warps
  // Split-K (blockIdx.z) exists only for the f32 partials of EPI_STORE_F32.
  constexpr bool kSplit = EPI == EPI_STORE_F32;
  const int k_begin = kSplit ? blockIdx.z * k_chunk : 0;
  const int k_end = kSplit ? min(K, k_begin + k_chunk) : K;
  if (kSplit) e.out = static_cast<float*>(e.out) + (size_t)blockIdx.z * M * N;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (k_end - k_begin + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nk)
      tc_load_stage<A_T, B_T>(smem + st * 2 * TC_TILE, A, B, bm, bn, M, N, lda, ldb,
                              k_begin + st * TC_BK, k_end, vec_a, vec_b, tid);
    cp_async_commit();
  }
  // ldmatrix row addresses. K-contiguous A: rows (lane & 15), column half
  // (lane >> 4); K-contiguous B: rows (lane & 7) + 8 * (lane >> 4), column
  // half (lane >> 3) & 1. Transposed tiles hold k rows: matrix j = lane >> 3
  // sits at k + 8 * (j >> 1), m + 8 * (j & 1) for A and at k + 8 * (j & 1),
  // n + 8 * (j >> 1) for B.
  const int a_row = wm + (lane & 15), a_col = (lane >> 4) * 8;
  const int w_row = wn + (lane & 7) + 8 * (lane >> 4), w_col = ((lane >> 3) & 1) * 8;
  const int at_k = (lane & 7) + 8 * (lane >> 4), at_m = wm + 8 * ((lane >> 3) & 1);
  const int bt_k = (lane & 7) + 8 * ((lane >> 3) & 1), bt_n = wn + 8 * (lane >> 4);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t visible; stage (t - 1) % STAGES free
    const int nxt = t + TC_STAGES - 1;
    if (nxt < nk)
      tc_load_stage<A_T, B_T>(smem + (nxt % TC_STAGES) * 2 * TC_TILE, A, B, bm, bn, M, N,
                              lda, ldb, k_begin + nxt * TC_BK, k_end, vec_a, vec_b, tid);
    cp_async_commit();
    const uint16_t* as = smem + (t % TC_STAGES) * 2 * TC_TILE;
    const uint16_t* ws = as + TC_TILE;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (A_T)
          ldmatrix_x4_trans(af[mi], as + (kk + at_k) * TC_LDT + at_m + mi * 16);
        else
          ldmatrix_x4(af[mi], as + (a_row + mi * 16) * TC_LDS + kk + a_col);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n-tiles 2np, 2np + 1
        uint32_t r[4];
        if (B_T)
          ldmatrix_x4_trans(r, ws + (kk + bt_k) * TC_LDT + bt_n + np * 16);
        else
          ldmatrix_x4(r, ws + (w_row + np * 16) * TC_LDS + kk + w_col);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        epi_store2<EPI>(e, bm + wm + mi * 16 + g + hh * 8, bn + wn + ni * 8 + t4 * 2,
                        M, N, acc[mi][ni][hh * 2], acc[mi][ni][hh * 2 + 1]);
}

// -------------------------------------------------- f32 CUDA-core GEMM
constexpr int FS_BM = 64, FS_BN = 64, FS_BK = 16, FS_THREADS = 256;

// 4 consecutive floats of row `row` from column k, zero past the edge.
// vec: ld % 4 == 0 and 16-byte aligned base.
__device__ __forceinline__ float4 load4_f32(const float* p, int row, int rows,
                                            int k, int k_end, int ld, int vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows) {
    const float* src = p + (size_t)row * ld + k;
    if (vec && k + 4 <= k_end) {
      r = *reinterpret_cast<const float4*>(src);
    } else {
      if (k + 0 < k_end) r.x = src[0];
      if (k + 1 < k_end) r.y = src[1];
      if (k + 2 < k_end) r.z = src[2];
      if (k + 3 < k_end) r.w = src[3];
    }
  }
  return r;
}

// Element (r, k) of an operand (rows x K) stored k-contiguous or, TL,
// row-contiguous; zero outside.
template <bool TL>
__device__ __forceinline__ float load1_f32(const float* p, int r, int rows, int k,
                                           int k_end, int ld) {
  if (r >= rows || k >= k_end) return 0.f;
  return TL ? p[(size_t)k * ld + r] : p[(size_t)r * ld + k];
}

template <int EPI, bool A_T, bool B_T>
__global__ void __launch_bounds__(FS_THREADS)
gemm_f32_simt(const float* __restrict__ A, const float* __restrict__ B, int M, int N,
              int K, int lda, int ldb, int k_chunk, int vec_a, int vec_b, EpiArgs e) {
  __shared__ float As[FS_BK][FS_BM + 4];
  __shared__ float Ws[FS_BK][FS_BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm = blockIdx.y * FS_BM, bn = blockIdx.x * FS_BN;
  constexpr bool kSplit = EPI == EPI_STORE_F32;
  const int k_begin = kSplit ? blockIdx.z * k_chunk : 0;
  const int k_end = kSplit ? min(K, k_begin + k_chunk) : K;
  if (kSplit) e.out = static_cast<float*>(e.out) + (size_t)blockIdx.z * M * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // K-contiguous operands: thread loads 4 k of row tid / 4. Transposed
  // operands: thread loads 4 k-rows of column tid % 64 (coalesced over it).
  const int lrow = tid >> 2, lk = (tid & 3) * 4;
  const int tcol = tid & 63, tk = (tid >> 6) * 4;
  for (int k0 = k_begin; k0 < k_end; k0 += FS_BK) {
    if (A_T) {
#pragma unroll
      for (int i = 0; i < 4; ++i) As[tk + i][tcol] = load1_f32<true>(A, bm + tcol, M, k0 + tk + i, k_end, lda);
    } else {
      const float4 a = load4_f32(A, bm + lrow, M, k0 + lk, k_end, lda, vec_a);
      As[lk + 0][lrow] = a.x; As[lk + 1][lrow] = a.y;
      As[lk + 2][lrow] = a.z; As[lk + 3][lrow] = a.w;
    }
    if (B_T) {
#pragma unroll
      for (int i = 0; i < 4; ++i) Ws[tk + i][tcol] = load1_f32<true>(B, bn + tcol, N, k0 + tk + i, k_end, ldb);
    } else {
      const float4 w = load4_f32(B, bn + lrow, N, k0 + lk, k_end, ldb, vec_b);
      Ws[lk + 0][lrow] = w.x; Ws[lk + 1][lrow] = w.y;
      Ws[lk + 2][lrow] = w.z; Ws[lk + 3][lrow] = w.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FS_BK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        wv[i] = Ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = bm + ty * 4 + i, c = bn + tx * 4 + j;
      if (r < M && c < N) epi_store<float, EPI>(e, r, c, N, acc[i][j]);
    }
}

// ------------------------------------------------------ attention core
// One block per (example, head) x 32 queries; 4 warps, a warp per query
// row at a time. Lane l owns keys l, l+32, l+64, l+96 (S <= 128) and output
// columns l, l+32 (head_dim <= 64).
constexpr int AT_WARPS = 4, AT_QTILE = 32, AT_MAX_S = 128, AT_MAX_D = 64;

__host__ __device__ constexpr size_t at_smem_floats(int S, int D) {
  return (size_t)S * (D + 1) + (size_t)S * D + (size_t)AT_WARPS * S +
         (size_t)AT_WARPS * D + S;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(AT_WARPS * 32)
attention_core(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
               T* __restrict__ ctx, int S, int H, int nh, int D, float scale,
               Drop drop) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // S x (D + 1), padded: lane-strided reads
  float* Vs = Ks + (size_t)S * (D + 1); // S x D
  float* Ps = Vs + (size_t)S * D;       // AT_WARPS x S probabilities
  float* Qs = Ps + AT_WARPS * S;        // AT_WARPS x D query rows
  float* Bs = Qs + AT_WARPS * D;        // S mask bias

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int q0 = blockIdx.y * AT_QTILE;
  const size_t ld = 3 * (size_t)H;
  const T* base = qkv + (size_t)b * S * ld;
  const uint32_t dbase = site_base(drop.seed, SITE_PROBS, (uint32_t)b, (uint32_t)h);

  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    Ks[j * (D + 1) + d] = to_f(base[j * ld + H + h * D + d]);
    Vs[j * D + d] = to_f(base[j * ld + 2 * H + h * D + d]);
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) Bs[j] = mask_bias[(size_t)b * S + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = Ps + warp * S;
  float* q = Qs + warp * D;
  const int q_end = min(q0 + AT_QTILE, S);
  for (int i = q0 + warp; i < q_end; i += AT_WARPS) {
    const T* qrow = base + (size_t)i * ld + h * D;
    for (int d = lane; d < D; d += 32) q[d] = to_f(qrow[d]);
    __syncwarp();

    float s[4];
    int krow[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      s[t] = 0.f;
      const int j = lane + 32 * t;
      krow[t] = (j < S ? j : 0) * (D + 1);
    }
    for (int d = 0; d < D; ++d) {
      const float qd = q[d];
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t] = fmaf(qd, Ks[krow[t] + d], s[t]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      s[t] = (j < S) ? s[t] * scale + Bs[j] : -INFINITY;
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      s[t] = (j < S) ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        float pj = s[t] / sum;
        if (DROP) pj *= keep_mult(drop, dbase, i, j, S);
        p[j] = round_to<T>(pj);
      }
    }
    __syncwarp();

    const int d0 = lane, d1 = lane + 32;
    float c0 = 0.f, c1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      if (d0 < D) c0 = fmaf(pj, Vs[j * D + d0], c0);
      if (d1 < D) c1 = fmaf(pj, Vs[j * D + d1], c1);
    }
    T* out = ctx + ((size_t)b * S + i) * H + h * D;
    if (d0 < D) out[d0] = from_f<T>(c0);
    if (d1 < D) out[d1] = from_f<T>(c1);
    __syncwarp();
  }
}

// bf16 attention core on the tensor cores, head_dim 64, S <= 128. The block
// is persistent (as many per SM as fit) and walks over the (example, head)
// pairs; its 8 warps own 16 query rows each, so all S <= 128 rows of a pair
// share one copy of its K and V. While the warps work on one pair, cp.async
// stages the block's next pair (its Q, K and V head windows and the mask
// bias) into the other of two buffers. Rows are padded by 8 elements so the
// 32-bit fragment loads hit 32 distinct banks; keys are padded to a multiple
// of 16 (zero rows, bias -inf).
// Each warp runs S = Q.K^T (mma m16n8k16, f32 accumulation) for all keys at
// once, the softmax in registers, then P.V with the rounded probabilities as
// the A operand straight from the score fragments and V's B fragments read
// with ldmatrix.trans. The k16 steps, the key tiles, the per-thread sums in
// key-tile order, the quad shuffles, expf, the division by the sum, the keep
// multiply and the rounding are those that attention_bwd_core_tc's phase A
// replays, so the backward's probabilities are the forward's bit for bit.
// Shared memory at S = 128: 2 x 54.5 KB.
constexpr int TA_D = 64, TA_LDK = TA_D + 8, AFT_WARPS = 8;

__host__ __device__ constexpr int ta_pad(int S) { return (S + 15) & ~15; }

// bf16 elements of one staging buffer: Q, K and V (s_pad x TA_LDK each) and
// the s_pad floats of mask bias.
__host__ __device__ constexpr int aft_stage_elems(int s_pad) {
  return 3 * s_pad * TA_LDK + 2 * s_pad;
}

__host__ __device__ constexpr size_t aft_smem_bytes(int S) {
  return 2 * 2 * (size_t)aft_stage_elems(ta_pad(S));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// A 4 x 4 transpose of 32-bit words across the 4 threads of a quad: thread
// t4 gives w.x .. w.w and gets word t4 of thread j in place j.
__device__ __forceinline__ uint4 quad_transpose(uint4 w, int t4) {
  const bool hi = t4 & 2, odd = t4 & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? w.x : w.z, 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? w.y : w.w, 2);
  const uint32_t b0 = hi ? r0 : w.x, b1 = hi ? r1 : w.y;
  const uint32_t b2 = hi ? w.z : r0, b3 = hi ? w.w : r1;
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, odd ? b0 : b1, 1);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, odd ? b2 : b3, 1);
  return make_uint4(odd ? q0 : b0, odd ? b1 : q0, odd ? q1 : b2, odd ? b3 : q1);
}

template <bool DROP>
__global__ void __launch_bounds__(AFT_WARPS * 32, 2)
attention_fwd_core_tc(const bf16* __restrict__ qkv, const float* __restrict__ mask_bias,
                      bf16* __restrict__ ctx, int S, int H, int nh, int units, float scale,
                      Drop drop) {
  extern __shared__ __align__(16) unsigned char aft_smem[];
  const int s_pad = ta_pad(S), tile = s_pad * TA_LDK;
  const int stage_elems = aft_stage_elems(s_pad);
  uint16_t* staging = reinterpret_cast<uint16_t*>(aft_smem);  // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t ld = 3 * (size_t)H;
  const uint16_t* qkv16 = reinterpret_cast<const uint16_t*>(qkv);

  // Stage pair u (example u / nh, head u % nh) into buffer `buf`: rows
  // j >= S read as zeros, and their bias is -inf in both buffers (set once).
  auto stage = [&](int u, int buf) {
    const int b = u / nh, h = u % nh;
    uint16_t* Q = staging + buf * stage_elems;
    const uint16_t* rows = qkv16 + (size_t)b * S * ld + h * TA_D;
    for (int idx = tid; idx < s_pad * 8; idx += blockDim.x) {
      const int j = idx >> 3, c = (idx & 7) * 8, o = j * TA_LDK + c;
      const int n = j < S ? 16 : 0, jj = j < S ? j : 0;
      const uint16_t* row = rows + jj * ld + c;
      cp_async16(Q + o, row, n);
      cp_async16(Q + tile + o, row + H, n);
      cp_async16(Q + 2 * tile + o, row + 2 * H, n);
    }
    float* bias = reinterpret_cast<float*>(Q + 3 * tile);
    for (int j = tid; j < S; j += blockDim.x) cp_async4(bias + j, mask_bias + (size_t)b * S + j);
    cp_async_commit();
  };
  for (int j = S + tid; j < s_pad; j += blockDim.x)
#pragma unroll
    for (int buf = 0; buf < 2; ++buf)
      reinterpret_cast<float*>(staging + buf * stage_elems + 3 * tile)[j] = -INFINITY;
  stage(blockIdx.x, 0);

  // ldmatrix.trans row addresses of a B operand stored [k][n] (n-contiguous).
  const int bt_k = (lane & 7) + 8 * ((lane >> 3) & 1), bt_n = 8 * (lane >> 4);
  const int n_tiles = s_pad / 8;  // <= 16 key tiles of 8
  const int r0 = warp * 16;
  int buf = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    // Pair u is staged, and every warp is done with the other buffer:
    // prefetch the block's next pair there.
    __syncthreads();
    if (u + (int)gridDim.x < units) stage(u + gridDim.x, buf ^ 1);
    if (r0 >= S) continue;
    const uint16_t* Qs = staging + buf * stage_elems;
    const uint16_t* Ks = Qs + tile;
    const uint16_t* Vs = Ks + tile;
    const float* Bs = reinterpret_cast<const float*>(Vs + tile);
    const int b = u / nh, h = u % nh;

    float sc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TA_D; kk += 16) {
      uint32_t a[4];
      const uint16_t* p0 = Qs + (r0 + g) * TA_LDK + kk + t4 * 2;
      const uint16_t* p1 = p0 + 8 * TA_LDK;
      a[0] = *reinterpret_cast<const uint32_t*>(p0);
      a[1] = *reinterpret_cast<const uint32_t*>(p1);
      a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt < n_tiles) {
          const uint16_t* q = Ks + (nt * 8 + g) * TA_LDK + kk + t4 * 2;
          uint32_t bfr[2];
          bfr[0] = *reinterpret_cast<const uint32_t*>(q);
          bfr[1] = *reinterpret_cast<const uint32_t*>(q + 8);
          mma_bf16_16816(sc[nt], a, bfr);
        }
      }
    }

    // Softmax over the rows g (c0, c1) and g + 8 (c2, c3); a row's columns
    // are spread over the 4 threads of a quad.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt < n_tiles) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = Bs[nt * 8 + t4 * 2 + e];
          sc[nt][e] = sc[nt][e] * scale + bias;
          sc[nt][2 + e] = sc[nt][2 + e] * scale + bias;
          mx0 = fmaxf(mx0, sc[nt][e]);
          mx1 = fmaxf(mx1, sc[nt][2 + e]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt < n_tiles) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = expf(sc[nt][e] - mx0);
          sc[nt][2 + e] = expf(sc[nt][2 + e] - mx1);
          sum0 += sc[nt][e];
          sum1 += sc[nt][2 + e];
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }

    // p = e / sum, times the keep multiplier (f32), rounded to bf16 pairs:
    // the A fragments of P.V, rows g and g + 8 of each key tile.
    const int i0 = r0 + g, i1 = i0 + 8;
    const uint32_t dbase = DROP ? site_base(drop.seed, SITE_PROBS, (uint32_t)b, (uint32_t)h) : 0u;
    uint32_t pk[16][2];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      pk[nt][0] = pk[nt][1] = 0u;
      if (nt < n_tiles) {
        float p0[2], p1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p0[e] = sc[nt][e] / sum0;
          p1[e] = sc[nt][2 + e] / sum1;
          if (DROP) {
            const int j = nt * 8 + t4 * 2 + e;
            p0[e] *= keep_mult(drop, dbase, i0, j, S);
            p1[e] *= keep_mult(drop, dbase, i1, j, S);
          }
        }
        pk[nt][0] = pack_bf16x2(p0[0], p0[1]);
        pk[nt][1] = pack_bf16x2(p1[0], p1[1]);
      }
    }

    float out[8][4];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[dn][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      if (kc < n_tiles / 2) {
        const uint32_t a[4] = {pk[2 * kc][0], pk[2 * kc][1], pk[2 * kc + 1][0],
                               pk[2 * kc + 1][1]};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Vs + (kc * 16 + bt_k) * TA_LDK + bt_n + np * 16);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16_16816(out[2 * np], a, b0);
          mma_bf16_16816(out[2 * np + 1], a, b1);
        }
      }
    }

    // ctx rows i0 and i1: the quad's column pairs transposed so that each
    // thread stores 8 consecutive columns (16 bytes) of a 32-column half.
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 w0 = quad_transpose(
          make_uint4(pack_bf16x2(out[4 * q][0], out[4 * q][1]),
                     pack_bf16x2(out[4 * q + 1][0], out[4 * q + 1][1]),
                     pack_bf16x2(out[4 * q + 2][0], out[4 * q + 2][1]),
                     pack_bf16x2(out[4 * q + 3][0], out[4 * q + 3][1])),
          t4);
      const uint4 w1 = quad_transpose(
          make_uint4(pack_bf16x2(out[4 * q][2], out[4 * q][3]),
                     pack_bf16x2(out[4 * q + 1][2], out[4 * q + 1][3]),
                     pack_bf16x2(out[4 * q + 2][2], out[4 * q + 2][3]),
                     pack_bf16x2(out[4 * q + 3][2], out[4 * q + 3][3])),
          t4);
      bf16* col = ctx + (size_t)b * S * H + h * TA_D + q * 32 + t4 * 8;
      if (i0 < S) *reinterpret_cast<uint4*>(col + (size_t)i0 * H) = w0;
      if (i1 < S) *reinterpret_cast<uint4*>(col + (size_t)i1 * H) = w1;
    }
  }
}

// ------------------------------------------------------------ LayerNorm
// y = LN(z) * g + b over rows of H, one warp per row; z is the f32 pre-LN
// sum. WITH_Z: also write z rounded to T into zout.
template <typename T, bool WITH_Z>
__global__ void __launch_bounds__(256)
layer_norm_rows(const float* __restrict__ z, const float* __restrict__ g,
                const float* __restrict__ beta, T* __restrict__ y, T* __restrict__ zout,
                int M, int H, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* zr = z + (size_t)row * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += zr[c];
  const float mu = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = zr[c] - mu;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / H + eps);
  T* yr = y + (size_t)row * H;
  for (int c = lane; c < H; c += 32) yr[c] = from_f<T>((zr[c] - mu) * r * g[c] + beta[c]);
  if (WITH_Z) {
    T* zo = zout + (size_t)row * H;
    for (int c = lane; c < H; c += 32) zo[c] = from_f<T>(zr[c]);
  }
}

// ------------------------------------------------------------- launchers
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// C (M, N) = A . B with the layouts of A_T / B_T (see the top of the file);
// splits > 1 (EPI_STORE_F32 only) writes `splits` partials of M x N.
template <int EPI, bool A_T = false, bool B_T = false>
int launch_gemm(const bf16* A, const bf16* B, int M, int N, int K, int lda, int ldb,
                EpiArgs e, cudaStream_t st, int splits = 1) {
  if (!A_T && !B_T && lda != ldb) return (int)cudaErrorInvalidValue;
  const int vec_a = aligned16(A) && lda % 8 == 0 && (A_T ? M : K) % 8 == 0;
  const int vec_b = aligned16(B) && ldb % 8 == 0 && (B_T ? N : K) % 8 == 0;
  int err = (int)cudaFuncSetAttribute(gemm_bf16_tc<EPI, A_T, B_T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)TC_SMEM);
  if (err) return err;
  const int k_chunk = ((K + splits - 1) / splits + TC_BK - 1) / TC_BK * TC_BK;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, (K + k_chunk - 1) / k_chunk);
  gemm_bf16_tc<EPI, A_T, B_T><<<grid, TC_THREADS, TC_SMEM, st>>>(
      A, B, M, N, K, lda, ldb, k_chunk, vec_a, vec_b, e);
  return (int)cudaGetLastError();
}

template <int EPI, bool A_T = false, bool B_T = false>
int launch_gemm(const float* A, const float* B, int M, int N, int K, int lda, int ldb,
                EpiArgs e, cudaStream_t st, int splits = 1) {
  const int vec_a = aligned16(A) && lda % 4 == 0;
  const int vec_b = aligned16(B) && ldb % 4 == 0;
  const int k_chunk = ((K + splits - 1) / splits + FS_BK - 1) / FS_BK * FS_BK;
  dim3 grid((N + FS_BN - 1) / FS_BN, (M + FS_BM - 1) / FS_BM, (K + k_chunk - 1) / k_chunk);
  gemm_f32_simt<EPI, A_T, B_T><<<grid, FS_THREADS, 0, st>>>(A, B, M, N, K, lda, ldb,
                                                            k_chunk, vec_a, vec_b, e);
  return (int)cudaGetLastError();
}

inline EpiArgs epi(const float* bias, const void* resid, void* out, void* out2 = nullptr,
                   Drop drop = Drop{0u, 0u, 0u, 0u, 1.f, 0}, int S = 1) {
  return EpiArgs{bias, resid, out, out2, drop, S};
}

template <typename T>
int layer_norm(const float* z, const float* g, const float* b, T* y, int M, int H,
               float eps, cudaStream_t st, T* zout = nullptr) {
  const int rows_per_block = 256 / 32, blocks = (M + rows_per_block - 1) / rows_per_block;
  if (zout != nullptr)
    layer_norm_rows<T, true><<<blocks, 256, 0, st>>>(z, g, b, y, zout, M, H, eps);
  else
    layer_norm_rows<T, false><<<blocks, 256, 0, st>>>(z, g, b, y, zout, M, H, eps);
  return (int)cudaGetLastError();
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// The persistent tensor-core core: as many blocks as fit on the card at
// once (two per SM at S = 128 when the registers allow), at most one per
// (example, head) pair.
template <bool DROP>
int attention_fwd_tc_launch(const bf16* qkv, const float* mask, bf16* ctx, int B, int S, int H,
                            int nh, float scale, Drop drop, cudaStream_t st) {
  const size_t smem = aft_smem_bytes(S);
  int err = (int)cudaFuncSetAttribute(attention_fwd_core_tc<DROP>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  static int fit[AT_MAX_S / 16 + 1] = {};  // blocks per SM, by the padded S / 16
  int& per_sm = fit[ta_pad(S) / 16];
  if (per_sm == 0) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_fwd_core_tc<DROP>, AFT_WARPS * 32, smem);
    if (err) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const int units = B * nh;
  if (units == 0) return 0;
  const long slots = (long)per_sm * sm_count();
  const int blocks = units < slots ? units : (int)slots;
  attention_fwd_core_tc<DROP><<<blocks, AFT_WARPS * 32, smem, st>>>(qkv, mask, ctx, S, H, nh,
                                                                    units, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
int attention_core_launch_as(const T* qkv, const float* mask, T* ctx, int B, int S,
                             int H, int nh, float scale, Drop drop, cudaStream_t st) {
  const int D = H / nh;
  if constexpr (sizeof(T) == 2) {
    if (D == TA_D && aligned16(qkv) && aligned16(ctx))
      return attention_fwd_tc_launch<DROP>(qkv, mask, ctx, B, S, H, nh, scale, drop, st);
  }
  const size_t smem = at_smem_floats(S, D) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(attention_core<T, DROP>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  dim3 grid(B * nh, (S + AT_QTILE - 1) / AT_QTILE);
  attention_core<T, DROP><<<grid, AT_WARPS * 32, smem, st>>>(qkv, mask, ctx, S, H, nh,
                                                             D, scale, drop);
  return (int)cudaGetLastError();
}

// softmax(q.k^T * scale + mask) . v for every (example, head), the
// probabilities dropped with `drop` (site SITE_PROBS) when drop.on: the
// persistent tensor-core core for bf16 at head_dim 64 (16-byte aligned
// q/k/v and ctx), the CUDA-core version otherwise.
template <typename T>
int attention_core_launch(const T* qkv, const float* mask, T* ctx, int B, int S,
                          int H, int nh, float scale, Drop drop, cudaStream_t st) {
  return drop.on ? attention_core_launch_as<T, true>(qkv, mask, ctx, B, S, H, nh, scale,
                                                     drop, st)
                 : attention_core_launch_as<T, false>(qkv, mask, ctx, B, S, H, nh, scale,
                                                      drop, st);
}

}  // namespace
