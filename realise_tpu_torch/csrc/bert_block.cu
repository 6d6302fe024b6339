// Fused BERT sub-block kernels for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernels of realise_tpu/ops/pallas/bert_block.py:
//   * rt_attention_block  <- attention_block (y = LN(x + ctx.Wo + bo), with
//                            ctx = softmax(q.k^T * scale + mask) . v per head)
//   * rt_ffn_block        <- ffn_block       (y = LN(x + b2 + gelu(x.W1 + b1).W2))
//
// Numerics are the Pallas kernels': a matmul accumulates in f32, its output
// rounds to the activation dtype T and the bias (rounded to T) is added in T;
// scores, softmax and LayerNorm run in f32; probabilities round to T before
// P.V; the FFN's W2 product stays f32 (not rounded) up to the residual; gelu
// is the exact erf form (erff here, where Mosaic needed a polynomial).
//
// What bounds them on an H100: at the serving shapes (B*S = 4096 rows of
// H = 768, I = 3072) the four weight products are ~60 GFLOP per layer against
// ~40 MB of traffic, so both sub-blocks are bound by operations (bf16 tensor
// cores), not bytes. The attention core (S <= 128, head_dim 64) is ~3% of the
// operations.
//
// What the design does about it, first version:
//   * bf16 products run on the tensor cores with mma.sync m16n8k16 (f32
//     accumulation) in a 128x128x32 block tile, 8 warps of 64x32, operands
//     staged through double-buffered shared memory with register prefetch;
//     rows padded to 40 elements so fragment loads are free of bank
//     conflicts. f32 products use a 64x64 CUDA-core FMA tile (no TF32), so
//     float32 stays float32.
//   * every epilogue is fused into its GEMM (bias, gelu, residual), so the
//     q/k/v, the FFN intermediate and the pre-LN sum each cross device
//     memory once; the pre-LN sum is f32 and a row kernel (one warp per row)
//     finishes the LayerNorm over the whole H-wide row.
//   * the attention core reads q/k/v in their natural (B, S, 3H) layout (a
//     head is a 64-column window, no transpose in device memory). In bf16 at
//     head_dim 64 it runs on the tensor cores: one block per (example, head,
//     64 queries), all S <= 128 keys at once, the softmax in registers and
//     the rounded probabilities fed to P.V straight from the score
//     fragments. Otherwise (f32, other head dims) one warp per query row on
//     the CUDA cores, K and V of the head in shared memory as f32 (64 KB at
//     S = 128: dynamic shared memory).
// Not yet: ldmatrix, cp.async/TMA pipelines, wgmma, persistence.

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

// ---------------------------------------------------------------- epilogues
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_RESID_ROUND = 2, EPI_RESID_F32 = 3 };

struct EpiArgs {
  const float* bias;   // (N,) f32
  const void* resid;   // (M, N) T, RESID modes
  void* out;           // (M, N): T for BIAS modes, f32 for RESID modes
};

// out[m, n] from the f32 accumulator of C = A . W^T.
template <typename T, int EPI>
__device__ __forceinline__ void epi_store(const EpiArgs& e, int m, int n, int N,
                                          float acc) {
  const size_t idx = (size_t)m * N + n;
  if (EPI == EPI_RESID_F32) {
    const float r = to_f(static_cast<const T*>(e.resid)[idx]);
    static_cast<float*>(e.out)[idx] = (r + e.bias[n]) + acc;
    return;
  }
  const float v = round_to<T>(round_to<T>(acc) + round_to<T>(e.bias[n]));
  if (EPI == EPI_BIAS) {
    static_cast<T*>(e.out)[idx] = from_f<T>(v);
  } else if (EPI == EPI_BIAS_GELU) {
    const float g = (v * 0.5f) * (1.0f + erff(v * 0.7071067811865476f));
    static_cast<T*>(e.out)[idx] = from_f<T>(g);
  } else {  // EPI_RESID_ROUND
    const float r = to_f(static_cast<const T*>(e.resid)[idx]);
    static_cast<float*>(e.out)[idx] = r + v;
  }
}

// ------------------------------------------------ bf16 tensor-core GEMM
// C (M, N) = A (M, K) . W (N, K)^T, both operands K-contiguous.
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_LDS = TC_BK + 8;
constexpr int TC_THREADS = 256;

union Pack8 {
  uint4 u;
  uint16_t h[8];
};

// 8 consecutive bf16 of row `row` starting at column k, zero-filled past
// the matrix edge. vec: K % 8 == 0 and 16-byte aligned base.
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, int row, int rows,
                                            int k, int K, int vec) {
  Pack8 r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows) {
    const uint16_t* src =
        reinterpret_cast<const uint16_t*>(p) + (size_t)row * K + k;
    if (vec && k + 8 <= K) {
      r.u = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) r.h[i] = (k + i < K) ? src[i] : (uint16_t)0;
    }
  }
  return r.u;
}

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
// l % 8 of matrix l / 8, and register i receives matrix i in mma layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const uint16_t* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

constexpr int TC_STAGES = 3;
constexpr int TC_TILE = TC_BM * TC_LDS;  // elements of one operand tile
constexpr size_t TC_SMEM = (size_t)TC_STAGES * 2 * TC_TILE * sizeof(uint16_t);

// Stage the (128 x 32) A and W tiles at column k0 into shared memory: 16-byte
// cp.async copies (zero-filled past the edges) when vec, else plain loads.
__device__ __forceinline__ void tc_load_tile(uint16_t* as, uint16_t* ws,
                                             const bf16* A, const bf16* W,
                                             int bm, int bn, int M, int N, int K,
                                             int k0, int vec, int tid) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = tid + c * TC_THREADS;
    const int row = chunk >> 2, kc = (chunk & 3) * 8, k = k0 + kc;
    uint16_t* da = as + row * TC_LDS + kc;
    uint16_t* dw = ws + row * TC_LDS + kc;
    if (vec) {
      const bool in_k = k < K;
      const bool a_ok = in_k && bm + row < M, w_ok = in_k && bn + row < N;
      cp_async16(da, a_ok ? A + (size_t)(bm + row) * K + k : A, a_ok ? 16 : 0);
      cp_async16(dw, w_ok ? W + (size_t)(bn + row) * K + k : W, w_ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(da) = load8_bf16(A, bm + row, M, k, K, 0);
      *reinterpret_cast<uint4*>(dw) = load8_bf16(W, bn + row, N, k, K, 0);
    }
  }
}

// Two adjacent outputs (columns c, c + 1 of row r); a vector store when both
// exist and N is even.
template <int EPI>
__device__ __forceinline__ void epi_store2(const EpiArgs& e, int r, int c, int M,
                                           int N, float a0, float a1) {
  if (r >= M) return;
  if (c + 1 < N && (N & 1) == 0) {
    const size_t idx = (size_t)r * N + c;
    const float b0 = e.bias[c], b1 = e.bias[c + 1];
    if (EPI == EPI_RESID_F32 || EPI == EPI_RESID_ROUND) {
      const __nv_bfloat162 x2 =
          *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(e.resid) + idx);
      float2 z;
      if (EPI == EPI_RESID_F32) {
        z.x = (__bfloat162float(x2.x) + b0) + a0;
        z.y = (__bfloat162float(x2.y) + b1) + a1;
      } else {
        z.x = __bfloat162float(x2.x) + round_to<bf16>(round_to<bf16>(a0) + round_to<bf16>(b0));
        z.y = __bfloat162float(x2.y) + round_to<bf16>(round_to<bf16>(a1) + round_to<bf16>(b1));
      }
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) + idx) = z;
    } else {
      float v0 = round_to<bf16>(round_to<bf16>(a0) + round_to<bf16>(b0));
      float v1 = round_to<bf16>(round_to<bf16>(a1) + round_to<bf16>(b1));
      if (EPI == EPI_BIAS_GELU) {
        v0 = (v0 * 0.5f) * (1.0f + erff(v0 * 0.7071067811865476f));
        v1 = (v1 * 0.5f) * (1.0f + erff(v1 * 0.7071067811865476f));
      }
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out) + idx) =
          __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  if (c < N) epi_store<bf16, EPI>(e, r, c, N, a0);
  if (c + 1 < N) epi_store<bf16, EPI>(e, r, c + 1, N, a1);
}

template <int EPI>
__global__ void __launch_bounds__(TC_THREADS, 2)
gemm_bf16_tc(const bf16* __restrict__ A, const bf16* __restrict__ W, int M,
             int N, int K, int vec, EpiArgs e) {
  // TC_STAGES x {A tile, W tile}, bf16 bits as uint16_t.
  extern __shared__ __align__(16) unsigned char tc_smem[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(tc_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bm = blockIdx.y * TC_BM, bn = blockIdx.x * TC_BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // 2 x 4 warps

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (K + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nk)
      tc_load_tile(smem + st * 2 * TC_TILE, smem + st * 2 * TC_TILE + TC_TILE, A, W,
                   bm, bn, M, N, K, st * TC_BK, vec, tid);
    cp_async_commit();
  }
  // ldmatrix row addresses: A rows (lane & 15), column half (lane >> 4);
  // W rows (lane & 7) + 8 * (lane >> 4), column half (lane >> 3) & 1.
  const int a_row = wm + (lane & 15), a_col = (lane >> 4) * 8;
  const int w_row = wn + (lane & 7) + 8 * (lane >> 4), w_col = ((lane >> 3) & 1) * 8;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t visible; stage (t - 1) % STAGES free
    const int nxt = t + TC_STAGES - 1;
    if (nxt < nk) {
      uint16_t* base = smem + (nxt % TC_STAGES) * 2 * TC_TILE;
      tc_load_tile(base, base + TC_TILE, A, W, bm, bn, M, N, K, nxt * TC_BK, vec, tid);
    }
    cp_async_commit();
    const uint16_t* as = smem + (t % TC_STAGES) * 2 * TC_TILE;
    const uint16_t* ws = as + TC_TILE;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (a_row + mi * 16) * TC_LDS + kk + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n-tiles 2np, 2np + 1
        uint32_t r[4];
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
// vec: K % 4 == 0 and 16-byte aligned base.
__device__ __forceinline__ float4 load4_f32(const float* p, int row, int rows,
                                            int k, int K, int vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows) {
    const float* src = p + (size_t)row * K + k;
    if (vec && k + 4 <= K) {
      r = *reinterpret_cast<const float4*>(src);
    } else {
      if (k + 0 < K) r.x = src[0];
      if (k + 1 < K) r.y = src[1];
      if (k + 2 < K) r.z = src[2];
      if (k + 3 < K) r.w = src[3];
    }
  }
  return r;
}

template <int EPI>
__global__ void __launch_bounds__(FS_THREADS)
gemm_f32_simt(const float* __restrict__ A, const float* __restrict__ W, int M,
              int N, int K, int vec, EpiArgs e) {
  __shared__ float As[FS_BK][FS_BM + 4];
  __shared__ float Ws[FS_BK][FS_BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm = blockIdx.y * FS_BM, bn = blockIdx.x * FS_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int lrow = tid >> 2, lk = (tid & 3) * 4;
  for (int k0 = 0; k0 < K; k0 += FS_BK) {
    const float4 a = load4_f32(A, bm + lrow, M, k0 + lk, K, vec);
    const float4 w = load4_f32(W, bn + lrow, N, k0 + lk, K, vec);
    As[lk + 0][lrow] = a.x; As[lk + 1][lrow] = a.y;
    As[lk + 2][lrow] = a.z; As[lk + 3][lrow] = a.w;
    Ws[lk + 0][lrow] = w.x; Ws[lk + 1][lrow] = w.y;
    Ws[lk + 2][lrow] = w.z; Ws[lk + 3][lrow] = w.w;
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

template <typename T>
__global__ void __launch_bounds__(AT_WARPS * 32)
attention_core(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
               T* __restrict__ ctx, int S, int H, int nh, int D, float scale) {
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
      if (j < S) p[j] = round_to<T>(s[t] / sum);
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

// bf16 attention core on the tensor cores, head_dim 64. One block per
// (example, head) x 64 queries; each of the 4 warps owns 16 query rows and
// runs S = Q.K^T (mma m16n8k16, f32 accumulation) for all keys at once,
// the softmax in registers, then P.V with the rounded probabilities as the A
// operand straight from the score fragments. Keys are padded to a multiple
// of 16 (zero rows, bias -inf). Shared rows are padded by 8 elements so the
// 32-bit fragment loads hit 32 distinct banks.
constexpr int TA_D = 64, TA_QROWS = 64, TA_WARPS = 4, TA_LDK = TA_D + 8;

__host__ __device__ constexpr int ta_pad(int S) { return (S + 15) & ~15; }

__host__ __device__ constexpr size_t ta_smem_bytes(int S) {
  return 2 * ((size_t)ta_pad(S) * TA_LDK + (size_t)TA_QROWS * TA_LDK +
              (size_t)TA_D * (ta_pad(S) + 8)) + 4 * (size_t)ta_pad(S);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(TA_WARPS * 32)
attention_core_tc(const bf16* __restrict__ qkv, const float* __restrict__ mask_bias,
                  bf16* __restrict__ ctx, int S, int H, int nh, float scale) {
  extern __shared__ __align__(16) unsigned char ta_smem[];
  const int s_pad = ta_pad(S), ldv = s_pad + 8;
  uint16_t* Ks = reinterpret_cast<uint16_t*>(ta_smem);  // s_pad x TA_LDK
  uint16_t* Qs = Ks + s_pad * TA_LDK;                    // TA_QROWS x TA_LDK
  uint16_t* Vt = Qs + TA_QROWS * TA_LDK;                 // TA_D x ldv (V^T)
  float* Bs = reinterpret_cast<float*>(Vt + TA_D * ldv); // s_pad mask bias

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int q0 = blockIdx.y * TA_QROWS;
  const size_t ld = 3 * (size_t)H;
  const uint16_t* base = reinterpret_cast<const uint16_t*>(qkv) + (size_t)b * S * ld;

  for (int idx = tid; idx < s_pad * 8; idx += blockDim.x) {
    const int j = idx >> 3, c = (idx & 7) * 8;
    Pack8 k, v;
    k.u = v.u = make_uint4(0u, 0u, 0u, 0u);
    if (j < S) {
      k.u = *reinterpret_cast<const uint4*>(base + j * ld + H + h * TA_D + c);
      v.u = *reinterpret_cast<const uint4*>(base + j * ld + 2 * H + h * TA_D + c);
    }
    *reinterpret_cast<uint4*>(Ks + j * TA_LDK + c) = k.u;
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(c + e) * ldv + j] = v.h[e];
  }
  for (int idx = tid; idx < TA_QROWS * 8; idx += blockDim.x) {
    const int r = idx >> 3, c = (idx & 7) * 8, i = q0 + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (i < S) q = *reinterpret_cast<const uint4*>(base + i * ld + h * TA_D + c);
    *reinterpret_cast<uint4*>(Qs + r * TA_LDK + c) = q;
  }
  for (int j = tid; j < s_pad; j += blockDim.x)
    Bs[j] = j < S ? mask_bias[(size_t)b * S + j] : -INFINITY;
  __syncthreads();

  const int r0 = warp * 16;
  if (q0 + r0 >= S) return;
  const int n_tiles = s_pad / 8;  // <= 16 key tiles of 8

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

  // Softmax over the rows g (c0, c1) and g + 8 (c2, c3); a row's columns are
  // spread over the 4 threads of a quad.
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

  float out[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[dn][c] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    if (kc < n_tiles / 2) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sc[2 * kc][0] / sum0, sc[2 * kc][1] / sum0);
      a[1] = pack_bf16x2(sc[2 * kc][2] / sum1, sc[2 * kc][3] / sum1);
      a[2] = pack_bf16x2(sc[2 * kc + 1][0] / sum0, sc[2 * kc + 1][1] / sum0);
      a[3] = pack_bf16x2(sc[2 * kc + 1][2] / sum1, sc[2 * kc + 1][3] / sum1);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const uint16_t* q = Vt + (dn * 8 + g) * ldv + kc * 16 + t4 * 2;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(q);
        bfr[1] = *reinterpret_cast<const uint32_t*>(q + 8);
        mma_bf16_16816(out[dn], a, bfr);
      }
    }
  }

  const int i0 = q0 + r0 + g, i1 = i0 + 8;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = h * TA_D + dn * 8 + t4 * 2;
    if (i0 < S)
      *reinterpret_cast<uint32_t*>(ctx + ((size_t)b * S + i0) * H + col) =
          pack_bf16x2(out[dn][0], out[dn][1]);
    if (i1 < S)
      *reinterpret_cast<uint32_t*>(ctx + ((size_t)b * S + i1) * H + col) =
          pack_bf16x2(out[dn][2], out[dn][3]);
  }
}

// ------------------------------------------------------------ LayerNorm
// y = LN(z) * g + b over rows of H, one warp per row; z is the f32 pre-LN sum.
template <typename T>
__global__ void __launch_bounds__(256)
layer_norm_rows(const float* __restrict__ z, const float* __restrict__ g,
                const float* __restrict__ beta, T* __restrict__ y, int M, int H,
                float eps) {
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
}

// ------------------------------------------------------------- launchers
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int EPI>
int launch_gemm_epi(const bf16* A, const bf16* W, int M, int N, int K, EpiArgs e,
                    cudaStream_t st) {
  const int vec = (K % 8 == 0) && aligned16(A) && aligned16(W);
  int err = (int)cudaFuncSetAttribute(
      gemm_bf16_tc<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (err) return err;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  gemm_bf16_tc<EPI><<<grid, TC_THREADS, TC_SMEM, st>>>(A, W, M, N, K, vec, e);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_gemm_epi(const float* A, const float* W, int M, int N, int K, EpiArgs e,
                    cudaStream_t st) {
  const int vec = (K % 4 == 0) && aligned16(A) && aligned16(W);
  dim3 grid((N + FS_BN - 1) / FS_BN, (M + FS_BM - 1) / FS_BM);
  gemm_f32_simt<EPI><<<grid, FS_THREADS, 0, st>>>(A, W, M, N, K, vec, e);
  return (int)cudaGetLastError();
}

template <typename T>
int layer_norm(const float* z, const float* g, const float* b, T* y, int M, int H,
               float eps, cudaStream_t st) {
  const int rows_per_block = 256 / 32;
  layer_norm_rows<T><<<(M + rows_per_block - 1) / rows_per_block, 256, 0, st>>>(
      z, g, b, y, M, H, eps);
  return (int)cudaGetLastError();
}

// softmax(q.k^T * scale + mask) . v for every (example, head): the tensor
// cores for bf16 at head_dim 64, the CUDA-core version otherwise.
template <typename T>
int attention_core_launch(const T* qkv, const float* mask, T* ctx, int B, int S,
                          int H, int nh, float scale, cudaStream_t st) {
  const int D = H / nh;
  if constexpr (sizeof(T) == 2) {
    if (D == TA_D) {
      const size_t smem = ta_smem_bytes(S);
      int err = (int)cudaFuncSetAttribute(
          attention_core_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      dim3 grid(B * nh, (S + TA_QROWS - 1) / TA_QROWS);
      attention_core_tc<<<grid, TA_WARPS * 32, smem, st>>>(qkv, mask, ctx, S, H,
                                                           nh, scale);
      return (int)cudaGetLastError();
    }
  }
  const size_t smem = at_smem_floats(S, D) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(attention_core<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  dim3 grid(B * nh, (S + AT_QTILE - 1) / AT_QTILE);
  attention_core<T><<<grid, AT_WARPS * 32, smem, st>>>(qkv, mask, ctx, S, H, nh, D,
                                                       scale);
  return (int)cudaGetLastError();
}

template <typename T>
int attention_impl(const T* x, const T* wqkv, const float* bqkv, const T* wo,
                   const float* bo, const float* ln_g, const float* ln_b,
                   const float* mask, T* qkv, T* ctx, float* z, T* y, int B, int S,
                   int H, int nh, float scale, float eps, cudaStream_t st) {
  const int M = B * S, D = H / nh;
  if (S > AT_MAX_S || D > AT_MAX_D || D * nh != H) return (int)cudaErrorInvalidValue;
  int err = launch_gemm_epi<EPI_BIAS>(x, wqkv, M, 3 * H, H, EpiArgs{bqkv, nullptr, qkv}, st);
  if (err) return err;
  err = attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, st);
  if (err) return err;
  err = launch_gemm_epi<EPI_RESID_ROUND>(ctx, wo, M, H, H, EpiArgs{bo, x, z}, st);
  if (err) return err;
  return layer_norm<T>(z, ln_g, ln_b, y, M, H, eps, st);
}

template <typename T>
int ffn_impl(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
             const float* ln_g, const float* ln_b, T* inter, float* z, T* y, int M,
             int H, int I, float eps, cudaStream_t st) {
  int err = launch_gemm_epi<EPI_BIAS_GELU>(x, w1, M, I, H, EpiArgs{b1, nullptr, inter}, st);
  if (err) return err;
  err = launch_gemm_epi<EPI_RESID_F32>(inter, w2, M, H, I, EpiArgs{b2, x, z}, st);
  if (err) return err;
  return layer_norm<T>(z, ln_g, ln_b, y, M, H, eps, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 or the first CUDA error code.
extern "C" int rt_attention_block(const void* x, const void* wqkv, const void* bqkv,
                                  const void* wo, const void* bo, const void* ln_g,
                                  const void* ln_b, const void* mask_bias, void* qkv,
                                  void* ctx, void* z, void* y, int B, int S, int H,
                                  int num_heads, float scale, float eps, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_bqkv = static_cast<const float*>(bqkv);
  const float* f_bo = static_cast<const float*>(bo);
  const float* f_g = static_cast<const float*>(ln_g);
  const float* f_b = static_cast<const float*>(ln_b);
  const float* f_mask = static_cast<const float*>(mask_bias);
  if (dtype == 0)
    return attention_impl<float>(
        static_cast<const float*>(x), static_cast<const float*>(wqkv), f_bqkv,
        static_cast<const float*>(wo), f_bo, f_g, f_b, f_mask,
        static_cast<float*>(qkv), static_cast<float*>(ctx), static_cast<float*>(z),
        static_cast<float*>(y), B, S, H, num_heads, scale, eps, st);
  if (dtype == 1)
    return attention_impl<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), f_bqkv,
        static_cast<const bf16*>(wo), f_bo, f_g, f_b, f_mask,
        static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), static_cast<float*>(z),
        static_cast<bf16*>(y), B, S, H, num_heads, scale, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rt_ffn_block(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* ln_g,
                            const void* ln_b, void* inter, void* z, void* y, int M,
                            int H, int I, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_g = static_cast<const float*>(ln_g);
  const float* f_b = static_cast<const float*>(ln_b);
  if (dtype == 0)
    return ffn_impl<float>(
        static_cast<const float*>(x), static_cast<const float*>(w1), f_b1,
        static_cast<const float*>(w2), f_b2, f_g, f_b, static_cast<float*>(inter),
        static_cast<float*>(z), static_cast<float*>(y), M, H, I, eps, st);
  if (dtype == 1)
    return ffn_impl<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), f_b1,
        static_cast<const bf16*>(w2), f_b2, f_g, f_b, static_cast<bf16*>(inter),
        static_cast<float*>(z), static_cast<bf16*>(y), M, H, I, eps, st);
  return (int)cudaErrorInvalidValue;
}
