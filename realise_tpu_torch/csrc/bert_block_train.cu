// Fused BERT sub-block kernels of the training step for Hopper (sm_90a):
// forward with dropout, and the fused backward.
//
// Replaces the TPU kernels of realise_tpu/ops/pallas/bert_block_train.py:
//   * rt_attention_train_fwd  <- _attn_fwd_impl (attention_block_train forward)
//   * rt_attention_train_bwd  <- _attn_bwd_impl (its backward, plus dWo/dbo)
//   * rt_ffn_train_fwd        <- _ffn_fwd_impl  (ffn_block_train forward)
//   * rt_ffn_train_bwd        <- _ffn_bwd_impl  (its backward)
// Each entry point launches a short sequence of kernels on the caller's
// stream into buffers the caller allocated; it returns 0 or the first CUDA
// error. Dropout masks are the Pallas kernels' counter hash, replayed
// identically in the backward (bert_block_common.cuh keep_mult).
//
// What bounds them on an H100: at the training shape (B*S = 32768 rows, H =
// 768, I = 3072) a layer's forward is ~0.47 TFLOP of weight products and its
// backward ~0.93 TFLOP plus the recomputed forward products, against a few
// hundred MB of traffic: operations, on the bf16 tensor cores. The attention
// core is ~4% of the operations.
//
// What the design does about it, first version:
//   * every product runs in the shared mma.sync GEMM (bert_block_common.cuh)
//     with its epilogue fused: bias, gelu, dropout, residual, gelu' and the
//     residual dz of dx. The backward's data gradients (dx = dY.W) read W
//     n-contiguous and the weight gradients (dW = dY^T.X over the B*S rows)
//     read both operands transposed, with ldmatrix.trans, so no transpose
//     is ever written to device memory.
//   * the TPU kernels carry weight gradients in a grid-invariant accumulator
//     from one sequential grid step to the next; here blocks run in no
//     order, so a weight gradient is one GEMM over all rows, split along
//     the rows into at most MAX_SPLITS float32 partials summed in a fixed
//     order by a second pass; bias and LayerNorm gradients are two-pass
//     column sums. No float atomics: two runs give the same bits.
//   * only x (attention) or x and the rounded z (FFN) are kept from the
//     forward; the backward recomputes q/k/v, the probabilities, ctx and
//     the pre-LN z (attention) or t1 (FFN) in the same kernels as the
//     forward, so the replayed values are the forward's.
//   * the attention backward core runs on the CUDA cores in f32, one block
//     per (example, head) with K, V (then Q, dctx), the dropped
//     probabilities and the softmax gradient of the whole head in shared
//     memory (~200 KB at S = 128, head_dim 64).
// Not yet: the attention backward on the tensor cores, TMA, wgmma,
// persistence, fusing the LayerNorm backward into the GEMM epilogues.

#include "bert_block_common.cuh"

// The caller's dropout arguments (realise_tpu_torch/ops/kernels/
// bert_block_train.py _Dropout): the layer's seed, and for the probability
// site (p) and the hidden sites (h) the 16- and 24-bit keep thresholds, the
// survivors' scale and whether the site drops at all. At global scope: the
// extern "C" entry points take it, and a type of the anonymous namespace
// would give them internal linkage.
struct RtDropout {
  uint32_t seed;
  uint32_t p_thr16, p_thr24;
  float p_scale;
  int32_t p_on;
  uint32_t h_thr16, h_thr24;
  float h_scale;
  int32_t h_on;
};

namespace {

constexpr int CS_ROWS = 256;      // rows per partial of the column sums
constexpr int CS_THREADS = 128;
constexpr int MAX_SPLITS = 8;     // most K-splits of a weight-gradient GEMM

Drop probs_drop(const RtDropout& d) {
  return Drop{d.seed, SITE_PROBS, d.p_thr16, d.p_thr24, d.p_scale, d.p_on};
}
Drop hidden_drop(const RtDropout& d, uint32_t site) {
  return Drop{d.seed, site, d.h_thr16, d.h_thr24, d.h_scale, d.h_on};
}

// ------------------------------------------------------ column sums
// out[c] = sum over rows of x[r, c] in f32: pass 1 sums CS_ROWS-row chunks
// into part (chunks x N), pass 2 sums the chunks in order.
template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
colsum_partial(const T* __restrict__ x, int M, int N, float* __restrict__ part) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * CS_ROWS, r1 = min(M, r0 + CS_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(x[(size_t)r * N + c]);
  part[(size_t)blockIdx.y * N + c] = s;
}

__global__ void __launch_bounds__(CS_THREADS)
colsum_final(const float* __restrict__ part, int chunks, int N, float* __restrict__ out) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= N) return;
  float s = 0.f;
  for (int i = 0; i < chunks; ++i) s += part[(size_t)i * N + c];
  out[c] = s;
}

template <typename T>
int colsum(const T* x, int M, int N, float* part, float* out, cudaStream_t st) {
  const int chunks = (M + CS_ROWS - 1) / CS_ROWS;
  dim3 grid((N + CS_THREADS - 1) / CS_THREADS, chunks);
  colsum_partial<T><<<grid, CS_THREADS, 0, st>>>(x, M, N, part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  colsum_final<<<(N + CS_THREADS - 1) / CS_THREADS, CS_THREADS, 0, st>>>(part, chunks, N,
                                                                         out);
  return (int)cudaGetLastError();
}

// out[i] = sum over the splits of part[s * n + i], in split order.
__global__ void __launch_bounds__(256)
split_sum(const float* __restrict__ part, int splits, size_t n, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

// K-splits of a weight-gradient GEMM (M x N output, K = B*S rows): the
// count in {1, 2, 4, 8} that fills the card's GEMM slots (2 blocks per SM)
// best, each split at least 256 rows long.
int choose_splits(int M, int N, int K, int tile) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const int slots = 2 * sms;
  const long tiles = (long)((M + tile - 1) / tile) * ((N + tile - 1) / tile);
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= MAX_SPLITS; s *= 2) {
    if (s > 1 && K / s < 256) break;
    const long blocks = tiles * s;
    const double fill = (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  return best;
}

// dW (M x N) = A^T . B over K rows: A (K, M) and B (K, N) row-major, both
// read transposed; split along K into `wsplit` partials when that fills the
// card better, summed in order.
template <typename T>
int weight_grad(const T* A, const T* B, int M, int N, int K, float* out,
                float* wsplit, cudaStream_t st) {
  const int tile = sizeof(T) == 2 ? TC_BM : FS_BM;
  const int splits = sizeof(T) == 2 ? choose_splits(M, N, K, tile) : 1;
  if (splits == 1)
    return launch_gemm<EPI_STORE_F32, true, true>(A, B, M, N, K, M, N,
                                                  epi(nullptr, nullptr, out), st);
  int err = launch_gemm<EPI_STORE_F32, true, true>(A, B, M, N, K, M, N,
                                                   epi(nullptr, nullptr, wsplit), st, splits);
  if (err) return err;
  // The launcher rounds the split length up to whole k-tiles; count the
  // partials it wrote.
  const int k_chunk = ((K + splits - 1) / splits + TC_BK - 1) / TC_BK * TC_BK;
  const int used = (K + k_chunk - 1) / k_chunk;
  const size_t n = (size_t)M * N;
  split_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(wsplit, used, n, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ LayerNorm backward
// One warp per row of the pre-LN sum z (f32, or the rounded T of the FFN):
//   dz = rstd * (g - mean(g) - norm * mean(g * norm)),  g = dy * gamma,
// plus dnorm = dy * norm (the dgamma column sum's input), dlo = round(dz *
// keep) for the hidden site `drop`, and (optional) d32 = dz * keep in f32.
template <typename T, typename ZT>
__global__ void __launch_bounds__(256)
ln_bwd_rows(const ZT* __restrict__ z, const T* __restrict__ dy,
            const float* __restrict__ gamma, int M, int H, float eps, Drop drop, int S,
            float* __restrict__ dz, float* __restrict__ dnorm, T* __restrict__ dlo,
            float* __restrict__ d32) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += to_f(z[off + c]);
  const float mu = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = to_f(z[off + c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / H + eps);
  float sg = 0.f, sgn = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float norm = (to_f(z[off + c]) - mu) * rstd;
    const float g = to_f(dy[off + c]) * gamma[c];
    sg += g;
    sgn += g * norm;
  }
  const float mg = warp_sum(sg) / H, mgn = warp_sum(sgn) / H;
  const uint32_t base = drop.on ? site_base(drop.seed, drop.site, (uint32_t)(row / S), 0u) : 0u;
  for (int c = lane; c < H; c += 32) {
    const float norm = (to_f(z[off + c]) - mu) * rstd;
    const float dyc = to_f(dy[off + c]);
    const float d = rstd * (dyc * gamma[c] - mg - norm * mgn);
    dz[off + c] = d;
    dnorm[off + c] = dyc * norm;
    const float dd = drop.on ? d * keep_mult(drop, base, row % S, c, H) : d;
    dlo[off + c] = from_f<T>(dd);
    if (d32 != nullptr) d32[off + c] = dd;
  }
}

template <typename T, typename ZT>
int ln_bwd(const ZT* z, const T* dy, const float* gamma, int M, int H, float eps, Drop drop,
           int S, float* dz, float* dnorm, T* dlo, float* d32, cudaStream_t st) {
  ln_bwd_rows<T, ZT><<<(M + 7) / 8, 256, 0, st>>>(z, dy, gamma, M, H, eps, drop, S, dz,
                                                  dnorm, dlo, d32);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ attention backward core
// One block per (example, head), 8 warps, S <= 128 and head_dim D <= 64.
// Phase A, a warp per query row i: recompute the scores and the softmax,
// replay the probability mask m, then
//   Pd[i, j] = round(p * m),  dp = (dctx_i . v_j) * m,
//   dS[i, j] = round((p * (dp - sum_j dp * p)) * scale),
//   dq_i = round(sum_j dS[i, j] k_j).
// Phase B, a warp per key row j, with Q and dctx in the shared rows that held
// K and V: dk_j = round(sum_i dS[i, j] q_i), dv_j = round(sum_i Pd[i, j]
// dctx_i). Writes dq | dk | dv into the (B, S, 3H) gradient of qkv.
constexpr int AB_WARPS = 8;

__host__ __device__ constexpr size_t ab_smem_floats(int S, int D) {
  return 2 * (size_t)S * (D + 1) + 2 * (size_t)S * S + 2 * (size_t)AB_WARPS * D + S;
}

template <typename T>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_core(const T* __restrict__ qkv, const T* __restrict__ dctx,
                   const float* __restrict__ mask_bias, T* __restrict__ dqkv, int S,
                   int H, int nh, int D, float scale, Drop drop) {
  extern __shared__ float sm[];
  const int ldr = D + 1;
  float* KQ = sm;                       // S x (D + 1): K, then Q
  float* VC = KQ + (size_t)S * ldr;     // S x (D + 1): V, then dctx
  float* Pd = VC + (size_t)S * ldr;     // S x S rounded dropped probabilities
  float* dS = Pd + (size_t)S * S;       // S x S rounded scaled softmax grads
  float* Rq = dS + (size_t)S * S;       // AB_WARPS x D query rows
  float* Rc = Rq + AB_WARPS * D;        // AB_WARPS x D dctx rows
  float* Bs = Rc + AB_WARPS * D;        // S mask bias

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const size_t ld = 3 * (size_t)H;
  const T* base = qkv + (size_t)b * S * ld;
  const T* cbase = dctx + (size_t)b * S * H;
  T* gbase = dqkv + (size_t)b * S * ld;
  const uint32_t dbase = site_base(drop.seed, SITE_PROBS, (uint32_t)b, (uint32_t)h);

  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    KQ[j * ldr + d] = to_f(base[j * ld + H + h * D + d]);
    VC[j * ldr + d] = to_f(base[j * ld + 2 * H + h * D + d]);
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) Bs[j] = mask_bias[(size_t)b * S + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = Rq + warp * D;
  float* c = Rc + warp * D;
  for (int i = warp; i < S; i += AB_WARPS) {
    for (int d = lane; d < D; d += 32) {
      q[d] = to_f(base[(size_t)i * ld + h * D + d]);
      c[d] = to_f(cbase[(size_t)i * H + h * D + d]);
    }
    __syncwarp();
    float s[4], dpd[4];
    int krow[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      s[t] = dpd[t] = 0.f;
      const int j = lane + 32 * t;
      krow[t] = (j < S ? j : 0) * ldr;
    }
    for (int d = 0; d < D; ++d) {
      const float qd = q[d], cd = c[d];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[t] = fmaf(qd, KQ[krow[t] + d], s[t]);
        dpd[t] = fmaf(cd, VC[krow[t] + d], dpd[t]);
      }
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
    float dp[4], rs = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      s[t] = s[t] / sum;  // p
      float m = 1.f;
      if (drop.on && j < S) m = keep_mult(drop, dbase, i, j, S);
      dp[t] = (j < S) ? dpd[t] * (drop.on ? m : 1.f) : 0.f;
      rs += dp[t] * s[t];
      if (j < S) Pd[(size_t)i * S + j] = round_to<T>(drop.on ? s[t] * m : s[t]);
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      if (j < S) dS[(size_t)i * S + j] = round_to<T>((s[t] * (dp[t] - rs)) * scale);
    }
    __syncwarp();
    const int d0 = lane, d1 = lane + 32;
    float a0 = 0.f, a1 = 0.f;
    const float* dsr = dS + (size_t)i * S;
    for (int j = 0; j < S; ++j) {
      const float w = dsr[j];
      if (d0 < D) a0 = fmaf(w, KQ[j * ldr + d0], a0);
      if (d1 < D) a1 = fmaf(w, KQ[j * ldr + d1], a1);
    }
    T* out = gbase + (size_t)i * ld + h * D;
    if (d0 < D) out[d0] = from_f<T>(a0);
    if (d1 < D) out[d1] = from_f<T>(a1);
    __syncwarp();
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    KQ[j * ldr + d] = to_f(base[j * ld + h * D + d]);
    VC[j * ldr + d] = to_f(cbase[(size_t)j * H + h * D + d]);
  }
  __syncthreads();
  for (int j = warp; j < S; j += AB_WARPS) {
    const int d0 = lane, d1 = lane + 32;
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < S; ++i) {
      const float ds = dS[(size_t)i * S + j], pd = Pd[(size_t)i * S + j];
      if (d0 < D) {
        k0 = fmaf(ds, KQ[i * ldr + d0], k0);
        v0 = fmaf(pd, VC[i * ldr + d0], v0);
      }
      if (d1 < D) {
        k1 = fmaf(ds, KQ[i * ldr + d1], k1);
        v1 = fmaf(pd, VC[i * ldr + d1], v1);
      }
    }
    T* out = gbase + (size_t)j * ld + h * D;
    if (d0 < D) {
      out[H + d0] = from_f<T>(k0);
      out[2 * H + d0] = from_f<T>(v0);
    }
    if (d1 < D) {
      out[H + d1] = from_f<T>(k1);
      out[2 * H + d1] = from_f<T>(v1);
    }
  }
}

template <typename T>
int attention_bwd_launch(const T* qkv, const T* dctx, const float* mask, T* dqkv, int B,
                         int S, int H, int nh, float scale, Drop drop, cudaStream_t st) {
  const int D = H / nh;
  const size_t smem = ab_smem_floats(S, D) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(attention_bwd_core<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  attention_bwd_core<T><<<B * nh, AB_WARPS * 32, smem, st>>>(qkv, dctx, mask, dqkv, S, H,
                                                             nh, D, scale, drop);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ sub-blocks
#define RT_TRY(...)            \
  do {                         \
    int e_ = (__VA_ARGS__);    \
    if (e_) return e_;         \
  } while (0)

bool attention_shape_ok(int S, int H, int nh) {
  return nh > 0 && S > 0 && S <= AT_MAX_S && H % nh == 0 && H / nh <= AT_MAX_D;
}

template <typename T>
int attention_fwd_impl(const T* x, const T* wqkv, const float* bqkv, const T* wo,
                       const float* bo, const float* g, const float* beta,
                       const float* mask, T* qkv, T* ctx, float* z32, T* y, int B, int S,
                       int H, int nh, float scale, float eps, const RtDropout& d,
                       cudaStream_t st) {
  const int M = B * S;
  if (!attention_shape_ok(S, H, nh)) return (int)cudaErrorInvalidValue;
  RT_TRY(launch_gemm<EPI_BIAS>(x, wqkv, M, 3 * H, H, H, H, epi(bqkv, nullptr, qkv), st));
  RT_TRY(attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, probs_drop(d), st));
  RT_TRY(launch_gemm<EPI_RESID_ROUND_DROP>(
      ctx, wo, M, H, H, H, H, epi(bo, x, z32, nullptr, hidden_drop(d, SITE_ATTN_OUT), S),
      st));
  return layer_norm<T>(z32, g, beta, y, M, H, eps, st);
}

template <typename T>
int attention_bwd_impl(const T* x, const T* dy, const T* wqkv, const float* bqkv,
                       const T* wo, const float* bo, const float* g, const float* mask,
                       T* qkv, T* ctx, float* z32, float* dz, float* dnorm, T* dattn,
                       T* dctx, T* dqkv, float* part, float* wsplit, T* dx, float* dwqkv,
                       float* dbqkv, float* dwo, float* dbo, float* dg, float* dbeta, int B,
                       int S, int H, int nh, float scale, float eps,
                       const RtDropout& d, cudaStream_t st) {
  const int M = B * S;
  if (!attention_shape_ok(S, H, nh)) return (int)cudaErrorInvalidValue;
  const Drop dh = hidden_drop(d, SITE_ATTN_OUT);
  // Recompute the forward up to the pre-LN sum.
  RT_TRY(launch_gemm<EPI_BIAS>(x, wqkv, M, 3 * H, H, H, H, epi(bqkv, nullptr, qkv), st));
  RT_TRY(attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, probs_drop(d), st));
  RT_TRY(launch_gemm<EPI_RESID_ROUND_DROP>(ctx, wo, M, H, H, H, H,
                                           epi(bo, x, z32, nullptr, dh, S), st));
  // LayerNorm backward, the output-dropout replay, dgamma/dbeta/dbo.
  RT_TRY(ln_bwd<T, float>(z32, dy, g, M, H, eps, dh, S, dz, dnorm, dattn, nullptr, st));
  RT_TRY(colsum<float>(dnorm, M, H, part, dg, st));
  RT_TRY(colsum<T>(dy, M, H, part, dbeta, st));
  RT_TRY(colsum<T>(dattn, M, H, part, dbo, st));
  // dctx = dattn . Wo, then the attention core's backward.
  RT_TRY(launch_gemm<EPI_ROUND, false, true>(dattn, wo, M, H, H, H, H,
                                             epi(nullptr, nullptr, dctx), st));
  RT_TRY(attention_bwd_launch<T>(qkv, dctx, mask, dqkv, B, S, H, nh, scale, probs_drop(d),
                                 st));
  RT_TRY(colsum<T>(dqkv, M, 3 * H, part, dbqkv, st));
  // Weight gradients over the B*S rows, then dx = dz + dqkv . Wqkv.
  RT_TRY(weight_grad<T>(dqkv, x, 3 * H, H, M, dwqkv, wsplit, st));
  RT_TRY(weight_grad<T>(dattn, ctx, H, H, M, dwo, wsplit, st));
  return launch_gemm<EPI_ADD_F32_ROUND, false, true>(dqkv, wqkv, M, H, 3 * H, 3 * H, H,
                                                     epi(nullptr, dz, dx), st);
}

template <typename T>
int ffn_fwd_impl(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
                 const float* g, const float* beta, T* inter, float* z32, T* z, T* y, int M,
                 int S, int H, int I, float eps, const RtDropout& d, cudaStream_t st) {
  RT_TRY(launch_gemm<EPI_BIAS_GELU>(x, w1, M, I, H, H, H, epi(b1, nullptr, inter), st));
  RT_TRY(launch_gemm<EPI_RESID_F32_DROP>(
      inter, w2, M, H, I, I, I, epi(b2, x, z32, nullptr, hidden_drop(d, SITE_FFN_OUT), S),
      st));
  return layer_norm<T>(z32, g, beta, y, M, H, eps, st, z);
}

template <typename T>
int ffn_bwd_impl(const T* x, const T* z, const T* dy, const T* w1, const float* b1,
                 const T* w2, const float* g, float* dz, float* dnorm, float* dout32,
                 T* dout, T* t1, T* inter, T* dt1, float* part, float* wsplit, T* dx,
                 float* dw1, float* db1, float* dw2, float* db2, float* dg, float* dbeta,
                 int M, int S, int H, int I, float eps, const RtDropout& d,
                 cudaStream_t st) {
  const Drop dh = hidden_drop(d, SITE_FFN_OUT);
  // LayerNorm backward from the rounded z, the output-dropout replay.
  RT_TRY(ln_bwd<T, T>(z, dy, g, M, H, eps, dh, S, dz, dnorm, dout, dout32, st));
  RT_TRY(colsum<float>(dnorm, M, H, part, dg, st));
  RT_TRY(colsum<T>(dy, M, H, part, dbeta, st));
  RT_TRY(colsum<float>(dout32, M, H, part, db2, st));
  // t1 = round(x . W1) + b1 and gelu(t1) recomputed; dW2 = dout^T . gelu(t1).
  RT_TRY(launch_gemm<EPI_BIAS_T1_GELU>(x, w1, M, I, H, H, H, epi(b1, nullptr, t1, inter),
                                       st));
  RT_TRY(weight_grad<T>(dout, inter, H, I, M, dw2, wsplit, st));
  // dt1 = (dout . W2) * gelu'(t1); db1, dW1 = dt1^T . x; dx = dz + dt1 . W1.
  RT_TRY(launch_gemm<EPI_GELU_GRAD, false, true>(dout, w2, M, I, H, H, I,
                                                 epi(nullptr, t1, dt1), st));
  RT_TRY(colsum<T>(dt1, M, I, part, db1, st));
  RT_TRY(weight_grad<T>(dt1, x, I, H, M, dw1, wsplit, st));
  return launch_gemm<EPI_ADD_F32_ROUND, false, true>(dt1, w1, M, H, I, I, H,
                                                     epi(nullptr, dz, dx), st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 or the first CUDA error code.
#define RT_DISPATCH(impl, ...)                                        \
  do {                                                                \
    if (dtype == 0) { using T = float; return impl<T>(__VA_ARGS__); } \
    if (dtype == 1) { using T = bf16; return impl<T>(__VA_ARGS__); }  \
    return (int)cudaErrorInvalidValue;                                \
  } while (0)

// Float counts of the caller's scratch buffers, so that the blocking lives
// here alone: the column sums' partials over M rows of N columns, and the
// weight-gradient GEMMs' K-split partials of an M x N gradient.
extern "C" long long rt_train_colsum_scratch(int M, int N) {
  return (long long)((M + CS_ROWS - 1) / CS_ROWS) * N;
}

extern "C" long long rt_train_split_scratch(int M, int N) {
  return (long long)MAX_SPLITS * M * N;
}

#define F(p) static_cast<const float*>(p)
#define W(p) static_cast<float*>(p)
#define CT(p) static_cast<const T*>(p)
#define TT(p) static_cast<T*>(p)

extern "C" int rt_attention_train_fwd(const void* x, const void* wqkv, const void* bqkv,
                                      const void* wo, const void* bo, const void* g,
                                      const void* beta, const void* mask, void* qkv,
                                      void* ctx, void* z32, void* y, int B, int S, int H,
                                      int nh, float scale, float eps, const RtDropout* d,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(attention_fwd_impl, CT(x), CT(wqkv), F(bqkv), CT(wo), F(bo), F(g), F(beta),
              F(mask), TT(qkv), TT(ctx), W(z32), TT(y), B, S, H, nh, scale, eps, *d, st);
}

extern "C" int rt_attention_train_bwd(
    const void* x, const void* dy, const void* wqkv, const void* bqkv, const void* wo,
    const void* bo, const void* g, const void* mask, void* qkv, void* ctx, void* z32,
    void* dz, void* dnorm, void* dattn, void* dctx, void* dqkv, void* part, void* wsplit,
    void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo, void* dg, void* dbeta, int B,
    int S, int H, int nh, float scale, float eps, const RtDropout* d,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(attention_bwd_impl, CT(x), CT(dy), CT(wqkv), F(bqkv), CT(wo), F(bo), F(g),
              F(mask), TT(qkv), TT(ctx), W(z32), W(dz), W(dnorm), TT(dattn), TT(dctx),
              TT(dqkv), W(part), W(wsplit), TT(dx), W(dwqkv), W(dbqkv), W(dwo), W(dbo),
              W(dg), W(dbeta), B, S, H, nh, scale, eps, *d, st);
}

extern "C" int rt_ffn_train_fwd(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* g,
                                const void* beta, void* inter, void* z32, void* z, void* y,
                                int M, int S, int H, int I, float eps, const RtDropout* d,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(ffn_fwd_impl, CT(x), CT(w1), F(b1), CT(w2), F(b2), F(g), F(beta), TT(inter),
              W(z32), TT(z), TT(y), M, S, H, I, eps, *d, st);
}

extern "C" int rt_ffn_train_bwd(const void* x, const void* z, const void* dy, const void* w1,
                                const void* b1, const void* w2, const void* g, void* dz,
                                void* dnorm, void* dout32, void* dout, void* t1, void* inter,
                                void* dt1, void* part, void* wsplit, void* dx, void* dw1,
                                void* db1, void* dw2, void* db2, void* dg, void* dbeta,
                                int M, int S, int H, int I, float eps,
                                const RtDropout* d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(ffn_bwd_impl, CT(x), CT(z), CT(dy), CT(w1), F(b1), CT(w2), F(g), W(dz),
              W(dnorm), W(dout32), TT(dout), TT(t1), TT(inter), TT(dt1), W(part), W(wsplit),
              TT(dx), W(dw1), W(db1), W(dw2), W(db2), W(dg), W(dbeta), M, S, H, I, eps,
              *d, st);
}
