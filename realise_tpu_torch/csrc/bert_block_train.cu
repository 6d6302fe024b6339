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
// What the design does about it:
//   * the backward-only products (dctx, dt1, dx, and the weight gradients)
//     run in gemm_sm90.cuh: wgmma on TMA-fed shared memory in a persistent
//     warp-specialised block, with their epilogues fused (the residual dz of
//     dx, gelu'). The data gradients (dx = dY.W) read W n-contiguous and the
//     weight gradients (dW = dY^T.X over the B*S rows) read both operands
//     m- and n-contiguous, as wgmma's MN-major operands, so no transpose is
//     ever written to device memory. Operands TMA cannot address (bases not
//     16-byte aligned, row strides not a multiple of 8) take the mma.sync
//     GEMM of bert_block_common.cuh instead, decided from the shape before
//     the launch; float32 takes the CUDA-core GEMM.
//   * every forward product runs on gemm_sm90 with the weights read K-major
//     (linear_product): x.W1^T with bias and gelu on the ping-pong schedule,
//     so one warpgroup's epilogue overlaps the other's products; inter.W2^T
//     into the f32 residual with the output dropout, x.Wqkv^T with its bias
//     and ctx.Wo^T into the f32 residual with the attention output dropout
//     on the schedule measured fastest for their shapes. The backward's
//     replays take the forward's routes with the same operands (the FFN's t1
//     on the W1 product's route, the attention's q/k/v, core and
//     out-projection through attention_products), so the replayed values are
//     the forward's bit for bit.
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
//   * the attention backward core of bf16 at head_dim 64 runs on the tensor
//     cores (attention_bwd_core_tc, below): ~10.5 MFLOP of mma.sync per
//     (example, head), against the f32 CUDA-core loops of
//     attention_bwd_core, which stays for float32 and other head dims.
// Not yet: fusing the LayerNorm and its backward into the GEMM epilogues.

#include "bert_block_common.cuh"
#include "gemm_sm90.cuh"

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

#define RT_TRY(...)            \
  do {                         \
    int e_ = (__VA_ARGS__);    \
    if (e_) return e_;         \
  } while (0)

// K-splits of a weight-gradient GEMM of `tiles` output tiles over K rows,
// on a card that runs `slots` such blocks at once: the count in 1 ..
// MAX_SPLITS (the fewest among equals) whose last wave fills the slots best,
// each split at least 256 rows long.
int choose_splits(long tiles, int K, int slots) {
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= MAX_SPLITS; ++s) {
    if (s > 1 && K / s < 256) break;
    const double fill = wave_fill(tiles * s, slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  return best;
}

// dW (M x N) = A^T . B over K rows: A (K, M) and B (K, N) row-major, both
// read transposed; split along K into `wsplit` partials when that fills the
// card better, summed in order. bf16 takes gemm_sm90 (one persistent
// 128 x 256 block per SM) where TMA can address the operands, else
// gemm_bf16_tc (128 x 128, two blocks per SM); float32 the CUDA-core GEMM.
template <typename T>
int weight_grad(const T* A, const T* B, int M, int N, int K, float* out,
                float* wsplit, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    return launch_gemm<EPI_STORE_F32, true, true>(A, B, M, N, K, M, N,
                                                  epi(nullptr, nullptr, out), st);
  } else {
    const bool sm90 = sm90_gemm_ok(A, B, M, N);
    const int bm = sm90 ? G9_BM : TC_BM, bn = sm90 ? G9Tile<false>::BN : TC_BN;
    const long tiles = (long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    const int splits = choose_splits(tiles, K, sm90 ? sm_count() : 2 * sm_count());
    const EpiArgs e = epi(nullptr, nullptr, splits == 1 ? out : wsplit);
    RT_TRY(sm90 ? launch_gemm_sm90<EPI_STORE_F32, true, false, false>(A, B, M, N, K, M, N, e, st,
                                                                       splits)
                : launch_gemm<EPI_STORE_F32, true, true>(A, B, M, N, K, M, N, e, st, splits));
    if (splits == 1) return 0;
    // The launchers round the split length up to whole k-tiles; count the
    // partials they wrote.
    const int k_chunk = split_chunk(K, splits, sm90 ? G9_BK : TC_BK);
    const int used = (K + k_chunk - 1) / k_chunk;
    const size_t n = (size_t)M * N;
    split_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(wsplit, used, n, out);
    return (int)cudaGetLastError();
  }
}

// A data-gradient product C (M, N) = A . B, A k-contiguous and B
// n-contiguous: gemm_sm90 (cooperative) for bf16 operands TMA can address,
// gemm_bf16_tc for other bf16 operands, the CUDA-core GEMM for float32 (see
// the top).
template <int EPI>
int data_grad(const bf16* A, const bf16* B, int M, int N, int K, int lda, int ldb, EpiArgs e,
              cudaStream_t st) {
  if (sm90_gemm_ok(A, B, lda, ldb))
    return launch_gemm_sm90<EPI, false, false, false>(A, B, M, N, K, lda, ldb, e, st);
  return launch_gemm<EPI, false, true>(A, B, M, N, K, lda, ldb, e, st);
}

template <int EPI>
int data_grad(const float* A, const float* B, int M, int N, int K, int lda, int ldb, EpiArgs e,
              cudaStream_t st) {
  return launch_gemm<EPI, false, true>(A, B, M, N, K, lda, ldb, e, st);
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
// float32, and bf16 at head dims other than 64, on the CUDA cores. One block
// per (example, head), 8 warps, S <= 128 and head_dim D <= 64.
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

// ------------------------------- attention backward core, tensor cores
// bf16, head_dim 64, S <= 128: one block per (example, head), 8 warps. Q, K,
// V and dctx of the head are staged once as bf16 rows padded by 8 elements
// (TA_LDK, conflict-free fragment loads), keys padded to a multiple of 16
// (zero rows, bias -inf). Every product is mma.sync m16n8k16 with f32
// accumulation on operands that are already bf16: K, V, Q and dctx are bf16
// tensors, Pd and dS are rounded before use.
// Phase A, a warp per 16 query rows:
//   * the scores Q.K^T, their scale, bias and softmax in the k-order and
//     the operations of attention_core_tc, so the replayed probabilities p
//     are the forward's bit for bit;
//   * dP = dctx.V^T; with the mask m replayed at the fragment's (i, j),
//     Pd = round(p * m) and dp = dP * m; the row sum sum_j dp * p over the
//     quad; dS = round((p * (dp - sum)) * scale);
//   * dQ = dS.K with dS the A operand straight from registers;
//   * Pd and dS to shared memory, rows i >= S as zeros (they write nothing
//     and add nothing to dK and dV).
// Phase B, after a block barrier, a warp per 16 key rows: dK = dS^T.Q and
// dV = Pd^T.dctx, the A fragments read transposed with ldmatrix.trans.
// The block is persistent (one per SM) and walks over the (example, head)
// pairs; while it works on one, cp.async stages the next one's Q, K, V,
// dctx and mask bias into the other of two buffers, so the loads hide behind
// the products. Shared memory at S = 128: 2 x 72.5 KB of staging, 68 KB of
// Pd and dS.
constexpr int ABT_WARPS = 8;

// bf16 elements of one staging buffer: Q, K, V and dctx (s_pad x TA_LDK
// each) and the s_pad floats of mask bias.
__host__ __device__ constexpr int abt_stage_elems(int s_pad) {
  return 4 * s_pad * TA_LDK + 2 * s_pad;
}

__host__ __device__ constexpr size_t abt_smem_bytes(int S) {
  return 2 * (2 * (size_t)abt_stage_elems(ta_pad(S)) +
              2 * (size_t)ta_pad(S) * (ta_pad(S) + 8));
}

template <bool DROP>
__global__ void __launch_bounds__(ABT_WARPS * 32)
attention_bwd_core_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                      const float* __restrict__ mask_bias, bf16* __restrict__ dqkv, int S,
                      int H, int nh, int units, float scale, Drop drop) {
  extern __shared__ __align__(16) unsigned char abt_smem[];
  const int s_pad = ta_pad(S), ldp = s_pad + 8, tile = s_pad * TA_LDK;
  const int stage_elems = abt_stage_elems(s_pad);
  uint16_t* staging = reinterpret_cast<uint16_t*>(abt_smem);  // two buffers
  uint16_t* Ps = staging + 2 * stage_elems;                    // Pd, s_pad x ldp
  uint16_t* Ds = Ps + s_pad * ldp;                             // dS, s_pad x ldp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t ld = 3 * (size_t)H;
  const uint16_t* qkv16 = reinterpret_cast<const uint16_t*>(qkv);
  const uint16_t* dctx16 = reinterpret_cast<const uint16_t*>(dctx);

  // Stage pair u (example u / nh, head u % nh) into buffer `buf`: rows
  // j >= S read as zeros, and their bias is -inf in both buffers (set once).
  auto stage = [&](int u, int buf) {
    const int b = u / nh, h = u % nh;
    uint16_t* Q = staging + buf * stage_elems;
    const uint16_t* rows = qkv16 + (size_t)b * S * ld + h * TA_D;
    const uint16_t* crows = dctx16 + (size_t)b * S * H + h * TA_D;
    for (int idx = tid; idx < s_pad * 8; idx += blockDim.x) {
      const int j = idx >> 3, c = (idx & 7) * 8, o = j * TA_LDK + c;
      const int n = j < S ? 16 : 0, jj = j < S ? j : 0;
      const uint16_t* row = rows + jj * ld + c;
      cp_async16(Q + o, row, n);
      cp_async16(Q + tile + o, row + H, n);
      cp_async16(Q + 2 * tile + o, row + 2 * H, n);
      cp_async16(Q + 3 * tile + o, crows + (size_t)jj * H + c, n);
    }
    float* bias = reinterpret_cast<float*>(Q + 4 * tile);
    for (int j = tid; j < S; j += blockDim.x) cp_async4(bias + j, mask_bias + (size_t)b * S + j);
    cp_async_commit();
  };
  for (int j = S + tid; j < s_pad; j += blockDim.x)
#pragma unroll
    for (int buf = 0; buf < 2; ++buf)
      reinterpret_cast<float*>(staging + buf * stage_elems + 4 * tile)[j] = -INFINITY;
  stage(blockIdx.x, 0);

  int buf = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    // Pair u is staged, and every warp is done with the other buffer and with
    // Pd and dS: prefetch the block's next pair there.
    __syncthreads();
    if (u + (int)gridDim.x < units) stage(u + gridDim.x, buf ^ 1);
    const uint16_t* Qs = staging + buf * stage_elems;
    const uint16_t* Ks = Qs + tile;
    const uint16_t* Vs = Ks + tile;
    const uint16_t* Cs = Vs + tile;                                 // dctx
    const float* Bs = reinterpret_cast<const float*>(Cs + tile);    // mask bias
    const int b = u / nh, h = u % nh;
    bf16* gbase = dqkv + (size_t)b * S * ld + h * TA_D;

    const int n_tiles = s_pad / 8;  // <= 16 key tiles of 8
    // ldmatrix.trans row addresses of a B operand stored [k][n] (n-contiguous)
    // and of an A operand stored [k][m] (m-contiguous), as in gemm_bf16_tc.
    const int bt_k = (lane & 7) + 8 * ((lane >> 3) & 1), bt_n = 8 * (lane >> 4);
    const int at_k = (lane & 7) + 8 * (lane >> 4), at_m = 8 * ((lane >> 3) & 1);

    const int r0 = warp * 16;
    if (r0 < s_pad) {  // Phase A: query rows r0 .. r0 + 15
      float sc[16][4], dp[16][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TA_D; kk += 16) {
        uint32_t a[4], ac[4];
        const uint16_t* p0 = Qs + (r0 + g) * TA_LDK + kk + t4 * 2;
        const uint16_t* p1 = p0 + 8 * TA_LDK;
        a[0] = *reinterpret_cast<const uint32_t*>(p0);
        a[1] = *reinterpret_cast<const uint32_t*>(p1);
        a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        const uint16_t* c0 = Cs + (r0 + g) * TA_LDK + kk + t4 * 2;
        const uint16_t* c1 = c0 + 8 * TA_LDK;
        ac[0] = *reinterpret_cast<const uint32_t*>(c0);
        ac[1] = *reinterpret_cast<const uint32_t*>(c1);
        ac[2] = *reinterpret_cast<const uint32_t*>(c0 + 8);
        ac[3] = *reinterpret_cast<const uint32_t*>(c1 + 8);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          if (nt < n_tiles) {
            const uint16_t* kq = Ks + (nt * 8 + g) * TA_LDK + kk + t4 * 2;
            const uint16_t* vq = Vs + (nt * 8 + g) * TA_LDK + kk + t4 * 2;
            uint32_t bk[2], bv[2];
            bk[0] = *reinterpret_cast<const uint32_t*>(kq);
            bk[1] = *reinterpret_cast<const uint32_t*>(kq + 8);
            bv[0] = *reinterpret_cast<const uint32_t*>(vq);
            bv[1] = *reinterpret_cast<const uint32_t*>(vq + 8);
            mma_bf16_16816(sc[nt], a, bk);
            mma_bf16_16816(dp[nt], ac, bv);
          }
        }
      }

      // The softmax of attention_core_tc: rows g (c0, c1) and g + 8 (c2, c3),
      // a row's columns spread over the 4 threads of a quad.
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

      // p, the mask, Pd, dp and the row sums sum_j dp * p.
      const int i0 = r0 + g, i1 = i0 + 8;
      const uint32_t dbase = DROP ? site_base(drop.seed, SITE_PROBS, (uint32_t)b, (uint32_t)h) : 0u;
      uint32_t pd[16][2], ds[16][2];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt < n_tiles) {
          float q0[2], q1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[nt][e] = sc[nt][e] / sum0;
            sc[nt][2 + e] = sc[nt][2 + e] / sum1;
            q0[e] = sc[nt][e];
            q1[e] = sc[nt][2 + e];
            if (DROP) {
              const int j = nt * 8 + t4 * 2 + e;
              const float m0 = keep_mult(drop, dbase, i0, j, S);
              const float m1 = keep_mult(drop, dbase, i1, j, S);
              q0[e] *= m0;
              q1[e] *= m1;
              dp[nt][e] *= m0;
              dp[nt][2 + e] *= m1;
            }
            rs0 += dp[nt][e] * sc[nt][e];
            rs1 += dp[nt][2 + e] * sc[nt][2 + e];
          }
          pd[nt][0] = pack_bf16x2(q0[0], q0[1]);
          pd[nt][1] = pack_bf16x2(q1[0], q1[1]);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt < n_tiles) {
          ds[nt][0] = pack_bf16x2((sc[nt][0] * (dp[nt][0] - rs0)) * scale,
                                  (sc[nt][1] * (dp[nt][1] - rs0)) * scale);
          ds[nt][1] = pack_bf16x2((sc[nt][2] * (dp[nt][2] - rs1)) * scale,
                                  (sc[nt][3] * (dp[nt][3] - rs1)) * scale);
          if (i0 >= S) pd[nt][0] = ds[nt][0] = 0u;
          if (i1 >= S) pd[nt][1] = ds[nt][1] = 0u;
        }
      }

      // dQ = dS . K: the dS fragments are the A operand of 16 keys at a time.
      float dq[8][4];
#pragma unroll
      for (int dn = 0; dn < 8; ++dn)
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[dn][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        if (kc < n_tiles / 2) {
          const uint32_t a[4] = {ds[2 * kc][0], ds[2 * kc][1], ds[2 * kc + 1][0],
                                 ds[2 * kc + 1][1]};
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, Ks + (kc * 16 + bt_k) * TA_LDK + bt_n + np * 16);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16_16816(dq[2 * np], a, b0);
            mma_bf16_16816(dq[2 * np + 1], a, b1);
          }
        }
      }
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = dn * 8 + t4 * 2;
        if (i0 < S)
          *reinterpret_cast<uint32_t*>(gbase + (size_t)i0 * ld + col) =
              pack_bf16x2(dq[dn][0], dq[dn][1]);
        if (i1 < S)
          *reinterpret_cast<uint32_t*>(gbase + (size_t)i1 * ld + col) =
              pack_bf16x2(dq[dn][2], dq[dn][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if (nt < n_tiles) {
          const int c = nt * 8 + t4 * 2;
          *reinterpret_cast<uint32_t*>(Ps + i0 * ldp + c) = pd[nt][0];
          *reinterpret_cast<uint32_t*>(Ps + i1 * ldp + c) = pd[nt][1];
          *reinterpret_cast<uint32_t*>(Ds + i0 * ldp + c) = ds[nt][0];
          *reinterpret_cast<uint32_t*>(Ds + i1 * ldp + c) = ds[nt][1];
        }
      }
    }
    __syncthreads();

    const int j0 = warp * 16;
    if (j0 < S) {  // Phase B: key rows j0 .. j0 + 15
      float dk[8][4], dv[8][4];
#pragma unroll
      for (int dn = 0; dn < 8; ++dn)
#pragma unroll
        for (int c = 0; c < 4; ++c) dk[dn][c] = dv[dn][c] = 0.f;
      for (int kc = 0; kc < n_tiles / 2; ++kc) {  // 16 queries at a time
        uint32_t ads[4], apd[4];
        ldmatrix_x4_trans(ads, Ds + (kc * 16 + at_k) * ldp + j0 + at_m);
        ldmatrix_x4_trans(apd, Ps + (kc * 16 + at_k) * ldp + j0 + at_m);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t rq[4], rc[4];
          ldmatrix_x4_trans(rq, Qs + (kc * 16 + bt_k) * TA_LDK + bt_n + np * 16);
          ldmatrix_x4_trans(rc, Cs + (kc * 16 + bt_k) * TA_LDK + bt_n + np * 16);
          const uint32_t q0[2] = {rq[0], rq[1]}, q1[2] = {rq[2], rq[3]};
          const uint32_t c0[2] = {rc[0], rc[1]}, c1[2] = {rc[2], rc[3]};
          mma_bf16_16816(dk[2 * np], ads, q0);
          mma_bf16_16816(dk[2 * np + 1], ads, q1);
          mma_bf16_16816(dv[2 * np], apd, c0);
          mma_bf16_16816(dv[2 * np + 1], apd, c1);
        }
      }
      const int j = j0 + g, j1 = j + 8;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = dn * 8 + t4 * 2;
        if (j < S) {
          bf16* out = gbase + (size_t)j * ld + col;
          *reinterpret_cast<uint32_t*>(out + H) = pack_bf16x2(dk[dn][0], dk[dn][1]);
          *reinterpret_cast<uint32_t*>(out + 2 * H) = pack_bf16x2(dv[dn][0], dv[dn][1]);
        }
        if (j1 < S) {
          bf16* out = gbase + (size_t)j1 * ld + col;
          *reinterpret_cast<uint32_t*>(out + H) = pack_bf16x2(dk[dn][2], dk[dn][3]);
          *reinterpret_cast<uint32_t*>(out + 2 * H) = pack_bf16x2(dv[dn][2], dv[dn][3]);
        }
      }
    }
  }
}

template <bool DROP>
int attention_bwd_tc_launch(const bf16* qkv, const bf16* dctx, const float* mask, bf16* dqkv,
                            int B, int S, int H, int nh, float scale, Drop drop,
                            cudaStream_t st) {
  const size_t smem = abt_smem_bytes(S);
  int err = (int)cudaFuncSetAttribute(attention_bwd_core_tc<DROP>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int units = B * nh, blocks = units < sm_count() ? units : sm_count();
  attention_bwd_core_tc<DROP><<<blocks, ABT_WARPS * 32, smem, st>>>(qkv, dctx, mask, dqkv, S, H,
                                                                   nh, units, scale, drop);
  return (int)cudaGetLastError();
}

// dq | dk | dv of every (example, head): the tensor cores for bf16 at
// head_dim 64, the CUDA-core version otherwise.
template <typename T>
int attention_bwd_launch(const T* qkv, const T* dctx, const float* mask, T* dqkv, int B,
                         int S, int H, int nh, float scale, Drop drop, cudaStream_t st) {
  const int D = H / nh;
  if constexpr (sizeof(T) == 2) {
    if (D == TA_D)
      return drop.on ? attention_bwd_tc_launch<true>(qkv, dctx, mask, dqkv, B, S, H, nh, scale,
                                                     drop, st)
                     : attention_bwd_tc_launch<false>(qkv, dctx, mask, dqkv, B, S, H, nh,
                                                      scale, drop, st);
  }
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
bool attention_shape_ok(int S, int H, int nh) {
  return nh > 0 && S > 0 && S <= AT_MAX_S && H % nh == 0 && H / nh <= AT_MAX_D;
}

// The attention forward up to the pre-LN sum z32: q/k/v = x.Wqkv^T + bqkv,
// the core with the probability dropout, z32 = x + drop(ctx.Wo^T + bo). The
// forward and the backward's recompute both run this, so the replayed
// q/k/v, ctx and z32 are the forward's bit for bit.
template <typename T>
int attention_products(const T* x, const T* wqkv, const float* bqkv, const T* wo,
                       const float* bo, const float* mask, T* qkv, T* ctx, float* z32, int B,
                       int S, int H, int nh, float scale, const RtDropout& d, cudaStream_t st) {
  const int M = B * S;
  RT_TRY(linear_product<EPI_BIAS>(x, wqkv, M, 3 * H, H, epi(bqkv, nullptr, qkv), st));
  RT_TRY(attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, probs_drop(d), st));
  return linear_product<EPI_RESID_ROUND_DROP>(
      ctx, wo, M, H, H, epi(bo, x, z32, nullptr, hidden_drop(d, SITE_ATTN_OUT), S), st);
}

template <typename T>
int attention_fwd_impl(const T* x, const T* wqkv, const float* bqkv, const T* wo,
                       const float* bo, const float* g, const float* beta,
                       const float* mask, T* qkv, T* ctx, float* z32, T* y, int B, int S,
                       int H, int nh, float scale, float eps, const RtDropout& d,
                       cudaStream_t st) {
  if (!attention_shape_ok(S, H, nh)) return (int)cudaErrorInvalidValue;
  RT_TRY(attention_products<T>(x, wqkv, bqkv, wo, bo, mask, qkv, ctx, z32, B, S, H, nh, scale,
                               d, st));
  return layer_norm<T>(z32, g, beta, y, B * S, H, eps, st);
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
  RT_TRY(attention_products<T>(x, wqkv, bqkv, wo, bo, mask, qkv, ctx, z32, B, S, H, nh, scale,
                               d, st));
  // LayerNorm backward, the output-dropout replay, dgamma/dbeta/dbo.
  RT_TRY(ln_bwd<T, float>(z32, dy, g, M, H, eps, dh, S, dz, dnorm, dattn, nullptr, st));
  RT_TRY(colsum<float>(dnorm, M, H, part, dg, st));
  RT_TRY(colsum<T>(dy, M, H, part, dbeta, st));
  RT_TRY(colsum<T>(dattn, M, H, part, dbo, st));
  // dctx = dattn . Wo, then the attention core's backward.
  RT_TRY(data_grad<EPI_ROUND>(dattn, wo, M, H, H, H, H, epi(nullptr, nullptr, dctx), st));
  RT_TRY(attention_bwd_launch<T>(qkv, dctx, mask, dqkv, B, S, H, nh, scale, probs_drop(d),
                                 st));
  RT_TRY(colsum<T>(dqkv, M, 3 * H, part, dbqkv, st));
  // Weight gradients over the B*S rows, then dx = dz + dqkv . Wqkv.
  RT_TRY(weight_grad<T>(dqkv, x, 3 * H, H, M, dwqkv, wsplit, st));
  RT_TRY(weight_grad<T>(dattn, ctx, H, H, M, dwo, wsplit, st));
  return data_grad<EPI_ADD_F32_ROUND>(dqkv, wqkv, M, H, 3 * H, 3 * H, H, epi(nullptr, dz, dx),
                                      st);
}

template <typename T>
int ffn_fwd_impl(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
                 const float* g, const float* beta, T* inter, float* z32, T* z, T* y, int M,
                 int S, int H, int I, float eps, const RtDropout& d, cudaStream_t st) {
  RT_TRY(linear_product<EPI_BIAS_GELU>(x, w1, M, I, H, epi(b1, nullptr, inter), st));
  RT_TRY(linear_product<EPI_RESID_F32_DROP>(
      inter, w2, M, H, I, epi(b2, x, z32, nullptr, hidden_drop(d, SITE_FFN_OUT), S), st));
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
  // t1 = round(x . W1) + b1 and gelu(t1) replayed on the forward's route;
  // dW2 = dout^T . gelu(t1).
  RT_TRY(linear_product<EPI_BIAS_T1_GELU>(x, w1, M, I, H, epi(b1, nullptr, t1, inter), st));
  RT_TRY(weight_grad<T>(dout, inter, H, I, M, dw2, wsplit, st));
  // dt1 = (dout . W2) * gelu'(t1); db1, dW1 = dt1^T . x; dx = dz + dt1 . W1.
  RT_TRY(data_grad<EPI_GELU_GRAD>(dout, w2, M, I, H, H, I, epi(nullptr, t1, dt1), st));
  RT_TRY(colsum<T>(dt1, M, I, part, db1, st));
  RT_TRY(weight_grad<T>(dt1, x, I, H, M, dw1, wsplit, st));
  return data_grad<EPI_ADD_F32_ROUND>(dt1, w1, M, H, I, I, H, epi(nullptr, dz, dx), st);
}

// One forward product of the attention and FFN blocks alone, for tests and
// timing, on the route the blocks take (linear_product): A (M, K) times a
// torch weight W (N, K), with the epilogue `mode`: EPI_BIAS (out T = t =
// round(A.W^T) + b, the q/k/v), EPI_BIAS_GELU (out T = gelu(t)),
// EPI_RESID_ROUND (out f32 = resid + t, the serving out-projection),
// EPI_RESID_ROUND_DROP (out f32 = resid + round(t * keep), the training
// out-projection), EPI_RESID_F32 (out f32 = (resid + b) + A.W^T),
// EPI_RESID_F32_DROP (out f32 = resid + (A.W^T + b) * keep) or
// EPI_BIAS_T1_GELU (out T = t, out2 T = gelu(t)); keep is the hidden dropout
// site `site` over examples of S rows.
template <typename T>
int forward_gemm_impl(const T* a, const T* w, const float* bias, const T* resid, void* out,
                      void* out2, int M, int N, int K, int S, int mode, int site,
                      const RtDropout& d, cudaStream_t st) {
  const EpiArgs e = epi(bias, resid, out, out2, hidden_drop(d, (uint32_t)site), S);
  switch (mode) {
    case EPI_BIAS: return linear_product<EPI_BIAS>(a, w, M, N, K, e, st);
    case EPI_RESID_ROUND: return linear_product<EPI_RESID_ROUND>(a, w, M, N, K, e, st);
    case EPI_RESID_ROUND_DROP: return linear_product<EPI_RESID_ROUND_DROP>(a, w, M, N, K, e, st);
    case EPI_BIAS_GELU: return linear_product<EPI_BIAS_GELU>(a, w, M, N, K, e, st);
    case EPI_RESID_F32: return linear_product<EPI_RESID_F32>(a, w, M, N, K, e, st);
    case EPI_RESID_F32_DROP: return linear_product<EPI_RESID_F32_DROP>(a, w, M, N, K, e, st);
    case EPI_BIAS_T1_GELU: return linear_product<EPI_BIAS_T1_GELU>(a, w, M, N, K, e, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// One backward product alone, bf16, for tests and timing, on the route
// the backward takes: a_t = 0, out (bf16, M x N) = round(A . B) for A (M, K)
// and B (K, N) row-major, as dctx, dt1 and dx; a_t = 1, out (f32, M x N) =
// A^T . B over K rows for A (K, M) and B (K, N), as a weight gradient, with
// its split-K partials in wsplit (rt_train_split_scratch(M, N) floats).
extern "C" int rt_train_gemm(const void* a, const void* b, void* out, void* wsplit, int M,
                             int N, int K, int a_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  if (a_t)
    return weight_grad<bf16>(A, B, M, N, K, static_cast<float*>(out),
                             static_cast<float*>(wsplit), st);
  return data_grad<EPI_ROUND>(A, B, M, N, K, K, N, epi(nullptr, nullptr, out), st);
}

extern "C" int rt_forward_gemm(const void* a, const void* w, const void* bias, const void* resid,
                               void* out, void* out2, int M, int N, int K, int S, int mode,
                               int site, const RtDropout* d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(forward_gemm_impl, static_cast<const T*>(a), static_cast<const T*>(w),
              static_cast<const float*>(bias), static_cast<const T*>(resid), out, out2, M, N, K,
              S, mode, site, *d, st);
}

// The attention core alone, for tests and timing, on the launcher the blocks
// use: ctx (B*S, H) = drop_p(softmax(q.k^T * scale + mask)) . v per head of
// the (B*S, 3H) q/k/v, the probabilities' dropout from d.
template <typename T>
int attention_core_impl(const T* qkv, const float* mask, T* ctx, int B, int S, int H, int nh,
                        float scale, const RtDropout& d, cudaStream_t st) {
  if (!attention_shape_ok(S, H, nh)) return (int)cudaErrorInvalidValue;
  return attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, probs_drop(d), st);
}

extern "C" int rt_attention_core(const void* qkv, const void* mask, void* ctx, int B, int S,
                                 int H, int nh, float scale, const RtDropout* d, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(attention_core_impl, static_cast<const T*>(qkv), static_cast<const float*>(mask),
              static_cast<T*>(ctx), B, S, H, nh, scale, *d, st);
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
