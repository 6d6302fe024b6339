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
// What the design does about it:
//   * every bf16 weight product runs on gemm_sm90.cuh's wgmma + TMA GEMM,
//     reading the weights K-major as torch stores them (linear_product,
//     shared with the training kernels): x.W1^T with bias and gelu on the
//     ping-pong schedule, where one warpgroup's gelu epilogue overlaps the
//     other's products; inter.W2^T into the f32 residual, x.Wqkv^T with its
//     bias (16-byte stores) and ctx.Wo^T into the f32 residual on the schedule
//     that tools/gemm_sm90_probe.py measured fastest for their shapes.
//     Operands TMA cannot address take the mma.sync GEMM (gemm_bf16_tc,
//     128x128x32 tiles, a 3-stage cp.async ring, ldmatrix); f32 products a
//     64x64 CUDA-core FMA tile (no TF32), so float32 stays float32. The
//     GEMMs, the attention cores and the LayerNorm rows live in
//     bert_block_common.cuh and gemm_sm90.cuh, shared with the training
//     kernels.
//   * every epilogue is fused into its GEMM (bias, gelu, residual), so the
//     q/k/v, the FFN intermediate and the pre-LN sum each cross device
//     memory once; the pre-LN sum is f32 and a row kernel (one warp per row)
//     finishes the LayerNorm over the whole H-wide row.
//   * the attention core reads q/k/v in their natural (B, S, 3H) layout (a
//     head is a 64-column window, no transpose in device memory). In bf16 at
//     head_dim 64 it runs on the tensor cores in persistent blocks that walk
//     over the (example, head) pairs: 8 warps cover all S <= 128 query rows,
//     so K and V are staged once per pair, and cp.async stages the next pair
//     while the warps work on this one; the softmax stays in registers and
//     the rounded probabilities feed P.V straight from the score fragments.
//     Otherwise (f32, other head dims) one warp per query row on the CUDA
//     cores, K and V of the head in shared memory as f32 (64 KB at S = 128:
//     dynamic shared memory).
// Not yet: the LayerNorm fused into the residual epilogues.

#include "bert_block_common.cuh"
#include "gemm_sm90.cuh"

namespace {

template <typename T>
int attention_impl(const T* x, const T* wqkv, const float* bqkv, const T* wo,
                   const float* bo, const float* ln_g, const float* ln_b,
                   const float* mask, T* qkv, T* ctx, float* z, T* y, int B, int S,
                   int H, int nh, float scale, float eps, cudaStream_t st) {
  const int M = B * S, D = H / nh;
  if (S > AT_MAX_S || D > AT_MAX_D || D * nh != H) return (int)cudaErrorInvalidValue;
  int err = linear_product<EPI_BIAS>(x, wqkv, M, 3 * H, H, epi(bqkv, nullptr, qkv), st);
  if (err) return err;
  err = attention_core_launch<T>(qkv, mask, ctx, B, S, H, nh, scale, Drop{}, st);
  if (err) return err;
  err = linear_product<EPI_RESID_ROUND>(ctx, wo, M, H, H, epi(bo, x, z), st);
  if (err) return err;
  return layer_norm<T>(z, ln_g, ln_b, y, M, H, eps, st);
}

template <typename T>
int ffn_impl(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
             const float* ln_g, const float* ln_b, T* inter, float* z, T* y, int M,
             int H, int I, float eps, cudaStream_t st) {
  int err = linear_product<EPI_BIAS_GELU>(x, w1, M, I, H, epi(b1, nullptr, inter), st);
  if (err) return err;
  err = linear_product<EPI_RESID_F32>(inter, w2, M, H, I, epi(b2, x, z), st);
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
