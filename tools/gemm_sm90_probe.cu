// One weight product of realise_tpu_torch's kernels on a chosen GEMM, for
// tools/gemm_sm90_probe.py: the same launchers the blocks use, with the
// route fixed by the caller instead of by linear_product.
#include "../realise_tpu_torch/csrc/bert_block_common.cuh"
#include "../realise_tpu_torch/csrc/gemm_sm90.cuh"

namespace {

// gemm: 0 = gemm_bf16_tc (mma.sync), 1 = gemm_sm90 cooperative 128 x 256,
// 2 = gemm_sm90 ping-pong 128 x 128; weights K-major (torch's (out, in)).
template <int EPI>
int run(int gemm, const bf16* x, const bf16* w, int M, int N, int K, EpiArgs e,
        cudaStream_t st) {
  if (gemm == 1) return launch_gemm_sm90<EPI, false, true, false>(x, w, M, N, K, K, K, e, st);
  if (gemm == 2) return launch_gemm_sm90<EPI, false, true, true>(x, w, M, N, K, K, K, e, st);
  return launch_gemm<EPI>(x, w, M, N, K, K, K, e, st);
}

}  // namespace

// mode: EPI_BIAS (0), EPI_BIAS_GELU (1), EPI_RESID_ROUND (2), EPI_RESID_F32
// (3), EPI_RESID_ROUND_DROP (4, the attention output site) or
// EPI_RESID_F32_DROP (5, the FFN output site); the dropout keeps 0.9 over
// examples of S rows. Returns 0 or the CUDA error.
extern "C" int probe_gemm(int gemm, int mode, const void* x, const void* w, const void* bias,
                          const void* resid, void* out, int M, int N, int K, int S,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* W = static_cast<const bf16*>(w);
  const uint32_t site = mode == EPI_RESID_ROUND_DROP ? SITE_ATTN_OUT : SITE_FFN_OUT;
  const Drop drop{7u, site, 58982u, 15099494u, 1.0f / 0.9f, 1};
  const EpiArgs e = epi(static_cast<const float*>(bias), resid, out, nullptr, drop, S);
  if (mode == EPI_BIAS) return run<EPI_BIAS>(gemm, X, W, M, N, K, e, st);
  if (mode == EPI_RESID_ROUND) return run<EPI_RESID_ROUND>(gemm, X, W, M, N, K, e, st);
  if (mode == EPI_RESID_ROUND_DROP) return run<EPI_RESID_ROUND_DROP>(gemm, X, W, M, N, K, e, st);
  if (mode == EPI_BIAS_GELU) return run<EPI_BIAS_GELU>(gemm, X, W, M, N, K, e, st);
  if (mode == EPI_RESID_F32) return run<EPI_RESID_F32>(gemm, X, W, M, N, K, e, st);
  if (mode == EPI_RESID_F32_DROP) return run<EPI_RESID_F32_DROP>(gemm, X, W, M, N, K, e, st);
  return (int)cudaErrorInvalidValue;
}
