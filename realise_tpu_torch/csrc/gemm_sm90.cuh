// Hopper GEMM (sm_90a): TMA loads into a 128-byte-swizzled shared-memory
// ring, wgmma on the tensor cores, accumulators in registers. It runs every
// bf16 weight product of the attention and FFN sub-blocks, serving and
// training, forward, backward and the backward's replays.
//
// C (M, N) = sum_k A(m, k) B(k, n) in the layouts those products need:
//   * A k-contiguous ("A[m * lda + k]", K-major, trans-a = 0), or A_T, A
//     m-contiguous ("A[k * lda + m]", MN-major, trans-a = 1): a weight
//     gradient dW = dY^T . X over the B*S rows, split along K into float32
//     partials (EPI_STORE_F32 at out + z * M * N) that the caller sums in a
//     fixed order. No atomics: two runs give the same bits.
//   * B n-contiguous ("B[k * ldb + n]", MN-major, trans-b = 1): dY . W, the
//     data gradients dctx, dt1 and dx; or B_K, B k-contiguous ("B[n * ldb +
//     k]", K-major, trans-b = 0): X . W^T for torch's (out, in) weight, the
//     forward products x.Wqkv^T, ctx.Wo^T, x.W1^T and inter.W2^T and the
//     backward's replays of them (linear_product, below).
// The epilogue is bert_block_common.cuh's epi_store2, fed from the
// accumulator fragment (each thread holds column pairs of rows g and g + 8
// of its warp's 16), so the rounding points are those of gemm_bf16_tc; the
// bf16 outputs of the bias epilogues (q/k/v, gelu) are computed the same way
// (epi_words) but leave through a transpose within each quad as 16-byte
// stores that fill whole 32-byte sectors (a pair store fills half of one:
// on an H100 the FFN's x.W1^T with gelu at B*S = 32768 took 0.535 ms with
// pair stores, 0.406 ms with these). The f32 residual epilogues (z = x +
// ..., EPI_RESID_*) take the same transpose: a thread reads 8 bf16
// residuals in one 16-byte load and writes 8 f32 sums in two, the chunk's
// loads all before its first store, each row's dropout stream found once per
// chunk (ctx.Wo^T into the residual at B*S = 32768: 0.172 ms with float2
// stores, 0.110 ms with these, tools/gemm_sm90_probe.py on an H100).
//
// What bounds it: at the training shapes (M = B*S = 32768, H = 768, I =
// 3072) every product does 24-155 GFLOP on a few hundred MB, and at the
// serving shapes (M = 4096) 19 GFLOP on ~30 MB: operations, on the bf16
// tensor cores, which only wgmma drives at their full rate.
//
// Design: one persistent block per SM walks over the output tiles (n
// fastest, then m, then the K split); warpgroup 2 gives its registers up
// (setmaxnreg) and one of its threads keeps the ring full with
// cp.async.bulk.tensor (TMA, 128-byte swizzle, zero fill past the edges),
// a full and an empty mbarrier per stage; warpgroups 0 and 1 consume. Two
// schedules share that ring (192 KB, one block per SM):
//   * cooperative (PP = false): both consumer warpgroups work on one 128 x
//     256 tile, 64 rows each, with wgmma.m64n256k16 (128 f32 accumulators a
//     thread), 4 stages of 128 x 256 x 64 (48 KB for 4.2 MFLOP, 87 FLOP per
//     byte read from L2). Tensor cores idle while the tile's epilogue runs;
//     the long-K products with light epilogues (the weight gradients, dctx,
//     dx) lose little to that, and the K split exists only here.
//   * ping-pong (PP = true): each consumer warpgroup owns a whole 128 x 128
//     tile (two m64n128k16 rows, again 128 accumulators a thread) and the two
//     take the block's tiles in turn, 6 stages of 128 x 128 x 64 (32 KB). An
//     ordered pair of named barriers hands the tensor cores from one
//     warpgroup to the other when its last wgmma of a tile is issued, so one
//     warpgroup's epilogue (an erf per element for gelu, the dropout hash)
//     runs while the other's products do. The producer fills the ring in the
//     order the warpgroups take the tiles. This is the schedule of every
//     forward product over K = 768 (12 k-tiles: q/k/v, the out-projection,
//     x.W1^T and their replays), whose epilogues (bias and 16-byte stores,
//     the f32 residual, gelu's erf, the dropout hash) last about as long as
//     the products, and of any product whose 128 x 256 tiles would leave
//     more of the card idle in their last wave.
// The 64-deep box is the 128-byte swizzle span. N = 768, 2304 and 3072 are
// whole multiples of 128 (and 768 and 3072 of 256), and B*S of 128.
//
// Where it does not apply: TMA needs 16-byte-aligned bases and row strides
// that are multiples of 8 bf16 elements. sm90_gemm_ok decides that from the
// shape before the launch; other shapes take gemm_bf16_tc. Tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, looked up at run time
// through the CUDA runtime, so nothing links against libcuda.
#pragma once

#include <cuda.h>

#include "bert_block_common.cuh"

namespace {

constexpr int G9_BM = 128, G9_BK = 64;
constexpr int G9_THREADS = 3 * 128;                   // 2 consumer warpgroups, 1 producer
constexpr int G9_BOX = 64;                            // 64 bf16 = the 128-byte swizzle span
constexpr int G9_BOX_BYTES = G9_BOX * G9_BK * 2;      // one 64 x 64 box: 8 KB
constexpr int G9_A_BYTES = G9_BM * G9_BK * 2;         // 16 KB
constexpr int G9_RING_BYTES = 192 * 1024;
constexpr int G9_MAX_STAGES = 8;
constexpr int G9_ATOM = 1024;                         // 8 rows of 128 bytes: the swizzle atom
constexpr size_t G9_SMEM = (size_t)G9_RING_BYTES + G9_ATOM + 2 * G9_MAX_STAGES * sizeof(uint64_t);
// A wait longer than this is a broken pipeline: trap, so the launch fails
// with an error instead of holding the card.
constexpr unsigned long long G9_WAIT_NS = 20000000000ull;
// Named barriers 1 and 2 (0 is __syncthreads'): a consumer warpgroup's turn
// on the tensor cores in the ping-pong schedule; both consumer warpgroups
// take part.
constexpr int G9_TURN_BAR = 1, G9_CONSUMER_THREADS = 256;

// The tile of a schedule (see the top of the file).
template <bool PP>
struct G9Tile {
  static constexpr int BN = PP ? 128 : 256;
  static constexpr int STAGE_BYTES = G9_A_BYTES + BN * G9_BK * 2;
  static constexpr int STAGES = G9_RING_BYTES / STAGE_BYTES;
  static constexpr int EMPTY_ARRIVALS = PP ? 4 : 8;  // the warps that read a stage
  static_assert(STAGES <= G9_MAX_STAGES && STAGE_BYTES % G9_ATOM == 0, "ring layout");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > G9_WAIT_NS) __trap();
}

// One 2-D box of `map` at (c0 inner, c1 outer) into shared memory; its bytes
// complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type B128. K-major:
// the stride offset steps 8 rows of 128 bytes (the leading one is unused).
// MN-major: the leading offset steps 64 elements of M or N, the stride
// offset 8 rows of K.
__device__ __forceinline__ uint64_t g9_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across an asynchronous
// wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (the warpgroup's 64 x 256 f32 fragment) += A (64 x 16) . B (16 x 256),
// A MN-major when TA = 1, B MN-major when TB = 1 (else K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[OFF .. OFF + 63] (one warpgroup's 64 x 128 f32 fragment) += A (64 x 16)
// . B (16 x 128), A K-major, B K-major (TB = 0) or MN-major (TB = 1).
template <int TB, int OFF>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// The packed bf16 outputs of columns c, c + 1 of the bias epilogues, with
// epi_store2's arithmetic: (t, unused) for EPI_BIAS, (gelu(t), unused) for
// EPI_BIAS_GELU, (t, gelu(t)) for EPI_BIAS_T1_GELU, t = round(acc) + bias.
template <int EPI>
__device__ __forceinline__ uint2 epi_words(const EpiArgs& e, int c, float a0, float a1) {
  const float2 b = *reinterpret_cast<const float2*>(e.bias + c);
  const float v0 = round_to<bf16>(round_to<bf16>(a0) + round_to<bf16>(b.x));
  const float v1 = round_to<bf16>(round_to<bf16>(a1) + round_to<bf16>(b.y));
  if (EPI == EPI_BIAS) return make_uint2(pack_bf16x2(v0, v1), 0u);
  const uint32_t gelu = pack_bf16x2(v0 * gelu_cdf(v0), v1 * gelu_cdf(v1));
  return EPI == EPI_BIAS_GELU ? make_uint2(gelu, 0u) : make_uint2(pack_bf16x2(v0, v1), gelu);
}

// z of the 8 columns c .. c + 7 of one row for the f32 residual epilogues,
// from their accumulators `a` and bf16 residuals `x`, with epi_store2's
// arithmetic (rd: the row's dropout stream).
template <int EPI>
__device__ __forceinline__ void epi_resid8(const EpiArgs& e, RowDrop rd, int c, int N,
                                           const float (&a)[8], uint4 x, float (&z)[8]) {
  const float4 bl = *reinterpret_cast<const float4*>(e.bias + c);
  const float4 bh = *reinterpret_cast<const float4*>(e.bias + c + 4);
  const float b[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
  const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[i / 2]));
    const float2 k = epi_drops(EPI) && e.drop.on ? keep_mult2(e.drop, rd, c + i, N)
                                                 : make_float2(1.f, 1.f);
    z[i] = resid_out<bf16, EPI>(xv.x, a[i], b[i], k.x);
    z[i + 1] = resid_out<bf16, EPI>(xv.y, a[i + 1], b[i + 1], k.y);
  }
}

// C = A . B (see the top of the file) for the output tiles of units
// blockIdx.x, + gridDim.x, ...; unit u is K split u / (tiles_m * tiles_n),
// k rows [z * k_chunk, min(K, (z + 1) * k_chunk)). PP: one split.
template <int EPI, bool A_T, bool B_K, bool PP>
__global__ void __launch_bounds__(G9_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          int M, int N, int K, int k_chunk, int tiles_m, int tiles_n, int units, EpiArgs e) {
  using Tile = G9Tile<PP>;
  static_assert(!(PP && A_T), "the ping-pong schedule takes a K-major A");
  extern __shared__ __align__(16) unsigned char g9_raw[];
  // The swizzle pattern repeats every 1024 bytes of shared address: align the
  // ring to it.
  unsigned char* smem = g9_raw + ((G9_ATOM - (smem_u32(g9_raw) & (G9_ATOM - 1))) & (G9_ATOM - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + Tile::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Tile::EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int per_split = tiles_m * tiles_n;

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int z = u / per_split, rem = u - z * per_split;
        const int bm = (rem / tiles_n) * G9_BM, bn = (rem % tiles_n) * Tile::BN;
        const int k_end = min(K, (z + 1) * k_chunk);
        for (int k = z * k_chunk; k < k_end; k += G9_BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * Tile::STAGE_BYTES;
          unsigned char* b = a + G9_A_BYTES;
          mbar_expect_tx(&full[stage], Tile::STAGE_BYTES);
          if (A_T) {  // two 64-wide boxes of M, one per 64 rows
            tma_load(a, &map_a, &full[stage], bm, k);
            tma_load(a + G9_BOX_BYTES, &map_a, &full[stage], bm + G9_BOX, k);
          } else {    // 128 rows of 64 k
            tma_load(a, &map_a, &full[stage], k, bm);
          }
          if (B_K) {  // BN rows of 64 k
            tma_load(b, &map_b, &full[stage], k, bn);
          } else {    // 64-wide boxes of N
#pragma unroll
            for (int j = 0; j < Tile::BN / G9_BOX; ++j)
              tma_load(b + j * G9_BOX_BYTES, &map_b, &full[stage], bn + j * G9_BOX, k);
          }
          if (++stage == Tile::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    // This block's tiles are i = 0, 1, ... (unit blockIdx.x + i * gridDim.x);
    // cooperative: both warpgroups take each; ping-pong: warpgroup wg takes
    // i = wg, wg + 2, ..., and tile i begins at ring position i * nk.
    const int tiles = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    // The bias epilogues' bf16 outputs leave 16 bytes a thread (below) where
    // the row stride and the bases allow it.
    constexpr bool WIDE = EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_T1_GELU;
    const bool wide = WIDE && (N & 7) == 0 &&
                      ((reinterpret_cast<uintptr_t>(e.out) |
                        (EPI == EPI_BIAS_T1_GELU ? reinterpret_cast<uintptr_t>(e.out2) : 0)) &
                       15) == 0 &&
                      (reinterpret_cast<uintptr_t>(e.bias) & 7) == 0;
    // So do the f32 residual epilogues' outputs, 32 bytes a thread, reading
    // their bf16 residuals 16 bytes a thread.
    constexpr bool RWIDE = epi_resid(EPI);
    const bool rwide = RWIDE && (N & 7) == 0 &&
                       ((reinterpret_cast<uintptr_t>(e.out) | reinterpret_cast<uintptr_t>(e.resid) |
                         reinterpret_cast<uintptr_t>(e.bias)) &
                        15) == 0;
    float acc[128];
    int pos = 0;  // ring position of the tile's first k-tile
    for (int i = PP ? wg : 0; i < tiles; i += PP ? 2 : 1) {
      const int u = blockIdx.x + i * gridDim.x;
      const int z = u / per_split, rem = u - z * per_split;
      const int bm = (rem / tiles_n) * G9_BM, bn = (rem % tiles_n) * Tile::BN;
      const int k_begin = z * k_chunk, k_end = min(K, k_begin + k_chunk);
      const int nk = (k_end - k_begin + G9_BK - 1) / G9_BK;
      if (PP) pos = i * nk;
      int stage = pos % Tile::STAGES;
      uint32_t phase = (pos / Tile::STAGES) & 1;
      if (!PP) pos += nk;
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;
      // Ping-pong: wait for the other warpgroup to have issued tile i - 1.
      if (PP && i > 0) named_bar_sync(G9_TURN_BAR + wg, G9_CONSUMER_THREADS);
      int prev = -1;  // the stage whose wgmma group is still in flight
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        // Cooperative: this warpgroup's 64 rows of A sit 8 KB in, in both
        // layouts (64 rows x 128 bytes, or one 64-wide box of M).
        const unsigned char* a = smem + stage * Tile::STAGE_BYTES + (PP ? 0 : wg * G9_BOX_BYTES);
        const unsigned char* b = smem + stage * Tile::STAGE_BYTES + G9_A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G9_BK / 16; ++kk) {
          // k16 steps: 32 bytes along a K-major row, two 8-row atoms (2 KB)
          // down an MN-major tile.
          const uint64_t db = B_K ? g9_desc(b + kk * 32, 16, G9_ATOM)
                                  : g9_desc(b + kk * 2 * G9_ATOM, G9_BOX_BYTES, G9_ATOM);
          if constexpr (PP) {  // rows 0-63 and 64-127 of the warpgroup's tile
            wgmma_m64n128k16<B_K ? 0 : 1, 0>(acc, g9_desc(a + kk * 32, 16, G9_ATOM), db);
            wgmma_m64n128k16<B_K ? 0 : 1, 64>(
                acc, g9_desc(a + G9_BOX_BYTES + kk * 32, 16, G9_ATOM), db);
          } else {
            const uint64_t da = A_T ? g9_desc(a + kk * 2 * G9_ATOM, G9_BOX_BYTES, G9_ATOM)
                                    : g9_desc(a + kk * 32, 16, G9_ATOM);
            wgmma_m64n256k16<A_T ? 1 : 0, B_K ? 0 : 1>(acc, da, db);
          }
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous k-tile's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == Tile::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // Ping-pong: the tile's products are all issued; the other warpgroup
      // may issue its next tile's while this one finishes and stores.
      if (PP && i + 1 < tiles) named_bar_arrive(G9_TURN_BAR + (wg ^ 1), G9_CONSUMER_THREADS);
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      EpiArgs eu = e;
      if (EPI == EPI_STORE_F32) eu.out = static_cast<float*>(e.out) + (size_t)z * M * N;
      // The fragment holds, for each 64-row half of the warpgroup's rows and
      // each 8-column group j of the tile, column pair j * 8 + 2 t4 of rows r
      // and r + 8 (acc[4 j] ..; the ping-pong tile's second half from
      // acc[64]). They are stored in 4 chunks of 8 groups. The chunk loop is
      // not unrolled (a fully unrolled gelu' epilogue outgrows the
      // instruction cache); the next chunk's accumulators move to the front
      // instead, so every register index stays a constant.
      constexpr int GROUPS = Tile::BN / 8;  // 8-column groups per 64-row half
      const int r0 = bm + (PP ? 0 : wg * 64) + warp * 16 + g;
#pragma unroll 1
      for (int j0 = 0; j0 < 32; j0 += 8) {
        const int r = r0 + (j0 / GROUPS) * 64, c0 = bn + (j0 % GROUPS) * 8;
        // The chunk's two rows' dropout streams, found once.
        const RowDrop rd0 = epi_row<EPI>(eu, r), rd1 = epi_row<EPI>(eu, r + 8);
        if (WIDE && wide) {
          // Blocks of 4 groups (32 columns): a quad's 4 x 4 words are
          // transposed so that each thread holds 8 consecutive columns of one
          // group, and a warp's 16-byte stores fill whole 32-byte sectors.
          // A block past N takes epi_store2.
#pragma unroll
          for (int q = 0; q < 8; q += 4) {
            const int cb = c0 + q * 8;
            if (cb + 32 <= N) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint2 w[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  w[j] = epi_words<EPI>(eu, cb + j * 8 + t4 * 2, acc[4 * (q + j) + 2 * h],
                                        acc[4 * (q + j) + 2 * h + 1]);
                const size_t idx = (size_t)(r + 8 * h) * N + cb + t4 * 8;
                const uint4 o = quad_transpose(make_uint4(w[0].x, w[1].x, w[2].x, w[3].x), t4);
                if (r + 8 * h < M) *reinterpret_cast<uint4*>(static_cast<bf16*>(eu.out) + idx) = o;
                if (EPI == EPI_BIAS_T1_GELU) {
                  const uint4 o2 =
                      quad_transpose(make_uint4(w[0].y, w[1].y, w[2].y, w[3].y), t4);
                  if (r + 8 * h < M)
                    *reinterpret_cast<uint4*>(static_cast<bf16*>(eu.out2) + idx) = o2;
                }
              }
            } else {
#pragma unroll
              for (int j = q; j < q + 4; ++j) {
                const int c = c0 + j * 8 + t4 * 2;
                epi_store2<EPI>(eu, r, c, M, N, acc[4 * j], acc[4 * j + 1]);
                epi_store2<EPI>(eu, r + 8, c, M, N, acc[4 * j + 2], acc[4 * j + 3]);
              }
            }
          }
        } else if (RWIDE && rwide) {
          // Blocks of 4 groups again: the first and the second words of the
          // quad's column pairs are transposed apart, so that each thread
          // holds 8 consecutive columns of a row; it reads their bf16
          // residuals in one 16-byte load (the chunk's loads all before the
          // first store) and writes them in two. A block past N takes
          // epi_store2.
          uint4 xr[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = r + 8 * h, cb = c0 + q * 32;
              xr[q][h] = row < M && cb + 32 <= N
                             ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(eu.resid) +
                                                               (size_t)row * N + cb + t4 * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int cb = c0 + q * 32;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k0 = 16 * q + 2 * h;  // group 4 q + j at acc[k0 + 4 j], acc[k0 + 4 j + 1]
              const uint4 lo = quad_transpose(
                  make_uint4(__float_as_uint(acc[k0]), __float_as_uint(acc[k0 + 4]),
                             __float_as_uint(acc[k0 + 8]), __float_as_uint(acc[k0 + 12])),
                  t4);
              const uint4 hi = quad_transpose(
                  make_uint4(__float_as_uint(acc[k0 + 1]), __float_as_uint(acc[k0 + 5]),
                             __float_as_uint(acc[k0 + 9]), __float_as_uint(acc[k0 + 13])),
                  t4);
              if (cb + 32 <= N) {
                const float a[8] = {__uint_as_float(lo.x), __uint_as_float(hi.x),
                                    __uint_as_float(lo.y), __uint_as_float(hi.y),
                                    __uint_as_float(lo.z), __uint_as_float(hi.z),
                                    __uint_as_float(lo.w), __uint_as_float(hi.w)};
                float zv[8];
                epi_resid8<EPI>(eu, h ? rd1 : rd0, cb + t4 * 8, N, a, xr[q][h], zv);
                if (r + 8 * h < M) {
                  float4* o = reinterpret_cast<float4*>(static_cast<float*>(eu.out) +
                                                        (size_t)(r + 8 * h) * N + cb + t4 * 8);
                  o[0] = make_float4(zv[0], zv[1], zv[2], zv[3]);
                  o[1] = make_float4(zv[4], zv[5], zv[6], zv[7]);
                }
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  epi_store2<EPI>(eu, r + 8 * h, cb + j * 8 + t4 * 2, M, N, acc[k0 + 4 * j],
                                  acc[k0 + 4 * j + 1]);
              }
            }
          }
        } else {
          // Each chunk first loads every residual it reads, so the loads
          // overlap instead of each waiting behind the last store.
          float2 res[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            res[j][0] = epi_resid2<EPI>(eu, r, c0 + j * 8 + t4 * 2, M, N);
            res[j][1] = epi_resid2<EPI>(eu, r + 8, c0 + j * 8 + t4 * 2, M, N);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + j * 8 + t4 * 2;
            epi_store2<EPI>(eu, r, c, M, N, acc[4 * j], acc[4 * j + 1], res[j][0], rd0);
            epi_store2<EPI>(eu, r + 8, c, M, N, acc[4 * j + 2], acc[4 * j + 3], res[j][1], rd1);
          }
        }
#pragma unroll
        for (int j = 0; j < 96; ++j) acc[j] = acc[j + 32];
      }
    }
  }
}

// ----------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, rows `ld` elements
// apart, read in boxes of 64 x box_outer with the 128-byte swizzle; what lies
// outside reads as zero.
inline int tensor_map(CUtensorMap* map, const bf16* base, int inner, int outer, int ld,
                      int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)G9_BOX, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether operands with these bases and row strides take gemm_sm90.
inline bool sm90_gemm_ok(const void* A, const void* B, int lda, int ldb) {
  return aligned16(A) && aligned16(B) && lda % 8 == 0 && ldb % 8 == 0;
}

// Rows of one K split: an even share of K rounded up to whole k-tiles, so
// that only the last split meets the end of K (where TMA reads zeros).
inline int split_chunk(int K, int splits, int bk) {
  return ((K + splits - 1) / splits + bk - 1) / bk * bk;
}

// C (M, N) = A . B with A's layout per A_T and B's per B_K, on the schedule
// PP (see the top of the file); splits > 1 (EPI_STORE_F32, cooperative only)
// writes that many partials of M x N.
template <int EPI, bool A_T, bool B_K, bool PP>
int launch_gemm_sm90(const bf16* A, const bf16* B, int M, int N, int K, int lda, int ldb,
                     EpiArgs e, cudaStream_t st, int splits = 1) {
  using Tile = G9Tile<PP>;
  if (PP && splits != 1) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = A_T ? tensor_map(&ma, A, M, K, lda, G9_BK) : tensor_map(&ma, A, K, M, lda, G9_BM);
  if (err) return err;
  err = B_K ? tensor_map(&mb, B, K, N, ldb, Tile::BN) : tensor_map(&mb, B, N, K, ldb, G9_BK);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(gemm_sm90<EPI, A_T, B_K, PP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G9_SMEM);
  if (err) return err;
  const int k_chunk = split_chunk(K, splits, G9_BK);
  const int tiles_m = (M + G9_BM - 1) / G9_BM, tiles_n = (N + Tile::BN - 1) / Tile::BN;
  const int units = tiles_m * tiles_n * ((K + k_chunk - 1) / k_chunk);
  const int blocks = units < sm_count() ? units : sm_count();
  gemm_sm90<EPI, A_T, B_K, PP><<<blocks, G9_THREADS, G9_SMEM, st>>>(
      ma, mb, M, N, K, k_chunk, tiles_m, tiles_n, units, e);
  return (int)cudaGetLastError();
}

// The serving and training blocks' products X . W^T for a torch (out, in)
// weight W (N x K): x.Wqkv^T (EPI_BIAS), ctx.Wo^T (EPI_RESID_ROUND,
// EPI_RESID_ROUND_DROP), x.W1^T (EPI_BIAS_GELU), inter.W2^T (EPI_RESID_F32,
// EPI_RESID_F32_DROP) and the FFN backward's t1 replay (EPI_BIAS_T1_GELU).
// One route for all of them, decided from the shape and the pointers before
// the launch: gemm_sm90 with a K-major B where TMA can address the operands,
// else gemm_bf16_tc (tools/gemm_sm90_probe.py: gemm_sm90 is the faster at
// every M from 32 rows up, for every one of these products). The products
// over K <= 1024 (16 k-tiles: q/k/v, the out-projection, x.W1^T and its
// replay), whose epilogues are as long as their products, take the
// ping-pong schedule, which overlaps one warpgroup's epilogue with the
// other's products. The longer ones (inter.W2^T) take the cooperative
// 128 x 256 tile, which reads fewer bytes per product, unless the 128 x 128
// tiles fill the card's waves better (wave_fill). A forward and its replay
// see the same M, N, K and operands, so they take the same route and the
// replayed values are the forward's bit for bit.
inline double wave_fill(long tiles, int slots) {
  return (double)tiles / (double)(((tiles + slots - 1) / slots) * slots);
}

template <int EPI>
int linear_product(const bf16* X, const bf16* W, int M, int N, int K, EpiArgs e,
                   cudaStream_t st) {
  if (!sm90_gemm_ok(X, W, K, K)) return launch_gemm<EPI>(X, W, M, N, K, K, K, e, st);
  const long rows = (M + G9_BM - 1) / G9_BM;
  const long coop = rows * ((N + G9Tile<false>::BN - 1) / G9Tile<false>::BN);
  const long pp = rows * ((N + G9Tile<true>::BN - 1) / G9Tile<true>::BN);
  if (K <= 16 * G9_BK || wave_fill(coop, sm_count()) < wave_fill(pp, sm_count()))
    return launch_gemm_sm90<EPI, false, true, true>(X, W, M, N, K, K, K, e, st);
  return launch_gemm_sm90<EPI, false, true, false>(X, W, M, N, K, K, K, e, st);
}

// float32 stays on the CUDA-core GEMM.
template <int EPI>
int linear_product(const float* X, const float* W, int M, int N, int K, EpiArgs e,
                   cudaStream_t st) {
  return launch_gemm<EPI>(X, W, M, N, K, K, K, e, st);
}

}  // namespace
