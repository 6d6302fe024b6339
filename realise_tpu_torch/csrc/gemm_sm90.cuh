// Hopper GEMM for the products of the training backward (sm_90a): TMA
// loads into a 128-byte-swizzled shared-memory ring, wgmma on the tensor
// cores, accumulators in registers.
//
// C (M, N) = sum_k A(m, k) B(k, n), B stored n-contiguous ("B[k * ldb + n]",
// wgmma's MN-major B, trans-b = 1) in both layouts the backward needs:
//   * A k-contiguous ("A[m * lda + k]", K-major, trans-a = 0): dY . W, the
//     data gradients dctx, dt1 and dx;
//   * A_T, A m-contiguous ("A[k * lda + m]", MN-major, trans-a = 1): a weight
//     gradient dW = dY^T . X over the B*S rows, split along K into float32
//     partials (EPI_STORE_F32 at out + z * M * N) that the caller sums in a
//     fixed order. No atomics: two runs give the same bits.
// The epilogue is bert_block_common.cuh's epi_store2, fed from the
// accumulator fragment (each thread holds column pairs of rows g and g + 8
// of its warp's 16), so the rounding points are those of gemm_bf16_tc.
//
// What bounds it: at the training shapes (M = B*S = 32768, H = 768, I =
// 3072) every product does 24-155 GFLOP on a few hundred MB: operations, on
// the bf16 tensor cores, which only wgmma drives at their full rate.
//
// Design: one persistent block per SM walks over the output tiles (n
// fastest, then m, then the K split). Warpgroups 0 and 1 each own 64 rows of
// a 128 x 256 tile and run wgmma.m64n256k16 (128 f32 accumulators a thread)
// on descriptors into the ring; warpgroup 2 gives its registers up
// (setmaxnreg) and one of its threads keeps the ring full with
// cp.async.bulk.tensor (TMA, 128-byte swizzle, zero fill past the edges),
// a full and an empty mbarrier per stage. The producer runs ahead into the
// next tile while the consumers store the last one.
//
// Tile 128 x 256 x 64, 4 stages: a k-tile is 48 KB for 4.2 MFLOP (87
// FLOP per byte read from L2, against 64 for 128 x 128), the 64-deep box is
// the 128-byte swizzle span, and 4 stages (192 KB) are what fits: one block
// per SM, hence persistent. N = 768 and 3072 are whole multiples of 256, and
// B*S of 128.
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

constexpr int G9_BM = 128, G9_BN = 256, G9_BK = 64, G9_STAGES = 4;
constexpr int G9_THREADS = 3 * 128;                   // 2 consumer warpgroups, 1 producer
constexpr int G9_CONSUMER_WARPS = 8;                  // arrivals on an empty barrier
constexpr int G9_BOX = 64;                            // 64 bf16 = the 128-byte swizzle span
constexpr int G9_BOX_BYTES = G9_BOX * G9_BK * 2;      // one 64 x 64 box: 8 KB
constexpr int G9_A_BYTES = G9_BM * G9_BK * 2;         // 16 KB
constexpr int G9_STAGE_BYTES = G9_A_BYTES + G9_BN * G9_BK * 2;  // 48 KB
constexpr int G9_ATOM = 1024;                         // 8 rows of 128 bytes: the swizzle atom
constexpr size_t G9_SMEM =
    (size_t)G9_STAGES * G9_STAGE_BYTES + G9_ATOM + 2 * G9_STAGES * sizeof(uint64_t);
// A wait longer than this is a broken pipeline: trap, so the launch fails
// with an error instead of holding the card.
constexpr unsigned long long G9_WAIT_NS = 20000000000ull;

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

// d (the warpgroup's 64 x 256 f32 fragment) += A (64 x 16) . B (16 x 256),
// B MN-major, A MN-major when TA = 1.
template <int TA>
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
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// C = A . B (see the top of the file) for the output tiles of units
// blockIdx.x, + gridDim.x, ...; unit u is K split u / (tiles_m * tiles_n),
// k rows [z * k_chunk, min(K, (z + 1) * k_chunk)).
template <int EPI, bool A_T>
__global__ void __launch_bounds__(G9_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          int M, int N, int K, int k_chunk, int tiles_m, int tiles_n, int units, EpiArgs e) {
  extern __shared__ __align__(16) unsigned char g9_raw[];
  // The swizzle pattern repeats every 1024 bytes of shared address: align the
  // ring to it.
  unsigned char* smem = g9_raw + ((G9_ATOM - (smem_u32(g9_raw) & (G9_ATOM - 1))) & (G9_ATOM - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G9_STAGES * G9_STAGE_BYTES);
  uint64_t* empty = full + G9_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G9_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G9_CONSUMER_WARPS);
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
        const int bm = (rem / tiles_n) * G9_BM, bn = (rem % tiles_n) * G9_BN;
        const int k_end = min(K, (z + 1) * k_chunk);
        for (int k = z * k_chunk; k < k_end; k += G9_BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * G9_STAGE_BYTES;
          unsigned char* b = a + G9_A_BYTES;
          mbar_expect_tx(&full[stage], G9_STAGE_BYTES);
          if (A_T) {  // two 64-wide boxes of M, one per consumer warpgroup
            tma_load(a, &map_a, &full[stage], bm, k);
            tma_load(a + G9_BOX_BYTES, &map_a, &full[stage], bm + G9_BOX, k);
          } else {    // 128 rows of 64 k
            tma_load(a, &map_a, &full[stage], k, bm);
          }
#pragma unroll
          for (int j = 0; j < G9_BN / G9_BOX; ++j)
            tma_load(b + j * G9_BOX_BYTES, &map_b, &full[stage], bn + j * G9_BOX, k);
          if (++stage == G9_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / per_split, rem = u - z * per_split;
      const int bm = (rem / tiles_n) * G9_BM, bn = (rem % tiles_n) * G9_BN;
      const int k_end = min(K, (z + 1) * k_chunk);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;  // the stage whose wgmma group is still in flight
      for (int k = z * k_chunk; k < k_end; k += G9_BK) {
        mbar_wait(&full[stage], phase);
        // This warpgroup's 64 rows of A sit 8 KB apart in both layouts
        // (64 rows x 128 bytes, or one 64-wide box of M).
        const unsigned char* a = smem + stage * G9_STAGE_BYTES + wg * G9_BOX_BYTES;
        const unsigned char* b = smem + stage * G9_STAGE_BYTES + G9_A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G9_BK / 16; ++kk) {
          // k16 steps: 32 bytes along a K-major row, two 8-row atoms (2 KB)
          // down an MN-major tile.
          const uint64_t da = A_T ? g9_desc(a + kk * 2 * G9_ATOM, G9_BOX_BYTES, G9_ATOM)
                                  : g9_desc(a + kk * 32, 16, G9_ATOM);
          const uint64_t db = g9_desc(b + kk * 2 * G9_ATOM, G9_BOX_BYTES, G9_ATOM);
          wgmma_m64n256k16<A_T ? 1 : 0>(acc, da, db);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous k-tile's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == G9_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      EpiArgs eu = e;
      if (EPI == EPI_STORE_F32) eu.out = static_cast<float*>(e.out) + (size_t)z * M * N;
      // The fragment holds column pairs j * 8 + 2 t4 of rows r and r + 8
      // (acc[4 j] ..). They are stored in 4 chunks of 8 pairs: each chunk
      // first loads every residual it reads, so the loads overlap instead of
      // each waiting behind the last store. The chunk loop is not unrolled
      // (a fully unrolled gelu' epilogue outgrows the instruction cache);
      // the next chunk's accumulators move to the front instead, so every
      // register index stays a constant.
      const int r = bm + wg * 64 + warp * 16 + g;
#pragma unroll 1
      for (int j0 = 0; j0 < 32; j0 += 8) {
        float2 res[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = bn + (j0 + j) * 8 + t4 * 2;
          res[j][0] = epi_resid2<EPI>(eu, r, c, M, N);
          res[j][1] = epi_resid2<EPI>(eu, r + 8, c, M, N);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = bn + (j0 + j) * 8 + t4 * 2;
          epi_store2<EPI>(eu, r, c, M, N, acc[4 * j], acc[4 * j + 1], res[j][0]);
          epi_store2<EPI>(eu, r + 8, c, M, N, acc[4 * j + 2], acc[4 * j + 3], res[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 96; ++i) acc[i] = acc[i + 32];
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

// C (M, N) = A . B with A's layout per A_T; splits > 1 (EPI_STORE_F32 only)
// writes that many partials of M x N.
template <int EPI, bool A_T>
int launch_gemm_sm90(const bf16* A, const bf16* B, int M, int N, int K, int lda, int ldb,
                     EpiArgs e, cudaStream_t st, int splits = 1) {
  CUtensorMap ma, mb;
  int err = A_T ? tensor_map(&ma, A, M, K, lda, G9_BK) : tensor_map(&ma, A, K, M, lda, G9_BM);
  if (err) return err;
  err = tensor_map(&mb, B, N, K, ldb, G9_BK);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(gemm_sm90<EPI, A_T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G9_SMEM);
  if (err) return err;
  const int k_chunk = split_chunk(K, splits, G9_BK);
  const int tiles_m = (M + G9_BM - 1) / G9_BM, tiles_n = (N + G9_BN - 1) / G9_BN;
  const int units = tiles_m * tiles_n * ((K + k_chunk - 1) / k_chunk);
  const int blocks = units < sm_count() ? units : sm_count();
  gemm_sm90<EPI, A_T><<<blocks, G9_THREADS, G9_SMEM, st>>>(
      ma, mb, M, N, K, k_chunk, tiles_m, tiles_n, units, e);
  return (int)cudaGetLastError();
}

}  // namespace
