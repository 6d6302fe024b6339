// The CharResNet's training-mode BatchNorm for Hopper (sm_90a): batch
// statistics (optionally weighted by row), the running statistics' update,
// the normalisation with the ReLU that follows it, and the centred
// backward, for one BatchNorm or for a block's tail, where two of them
// (the residual branch's and the shortcut's) meet in an add and a ReLU.
//
//   rt_bn_fwd  stats_kernel: per chunk of kChunk rows, fixed-order float64
//              partial sums of w*x and w*x^2 (w the row's weight, 1
//              without), per channel; stats_final_kernel: the partials
//              summed in chunk order, the mean and variance in float64,
//              rounded to float32, the running statistics moved and
//              num_batches_tracked counted, inv and shift; apply_kernel:
//              y = relu(bf16(x*inv + shift)), or on a tail
//              relu(bf16(bf16(bn(x)) + bf16(bn2(x2)))).
//   rt_bn_bwd  bwd_partial_kernel: fixed-order partials of sum(g) and
//              sum(g*xhat), g the incoming gradient masked by the ReLU
//              (whose output is recomputed from x with the forward's inv
//              and shift, the same bits), xhat = (x - mean) * r;
//              bwd_final_kernel: dbias = sum(g), dweight = sum(g*xhat);
//              dx_kernel: dx = weight*r * (g - w/T * (sum(g) + xhat *
//              sum(g*xhat))) in x's dtype. A tail's two BatchNorms take the
//              same g, in one pass.
//
// Replaces no pallas_call: the JAX package writes this BatchNorm in jnp
// (realise_tpu/ops/resnet.py, batch_norm) and XLA fuses it. Run eagerly
// (realise_tpu_torch/ops/resnet.py, batch_norm_train and _BatchNormTrain,
// which stay as the plain version), one BatchNorm was ~65 launches: a
// float64 copy of x, two float64 reductions, broadcasts and casts, about
// 170 bytes an element.
//
// What bounds them: bytes. Each input is read twice (the statistics, then
// the apply; the backward's sums, then dx) and each output written once:
// forward 6 B an element (bf16), 10 B a tail pair; backward 10 B, 16 B a
// pair. The least any design can move reads each input once: 4 B, 6 B,
// 6 B, 10 B. The statistics' float64 sums cost a conversion and two FP64
// operations an element, under half of Hopper's FP64 and conversion rates
// at the bandwidth bound. Measured on an H100 (the CharResNet's 15
// BatchNorms at 2816 bf16 rows): the first passes, which read from device
// memory alone, move ~2.2-2.4 TB/s, the second ones ~3.3 TB/s of counted
// bytes, part of them from L2; float32 statistics (wrong, for the test)
// were 4% faster, so the float64 arithmetic is not what holds them.
//
// What the design does about it: one 16-byte vector a thread (8 bf16 or 4
// float32 elements) wherever rows are 16-byte aligned and a vector holds
// one channel or whole channels (H*W a multiple or a divisor of the
// vector), else one element a thread; a CTA tiles kCols vectors of a row
// by kChunk rows, in batches of kBatch rows whose loads a thread issues
// before their arithmetic (64 or 128 vectors a row, or 64 to 512 rows a
// chunk, measured slower); the second pass walks the chunks in reverse, so
// the rows the first pass read last are still in L2. The ReLU's mask is
// recomputed from x rather than read. The statistics' partials are summed
// across a CTA's row lanes and the vectors of one channel, in a fixed order,
// into one float64 per (chunk, channel piece); the finalize sums them in
// chunk order, a warp a channel. No atomics, and no order depends on the
// card: two runs give equal bits.
//
// Numerics: the plain version's rounding points. Statistics: n = max(sum(w)
// * H*W, 1), mean = sum(w*x) / n and var = max(sum(w*x^2) / n - mean^2, 0)
// in float64, each rounded to float32; running = 0.9f*running + 0.1f*stat
// (the variance unbiased by float32(n / max(n - 1, 1))), no FMA
// contraction; r = rsqrtf(var + 1e-5f), inv = r*weight, shift = bias -
// mean*inv. Apply: x*inv and + shift rounded apart (__fmul_rn, __fadd_rn),
// then to the dtype. Backward: the float32 sums rounded from float64,
// the per-row scale w / float32(n) (1 / n in float64 rounded, without
// weights), and dx's five float32 operations in the plain order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 32;                  // vectors (or elements) of a CTA
constexpr int kLanes = 8;                  // row lanes of a CTA
constexpr int kPerLane = 4;                // rows a thread loads at once
constexpr int kBatch = kLanes * kPerLane;  // rows a CTA loads at once
constexpr int kChunk = 128;                // rows of a CTA: a partials row
static_assert(kChunk % kBatch == 0 && kCols % kWarp == 0, "tiling");
constexpr int kThreads = kCols * kLanes;
constexpr int kFinWarps = 8;               // channels of a finalize CTA
constexpr float kEps = 1e-5f;
constexpr float kMomentum = 0.1f;
constexpr float kKeep = 0.9f;              // 1 - momentum, as Python rounds it
// CTAs an SM must hold: registers for two (one where a unit holds 4 or 8
// channels, whose coefficients fill the registers; those shapes are small).
template <int K>
constexpr int kMinBlocks = K <= 2 ? 2 : 1;

template <typename T>
struct Fmt;

template <>
struct Fmt<float> {
  static constexpr int kVec = 4;  // elements of a 16-byte vector
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static void round2(float&, float&) {}
  __device__ __forceinline__ static float get(float x) { return x; }
  __device__ __forceinline__ static float put(float x) { return x; }
  __device__ __forceinline__ static void unpack(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* d) {
    return make_uint4(__float_as_uint(d[0]), __float_as_uint(d[1]),
                      __float_as_uint(d[2]), __float_as_uint(d[3]));
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x the low half
  return *reinterpret_cast<unsigned*>(&h);
}

template <>
struct Fmt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // Two values rounded at once (one conversion instruction).
  __device__ __forceinline__ static void round2(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
  __device__ __forceinline__ static float get(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static void unpack(uint4 r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* d) {
    return make_uint4(pack_bf16x2(d[0], d[1]), pack_bf16x2(d[2], d[3]),
                      pack_bf16x2(d[4], d[5]), pack_bf16x2(d[6], d[7]));
  }
};

// U elements of a row: one element (U = 1) or one 16-byte vector.
template <typename T, int U>
struct Unit {
  uint4 raw;
  T one;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (U == 1) one = p[0];
    else raw = *reinterpret_cast<const uint4*>(p);
  }
  // The last read of p in this pass: evict first.
  __device__ __forceinline__ void load_last(const T* p) {
    if constexpr (U == 1) one = p[0];
    else raw = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* v) const {
    if constexpr (U == 1) v[0] = Fmt<T>::get(one);
    else Fmt<T>::unpack(raw, v);
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    if constexpr (U == 1) p[0] = Fmt<T>::put(v[0]);
    else *reinterpret_cast<uint4*>(p) = Fmt<T>::pack(v);
  }
};

// The pointers of one call: up to two BatchNorms (a tail's second is the
// shortcut's).
struct Sets {
  const void* x[2];
  const float* gamma[2];
  const float* beta[2];
  float* rmean[2];
  float* rvar[2];
  long long* nbt[2];
  double* coef[2];  // float32 mean, var, inv, shift (C each), then float64 n
  float* dgamma[2];
  float* dbeta[2];
  void* dx[2];
};

// How a call tiles its (rows, C*H*W) input.
struct Shape {
  long long rows;
  int C, HW;
  int L;       // elements of a row
  int units;   // U-element units of a row
  int K;       // channels a unit holds (1 unless H*W < U)
  int g;       // units of one channel summed in a CTA before the partials
  int gpc;     // partials of a channel in a chunk
  int chunks;  // row chunks
};

// Channel of slot k of unit u.
template <int U, int K>
__device__ __forceinline__ int channel(int u, int k, int HW) {
  return K == 1 ? (u * U) / HW : u * K + k;
}

// v rounded to T, two values a conversion.
template <typename T, int N>
__device__ __forceinline__ void round_all(float* v) {
  if constexpr (N == 1) {
    v[0] = Fmt<T>::round(v[0]);
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 2) Fmt<T>::round2(v[e], v[e + 1]);
  }
}

// The ReLU's input of a unit's U elements, as the forward rounded it: the
// BatchNorm's output, or on a tail the two outputs' rounded sum.
template <typename T, int U, int K, int NBN>
__device__ __forceinline__ void pre_relu(const float* x0, const float* x1,
                                         const float (*inv)[K],
                                         const float (*shift)[K], float* a) {
  constexpr int E = U / K;
#pragma unroll
  for (int e = 0; e < U; ++e)
    a[e] = __fadd_rn(__fmul_rn(x0[e], inv[0][e / E]), shift[0][e / E]);
  round_all<T, U>(a);
  if constexpr (NBN == 2) {
    float b[U];
#pragma unroll
    for (int e = 0; e < U; ++e)
      b[e] = __fadd_rn(__fmul_rn(x1[e], inv[1][e / E]), shift[1][e / E]);
    round_all<T, U>(b);
#pragma unroll
    for (int e = 0; e < U; ++e) a[e] = __fadd_rn(a[e], b[e]);
    round_all<T, U>(a);
  }
}

// v[0] + ... + v[N-1] as a pairwise tree (v is overwritten).
template <int N>
__device__ __forceinline__ double tree_sum(double* v) {
#pragma unroll
  for (int s = 1; s < N; s *= 2) {
#pragma unroll
    for (int i = 0; i + s < N; i += 2 * s) v[i] += v[i + s];
  }
  return v[0];
}

// Values a thread hands to cta_sum in one pass: at most 16 (32 KB of
// shared memory for the CTA).
template <int N>
constexpr int kSumWidth = N < 16 ? N : 16;

// acc[0 .. N) of every thread → in each group leader (row lane 0, x a
// multiple of g, a power of two), each value's sum over its g units and
// the kLanes row lanes, in a fixed order: the lanes in lane order, then the
// units by a tree of shuffles within row lane 0's warps. red: kLanes x kCols
// x kSumWidth<N> doubles of shared memory.
template <int N>
__device__ __forceinline__ void cta_sum(double* acc, double* red, int g) {
  constexpr int M = kSumWidth<N>;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += M) {
    constexpr int kRow = kCols * M;
#pragma unroll
    for (int m = 0; m < M && n0 + m < N; ++m)
      red[ty * kRow + tx * M + m] = acc[n0 + m];
    __syncthreads();
    if (ty == 0) {
#pragma unroll
      for (int m = 0; m < M && n0 + m < N; ++m) {
        double t = red[tx * M + m];
#pragma unroll
        for (int y = 1; y < kLanes; ++y) t += red[y * kRow + tx * M + m];
        for (int o = 1; o < g; o *= 2) {
          const double v = __shfl_down_sync(0xffffffffu, t, o);
          if ((tx & (2 * o - 1)) == 0) t += v;
        }
        acc[n0 + m] = t;
      }
    }
    __syncthreads();
  }
}

// Lane 0's sum of v over the warp, in a fixed order.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Partials row of chunk blockIdx.y, BatchNorm blockIdx.z: [sum(w*x) (C*gpc)]
// [sum(w*x^2) (C*gpc)] [sum(w) (1)].
template <typename T, int U, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
stats_kernel(Sets s, const float* __restrict__ w, Shape sh, int slots,
             long long stride, double* __restrict__ part) {
  constexpr int E = U / K;  // elements of a channel in a unit
  constexpr int N = 2 * K + 1;
  __shared__ double red[kLanes * kCols * kSumWidth<N>];
  const T* __restrict__ x = static_cast<const T*>(s.x[blockIdx.z]);
  const int u = blockIdx.x * kCols + threadIdx.x;
  const bool active = u < sh.units;
  const long long c0 = (long long)blockIdx.y * kChunk;
  const long long c1 = c0 + kChunk < sh.rows ? c0 + kChunk : sh.rows;
  // sum(w*x) of each channel slot, then sum(w*x^2), then sum(w) (column 0:
  // every row of the chunk once).
  double acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.0;
  double* s1 = acc;
  double* s2 = acc + K;
  for (long long b0 = c0 + threadIdx.y; active && b0 < c1; b0 += kBatch) {
    Unit<T, U> in[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long r = b0 + i * kLanes;
      if (r < c1) in[i].load(x + r * sh.L + (long long)u * U);
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long r = b0 + i * kLanes;
      if (r >= c1) break;
      float v[U];
      in[i].get(v);
      const double wr = w != nullptr ? (double)__ldg(w + r) : 1.0;
      // sum(w) once a row: column 0 alone, so the group sum adds zeros.
      if (threadIdx.x == 0) acc[2 * K] += wr;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        double xs[E], xx[E];  // x^2 is exact in float64
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xs[e] = (double)v[k * E + e];
          xx[e] = xs[e] * xs[e];
        }
        s1[k] = fma(wr, tree_sum<E>(xs), s1[k]);
        s2[k] = fma(wr, tree_sum<E>(xx), s2[k]);
      }
    }
  }
  cta_sum<N>(acc, red, sh.g);
  if (threadIdx.y == 0 && active && threadIdx.x % sh.g == 0) {
    double* p = part + blockIdx.z * stride + (long long)blockIdx.y * slots;
    const int cg = sh.C * sh.gpc;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = u / sh.g * K + k;
      p[idx] = s1[k];
      p[cg + idx] = s2[k];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) p[2 * cg] = acc[2 * K];
  }
}

// One warp a channel (blockIdx.x * kFinWarps + warp), BatchNorm blockIdx.y.
__global__ void __launch_bounds__(kFinWarps * 32)
stats_final_kernel(Sets s, Shape sh, int slots, long long stride,
                   const double* __restrict__ part, int weighted) {
  const int z = blockIdx.y, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kFinWarps + (threadIdx.x >> 5);
  if (c >= sh.C) return;
  const double* p = part + z * stride;
  const int cg = sh.C * sh.gpc;
  double tw = 0.0;
  if (weighted) {
    for (int ch = lane; ch < sh.chunks; ch += 32)
      tw += p[(long long)ch * slots + 2 * cg];
    tw = warp_sum(tw);
  }
  double a = 0.0, b = 0.0;
  const int items = sh.chunks * sh.gpc;
#pragma unroll 4
  for (int j = lane; j < items; j += 32) {
    const int ch = j / sh.gpc, q = j - ch * sh.gpc;
    const double* pp = p + (long long)ch * slots + c * sh.gpc + q;
    a += pp[0];
    b += pp[cg];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane != 0) return;
  double n = __dmul_rn(weighted ? tw : (double)sh.rows, (double)sh.HW);
  if (n < 1.0) n = 1.0;
  double un = __dsub_rn(n, 1.0);
  if (un < 1.0) un = 1.0;
  const double mean_d = __ddiv_rn(a, n);
  double var_d = __dsub_rn(__ddiv_rn(b, n), __dmul_rn(mean_d, mean_d));
  if (var_d < 0.0) var_d = 0.0;
  const float mean = __double2float_rn(mean_d);
  const float var = __double2float_rn(var_d);
  const float unbiased = __fmul_rn(var, __double2float_rn(__ddiv_rn(n, un)));
  s.rmean[z][c] = __fadd_rn(__fmul_rn(kKeep, s.rmean[z][c]),
                            __fmul_rn(kMomentum, mean));
  s.rvar[z][c] = __fadd_rn(__fmul_rn(kKeep, s.rvar[z][c]),
                           __fmul_rn(kMomentum, unbiased));
  const float inv = __fmul_rn(rsqrtf(__fadd_rn(var, kEps)), s.gamma[z][c]);
  float* cf = reinterpret_cast<float*>(s.coef[z]);
  cf[c] = mean;
  cf[sh.C + c] = var;
  cf[2 * sh.C + c] = inv;
  cf[3 * sh.C + c] = __fsub_rn(s.beta[z][c], __fmul_rn(mean, inv));
  if (c == 0) {
    s.coef[z][2 * sh.C] = n;
    *s.nbt[z] += 1;
  }
}

template <typename T, int U, int K, int NBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
apply_kernel(Sets s, Shape sh, T* __restrict__ y) {
  const int u = blockIdx.x * kCols + threadIdx.x;
  if (u >= sh.units) return;
  float inv[NBN][K], shift[NBN][K];
#pragma unroll
  for (int j = 0; j < NBN; ++j) {
    const float* cf = reinterpret_cast<const float*>(s.coef[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = channel<U, K>(u, k, sh.HW);
      inv[j][k] = cf[2 * sh.C + c];
      shift[j][k] = cf[3 * sh.C + c];
    }
  }
  const T* __restrict__ x0 = static_cast<const T*>(s.x[0]);
  const T* __restrict__ x1 = static_cast<const T*>(s.x[1]);
  const long long col = (long long)u * U;
  // The chunks and their batches in reverse: the statistics' last rows
  // first, while L2 still holds them.
  const long long c0 = (long long)(gridDim.y - 1 - blockIdx.y) * kChunk;
  const long long c1 = c0 + kChunk < sh.rows ? c0 + kChunk : sh.rows;
  for (long long b0 = c0 + (c1 - 1 - c0) / kBatch * kBatch + threadIdx.y;
       b0 >= c0; b0 -= kBatch) {
    Unit<T, U> in0[kPerLane], in1[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long r = b0 + i * kLanes;
      if (r < c1) {
        in0[i].load_last(x0 + r * sh.L + col);
        if constexpr (NBN == 2) in1[i].load_last(x1 + r * sh.L + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long r = b0 + i * kLanes;
      if (r >= c1) break;
      float v0[U], v1[U], out[U];
      in0[i].get(v0);
      if constexpr (NBN == 2) in1[i].get(v1);
      pre_relu<T, U, K, NBN>(v0, v1, inv, shift, out);
#pragma unroll
      for (int e = 0; e < U; ++e) out[e] = out[e] <= 0.f ? 0.f : out[e];
      Unit<T, U>::store(y + r * sh.L + col, out);
    }
  }
}

// Partials row of chunk blockIdx.y: [sum(g)] [sum(g*xhat0)] [sum(g*xhat1)],
// C*gpc each.
template <typename T, int U, int K, int NBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
bwd_partial_kernel(Sets s, const T* __restrict__ dy, Shape sh, int slots,
                   double* __restrict__ part) {
  constexpr int E = U / K;
  constexpr int N = (1 + NBN) * K;
  __shared__ double red[kLanes * kCols * kSumWidth<N>];
  const int u = blockIdx.x * kCols + threadIdx.x;
  const bool active = u < sh.units;
  // sum(g) of each channel slot, then sum(g*xhat) of each BatchNorm.
  double acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.0;
  if (active) {
    float mean[NBN][K], r[NBN][K], inv[NBN][K], shift[NBN][K];
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
      const float* cf = reinterpret_cast<const float*>(s.coef[j]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = channel<U, K>(u, k, sh.HW);
        mean[j][k] = cf[c];
        r[j][k] = rsqrtf(__fadd_rn(cf[sh.C + c], kEps));
        inv[j][k] = cf[2 * sh.C + c];
        shift[j][k] = cf[3 * sh.C + c];
      }
    }
    const T* __restrict__ x0 = static_cast<const T*>(s.x[0]);
    const T* __restrict__ x1 = static_cast<const T*>(s.x[1]);
    const long long col = (long long)u * U;
    const long long c0 = (long long)blockIdx.y * kChunk;
    const long long c1 = c0 + kChunk < sh.rows ? c0 + kChunk : sh.rows;
    for (long long b0 = c0 + threadIdx.y; b0 < c1; b0 += kBatch) {
      Unit<T, U> ing[kPerLane], in0[kPerLane], in1[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const long long row = b0 + i * kLanes;
        if (row < c1) {
          ing[i].load(dy + row * sh.L + col);
          in0[i].load(x0 + row * sh.L + col);
          if constexpr (NBN == 2) in1[i].load(x1 + row * sh.L + col);
        }
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (b0 + i * kLanes >= c1) break;
        float vg[U], v0[U], v1[U], pre[U];
        ing[i].get(vg);
        in0[i].get(v0);
        if constexpr (NBN == 2) in1[i].get(v1);
        pre_relu<T, U, K, NBN>(v0, v1, inv, shift, pre);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          // A unit-row's few terms in float32, then into float64.
          float fg = 0.f, fgx[NBN];
#pragma unroll
          for (int j = 0; j < NBN; ++j) fgx[j] = 0.f;
#pragma unroll
          for (int e = k * E; e < (k + 1) * E; ++e) {
            const float g = pre[e] <= 0.f ? 0.f : vg[e];
            fg += g;
            fgx[0] += __fmul_rn(g, __fmul_rn(__fsub_rn(v0[e], mean[0][k]),
                                             r[0][k]));
            if constexpr (NBN == 2)
              fgx[1] += __fmul_rn(g, __fmul_rn(__fsub_rn(v1[e], mean[1][k]),
                                               r[1][k]));
          }
          acc[k] += (double)fg;
#pragma unroll
          for (int j = 0; j < NBN; ++j) acc[(j + 1) * K + k] += (double)fgx[j];
        }
      }
    }
  }
  cta_sum<N>(acc, red, sh.g);
  if (threadIdx.y == 0 && active && threadIdx.x % sh.g == 0) {
    double* p = part + (long long)blockIdx.y * slots;
    const int cg = sh.C * sh.gpc;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = u / sh.g * K + k;
#pragma unroll
      for (int j = 0; j <= NBN; ++j) p[j * cg + idx] = acc[j * K + k];
    }
  }
}

// One warp a channel: dbias (both BatchNorms of a tail: the same sum) and
// dweight of each.
__global__ void __launch_bounds__(kFinWarps * 32)
bwd_final_kernel(Sets s, Shape sh, int slots, int nbn,
                 const double* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kFinWarps + (threadIdx.x >> 5);
  if (c >= sh.C) return;
  const int cg = sh.C * sh.gpc;
  double a = 0.0, b0 = 0.0, b1 = 0.0;
  const int items = sh.chunks * sh.gpc;
#pragma unroll 4
  for (int j = lane; j < items; j += 32) {
    const int ch = j / sh.gpc, q = j - ch * sh.gpc;
    const double* pp = part + (long long)ch * slots + c * sh.gpc + q;
    a += pp[0];
    b0 += pp[cg];
    if (nbn == 2) b1 += pp[2 * cg];
  }
  a = warp_sum(a);
  b0 = warp_sum(b0);
  b1 = warp_sum(b1);
  if (lane != 0) return;
  s.dbeta[0][c] = __double2float_rn(a);
  s.dgamma[0][c] = __double2float_rn(b0);
  if (nbn == 2) {
    s.dbeta[1][c] = __double2float_rn(a);
    s.dgamma[1][c] = __double2float_rn(b1);
  }
}

template <typename T, int U, int K, int NBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
dx_kernel(Sets s, const T* __restrict__ dy, const float* __restrict__ w,
          Shape sh) {
  constexpr int E = U / K;
  const int u = blockIdx.x * kCols + threadIdx.x;
  if (u >= sh.units) return;
  float mean[NBN][K], r[NBN][K], inv[NBN][K], shift[NBN][K], a[NBN][K],
      sgx[NBN][K], sg[K];
#pragma unroll
  for (int j = 0; j < NBN; ++j) {
    const float* cf = reinterpret_cast<const float*>(s.coef[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = channel<U, K>(u, k, sh.HW);
      mean[j][k] = cf[c];
      r[j][k] = rsqrtf(__fadd_rn(cf[sh.C + c], kEps));
      inv[j][k] = cf[2 * sh.C + c];
      shift[j][k] = cf[3 * sh.C + c];
      a[j][k] = __fmul_rn(s.gamma[j][c], r[j][k]);
      sgx[j][k] = s.dgamma[j][c];
      if (j == 0) sg[k] = s.dbeta[0][c];
    }
  }
  const double n = s.coef[0][2 * sh.C];
  const float nf = __double2float_rn(n);
  const float unweighted = __double2float_rn(__ddiv_rn(1.0, n));
  const T* __restrict__ x0 = static_cast<const T*>(s.x[0]);
  const T* __restrict__ x1 = static_cast<const T*>(s.x[1]);
  T* __restrict__ d0 = static_cast<T*>(s.dx[0]);
  T* __restrict__ d1 = static_cast<T*>(s.dx[1]);
  const long long col = (long long)u * U;
  const long long c0 = (long long)(gridDim.y - 1 - blockIdx.y) * kChunk;
  const long long c1 = c0 + kChunk < sh.rows ? c0 + kChunk : sh.rows;
  for (long long b0 = c0 + (c1 - 1 - c0) / kBatch * kBatch + threadIdx.y;
       b0 >= c0; b0 -= kBatch) {
    Unit<T, U> ing[kPerLane], in0[kPerLane], in1[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long row = b0 + i * kLanes;
      if (row < c1) {
        ing[i].load_last(dy + row * sh.L + col);
        in0[i].load_last(x0 + row * sh.L + col);
        if constexpr (NBN == 2) in1[i].load_last(x1 + row * sh.L + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long row = b0 + i * kLanes;
      if (row >= c1) break;
      const float scale =
          w != nullptr ? __fdiv_rn(__ldg(w + row), nf) : unweighted;
      float vg[U], v0[U], v1[U], pre[U], o0[U], o1[U];
      ing[i].get(vg);
      in0[i].get(v0);
      if constexpr (NBN == 2) in1[i].get(v1);
      pre_relu<T, U, K, NBN>(v0, v1, inv, shift, pre);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int k = e / E;
        const float g = pre[e] <= 0.f ? 0.f : vg[e];
#pragma unroll
        for (int j = 0; j < NBN; ++j) {
          const float xv = j == 0 ? v0[e] : v1[e];
          const float xh = __fmul_rn(__fsub_rn(xv, mean[j][k]), r[j][k]);
          float t = __fadd_rn(sg[k], __fmul_rn(xh, sgx[j][k]));
          t = __fsub_rn(g, __fmul_rn(scale, t));
          if (j == 0) o0[e] = __fmul_rn(a[j][k], t);
          else o1[e] = __fmul_rn(a[j][k], t);
        }
      }
      Unit<T, U>::store(d0 + row * sh.L + col, o0);
      if constexpr (NBN == 2) Unit<T, U>::store(d1 + row * sh.L + col, o1);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The tiling of a call, or false when the arguments do not describe one:
// unit 1, or the 16-byte vector of vec elements where every row holds whole
// vectors and a vector one channel or whole channels.
bool make_shape(int unit, int vec, long long rows, int C, int HW,
                Shape* sh) {
  if (rows < 1 || C < 1 || HW < 1 || (long long)C * HW > (1 << 30))
    return false;
  const int L = C * HW;
  if (unit != 1 &&
      (unit != vec || L % vec != 0 || (HW % vec != 0 && vec % HW != 0)))
    return false;
  const long long chunks = (rows + kChunk - 1) / kChunk;
  if (chunks > 65535) return false;
  sh->rows = rows;
  sh->C = C;
  sh->HW = HW;
  sh->L = L;
  sh->units = L / unit;
  sh->K = unit > HW ? unit / HW : 1;
  const int upc = sh->K > 1 ? 1 : HW / unit;  // units of a channel
  sh->g = sh->K > 1 ? 1 : gcd(upc, kWarp);
  sh->gpc = upc / sh->g;
  sh->chunks = (int)chunks;
  return true;
}

template <typename T, int U, int K>
int fwd_launch(const Sets& s, int nbn, const float* w, const Shape& sh,
               double* part, void* y, cudaStream_t st) {
  const int slots = 2 * sh.C * sh.gpc + 1;
  const long long stride = (long long)sh.chunks * slots;
  const dim3 block(kCols, kLanes);
  const unsigned gx = (unsigned)((sh.units + kCols - 1) / kCols);
  stats_kernel<T, U, K><<<dim3(gx, sh.chunks, nbn), block, 0, st>>>(
      s, w, sh, slots, stride, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_final_kernel<<<dim3((sh.C + kFinWarps - 1) / kFinWarps, nbn),
                       kFinWarps * 32, 0, st>>>(s, sh, slots, stride, part,
                                                w != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nbn == 1)
    apply_kernel<T, U, K, 1><<<dim3(gx, sh.chunks), block, 0, st>>>(
        s, sh, static_cast<T*>(y));
  else
    apply_kernel<T, U, K, 2><<<dim3(gx, sh.chunks), block, 0, st>>>(
        s, sh, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T, int U, int K, int NBN>
int bwd_launch_n(const Sets& s, const void* dy, const float* w,
                 const Shape& sh, double* part, cudaStream_t st) {
  const int slots = (1 + NBN) * sh.C * sh.gpc;
  const dim3 block(kCols, kLanes);
  const dim3 grid((unsigned)((sh.units + kCols - 1) / kCols), sh.chunks);
  bwd_partial_kernel<T, U, K, NBN><<<grid, block, 0, st>>>(
      s, static_cast<const T*>(dy), sh, slots, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_final_kernel<<<(sh.C + kFinWarps - 1) / kFinWarps, kFinWarps * 32, 0,
                     st>>>(s, sh, slots, NBN, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dx_kernel<T, U, K, NBN><<<grid, block, 0, st>>>(
      s, static_cast<const T*>(dy), w, sh);
  return (int)cudaGetLastError();
}

template <typename T, int U, int K>
int bwd_launch(const Sets& s, int nbn, const void* dy, const float* w,
               const Shape& sh, double* part, cudaStream_t st) {
  return nbn == 1 ? bwd_launch_n<T, U, K, 1>(s, dy, w, sh, part, st)
                  : bwd_launch_n<T, U, K, 2>(s, dy, w, sh, part, st);
}

// f(U, K) (std::integral_constant each) for the shape's route: unit 1, or
// the vector holding K channels (8 only in bfloat16).
template <typename T, typename F>
int by_route(int unit, int K, F&& f) {
  using std::integral_constant;
  constexpr int V = Fmt<T>::kVec;
  if (unit == 1)
    return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
  switch (K) {
    case 1: return f(integral_constant<int, V>{}, integral_constant<int, 1>{});
    case 2: return f(integral_constant<int, V>{}, integral_constant<int, 2>{});
    case 4: return f(integral_constant<int, V>{}, integral_constant<int, 4>{});
    case 8:
      if constexpr (V == 8)
        return f(integral_constant<int, V>{}, integral_constant<int, 8>{});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int fwd_typed(const Sets& s, int nbn, int unit, const float* w,
              const Shape& sh, double* part, void* y, cudaStream_t st) {
  return by_route<T>(unit, sh.K, [&](auto u, auto k) {
    return fwd_launch<T, decltype(u)::value, decltype(k)::value>(
        s, nbn, w, sh, part, y, st);
  });
}

template <typename T>
int bwd_typed(const Sets& s, int nbn, int unit, const void* dy,
              const float* w, const Shape& sh, double* part,
              cudaStream_t st) {
  return by_route<T>(unit, sh.K, [&](auto u, auto k) {
    return bwd_launch<T, decltype(u)::value, decltype(k)::value>(
        s, nbn, dy, w, sh, part, st);
  });
}

bool vector_ok(int unit, std::initializer_list<const void*> ptrs) {
  if (unit == 1) return true;
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return false;
  return true;
}

}  // namespace

// nbn 1: y = relu(bn0(x0)); nbn 2: y = relu(bn0(x0) + bn1(x1)), each
// rounded to the dtype (0 float32, 1 bfloat16) as the plain version rounds
// it. x0, x1, y: (rows, C, HW) contiguous; w: (rows,) float32 row weights
// or null. Per BatchNorm j: gamma, beta (C,) float32; running mean and var
// (C,) float32, updated in place; nbt one int64, counted; coef (2C + 1)
// float64, written: float32 mean, var, inv, shift, then float64 n. unit: 1
// or the 16-byte vector's elements (4 float32, 8 bfloat16). scratch:
// float64, rt_bn_fwd_scratch of the same arguments. Returns a CUDA error
// code.
extern "C" int rt_bn_fwd(int nbn, int dtype, int unit, long long rows, int C,
                         int HW, const void* x0, const void* x1,
                         const float* w, const float* gamma0,
                         const float* beta0, float* rmean0, float* rvar0,
                         long long* nbt0, double* coef0, const float* gamma1,
                         const float* beta1, float* rmean1, float* rvar1,
                         long long* nbt1, double* coef1, double* scratch,
                         long long scratch_len, void* y, void* stream) {
  Shape sh;
  if ((nbn != 1 && nbn != 2) || (dtype != 0 && dtype != 1) ||
      !make_shape(unit, dtype == 1 ? 8 : 4, rows, C, HW, &sh) ||
      !vector_ok(unit, {x0, x1, y}) ||
      scratch_len != (long long)nbn * sh.chunks * (2LL * C * sh.gpc + 1))
    return (int)cudaErrorInvalidValue;
  Sets s = {};
  s.x[0] = x0;
  s.x[1] = x1;
  s.gamma[0] = gamma0;
  s.gamma[1] = gamma1;
  s.beta[0] = beta0;
  s.beta[1] = beta1;
  s.rmean[0] = rmean0;
  s.rmean[1] = rmean1;
  s.rvar[0] = rvar0;
  s.rvar[1] = rvar1;
  s.nbt[0] = nbt0;
  s.nbt[1] = nbt1;
  s.coef[0] = coef0;
  s.coef[1] = coef1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd_typed<__nv_bfloat16>(s, nbn, unit, w, sh, scratch,
                                               y, st)
                    : fwd_typed<float>(s, nbn, unit, w, sh, scratch, y, st);
}

// The backward of rt_bn_fwd from dy (the gradient of y, y's shape and
// dtype): dx0 (and dx1) in x's dtype; dgamma, dbeta (C,) float32 of each
// BatchNorm. x0, x1, w, gamma, coef as the forward had them. scratch:
// float64, rt_bn_bwd_scratch of the same arguments. Returns a CUDA error
// code.
extern "C" int rt_bn_bwd(int nbn, int dtype, int unit, long long rows, int C,
                         int HW, const void* dy, const void* x0,
                         const void* x1, const float* w, const float* gamma0,
                         const double* coef0, const float* gamma1,
                         const double* coef1, double* scratch,
                         long long scratch_len, float* dgamma0, float* dbeta0,
                         float* dgamma1, float* dbeta1, void* dx0, void* dx1,
                         void* stream) {
  Shape sh;
  if ((nbn != 1 && nbn != 2) || (dtype != 0 && dtype != 1) ||
      !make_shape(unit, dtype == 1 ? 8 : 4, rows, C, HW, &sh) ||
      !vector_ok(unit, {dy, x0, x1, dx0, dx1}) ||
      scratch_len != (long long)sh.chunks * (1 + nbn) * C * sh.gpc)
    return (int)cudaErrorInvalidValue;
  Sets s = {};
  s.x[0] = x0;
  s.x[1] = x1;
  s.gamma[0] = gamma0;
  s.gamma[1] = gamma1;
  s.coef[0] = const_cast<double*>(coef0);
  s.coef[1] = const_cast<double*>(coef1);
  s.dgamma[0] = dgamma0;
  s.dgamma[1] = dgamma1;
  s.dbeta[0] = dbeta0;
  s.dbeta[1] = dbeta1;
  s.dx[0] = dx0;
  s.dx[1] = dx1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd_typed<__nv_bfloat16>(s, nbn, unit, dy, w, sh,
                                               scratch, st)
                    : bwd_typed<float>(s, nbn, unit, dy, w, sh, scratch, st);
}

// float64 scratch of rt_bn_fwd (backward 0) or rt_bn_bwd (backward 1) at
// these arguments; -1 when they describe no call.
extern "C" long long rt_bn_scratch(int backward, int nbn, int dtype, int unit,
                                   long long rows, int C, int HW) {
  Shape sh;
  if ((nbn != 1 && nbn != 2) || (dtype != 0 && dtype != 1) ||
      !make_shape(unit, dtype == 1 ? 8 : 4, rows, C, HW, &sh))
    return -1;
  return backward ? (long long)sh.chunks * (1 + nbn) * C * sh.gpc
                  : (long long)nbn * sh.chunks * (2LL * C * sh.gpc + 1);
}
