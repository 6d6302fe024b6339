// The tied head's masked cross-entropy for Hopper (sm_90a): the loss's
// per-row log-partition and gold logit, and the logits' and head bias's
// gradients, each in one pass over the (rows, V) logits.
//
//   rt_masked_ce_fwd  one read of the logits: per row, the biased logit
//                     l = round(logit + round(bias)) (the logits' dtype's
//                     rounding; the logit itself without a bias), logz =
//                     max + log sum exp(l - max) by an online max and sum,
//                     and the gold l[label]; writes logz and gold (rows,)
//                     float32;
//   rt_masked_ce_bwd  one read of the logits and one write of the gradient:
//                     dlogits = round((exp(l - logz) - onehot) * dsum * m),
//                     and with a bias the float32 column sums of the
//                     rounded dlogits over each chunk of kChunk rows, which
//                     a second small launch sums in chunk order into dbias.
//
// Replaces no pallas_call: the JAX package writes this loss as a hand VJP
// in jnp (realise_tpu/models/realise.py, _masked_ce_sum and _ce_dlogits)
// and XLA fuses its casts and broadcasts into the reductions. Run eagerly,
// each cast and broadcast of that VJP was a pass of its own over the
// logits, about 116 bytes an element a step.
//
// What bounds them: bytes. The forward reads each logit once (2 B an
// element in bf16), the backward reads it once more and writes its
// gradient once (4 B); besides, rows x 20 B of labels, mask, logz and gold,
// the bias (4 V B, from L1 and L2) and the backward's partial sums (4 V B
// for every kChunk rows, 1/64 of its other bytes, written and read once).
// At 16,384 rows of 21,128 bf16 logits: 0.69 GB forward, 1.38 GB backward,
// 0.21 + 0.41 ms at 3.35 TB/s.
//
// What the design does about it: one 16-byte load a thread for eight bf16
// (four float32) logits wherever rows are 16-byte aligned, streaming loads
// and stores (evict first), a scalar route for other widths; few
// instructions an element (the forward's exp is one FFMA and one ex2), and
// no barrier in either kernel's loop. The forward gives each warp whole
// rows: each lane keeps a running max and sum over its vectors, four loads
// in flight, and the warp merges them once a row. The backward tiles the
// logits by (kSlab vectors, kChunk rows): a thread owns one vector of
// columns, loads its bias once and keeps its column sums in registers over
// the rows it walks (four loads in flight), and the CTA's row lanes are
// merged in shared memory once, in a fixed order.
//
// Numerics: the JAX hand VJP's rounding points. The bias is rounded to the
// logits' dtype, added in float32 and the sum rounded to the dtype; p is
// exp(l - logz) (expf, as torch.exp), minus 1 at the label, times dsum * m,
// rounded to the dtype; dbias is the float32 column sum of those rounded
// values. Every row is computed, masked rows too. The forward's sum of exps
// is ex2.approx of x * log2(e) - max * log2(e), in an order of its own:
// logz differs from a two-pass logsumexp in the last bits. Sums in fixed
// orders and no atomics, and no order depends on the card: two runs give
// equal bits. A label outside [0, V) reads NaN as its gold
// logit, so the loss turns NaN, and subtracts nothing in the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kSlab = 64;         // vectors (scalar route: columns) a CTA owns
constexpr int kLanes = 4;         // row lanes of a backward CTA
constexpr int kChunk = 256;       // rows of a backward CTA: a partials row
constexpr int kUnroll = 4;        // loads a thread keeps in flight
constexpr int kSumThreadsX = 32;  // columns of a column-sum CTA
constexpr int kSumThreadsY = 8;   // slices of the chunks' partials
constexpr float kLog2e = 1.4426950408889634f;

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

// The biased logit as _biased32 forms it.
template <typename T, bool kBias>
__device__ __forceinline__ float biased(float logit, float rounded_bias) {
  return kBias ? Fmt<T>::round(logit + rounded_bias) : logit;
}

// The bias of columns c .. c + kVec - 1, rounded to T (c a multiple of
// kVec, the bias 16-byte aligned).
template <typename T, bool kBias>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          long long c, float* b) {
  constexpr int kVec = Fmt<T>::kVec;
  if (!kBias) return;
  const float4* b4 = reinterpret_cast<const float4*>(bias + c);
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    const float4 v = __ldg(b4 + k);
    b[4 * k] = v.x;
    b[4 * k + 1] = v.y;
    b[4 * k + 2] = v.z;
    b[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int e = 0; e < kVec; e += 2) Fmt<T>::round2(b[e], b[e + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max that returns NaN when either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// A lane's running (max m, m * log2(e), sum of exp(x - m)) after the N
// values x. NaN reaches the sum; -inf adds nothing.
template <int N>
__device__ __forceinline__ void absorb(float& m, float& ml, float& s,
                                       const float* x) {
  float vm = x[0];
#pragma unroll
  for (int e = 1; e < N; ++e) vm = max_nan(vm, x[e]);
  if (vm > m) {
    s *= ex2((m - vm) * kLog2e);
    m = vm;
    ml = vm * kLog2e;
  }
  if (vm != -INFINITY) {
#pragma unroll
    for (int e = 0; e < N; ++e) s += ex2(fmaf(x[e], kLog2e, -ml));
  }
}

__device__ __forceinline__ void running_merge(float& m, float& s, float m2,
                                              float s2) {
  const float mm = fmaxf(m, m2);
  const float a = m == -INFINITY ? s : s * __expf(m - mm);
  const float b = m2 == -INFINITY ? s2 : s2 * __expf(m2 - mm);
  m = mm;
  s = a + b;
}

// x = round(x + b) over N values (N = 1 or even), as biased() forms each.
template <typename T, int N>
__device__ __forceinline__ void add_bias(float* x, const float* b) {
  if (N == 1) {
    x[0] = Fmt<T>::round(x[0] + b[0]);
    return;
  }
#pragma unroll
  for (int e = 0; e + 1 < N; e += 2) {
    x[e] += b[e];
    x[e + 1] += b[e + 1];
    Fmt<T>::round2(x[e], x[e + 1]);
  }
}

// The kVec logits of a 16-byte vector of a row, as floats, biased.
template <typename T, bool kBias>
__device__ __forceinline__ void biased_vector(uint4 raw, const float* b,
                                              float* x) {
  Fmt<T>::unpack(raw, x);
  if (kBias) add_bias<T, Fmt<T>::kVec>(x, b);
}

template <typename T, bool kBias, bool kVector>
__global__ void __launch_bounds__(kFwdThreads)
ce_fwd_kernel(const T* __restrict__ logits, const float* __restrict__ bias,
              const long long* __restrict__ labels, long long rows, int V,
              float* __restrict__ logz, float* __restrict__ gold) {
  constexpr int kVec = Fmt<T>::kVec;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kFwdThreads / 32);
  const int nvec = V / kVec;
  for (long long r = (long long)blockIdx.x * (kFwdThreads / 32) +
                     (threadIdx.x >> 5);
       r < rows; r += warps) {
    const T* row = logits + r * V;
    float gold_l = NAN;  // loaded first, by lane 0
    if (lane == 0) {
      const long long lab = labels[r];
      if (lab >= 0 && lab < V)
        gold_l = biased<T, kBias>(Fmt<T>::get(row[lab]),
                                  kBias ? Fmt<T>::round(bias[lab]) : 0.f);
    }
    float m = -INFINITY, ml = -INFINITY, s = 0.f;
    if (kVector) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      // Batches of kUnroll vectors a lane, the next batch's loads issued
      // before this batch's arithmetic.
      constexpr int kStep = 32 * kUnroll;
      int j = lane;
      uint4 raw[kUnroll];
      if (j + kStep - 32 < nvec) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u] = __ldcs(row4 + j + 32 * u);
      }
      for (; j + kStep - 32 < nvec; j += kStep) {
        uint4 next[kUnroll];
        const bool more = j + 2 * kStep - 32 < nvec;
        if (more) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            next[u] = __ldcs(row4 + j + kStep + 32 * u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float b[kVec], x[kVec];
          load_bias<T, kBias>(bias, (long long)(j + 32 * u) * kVec, b);
          biased_vector<T, kBias>(raw[u], b, x);
          absorb<kVec>(m, ml, s, x);
        }
        if (more) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
        }
      }
      for (; j < nvec; j += 32) {
        float b[kVec], x[kVec];
        load_bias<T, kBias>(bias, (long long)j * kVec, b);
        biased_vector<T, kBias>(__ldcs(row4 + j), b, x);
        absorb<kVec>(m, ml, s, x);
      }
    } else {
      for (int c = lane; c < V; c += 32) {
        const float x = biased<T, kBias>(
            Fmt<T>::get(row[c]), kBias ? Fmt<T>::round(__ldg(bias + c)) : 0.f);
        absorb<1>(m, ml, s, &x);
      }
    }
    // The warp's (max, sum): a butterfly, whose merges are commutative, so
    // every lane holds the same bits.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      running_merge(m, s, m2, s2);
    }
    if (lane == 0) {
      logz[r] = m + logf(s);
      gold[r] = gold_l;
    }
  }
}

// The gradient of N columns from c of one row, from their biased logits x,
// in float32 (the caller rounds it); the label's column, when it is one of
// them, subtracts 1 from p first.
template <int N>
__device__ __forceinline__ void row_grad(const float* x, long long c,
                                         float lz, long long lab, float scale,
                                         float* d) {
  float p[N];
#pragma unroll
  for (int e = 0; e < N; ++e) p[e] = expf(x[e] - lz);
  const unsigned long long off = (unsigned long long)(lab - c);
  if (off < (unsigned long long)N) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if ((unsigned long long)e == off) p[e] -= 1.f;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = p[e] * scale;
}

// A unit of columns: one 16-byte vector (kVec columns) on the vector route,
// one column on the scalar route.
template <typename T, bool kVector>
struct Unit {
  static constexpr int kN = kVector ? Fmt<T>::kVec : 1;
  uint4 raw;
  T one;
  __device__ __forceinline__ void load(const T* p) {
    if (kVector) raw = __ldcs(reinterpret_cast<const uint4*>(p));
    else one = p[0];
  }
  __device__ __forceinline__ void unpack(float* x) const {
    if (kVector) Fmt<T>::unpack(raw, x);
    else x[0] = Fmt<T>::get(one);
  }
  // Stores d rounded to T at p, and leaves the rounded values in d.
  __device__ __forceinline__ static void store(T* p, float* d) {
    if (kVector) {
      const uint4 out = Fmt<T>::pack(d);
      __stcs(reinterpret_cast<uint4*>(p), out);
      Fmt<T>::unpack(out, d);
    } else {
      p[0] = Fmt<T>::put(d[0]);
      d[0] = Fmt<T>::round(d[0]);
    }
  }
};

template <typename T, bool kBias, bool kVector>
__global__ void __launch_bounds__(kSlab * kLanes)
ce_bwd_kernel(const T* __restrict__ logits, const float* __restrict__ bias,
              const long long* __restrict__ labels,
              const float* __restrict__ mask, const float* __restrict__ logz,
              const float* __restrict__ dsum, long long rows, int V,
              T* __restrict__ dlogits, float* __restrict__ partials) {
  using U = Unit<T, kVector>;
  constexpr int kN = U::kN;
  __shared__ float red[kBias ? kLanes - 1 : 1][kSlab][kN];
  const int units = V / kN;
  const int unit = blockIdx.x * kSlab + threadIdx.x;
  const bool active = unit < units;
  const long long c = (long long)unit * kN;
  const long long r0 = (long long)blockIdx.y * kChunk;
  const long long r1 = r0 + kChunk < rows ? r0 + kChunk : rows;
  const float ds = *dsum;
  float b[kN], acc[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) acc[e] = 0.f;
  if (active) {
    if (kBias) {
      if (kVector) load_bias<T, true>(bias, c, b);
      else b[0] = Fmt<T>::round(__ldg(bias + c));
    }
    for (long long r = r0 + threadIdx.y; r < r1; r += kLanes * kUnroll) {
      U in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + kLanes * u < r1) in[u].load(logits + (r + kLanes * u) * V + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + kLanes * u;
        if (ru >= r1) continue;
        float x[kN], d[kN];
        in[u].unpack(x);
        if (kBias) add_bias<T, kN>(x, b);
        row_grad<kN>(x, c, __ldg(logz + ru), __ldg(labels + ru),
                     ds * __ldg(mask + ru), d);
        U::store(dlogits + ru * V + c, d);
        if (kBias) {
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[e] += d[e];
        }
      }
    }
  }
  if (!kBias) return;
  // The row lanes' sums in lane order, into this chunk's partials row.
  if (threadIdx.y > 0) {
#pragma unroll
    for (int e = 0; e < kN; ++e) red[threadIdx.y - 1][threadIdx.x][e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    for (int y = 0; y < kLanes - 1; ++y) {
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] += red[y][threadIdx.x][e];
    }
    float* out = partials + (long long)blockIdx.y * V + c;
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = acc[e];
  }
}

// dbias[c] = the sum of the chunks' partials in chunk order: each thread of
// a column sums a slice of kSumThreadsY in order, then the slices in order.
__global__ void __launch_bounds__(kSumThreadsX * kSumThreadsY)
colsum_kernel(const float* __restrict__ partials, int n, int V,
              float* __restrict__ dbias) {
  __shared__ float red[kSumThreadsY][kSumThreadsX];
  const int c = blockIdx.x * kSumThreadsX + threadIdx.x;
  const int per = (n + kSumThreadsY - 1) / kSumThreadsY;
  const int g0 = threadIdx.y * per;
  const int g1 = g0 + per < n ? g0 + per : n;
  float s = 0.f;
  if (c < V) {
#pragma unroll 4
    for (int g = g0; g < g1; ++g) s += partials[(long long)g * V + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < V) {
    float t = red[0][threadIdx.x];
    for (int y = 1; y < kSumThreadsY; ++y) t += red[y][threadIdx.x];
    dbias[c] = t;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The vector route needs every row 16-byte aligned.
bool vector_route(const void* logits, const void* dlogits, const float* bias,
                  int V, size_t elem) {
  return aligned16(logits) && (dlogits == nullptr || aligned16(dlogits)) &&
         (bias == nullptr || aligned16(bias)) && (V * elem) % 16 == 0;
}

template <typename T, bool kBias, bool kVector>
int fwd_launch(const void* logits, const float* bias,
               const long long* labels, long long rows, int V, float* logz,
               float* gold, cudaStream_t stream) {
  auto kernel = ce_fwd_kernel<T, kBias, kVector>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kFwdThreads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (rows + kFwdThreads / 32 - 1) / (kFwdThreads / 32);
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > need) grid = need;
  kernel<<<(unsigned)grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(logits), bias, labels, rows, V, logz, gold);
  return (int)cudaGetLastError();
}

template <typename T, bool kBias, bool kVector>
int bwd_launch(const void* logits, const float* bias,
               const long long* labels, const float* mask, const float* logz,
               const float* dsum, long long rows, int V, void* dlogits,
               float* partials, float* dbias, cudaStream_t stream) {
  const int units = V / (kVector ? Fmt<T>::kVec : 1);
  const long long chunks = (rows + kChunk - 1) / kChunk;
  if (chunks > 0) {
    const dim3 grid((units + kSlab - 1) / kSlab, (unsigned)chunks);
    ce_bwd_kernel<T, kBias, kVector><<<grid, dim3(kSlab, kLanes), 0,
                                       stream>>>(
        static_cast<const T*>(logits), bias, labels, mask, logz, dsum, rows,
        V, static_cast<T*>(dlogits), partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!kBias) return 0;
  colsum_kernel<<<(V + kSumThreadsX - 1) / kSumThreadsX,
                  dim3(kSumThreadsX, kSumThreadsY), 0, stream>>>(
      partials, (int)chunks, V, dbias);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_dispatch(const void* logits, const float* bias,
                 const long long* labels, long long rows, int V, float* logz,
                 float* gold, cudaStream_t stream) {
  const bool vec = vector_route(logits, nullptr, bias, V, sizeof(T));
  if (bias != nullptr)
    return vec ? fwd_launch<T, true, true>(logits, bias, labels, rows, V,
                                           logz, gold, stream)
               : fwd_launch<T, true, false>(logits, bias, labels, rows, V,
                                            logz, gold, stream);
  return vec ? fwd_launch<T, false, true>(logits, bias, labels, rows, V, logz,
                                          gold, stream)
             : fwd_launch<T, false, false>(logits, bias, labels, rows, V,
                                           logz, gold, stream);
}

template <typename T>
int bwd_dispatch(const void* logits, const float* bias,
                 const long long* labels, const float* mask,
                 const float* logz, const float* dsum, long long rows, int V,
                 void* dlogits, float* partials, float* dbias,
                 cudaStream_t stream) {
  const bool vec = vector_route(logits, dlogits, bias, V, sizeof(T));
  if (bias != nullptr)
    return vec ? bwd_launch<T, true, true>(logits, bias, labels, mask, logz,
                                           dsum, rows, V, dlogits, partials,
                                           dbias, stream)
               : bwd_launch<T, true, false>(logits, bias, labels, mask, logz,
                                            dsum, rows, V, dlogits, partials,
                                            dbias, stream);
  return vec ? bwd_launch<T, false, true>(logits, bias, labels, mask, logz,
                                          dsum, rows, V, dlogits, partials,
                                          dbias, stream)
             : bwd_launch<T, false, false>(logits, bias, labels, mask, logz,
                                           dsum, rows, V, dlogits, partials,
                                           dbias, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bias: (V,) float32 or null. labels: (rows,)
// int64. logz, gold: (rows,) float32 outputs. Returns a CUDA error code.
extern "C" int rt_masked_ce_fwd(const void* logits, int dtype,
                                const float* bias, const long long* labels,
                                long long rows, int V, float* logz,
                                float* gold, void* stream) {
  if (V < 1 || rows < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? fwd_dispatch<__nv_bfloat16>(logits, bias, labels, rows, V,
                                           logz, gold, s)
             : fwd_dispatch<float>(logits, bias, labels, rows, V, logz, gold,
                                   s);
}

// mask, logz: (rows,) float32; dsum: one float32 on the card. dlogits:
// (rows, V) of the logits' dtype; with a bias, partials: (n_partials, V)
// float32 scratch, n_partials = ceil(rows / rt_masked_ce_row_chunk()), and
// dbias: (V,) float32 (both untouched without a bias). Returns a CUDA error
// code.
extern "C" int rt_masked_ce_bwd(const void* logits, int dtype,
                                const float* bias, const long long* labels,
                                const float* mask, const float* logz,
                                const float* dsum, long long rows, int V,
                                void* dlogits, float* partials,
                                long long n_partials, float* dbias,
                                void* stream) {
  if (V < 1 || rows < 0 || (dtype != 0 && dtype != 1) ||
      (bias != nullptr && n_partials != (rows + kChunk - 1) / kChunk) ||
      (rows + kChunk - 1) / kChunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? bwd_dispatch<__nv_bfloat16>(logits, bias, labels, mask, logz,
                                           dsum, rows, V, dlogits, partials,
                                           dbias, s)
             : bwd_dispatch<float>(logits, bias, labels, mask, logz, dsum,
                                   rows, V, dlogits, partials, dbias, s);
}

// The rows a backward CTA walks: one row of partials each.
extern "C" int rt_masked_ce_row_chunk() { return kChunk; }
