// The training step's update for Hopper (sm_90a): the division by the token
// count, the global-norm clip and AdamW over every parameter tensor in two
// launches.
//
//   rt_adamw_norm    one pass over the gradients (the step's raw sums):
//                    per chunk, its sum of squares into partials[chunk];
//   rt_adamw_update  every CTA first sums all the partials in one fixed
//                    order and reads the token count on the device, forms
//                    the clip factor, then applies torch.optim.AdamW's
//                    update to its chunks.
//
// Replaces no TPU kernel: the JAX package leaves its optax chain
// (clip_by_global_norm, then adamw: realise_tpu/training/optim.py) to XLA.
// The port ran it as PyTorch's per-tensor division and clip and
// torch.optim.AdamW's _foreach passes, about 3N + 8 chunked passes over N
// tensors: ~1,200 launches a step for arch3's 372 tensors, whose host time
// left the card idle.
//
// What bounds them: bytes. Per element the norm reads the gradient (4 B);
// the update reads gradient, parameter and both moments and writes the
// parameter and both moments (28 B): 32 B an element, 5.43 GB for arch3's
// 169.8 M elements, 1.62 ms at 3.35 TB/s. Besides, only the tables (40 B a
// tensor, 16 B a chunk) and the partials (4 B a chunk, from L2).
//
// What the design does about it: 16-byte loads and stores wherever the
// tensors are 16-byte aligned (a chunk starts at a multiple of its size, so
// the chunks of an aligned tensor are aligned), a scalar tail; a grid of
// resident CTAs (the SMs times the CTAs each holds) that walks over the
// chunks, so each CTA reduces the partials once; chunks of 32 K elements,
// so that arch3's ~5,500 spread evenly over ~1,000 CTAs. The gradient is
// divided and clipped as it is read and never written back.
//
// Tables: the parameters' and moments' pointers, sizes and groups are a
// device table built once per optimizer (rebuilt when the state tensors
// change); the gradients, new tensors every step, travel by value in the
// launch's argument block, up to kMaxTensors a launch (a longer list takes
// one launch of each kernel per slice). Under tensor parallelism the split
// tensors come first, so their chunks' partials are one range that the
// trainer all-reduces over the model group between the two launches.
//
// Numerics: float32 throughout. The gradient is (g / count) * factor, the
// plain path's division and then its clip multiply, with factor =
// (1 / norm) * max_norm when norm >= max_norm (optax's rule; norm =
// sqrt(sum of squares) / count, the divided gradient's norm; no + 1e-6).
// Then torch.optim.AdamW in its order: p *= 1 - lr * wd; m lerps to g by
// 1 - beta1; v = v * beta2 + (1 - beta2) * g * g;
// p += -lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps). Sums in fixed orders and
// no atomics: two runs give equal bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTensors = 448;  // 3,584 B of gradient pointers a launch
constexpr int kMaxGroups = 8;

// One row of the tensor table (int64 words, built by the Python wrapper).
struct Tensor {
  float* p;
  float* m;
  float* v;
  long long n;
  long long group;
};

// One row of the chunk table: a tensor's index and the chunk's first element.
struct Chunk {
  long long tensor;
  long long start;
};

struct Grads {
  const float* g[kMaxTensors];
};

// Per parameter group, the update's float32 scalars (host-evaluated).
struct Groups {
  float decay[kMaxGroups];     // 1 - lr * weight_decay
  float w1[kMaxGroups];        // 1 - beta1, the first moment's lerp weight
  float beta2[kMaxGroups];
  float w2[kMaxGroups];        // 1 - beta2
  float step[kMaxGroups];      // -lr / (1 - beta1^t)
  float bc2_sqrt[kMaxGroups];  // sqrt(1 - beta2^t)
  float eps[kMaxGroups];
};
constexpr int kGroupFields = 7;

// The sum over the CTA in a fixed order: a butterfly in each warp, then the
// warps' sums in order by thread 0. Valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is reused from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float squares(float4 a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}

// The elements of a chunk that starts ``left`` elements before its
// tensor's end.
__device__ __forceinline__ int chunk_size(long long left, int chunk) {
  return left < chunk ? (int)left : chunk;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
norm_kernel(Grads grads, const Tensor* __restrict__ tensors,
            const Chunk* __restrict__ chunks, int first, int c0, int c1,
            int chunk, float* __restrict__ partials) {
  __shared__ float red[kWarps];
  for (int c = c0 + blockIdx.x; c < c1; c += gridDim.x) {
    const Chunk ch = chunks[c];
    const float* g = grads.g[ch.tensor - first] + ch.start;
    const int n = chunk_size(tensors[ch.tensor].n - ch.start, chunk);
    float acc = 0.f;
    int tail = 0;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int n4 = n >> 2;
      int j = threadIdx.x;
      for (; j + 3 * kThreads < n4; j += 4 * kThreads) {  // 4 loads in flight
        const float4 a = g4[j], b = g4[j + kThreads];
        const float4 d = g4[j + 2 * kThreads], e = g4[j + 3 * kThreads];
        acc += squares(a) + squares(b) + squares(d) + squares(e);
      }
      for (; j < n4; j += kThreads) acc += squares(g4[j]);
      tail = n4 << 2;
    }
    for (int k = tail + threadIdx.x; k < n; k += kThreads) acc += g[k] * g[k];
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) partials[c] = acc;
  }
}

struct Hyper {
  float decay, w1, beta2, w2, step, bc2_sqrt, eps;
};

__device__ __forceinline__ void adamw(float g, float& p, float& m, float& v,
                                      float count, float factor,
                                      const Hyper& h) {
  g = (g / count) * factor;
  p = p * h.decay;
  m = m + h.w1 * (g - m);
  v = v * h.beta2;
  v = v + h.w2 * (g * g);
  p = p + h.step * (m / (sqrtf(v) / h.bc2_sqrt + h.eps));
}

__global__ void __launch_bounds__(kThreads)
update_kernel(Grads grads, const Tensor* __restrict__ tensors,
              const Chunk* __restrict__ chunks, int first, int c0, int c1,
              int chunk, const float* __restrict__ partials, int n_partials,
              const float* __restrict__ count, float max_norm, int clip,
              Groups groups, float* __restrict__ norm_out) {
  __shared__ float red[kWarps];
  __shared__ float scale[2];
  float sum = 0.f;
  if (clip) {
    for (int k = threadIdx.x; k < n_partials; k += kThreads) sum += partials[k];
    sum = block_sum(sum, red);
  }
  if (threadIdx.x == 0) {
    const float cnt = count ? fmaxf(*count, 1.f) : 1.f;
    float factor = 1.f;
    if (clip) {
      const float norm = sqrtf(sum) / cnt;
      factor = norm < max_norm ? 1.f : (1.f / norm) * max_norm;
      if (norm_out && blockIdx.x == 0) *norm_out = norm;
    }
    scale[0] = cnt;
    scale[1] = factor;
  }
  __syncthreads();
  const float cnt = scale[0], factor = scale[1];
  for (int c = c0 + blockIdx.x; c < c1; c += gridDim.x) {
    const Chunk ch = chunks[c];
    const Tensor t = tensors[ch.tensor];
    const int gi = (int)t.group;
    const Hyper h = {groups.decay[gi], groups.w1[gi],   groups.beta2[gi],
                     groups.w2[gi],    groups.step[gi], groups.bc2_sqrt[gi],
                     groups.eps[gi]};
    const float* g = grads.g[ch.tensor - first] + ch.start;
    float* p = t.p + ch.start;
    float* m = t.m + ch.start;
    float* v = t.v + ch.start;
    const int n = chunk_size(t.n - ch.start, chunk);
    int tail = 0;
    if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v)) {
      const int n4 = n >> 2;
      for (int j = threadIdx.x; j < n4; j += kThreads) {
        const float4 G = reinterpret_cast<const float4*>(g)[j];
        float4 P = reinterpret_cast<float4*>(p)[j];
        float4 M = reinterpret_cast<float4*>(m)[j];
        float4 V = reinterpret_cast<float4*>(v)[j];
        adamw(G.x, P.x, M.x, V.x, cnt, factor, h);
        adamw(G.y, P.y, M.y, V.y, cnt, factor, h);
        adamw(G.z, P.z, M.z, V.z, cnt, factor, h);
        adamw(G.w, P.w, M.w, V.w, cnt, factor, h);
        reinterpret_cast<float4*>(p)[j] = P;
        reinterpret_cast<float4*>(m)[j] = M;
        reinterpret_cast<float4*>(v)[j] = V;
      }
      tail = n4 << 2;
    }
    for (int k = tail + threadIdx.x; k < n; k += kThreads) {
      float P = p[k], M = m[k], V = v[k];
      adamw(g[k], P, M, V, cnt, factor, h);
      p[k] = P;
      m[k] = M;
      v[k] = V;
    }
  }
}

// Resident CTAs of a kernel on the current device: its SMs times the CTAs
// one SM holds; no more than the chunks.
template <typename K>
int grid_for(K kernel, int chunks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  return grid < chunks ? grid : chunks;
}

Grads gradient_args(const void* const* grads, int n) {
  Grads out = {};
  for (int i = 0; i < n; ++i) out.g[i] = static_cast<const float*>(grads[i]);
  return out;
}

}  // namespace

// grads: the pointers of tensors first .. first + n_tensors - 1 (table
// order); c0 .. c1 - 1 their chunks. Returns 0 or the CUDA error code.
extern "C" int rt_adamw_norm(const void* const* grads, int first, int n_tensors,
                             const void* tensors, const void* chunks, int c0,
                             int c1, int chunk, void* partials, void* stream) {
  if (n_tensors < 0 || n_tensors > kMaxTensors || chunk % 4)
    return (int)cudaErrorInvalidValue;
  if (c1 <= c0) return 0;
  norm_kernel<<<grid_for(norm_kernel, c1 - c0), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      gradient_args(grads, n_tensors), static_cast<const Tensor*>(tensors),
      static_cast<const Chunk*>(chunks), first, c0, c1, chunk,
      static_cast<float*>(partials));
  return (int)cudaGetLastError();
}

// As rt_adamw_norm, plus: partials (n_partials, every chunk's, reduced
// only when clip != 0), count (a float32 scalar on the device, or null for
// 1), the group scalars (kGroupFields rows of n_groups, in Groups' order)
// and norm_out (the norm, written by CTA 0 when clipping, or null).
extern "C" int rt_adamw_update(const void* const* grads, int first,
                               int n_tensors, const void* tensors,
                               const void* chunks, int c0, int c1, int chunk,
                               const void* partials, int n_partials,
                               const void* count, float max_norm, int clip,
                               const float* group_scalars, int n_groups,
                               void* norm_out, void* stream) {
  if (n_tensors < 0 || n_tensors > kMaxTensors || chunk % 4 || n_groups < 1 ||
      n_groups > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  if (c1 <= c0) return 0;
  Groups groups = {};
  float* fields[kGroupFields] = {groups.decay, groups.w1,   groups.beta2,
                                 groups.w2,    groups.step, groups.bc2_sqrt,
                                 groups.eps};
  for (int f = 0; f < kGroupFields; ++f)
    for (int i = 0; i < n_groups; ++i)
      fields[f][i] = group_scalars[f * n_groups + i];
  update_kernel<<<grid_for(update_kernel, c1 - c0), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      gradient_args(grads, n_tensors), static_cast<const Tensor*>(tensors),
      static_cast<const Chunk*>(chunks), first, c0, c1, chunk,
      static_cast<const float*>(partials), n_partials,
      static_cast<const float*>(count), max_norm, clip, groups,
      static_cast<float*>(norm_out));
  return (int)cudaGetLastError();
}

// The launch-argument limit the Python wrapper slices by.
extern "C" int rt_adamw_max_tensors() { return kMaxTensors; }
extern "C" int rt_adamw_max_groups() { return kMaxGroups; }
