// The training optimizer's whole chain in one pass over the parameters,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's chain
// (scda_tpu/train/state.py), which XLA fuses into the step's program.
// Run eagerly (ops/kernels/sgd_kernel.py sgd_chain_plain, the CPU's path),
// the same chain costs two launches a tensor for the global norm, four foreach
// ops, five launches a tensor for momentum and update, and about 24 passes
// over the f32 parameters: some 750 launches a ResNet-101 step.  Here it
// is three launches a step, each over every trainable tensor at once:
//
//   1. sgd_norm_partial_kernel: block c sums g^2 over chunk c of the
//      clipped tensors (a prefix of the table) in double and writes the
//      sum to partials[c], a slot of its own: no atomics;
//   2. sgd_norm_finish_kernel: one block sums the partials in a fixed
//      order, takes the square root and writes {div, factor, norm} to
//      device memory (div = norm and factor = clip where norm >= clip,
//      else both 1), so the host never waits for the norm;
//   3. sgd_update_kernel: block c takes chunk c of any tensor, detector
//      and discriminator alike, and does each element in the eager
//      chain's order, each operation rounded on its own (the _rn
//      intrinsics, which nvcc never contracts into FMAs):
//        x = g / div * factor                  (clipped tensors)
//        x = x + p * decay                     (decayed tensors)
//        x = x * scale                         (doubled biases: 2)
//        trace = x + round_m(m * momentum)     (the product in m's dtype)
//        m = round_m(trace);  p = p + trace * (-lr)
//      m is float or bfloat16 per tensor (a template on the chunk's
//      type), so a bf16 momentum takes the same launch.
//
// A launch's parameter space holds kMaxTensors gradient pointers, more
// than any configuration trains (113 tensors at most: VGG16 with the SCDA
// discriminator); the wrapper refuses more.  The gradients' pointers change every step and go in as kernel
// parameters; the table of the parameters and momenta, which never move,
// and the chunk map are device arrays the wrapper builds once.
//
// Bound: bytes.  The norm reads g (4 B an element), the update reads g,
// p and m and writes p and m (20 B with an f32 momentum, 16 with bf16):
// 24 B an element, 3.3 GB a VGG16 step (136.6 M elements), 0.98 ms at
// 3.35 TB/s.  The design streams: 16-byte loads where the three
// pointers allow them (a scalar loop otherwise and for a chunk's tail),
// g read with the evict-first hint, 64 KB of g a block.  Repeats bit for
// bit: every sum is in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr long long kChunk = 16384;  // elements a block; a multiple of 4
constexpr int kMaxTensors = 400;     // 3.2 KB of the 4 KB parameter space

// TensorEntry::flags
constexpr int kClip = 1;   // in the norm; divided by div, times factor
constexpr int kBf16 = 2;   // momentum stored in bfloat16
constexpr int kPlain = 4;  // the plain group's momentum factor and rate

// One trainable tensor; the wrapper packs these with numpy (40 bytes).
struct TensorEntry {
  float* p;
  void* m;
  long long n;
  float decay;  // 0: no decay
  float scale;  // 1, or 2 for a doubled bias
  int flags;
  int pad;
};

struct Grads {
  const float* g[kMaxTensors];
};

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Sum over the block in a fixed order (lane shuffles, then the warps'
// sums by warp 0); the result is valid in thread 0.
template <int kBlock>
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ double sq(float v) {
  return static_cast<double>(v) * static_cast<double>(v);
}

__global__ void __launch_bounds__(kThreads)
sgd_norm_partial_kernel(Grads grads, const TensorEntry* __restrict__ tensors,
                        const int2* __restrict__ chunks,
                        double* __restrict__ partials) {
  const int c = blockIdx.x;
  const int2 ch = chunks[c];
  const float* g = grads.g[ch.x];
  const long long start = static_cast<long long>(ch.y) * kChunk;
  const long long end = min(start + kChunk, tensors[ch.x].n);
  double acc = 0.0;
  long long tail = start;
  if (aligned(g + start, 16)) {
    const float4* g4 = reinterpret_cast<const float4*>(g + start);
    const long long nv = (end - start) >> 2;
#pragma unroll 4
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      const float4 v = __ldcs(g4 + k);
      acc += sq(v.x) + sq(v.y) + sq(v.z) + sq(v.w);
    }
    tail = start + 4 * nv;
  }
  for (long long e = tail + threadIdx.x; e < end; e += kThreads) acc += sq(g[e]);
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[c] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
sgd_norm_finish_kernel(const double* __restrict__ partials, int count,
                       float clip, float* __restrict__ scal) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kFinishThreads) acc += partials[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(__double2float_rn(acc));
    const bool keep = norm < clip;  // false for a NaN norm, as eagerly
    scal[0] = keep ? 1.0f : norm;
    scal[1] = keep ? 1.0f : clip;
    scal[2] = norm;
  }
}

struct Coef {
  float div, factor, decay, scale, mom, neg_lr;
  bool clip, decayed, scaled;
};

template <typename M>
struct Mom;

template <>
struct Mom<float> {
  static constexpr uintptr_t kVecBytes = 16;
  __device__ static float round(float x) { return x; }
  __device__ static float get(const float* m, long long e) { return m[e]; }
  __device__ static void put(float* m, long long e, float x) { m[e] = x; }
  __device__ static void get4(const float* m, long long e, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(m + e);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void put4(float* m, long long e, const float* v) {
    *reinterpret_cast<float4*>(m + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Mom<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  static constexpr uintptr_t kVecBytes = 8;
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static float get(const T* m, long long e) {
    return __bfloat162float(m[e]);
  }
  __device__ static void put(T* m, long long e, float x) {
    m[e] = __float2bfloat16_rn(x);
  }
  __device__ static void get4(const T* m, long long e, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(m + e);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ static void put4(T* m, long long e, const float* v) {
    uint2 q;
    *reinterpret_cast<__nv_bfloat162*>(&q.x) =
        __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
    *reinterpret_cast<__nv_bfloat162*>(&q.y) =
        __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
    *reinterpret_cast<uint2*>(m + e) = q;
  }
};

// One element of the chain: p and m (m as a float holding its stored
// value) in, both updated; the caller stores m in its dtype.
template <typename M>
__device__ __forceinline__ void chain(float g, float& p, float& m, const Coef& c) {
  float x = g;
  if (c.clip) x = __fmul_rn(__fdiv_rn(x, c.div), c.factor);
  if (c.decayed) x = __fadd_rn(x, __fmul_rn(p, c.decay));
  if (c.scaled) x = __fmul_rn(x, c.scale);
  const float trace = __fadd_rn(x, Mom<M>::round(__fmul_rn(m, c.mom)));
  m = trace;
  p = __fadd_rn(p, __fmul_rn(trace, c.neg_lr));
}

template <typename M>
__device__ void update_chunk(const float* __restrict__ g, float* __restrict__ p,
                             M* __restrict__ m, long long start, long long end,
                             const Coef& c) {
  long long tail = start;
  if (aligned(g + start, 16) && aligned(p + start, 16) &&
      aligned(m + start, Mom<M>::kVecBytes)) {
    const long long nv = (end - start) >> 2;
#pragma unroll 2
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      const long long e = start + 4 * k;
      const float4 gv = __ldcs(reinterpret_cast<const float4*>(g + e));
      float4 pv = *reinterpret_cast<const float4*>(p + e);
      float mv[4];
      Mom<M>::get4(m, e, mv);
      chain<M>(gv.x, pv.x, mv[0], c);
      chain<M>(gv.y, pv.y, mv[1], c);
      chain<M>(gv.z, pv.z, mv[2], c);
      chain<M>(gv.w, pv.w, mv[3], c);
      *reinterpret_cast<float4*>(p + e) = pv;
      Mom<M>::put4(m, e, mv);
    }
    tail = start + 4 * nv;
  }
  for (long long e = tail + threadIdx.x; e < end; e += kThreads) {
    float pe = p[e], me = Mom<M>::get(m, e);
    chain<M>(g[e], pe, me, c);
    p[e] = pe;
    Mom<M>::put(m, e, me);
  }
}

__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(Grads grads, const TensorEntry* __restrict__ tensors,
                  const int2* __restrict__ chunks,
                  const float* __restrict__ scal, float mom0, float mom1,
                  float neg_lr0, float neg_lr1) {
  const int2 ch = chunks[blockIdx.x];
  const TensorEntry t = tensors[ch.x];
  const long long start = static_cast<long long>(ch.y) * kChunk;
  const long long end = min(start + kChunk, t.n);
  const bool plain = (t.flags & kPlain) != 0;
  Coef c;
  c.clip = (t.flags & kClip) != 0;
  c.div = c.clip ? scal[0] : 1.0f;
  c.factor = c.clip ? scal[1] : 1.0f;
  c.decay = t.decay;
  c.decayed = t.decay != 0.0f;
  c.scale = t.scale;
  c.scaled = t.scale != 1.0f;
  c.mom = plain ? mom1 : mom0;
  c.neg_lr = plain ? neg_lr1 : neg_lr0;
  const float* g = grads.g[ch.x];
  if (t.flags & kBf16) {
    update_chunk(g, t.p, static_cast<__nv_bfloat16*>(t.m), start, end, c);
  } else {
    update_chunk(g, t.p, static_cast<float*>(t.m), start, end, c);
  }
}

bool gather(Grads* out, const void* const* grads, int count) {
  if (count < 0 || count > kMaxTensors) return false;
  for (int i = 0; i < count; ++i) out->g[i] = static_cast<const float*>(grads[i]);
  return true;
}

}  // namespace

extern "C" long long scda_sgd_max_tensors() { return kMaxTensors; }

extern "C" long long scda_sgd_chunk() { return kChunk; }

// Partial sums of g^2 over chunks [0, nchunks) of the first count tensors,
// whose gradients are grads[0 .. count).
extern "C" int scda_sgd_norm(const void* const* grads, int count,
                             const void* tensors, const void* chunks,
                             int nchunks, void* partials, void* stream) {
  Grads g;
  if (!gather(&g, grads, count)) return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks <= 0) return static_cast<int>(cudaSuccess);
  sgd_norm_partial_kernel<<<nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const TensorEntry*>(tensors),
      static_cast<const int2*>(chunks), static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scda_sgd_norm_finish(const void* partials, int count, float clip,
                                    void* scal, void* stream) {
  sgd_norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), count, clip, static_cast<float*>(scal));
  return static_cast<int>(cudaGetLastError());
}

// The update over chunks [0, nchunks) of count tensors.  group 0's
// tensors take mom0 and neg_lr0, the plain group's mom1 and neg_lr1;
// scal is read only by clipped tensors.
extern "C" int scda_sgd_update(const void* const* grads, int count,
                               const void* tensors, const void* chunks,
                               int nchunks, const void* scal, float mom0,
                               float mom1, float neg_lr0, float neg_lr1,
                               void* stream) {
  Grads g;
  if (!gather(&g, grads, count)) return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks <= 0) return static_cast<int>(cudaSuccess);
  sgd_update_kernel<<<nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const TensorEntry*>(tensors),
      static_cast<const int2*>(chunks), static_cast<const float*>(scal),
      mom0, mom1, neg_lr0, neg_lr1);
  return static_cast<int>(cudaGetLastError());
}
