// RoI-Align as a separable double contraction, for Hopper (sm_90a):
//
//   out[b,r,p,q,c] = sum_w wx[b,r,q,w] * sum_h wy[b,r,p,h] * feat[b,h,w,c]
//
// Replaces scda_tpu/ops/pallas/roi_align_kernel.py:roi_align_contract
// (forward).  The weights hold all sampling semantics (torchvision align,
// adaptive sampling, the reference's legacy align), so one kernel serves
// every mode.  The TPU kernel runs both contractions as dense MXU
// matmuls over whole weight rows.  On the GPU that would be wasted work:
// a weight row has at most 2*S nonzero taps (S samples per bin edge; 4
// on the paths) out of H or W.
//
// What bounds it on the H100 is not bytes but latency: the map (a few MB)
// sits in L2 and the output is written once, yet a thread that reads one
// channel per tap inside loops of run-time length keeps few loads in
// flight.  So:
//   * one block per (b, r) and channel slice compacts the nonzero taps of
//     the roi's 2*P weight rows ONCE (a warp per row, ballot + popc, in
//     index order) into shared memory, as offsets into the map;
//   * a thread owns 16 bytes of channels (8 bf16 or 4 f32) of one bin
//     (p, q).  Where every row of the roi has at most kTaps = 4 taps (the
//     sampling modes of the paths), the 4 x 4 tap loops are unrolled with
//     predicated loads, so up to 16 independent 16-byte loads go out back
//     to back; a roi with a longer row (adaptive sampling, dense weights)
//     takes the general loops over the same lists, still exact;
//   * sums are f32, h inside w as the twin contracts, and leave as
//     16-byte stores.
// A channel count that is no multiple of the vector, or a pointer off
// 16 bytes, takes the same kernel at one channel per thread.
//
// The backward (JAX computes it as two einsums in _contract_bwd, no
// Pallas call) is the transpose of the same sparse map:
//
//   dfeat[b,h,w,c] = sum_{r,p,q} wy[b,r,p,h] * wx[b,r,q,w] * g[b,r,p,q,c]
//
// The einsum form materialises a (B, R, P, W, C) f32 intermediate (117 MB
// per VGG16 training image).  Here rois add into an f32 dfeat with
// atomics, and what bounds a scatter of wy*wx*g per tap pair is the bytes
// those atomics move through L2 (16 pairs per bin and channel; scalar and
// float4 atomics both ran at about 5.9 TB/s of them).  So the kernel
// sends fewer: a block per (b, r) and 64-channel slice stages its slice
// of g in shared memory, lists the pixels the roi touches with the bins
// that reach each, sums a pixel's contributions in registers and adds
// them to dfeat once, four channels per vector reduction (atomicAdd on
// float4, red.global.add.v4.f32 on compute capability 9.0).  The bins of
// a roi overlap on the map (two samples a bin, two taps a sample), so a
// pixel gets one reduction per roi instead of one per tap pair.  Rois of
// one image overlap too, so the order of the adds (and the f32 rounding)
// changes from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 4;   // taps a row may have on the unrolled path

// ---- 16 bytes of channels ------------------------------------------------

// Raw holds the bytes as loaded (so that 16 loads in flight cost 64
// registers, not 128); unpack() widens them to f32.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
  }
};

template <>
struct Vec<float, 1> {
  float raw;
  __device__ __forceinline__ void load(const float* p) { raw = *p; }
  __device__ __forceinline__ void unpack(float* v) const { v[0] = raw; }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float* v) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __nv_bfloat16 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { raw = *p; }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = __bfloat162float(raw);
  }
};

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// ---- the taps of one roi ---------------------------------------------------

// Compact the nonzero entries of src[0:len] into (off, val), in order;
// off is the entry's index times `stride`.  Called by one whole warp;
// returns the count in every lane.
__device__ __forceinline__ int compact_row(const float* __restrict__ src,
                                           int len, int stride, int* off,
                                           float* val, int lane) {
  int total = 0;
  for (int base = 0; base < len; base += 128) {
    float v[4];   // four loads in flight before the first ballot
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + 32 * u + lane;
      v[u] = i < len ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned nz = __ballot_sync(0xffffffffu, v[u] != 0.0f);
      if (v[u] != 0.0f) {
        const int pos = total + __popc(nz & ((1u << lane) - 1u));
        off[pos] = (base + 32 * u + lane) * stride;
        val[pos] = v[u];
      }
      total += __popc(nz);
    }
  }
  return total;
}

// The roi's tap lists in shared memory: row j < P is wy[b,r,j,:] (offsets
// h*W*C, capacity H), row P + j is wx[b,r,j,:] (offsets w*C, capacity W).
struct Taps {
  int* h_off;
  float* h_val;
  int* w_off;
  float* w_val;
  int* counts;   // 2 * P, then the longest row
};

__device__ __forceinline__ Taps compact_roi(int4* smem_raw,
                                            const float* __restrict__ wy,
                                            const float* __restrict__ wx,
                                            size_t br, int P, int H, int W,
                                            int C) {
  Taps t;
  t.h_off = reinterpret_cast<int*>(smem_raw);                  // P * H
  t.h_val = reinterpret_cast<float*>(t.h_off + P * H);         // P * H
  t.w_off = reinterpret_cast<int*>(t.h_val + P * H);           // P * W
  t.w_val = reinterpret_cast<float*>(t.w_off + P * W);         // P * W
  t.counts = reinterpret_cast<int*>(t.w_val + P * W);          // 2 * P + 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (threadIdx.x == 0) t.counts[2 * P] = 0;
  __syncthreads();
  for (int job = warp; job < 2 * P; job += warps) {
    int n;
    if (job < P) {
      n = compact_row(wy + (br * P + job) * H, H, W * C, t.h_off + job * H,
                      t.h_val + job * H, lane);
    } else {
      const int q = job - P;
      n = compact_row(wx + (br * P + q) * W, W, C, t.w_off + q * W,
                      t.w_val + q * W, lane);
    }
    if (lane == 0) {
      t.counts[job] = n;
      atomicMax(&t.counts[2 * P], n);
    }
  }
  __syncthreads();
  return t;
}

size_t tap_smem(int P, int H, int W) {
  return static_cast<size_t>(P) * (H + W) * (sizeof(int) + sizeof(float)) +
         (2 * P + 1) * sizeof(int);
}

// ---- forward -----------------------------------------------------------------

// Grid (B * R, channel slices).  A slice is `cvecs` vectors of V channels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_contract_kernel(const float* __restrict__ wy,
                          const float* __restrict__ wx,
                          const T* __restrict__ feat, float* __restrict__ out,
                          int R, int P, int H, int W, int C, int cvecs) {
  extern __shared__ int4 smem_raw[];
  const size_t br = blockIdx.x;
  const int b = static_cast<int>(br / R);
  const Taps t = compact_roi(smem_raw, wy, wx, br, P, H, W, C);

  const int c0 = blockIdx.y * cvecs * V;
  const int nvec = min(cvecs, (C - c0) / V);
  const T* fb = feat + static_cast<size_t>(b) * H * W * C + c0;
  float* ob = out + br * P * P * C + c0;
  const int items = P * P * nvec;
  const bool sparse = t.counts[2 * P] <= kTaps;

  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int bin = item / nvec, vec = item - bin * nvec;
    const int p = bin / P, q = bin - p * P;
    const int nh = t.counts[p], nw = t.counts[P + q];
    const int* ho = t.h_off + p * H;
    const float* hv = t.h_val + p * H;
    const int* wo = t.w_off + q * W;
    const float* wv = t.w_val + q * W;
    const T* src = fb + vec * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;

    if (sparse) {
      Vec<T, V> x[kTaps][kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int m = 0; m < kTaps; ++m) {
          if (k < nw && m < nh) x[k][m].load(src + ho[m] + wo[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        if (k < nw) {
          float s[V];
#pragma unroll
          for (int i = 0; i < V; ++i) s[i] = 0.0f;
#pragma unroll
          for (int m = 0; m < kTaps; ++m) {
            if (m < nh) {
              const float hw = hv[m];
              float xv[V];
              x[k][m].unpack(xv);
#pragma unroll
              for (int i = 0; i < V; ++i) s[i] = fmaf(hw, xv[i], s[i]);
            }
          }
          const float ww = wv[k];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(ww, s[i], acc[i]);
        }
      }
    } else {
      for (int k = 0; k < nw; ++k) {
        const T* col = src + wo[k];
        float s[V];
#pragma unroll
        for (int i = 0; i < V; ++i) s[i] = 0.0f;
        for (int m = 0; m < nh; ++m) {
          Vec<T, V> x;
          x.load(col + ho[m]);
          const float hw = hv[m];
          float xv[V];
          x.unpack(xv);
#pragma unroll
          for (int i = 0; i < V; ++i) s[i] = fmaf(hw, xv[i], s[i]);
        }
        const float ww = wv[k];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(ww, s[i], acc[i]);
      }
    }
    store_f32<V>(ob + static_cast<size_t>(bin) * C + vec * V, acc);
  }
}

// ---- backward ------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void add_f32(float* p, const float* v) {
  if constexpr (V == 1) {
    atomicAdd(p, v[0]);
  } else {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  }
}

constexpr int kBwdChannels = 64;   // channels of g a block stages

// The transpose of a (P, len) weight matrix as lists: for every column
// with a nonzero, in order, its offset index * stride and its (p, weight)
// entries.  Called by one whole warp; returns the number of columns.
struct ColumnLists {
  int* off;      // len: offset of the column's pixels in the map
  int* first;    // len: the column's first entry
  int* count;    // len: its entries
  int* ent_p;    // P * len
  float* ent_w;  // P * len
};

__device__ __forceinline__ int list_columns(const float* __restrict__ src,
                                            int P, int len, int stride,
                                            const ColumnLists& l, int lane) {
  int columns = 0, entries = 0;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    int cnt = 0;
    if (i < len) {
      for (int p = 0; p < P; ++p) cnt += src[p * len + i] != 0.0f;
    }
    int upto = cnt;                      // inclusive scan over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += x;
    }
    const unsigned nz = __ballot_sync(0xffffffffu, cnt > 0);
    if (cnt > 0) {
      const int pos = columns + __popc(nz & ((1u << lane) - 1u));
      int e = entries + upto - cnt;
      l.off[pos] = i * stride;
      l.first[pos] = e;
      l.count[pos] = cnt;
      for (int p = 0; p < P; ++p) {
        const float v = src[p * len + i];
        if (v != 0.0f) {
          l.ent_p[e] = p;
          l.ent_w[e] = v;
          ++e;
        }
      }
    }
    entries += __shfl_sync(0xffffffffu, upto, 31);
    columns += __popc(nz);
  }
  return columns;
}

// dfeat must be zero on entry; every block adds its roi's share of one
// channel slice.  Grid (B * R, channel slices of `cvecs` vectors).
//
// The transpose is taken as a gather.  The block stages its slice of
// g[b,r] in shared memory and lists the map rows and columns the roi
// touches, each with the bins (p or q, weight) that reach it.  A thread
// then owns V channels of one touched pixel (h, w), sums
//   sum_{p at h} wy[p,h] * sum_{q at w} wx[q,w] * g[p,q,:]
// from shared memory, and adds the sum to dfeat once.
template <int V>
__global__ void __launch_bounds__(kThreads)
roi_align_contract_bwd_kernel(const float* __restrict__ wy,
                              const float* __restrict__ wx,
                              const float* __restrict__ g,
                              float* __restrict__ dfeat, int R, int P, int H,
                              int W, int C, int cvecs) {
  extern __shared__ int4 smem_raw[];
  const int stride = cvecs * V;                        // floats a bin
  float* gs = reinterpret_cast<float*>(smem_raw);      // P * P * stride
  int* ints = reinterpret_cast<int*>(gs + P * P * stride);
  ColumnLists hl, wl;
  hl.off = ints;
  hl.first = hl.off + H;
  hl.count = hl.first + H;
  hl.ent_p = hl.count + H;
  wl.off = hl.ent_p + P * H;
  wl.first = wl.off + W;
  wl.count = wl.first + W;
  wl.ent_p = wl.count + W;
  hl.ent_w = reinterpret_cast<float*>(wl.ent_p + P * W);
  wl.ent_w = hl.ent_w + P * H;
  int* counts = reinterpret_cast<int*>(wl.ent_w + P * W);   // 2

  const size_t br = blockIdx.x;
  const int b = static_cast<int>(br / R);
  const int c0 = blockIdx.y * stride;
  const int nvec = min(cvecs, (C - c0) / V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* gb = g + br * P * P * C + c0;
  for (int item = threadIdx.x; item < P * P * nvec; item += kThreads) {
    const int bin = item / nvec, vec = item - bin * nvec;
    Vec<float, V> x;
    x.load(gb + static_cast<size_t>(bin) * C + vec * V);
    x.unpack(gs + bin * stride + vec * V);
  }
  if (warp == 0) {
    const int n = list_columns(wy + br * P * H, P, H, W * C, hl, lane);
    if (lane == 0) counts[0] = n;
  } else if (warp == 1) {
    const int n = list_columns(wx + br * P * W, P, W, C, wl, lane);
    if (lane == 0) counts[1] = n;
  }
  __syncthreads();

  const int nh = counts[0], nw = counts[1];
  float* db = dfeat + static_cast<size_t>(b) * H * W * C + c0;
  // nvec lanes run along the channels; the groups of nvec threads walk
  // the touched pixels row-major, (i, j) kept by carry, not by division.
  const int ngroups = kThreads / nvec;
  const int group = threadIdx.x / nvec, vec = threadIdx.x - group * nvec;
  if (group >= ngroups || nh == 0 || nw == 0) return;
  const float* gv = gs + vec * V;
  int i = group / nw, j = group - i * nw;
  for (int pix = group; pix < nh * nw; pix += ngroups) {
    const int h0 = hl.first[i], h1 = h0 + hl.count[i];
    const int w0 = wl.first[j], w1 = w0 + wl.count[j];
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int a = h0; a < h1; ++a) {
      const float* gp = gv + hl.ent_p[a] * P * stride;
      float t[V];
#pragma unroll
      for (int k = 0; k < V; ++k) t[k] = 0.0f;
      for (int e = w0; e < w1; ++e) {
        Vec<float, V> gq;      // one 16-byte read of shared memory
        gq.load(gp + wl.ent_p[e] * stride);
        float gk[V];
        gq.unpack(gk);
        const float bq = wl.ent_w[e];
#pragma unroll
        for (int k = 0; k < V; ++k) t[k] = fmaf(bq, gk[k], t[k]);
      }
      const float aw = hl.ent_w[a];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(aw, t[k], acc[k]);
    }
    add_f32<V>(db + hl.off[i] + wl.off[j] + vec * V, acc);
    j += ngroups;
    while (j >= nw) {
      j -= nw;
      ++i;
    }
  }
}

size_t bwd_smem(int P, int H, int W, int stride) {
  return (static_cast<size_t>(P) * P * stride + (H + W) * (3 + 2 * P) + 2) *
         sizeof(float);
}

// ---- launches ----------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Channel slices: enough blocks to fill the card's 132 SMs a few times
// over, a slice no narrower than a warp of vectors.
int channel_slices(long long rois, int vecs) {
  int slices = 1;
  while (rois * slices < 1024 && vecs / (slices * 2) >= 32 &&
         vecs % (slices * 2) == 0)
    slices *= 2;
  return slices;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

template <typename T, int V>
int launch_fwd(const void* wy, const void* wx, const void* feat, void* out,
               int B, int R, int P, int H, int W, int C, cudaStream_t s) {
  const size_t smem = tap_smem(P, H, W);
  cudaError_t e = allow_smem(roi_align_contract_kernel<T, V>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rois = static_cast<long long>(B) * R;
  const int vecs = C / V;
  const int slices = channel_slices(rois, vecs);
  roi_align_contract_kernel<T, V>
      <<<dim3(static_cast<unsigned>(rois), slices), kThreads, smem, s>>>(
          static_cast<const float*>(wy), static_cast<const float*>(wx),
          static_cast<const T*>(feat), static_cast<float*>(out), R, P, H, W,
          C, vecs / slices);
  return static_cast<int>(cudaGetLastError());
}

// Tap offsets into one image's map are ints.
bool map_fits(int H, int W, int C) {
  return static_cast<long long>(H) * W * C < (1LL << 31);
}

template <typename T>
int launch(const void* wy, const void* wx, const void* feat, void* out, int B,
           int R, int P, int H, int W, int C, void* stream) {
  if (B <= 0 || R <= 0 || P <= 0 || C <= 0) return cudaSuccess;
  if (!map_fits(H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % kVec == 0 && aligned16(feat) && aligned16(out))
    return launch_fwd<T, kVec>(wy, wx, feat, out, B, R, P, H, W, C, s);
  return launch_fwd<T, 1>(wy, wx, feat, out, B, R, P, H, W, C, s);
}

template <int V>
int launch_bwd_v(const void* wy, const void* wx, const void* g, void* dfeat,
                 int B, int R, int P, int H, int W, int C, cudaStream_t s) {
  const int vecs = C / V;
  const int cvecs = vecs < kBwdChannels / V ? vecs : kBwdChannels / V;
  const size_t smem = bwd_smem(P, H, W, cvecs * V);
  cudaError_t e = allow_smem(roi_align_contract_bwd_kernel<V>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rois = static_cast<long long>(B) * R;
  roi_align_contract_bwd_kernel<V>
      <<<dim3(static_cast<unsigned>(rois), (vecs + cvecs - 1) / cvecs),
         kThreads, smem, s>>>(
          static_cast<const float*>(wy), static_cast<const float*>(wx),
          static_cast<const float*>(g), static_cast<float*>(dfeat), R, P, H,
          W, C, cvecs);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const void* wy, const void* wx, const void* g, void* dfeat,
               int B, int R, int P, int H, int W, int C, void* stream) {
  if (B <= 0 || R <= 0 || P <= 0 || C <= 0) return cudaSuccess;
  if (!map_fits(H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && aligned16(g) && aligned16(dfeat))
    return launch_bwd_v<4>(wy, wx, g, dfeat, B, R, P, H, W, C, s);
  return launch_bwd_v<1>(wy, wx, g, dfeat, B, R, P, H, W, C, s);
}

}  // namespace

// wy (B,R,P,H) f32, wx (B,R,P,W) f32, feat (B,H,W,C), out (B,R,P,P,C) f32.
extern "C" int scda_roi_align_contract_f32(const void* wy, const void* wx,
                                           const void* feat, void* out, int B,
                                           int R, int P, int H, int W, int C,
                                           void* stream) {
  return launch<float>(wy, wx, feat, out, B, R, P, H, W, C, stream);
}

extern "C" int scda_roi_align_contract_bf16(const void* wy, const void* wx,
                                            const void* feat, void* out, int B,
                                            int R, int P, int H, int W, int C,
                                            void* stream) {
  return launch<__nv_bfloat16>(wy, wx, feat, out, B, R, P, H, W, C, stream);
}

// wy (B,R,P,H) f32, wx (B,R,P,W) f32, g (B,R,P,P,C) f32, dfeat (B,H,W,C)
// f32, zeroed by the caller.
extern "C" int scda_roi_align_contract_bwd(const void* wy, const void* wx,
                                           const void* g, void* dfeat, int B,
                                           int R, int P, int H, int W, int C,
                                           void* stream) {
  return launch_bwd(wy, wx, g, dfeat, B, R, P, H, W, C, stream);
}
