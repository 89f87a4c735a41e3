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
//   dfeat[b,h,w,c] = sum_r sum_{p at h} wy[b,r,p,h]
//                          * sum_{q at w} wx[b,r,q,w] * g[b,r,p,q,c]
//
// The einsum form materialises a (B, R, P, W, C) f32 intermediate (117 MB
// per VGG16 training image).  A scatter of each roi's share into dfeat
// needs atomics, and rois of one image overlap on the map, so the order
// of the f32 adds, and the rounding of dfeat, would change from run to
// run.  Here every dfeat element is computed by one thread, in an order
// fixed by the code, and stored once, in the caller's dtype: two
// launches on the same inputs give the same bits.  It is a gather:
//   * a prep kernel (a warp per roi) lists, for every map row h, the bins
//     p whose weight row reaches it (in p order, with the weight and the
//     offset of g[b,r,p,:,:]), the same for every map column w and bin q,
//     and the rectangle of rows and columns the roi touches.  A list
//     holds at most P entries whatever the sampling mode;
//   * the main kernel gives a block one image, a tile of kTileH x kTileW
//     pixels and 32 * V channels (V = 4 f32 where the channels allow), a
//     warp one pixel at a time and a lane V channels.  The block lists,
//     in r order, the rois whose rectangle meets its tile (ballots, no
//     atomics); each warp then walks them, and for each the bins of its
//     pixel's row and column, r ascending, then p, then q, summing
//     wx * g over q and wy times that over p in f32 registers;
//   * each pixel's channels are written once, every pixel of the map
//     included (zero where no roi reaches), so the output needs no
//     memset and no cast afterwards.
// What bounds it: the g rows it gathers come from L2 and L1 (a bin's g
// row is read for each of the up to 4 x 4 pixels its taps reach), not
// the bytes it must move (g once, dfeat once).
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

constexpr int kPrepWarps = 4;            // rois a prep block lists
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 2, kTileW = 8;    // map pixels a backward block owns
constexpr int kPixPerWarp = kTileH * kTileW / kWarps;
static_assert(kTileH * kTileW == kPixPerWarp * kWarps, "tile per warp");

// The transposed weights of every roi br = b * R + r (scratch the caller
// allocates, laid out by bwd_layout):
//   range[br]                int4: first and last map row, first and last
//                            map column the roi reaches (first > last: none)
//   hn[br * H + h]           how many bins p have wy[b,r,p,h] != 0
//   he[(br * H + h) * P + k] int2 (p * P * C, bits of wy[b,r,p,h]), k < hn,
//                            in p order
//   wn, we                   the same for the columns: (q * C, wx[b,r,q,w])
struct BwdLists {
  int4* range;
  int2* he;
  int2* we;
  int* hn;
  int* wn;
};

size_t align_up(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Byte offsets of the five arrays in the scratch; returns its size.
size_t bwd_layout(long long rois, int P, int H, int W, size_t off[5]) {
  const size_t n = static_cast<size_t>(rois);
  const size_t sizes[5] = {n * sizeof(int4), n * H * P * sizeof(int2),
                           n * W * P * sizeof(int2), n * H * sizeof(int),
                           n * W * sizeof(int)};
  size_t total = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = total;
    total += align_up(sizes[i]);
  }
  return total;
}

BwdLists bwd_lists(void* scratch, long long rois, int P, int H, int W) {
  size_t off[5];
  bwd_layout(rois, P, H, W, off);
  char* base = static_cast<char*>(scratch);
  return {reinterpret_cast<int4*>(base + off[0]),
          reinterpret_cast<int2*>(base + off[1]),
          reinterpret_cast<int2*>(base + off[2]),
          reinterpret_cast<int*>(base + off[3]),
          reinterpret_cast<int*>(base + off[4])};
}

// One warp lists, for every column i of a (P, len) weight matrix, the
// rows p with src[p, i] != 0, in p order, as (p * stride, weight).
// Returns the first and last column with an entry (len and -1 if none).
__device__ __forceinline__ int2 list_entries(const float* __restrict__ src,
                                             int P, int len, int stride,
                                             int2* ent, int* cnt, int lane) {
  int first = len, last = -1;
  for (int i = lane; i < len; i += 32) {
    int n = 0;
    for (int p = 0; p < P; ++p) {
      const float v = src[p * len + i];
      if (v != 0.0f) {
        ent[i * P + n] = make_int2(p * stride, __float_as_int(v));
        ++n;
      }
    }
    cnt[i] = n;
    if (n > 0) {
      first = min(first, i);
      last = max(last, i);
    }
  }
  return make_int2(__reduce_min_sync(0xffffffffu, first),
                   __reduce_max_sync(0xffffffffu, last));
}

// Grid ceil(B * R / kPrepWarps); a warp per roi.
__global__ void __launch_bounds__(kPrepWarps * 32)
roi_align_bwd_lists_kernel(const float* __restrict__ wy,
                           const float* __restrict__ wx, BwdLists l,
                           long long rois, int P, int H, int W, int C) {
  const long long br =
      static_cast<long long>(blockIdx.x) * kPrepWarps + (threadIdx.x >> 5);
  if (br >= rois) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const int2 rows = list_entries(wy + br * P * H, P, H, P * C,
                                 l.he + br * H * P, l.hn + br * H, lane);
  const int2 cols = list_entries(wx + br * P * W, P, W, C,
                                 l.we + br * W * P, l.wn + br * W, lane);
  if (lane == 0) l.range[br] = make_int4(rows.x, rows.y, cols.x, cols.y);
}

template <int V>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  store_f32<V>(p, v);
}

template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    static_assert(V == 4, "4 channels a lane");
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;   // 8 bytes: C % 4 == 0
  }
}

// Grid (tiles of the map, B, channel slices of 32 * V).  Writes every
// dfeat element of its tile and slice once.
template <int V, typename Out>
__global__ void __launch_bounds__(kThreads)
roi_align_contract_bwd_kernel(const float* __restrict__ g, BwdLists l,
                              Out* __restrict__ dfeat, int R, int P, int H,
                              int W, int C, int tiles_w) {
  __shared__ int cand[kThreads];
  __shared__ int warp_hits[kWarps];
  const int b = blockIdx.y;
  const int th = blockIdx.x / tiles_w, tw = blockIdx.x - th * tiles_w;
  const int h0 = th * kTileH, w0 = tw * kTileW;
  const int h1 = min(h0 + kTileH, H) - 1, w1 = min(w0 + kTileW, W) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.z * 32 + lane) * V;   // the lane's first channel
  const bool live = c < C;

  float acc[kPixPerWarp][V];
#pragma unroll
  for (int k = 0; k < kPixPerWarp; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
  }
  const size_t rbase = static_cast<size_t>(b) * R;
  for (int base = 0; base < R; base += kThreads) {
    // The rois of this chunk that reach the tile, in r order.
    const int r = base + threadIdx.x;
    bool hit = false;
    if (r < R) {
      const int4 s = l.range[rbase + r];
      hit = s.x <= h1 && s.y >= h0 && s.z <= w1 && s.w >= w0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      before += i < warp ? warp_hits[i] : 0;
      total += warp_hits[i];
    }
    if (hit) cand[before + __popc(m & ((1u << lane) - 1u))] = r;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kPixPerWarp; ++k) {
      const int pix = warp + k * kWarps;
      const int h = h0 + pix / kTileW, w = w0 + pix % kTileW;
      if (h > h1 || w > w1 || !live) continue;
      for (int i = 0; i < total; ++i) {
        const size_t br = rbase + cand[i];
        const int nh = l.hn[br * H + h];
        const int nw = l.wn[br * W + w];
        if (nh == 0 || nw == 0) continue;
        const int2* he = l.he + (br * H + h) * P;
        const int2* we = l.we + (br * W + w) * P;
        const float* gr = g + br * P * P * C + c;
        for (int a = 0; a < nh; ++a) {
          const int2 x = he[a];
          float t[V];
#pragma unroll
          for (int j = 0; j < V; ++j) t[j] = 0.0f;
          for (int e = 0; e < nw; ++e) {
            const int2 y = we[e];
            Vec<float, V> gv;
            gv.load(gr + x.x + y.x);
            float gk[V];
            gv.unpack(gk);
            const float bq = __int_as_float(y.y);
#pragma unroll
            for (int j = 0; j < V; ++j) t[j] = fmaf(bq, gk[j], t[j]);
          }
          const float aw = __int_as_float(x.y);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[k][j] = fmaf(aw, t[j], acc[k][j]);
        }
      }
    }
    __syncthreads();   // the next chunk rewrites cand
  }

#pragma unroll
  for (int k = 0; k < kPixPerWarp; ++k) {
    const int pix = warp + k * kWarps;
    const int h = h0 + pix / kTileW, w = w0 + pix % kTileW;
    if (h > h1 || w > w1 || !live) continue;
    store_out<V>(dfeat + ((static_cast<size_t>(b) * H + h) * W + w) * C + c,
                 acc[k]);
  }
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

template <int V, typename Out>
int launch_bwd_v(const void* g, BwdLists l, void* dfeat, int B, int R, int P,
                 int H, int W, int C, cudaStream_t s) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles = ((H + kTileH - 1) / kTileH) * tiles_w;
  const int slices = (C / V + 31) / 32;
  roi_align_contract_bwd_kernel<V, Out>
      <<<dim3(tiles, B, slices), kThreads, 0, s>>>(
          static_cast<const float*>(g), l, static_cast<Out*>(dfeat), R, P, H,
          W, C, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int launch_bwd(const void* wy, const void* wx, const void* g, void* dfeat,
               void* scratch, int B, int R, int P, int H, int W, int C,
               void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return cudaSuccess;   // no dfeat
  if (!map_fits(H, W, C) ||
      static_cast<long long>(P) * P * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) R = 0;   // no bins: dfeat is all zero, still written
  const long long rois = static_cast<long long>(B) * (R > 0 ? R : 0);
  const BwdLists l = bwd_lists(scratch, rois, P, H, W);
  if (rois > 0) {
    roi_align_bwd_lists_kernel<<<static_cast<unsigned>(
                                     (rois + kPrepWarps - 1) / kPrepWarps),
                                 kPrepWarps * 32, 0, s>>>(
        static_cast<const float*>(wy), static_cast<const float*>(wx), l,
        rois, P, H, W, C);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (C % 4 == 0 && aligned16(g) && aligned16(dfeat))
    return launch_bwd_v<4, Out>(g, l, dfeat, B, R, P, H, W, C, s);
  return launch_bwd_v<1, Out>(g, l, dfeat, B, R, P, H, W, C, s);
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

// Bytes of the scratch scda_roi_align_contract_bwd needs.
extern "C" long long scda_roi_align_contract_bwd_scratch(int B, int R, int P,
                                                         int H, int W) {
  size_t off[5];
  return static_cast<long long>(
      bwd_layout(static_cast<long long>(B) * R, P, H, W, off));
}

// wy (B,R,P,H) f32, wx (B,R,P,W) f32, g (B,R,P,P,C) f32 -> dfeat (B,H,W,C),
// f32 (out_bf16 == 0) or bf16, every element written; scratch of
// scda_roi_align_contract_bwd_scratch bytes, 256-byte aligned.
extern "C" int scda_roi_align_contract_bwd(const void* wy, const void* wx,
                                           const void* g, void* dfeat,
                                           void* scratch, int B, int R, int P,
                                           int H, int W, int C, int out_bf16,
                                           void* stream) {
  if (out_bf16)
    return launch_bwd<__nv_bfloat16>(wy, wx, g, dfeat, scratch, B, R, P, H,
                                     W, C, stream);
  return launch_bwd<float>(wy, wx, g, dfeat, scratch, B, R, P, H, W, C,
                           stream);
}
