// Greedy NMS over per-row score-sorted boxes, for Hopper (sm_90a).
//
// Replaces scda_tpu/ops/pallas/nms_kernel.py:nms_sorted_pallas.  The TPU
// kernel walks score-sorted tiles in grid order, carrying the kept boxes
// in VMEM scratch from step to step; a GPU grid has no such order.  Here
// the work splits into two launches, both on the caller's stream:
//
//   1. nms_mask_kernel: the upper triangle of a 64-bit suppression mask,
//      bit k of mask[i][w] saying "box i suppresses box j = 64*w + k"
//      (j > i and IoU > thr).  A 256-thread block takes 64 rows by four
//      column words; a thread holds its row's box in registers (one
//      float4 load) and walks 64 column boxes broadcast from shared
//      memory.  What bounds it is arithmetic (N^2/2 pairs on the CUDA
//      cores), so the pass does less of it per pair: the correctly
//      rounded division of the twin's test decides only the pairs a
//      division-free screen cannot (see suppresses()), blocks whose 64
//      rows or whose 64 columns hold no valid box return at once, and the
//      words leave through shared memory as whole 32-byte sectors.
//   2. nms_scan_kernel: one 512-thread block per row walks the words in
//      score order, ONE STEP PER 64-BOX WORD, and no step waits for
//      device memory:
//        * the words a step needs at once, mask[64w+k][w .. w+kNear] for
//          k < 64 (the diagonal word and the next kNear columns), lie at
//          addresses that depend on no data: cp.async brings them into a
//          ring in shared memory kPrefetch steps ahead;
//        * warp 0 resolves word w from shared memory alone: candidates =
//          valid & ~removed[w], lowest bit first, each keep clearing the
//          later boxes of the word it suppresses, until max_output
//          keeps.  A ballot finds the candidates that suppress another
//          candidate; the whole run up to the first of them is kept in
//          one turn, so a word of 60 boxes that do not overlap costs one
//          turn, not 60;
//        * then every kept box of the word ORs its row into removed[] at
//          once: columns w+1 .. w+kNear from the ring, the columns
//          beyond from device memory, a warp per kept row (up to four
//          rows a warp, OR-ed in registers) and a lane per column.
//          Those loads start in step w, into registers, and are OR-ed
//          into removed[] only in step w + kLag, just before their first
//          column (w + kLag) is resolved, so their latency hides under
//          the kLag - 1 steps in between (a word with more than 16 keeps
//          waits for its loads in step, to OR a warp's rows together).
//      Two __syncthreads per word are the whole chain; the scan stops at
//      max_output keeps and never syncs with the host.
//
// The serial floor the roofline leaves out: words-walked times one
// shared-memory round trip of the block (two barriers and the resolving
// warp's bit loop).
//
// The keep mask must equal the plain twin's bit for bit, so the IoU
// follows _iou_matrix's operation order exactly and uses the _rn
// intrinsics, which nvcc never contracts into FMAs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBoxesPerWord = 64;

// ---- the mask pass ------------------------------------------------------

constexpr int kMaskThreads = 256;
constexpr int kColWords = kMaskThreads / kBoxesPerWord;  // 4 words a block

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// The twin's test, fdiv_rn(inter, max(union, 1e-9)) > thr, bit for bit.
// With u = max(union, 1e-9) and p = fl(thr * u) (relative error 2^-24):
//   inter > p * (1 + 2^-20)  =>  inter/u > thr * (1 + 2^-21), which lies
//     more than an ulp above thr, so the rounded quotient exceeds thr;
//   inter < p * (1 - 2^-20)  =>  inter/u < thr, so the rounded quotient
//     cannot exceed thr (rounding is monotonic and thr is a float).
// Only pairs inside that band take the division.  `screen` is off for
// thr < 1e-6, where p could underflow: every pair divides then.
__device__ __forceinline__ bool suppresses(const float4 a, float area_a,
                                           const float4 b, float area_b,
                                           float thr, bool screen) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float u = fmaxf(uni, 1e-9f);
  if (screen) {
    const float p = __fmul_rn(thr, u);
    if (inter > __fmul_rn(p, 1.000001f)) return true;
    if (inter < __fmul_rn(p, 0.999999f)) return false;
  }
  return __fdiv_rn(inter, u) > thr;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, int n, int words,
                float thr, u64* __restrict__ mask) {
  const int rb = blockIdx.y, cb0 = blockIdx.x * kColWords, row = blockIdx.z;
  if (cb0 + kColWords - 1 < rb) return;  // the scan reads no word before a box's own
  const float4* b = boxes + static_cast<size_t>(row) * n;
  const uint8_t* v = valid + static_cast<size_t>(row) * n;

  __shared__ float4 col_box[kMaskThreads];
  __shared__ float col_area[kMaskThreads];
  __shared__ int col_any[kColWords];   // a valid box among the word's 64?
  __shared__ uint8_t row_valid[kBoxesPerWord];
  __shared__ u64 out_bits[kBoxesPerWord][kColWords];

  const int t = threadIdx.x;
  const int r = t & (kBoxesPerWord - 1), cw = t >> 6;
  const int j = cb0 * kBoxesPerWord + t;  // this thread's column box
  const bool j_valid = j < n && v[j] != 0;
  if (j < n) {
    const float4 cbx = b[j];
    col_box[t] = cbx;
    col_area[t] = box_area(cbx);
  }
  if (t < kColWords) col_any[t] = 0;
  const int i = rb * kBoxesPerWord + r;   // this thread's row box
  const bool i_valid = i < n && v[i] != 0;
  if (cw == 0) row_valid[r] = i_valid;
  __syncthreads();
  if (__ballot_sync(0xffffffffu, j_valid) != 0u && (t & 31) == 0)
    col_any[t >> 6] = 1;
  // A box that is not valid is never kept, so its row is never read; a
  // word with no valid box holds no candidate, whatever is OR-ed into it.
  if (!__syncthreads_or(i_valid)) return;

  const int cb = cb0 + cw;
  u64 bits = 0ULL;
  if (i_valid && cb >= rb && cb < words && col_any[cw]) {
    const float4 a = b[i];
    const float area_a = box_area(a);
    const bool screen = thr >= 1e-6f;
    const int cols = min(n - cb * kBoxesPerWord, kBoxesPerWord);
    const float4* cbx = col_box + cw * kBoxesPerWord;
    const float* car = col_area + cw * kBoxesPerWord;
    unsigned lo = 0u, hi = 0u;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      if (k < cols && suppresses(a, area_a, cbx[k], car[k], thr, screen))
        lo |= 1u << k;
    }
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      if (k + 32 < cols &&
          suppresses(a, area_a, cbx[k + 32], car[k + 32], thr, screen))
        hi |= 1u << k;
    }
    bits = (static_cast<u64>(hi) << 32) | lo;
    // The diagonal word: only later boxes, j > i.
    if (cb == rb) bits &= (r == 63) ? 0ULL : (~0ULL << (r + 1));
  }
  out_bits[r][cw] = bits;
  __syncthreads();

  // Four neighbouring threads write the four words of one row: 32 bytes.
  const int orow = t >> 2, ocw = t & (kColWords - 1);
  const int ocb = cb0 + ocw;
  if (row_valid[orow] && ocb >= rb && ocb < words && col_any[ocw]) {
    const size_t oi = static_cast<size_t>(rb) * kBoxesPerWord + orow;
    mask[(static_cast<size_t>(row) * n + oi) * words + ocb] =
        out_bits[orow][ocw];
  }
}

// ---- the scan -------------------------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerWarp = kBoxesPerWord / kScanWarps;  // kept rows a warp ORs
constexpr int kMaxWords = 1024;         // 65536 boxes a row
constexpr int kLag = 3;                 // steps between a far load and its OR
constexpr int kNear = kLag - 1;         // columns after the diagonal in the ring
constexpr int kTileWords = kNear + 1;
constexpr int kPrefetch = 4;            // steps the ring runs ahead
constexpr int kSlots = kPrefetch + 2;   // one being read, one just released
constexpr int kFar = 6;                 // far columns a lane holds in flight

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// removed[col] |= x with the 32-bit atomics shared memory has natively (a
// 64-bit atomicOr there is a compare-and-swap loop).
__device__ __forceinline__ void or_word(u64* removed, int col, u64 x) {
  unsigned* half = reinterpret_cast<unsigned*>(removed + col);
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned hi = static_cast<unsigned>(x >> 32);
  if (lo != 0u) atomicOr(half, lo);
  if (hi != 0u) atomicOr(half + 1, hi);
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask,
                const uint8_t* __restrict__ valid, int n, int words,
                int max_output, uint8_t* __restrict__ keep) {
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 valid_w[kMaxWords];
  __shared__ u64 kept_w[kMaxWords];
  __shared__ u64 tile[kSlots][kBoxesPerWord][kTileWords];
  __shared__ int kept_list[kBoxesPerWord];

  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const u64* m = mask + static_cast<size_t>(row) * n * words;
  const uint8_t* v = valid + static_cast<size_t>(row) * n;
  uint8_t* out = keep + static_cast<size_t>(row) * n;

  // Tile t of the ring: mask[64t + k][t + d], k < 64, d <= kNear.
  auto fetch_tile = [&](int t) {
    if (t < words && tid < kBoxesPerWord * kTileWords) {
      const int k = tid / kTileWords, d = tid - k * kTileWords;
      const int i = t * kBoxesPerWord + k, col = t + d;
      if (i < n && col < words)
        cp_async_8(&tile[t % kSlots][k][d],
                   m + static_cast<size_t>(i) * words + col);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kPrefetch; ++t) fetch_tile(t);

  for (int w = warp; w < words; w += kScanWarps) {
    const int i0 = w * kBoxesPerWord + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(full, i0 < n && v[i0] != 0);
    const unsigned hi = __ballot_sync(full, i1 < n && v[i1] != 0);
    if (lane == 0) {
      valid_w[w] = (static_cast<u64>(hi) << 32) | lo;
      removed[w] = 0ULL;
    }
  }

  // pend[u][f]: the words of this warp's kept rows at column s + kLag +
  // lane + 32 f, loaded in step s (s % kLag == u) and OR-ed together,
  // added to removed[] in step s + kLag.
  u64 pend[kLag][kFar];
#pragma unroll
  for (int u = 0; u < kLag; ++u) {
#pragma unroll
    for (int f = 0; f < kFar; ++f) pend[u][f] = 0ULL;
  }

  int count = 0, done_words = 0;
  bool stop = max_output <= 0;
  for (int w0 = 0; w0 < words && !stop; w0 += kLag) {
#pragma unroll
    for (int u = 0; u < kLag; ++u) {
      const int w = w0 + u;
      if (w >= words || stop) break;   // block-uniform

      // (a) The far words loaded kLag steps ago reach removed[] now;
      // their first column is w.  The ring runs one more step ahead.
#pragma unroll
      for (int f = 0; f < kFar; ++f) {
        if (pend[u][f] != 0ULL) or_word(removed, w + lane + 32 * f, pend[u][f]);
      }
      fetch_tile(w + kPrefetch);
      cp_async_wait<kPrefetch>();      // tile w has landed (this thread's part)
      __syncthreads();

      // (b) Warp 0 resolves the word; every lane holds the same values.
      const int slot = w % kSlots;
      if (warp == 0) {
        u64 cand = valid_w[w] & ~removed[w];
        // Lane k holds the diagonal words of boxes k and k + 32.
        const u64 d0 = tile[slot][lane][0], d1 = tile[slot][lane + 32][0];
        u64 kept = 0ULL;
        int c = count;
        while (cand != 0ULL && c < max_output) {
          // Candidates that suppress another candidate.  Up to and with
          // the first of them, every candidate is kept: none before it
          // suppresses anything.  Only that one then clears later boxes.
          const unsigned conf_lo = __ballot_sync(
              full, ((cand >> lane) & 1ULL) && (d0 & cand) != 0ULL);
          const unsigned conf_hi = __ballot_sync(
              full, ((cand >> (lane + 32)) & 1ULL) && (d1 & cand) != 0ULL);
          const u64 conf = (static_cast<u64>(conf_hi) << 32) | conf_lo;
          const int first = conf != 0ULL
                                ? __ffsll(static_cast<long long>(conf)) - 1
                                : kBoxesPerWord - 1;
          const u64 upto = first == kBoxesPerWord - 1
                               ? ~0ULL
                               : (1ULL << (first + 1)) - 1ULL;
          u64 run = cand & upto;
          const int room = max_output - c;
          if (__popcll(run) >= room) {   // the cap falls inside this run
            while (__popcll(run) > room)
              run &= ~(1ULL << (63 - __clzll(static_cast<long long>(run))));
            kept |= run;
            break;
          }
          kept |= run;
          c += __popcll(run);
          cand &= ~upto;
          if (conf != 0ULL)
            cand &= ~__shfl_sync(full, first < 32 ? d0 : d1, first & 31);
        }
        if ((kept >> lane) & 1ULL)
          kept_list[__popcll(kept & ((1ULL << lane) - 1ULL))] = lane;
        if ((kept >> (lane + 32)) & 1ULL)
          kept_list[__popcll(kept & ((1ULL << (lane + 32)) - 1ULL))] =
              lane + 32;
        if (lane == 0) kept_w[w] = kept;
      }
      __syncthreads();

      // (c) Every kept box of the word ORs its row into removed[].
      const u64 kept = kept_w[w];
      const int n_kept = __popcll(kept);
      count += n_kept;
      done_words = w + 1;
      stop = count >= max_output;
      if (stop) break;
      if (warp < kNear && w + 1 + warp < words) {
        const int d = 1 + warp;
        u64 x = 0ULL;
        if ((kept >> lane) & 1ULL) x |= tile[slot][lane][d];
        if ((kept >> (lane + 32)) & 1ULL) x |= tile[slot][lane + 32][d];
        const unsigned xl = __reduce_or_sync(full, static_cast<unsigned>(x));
        const unsigned xh =
            __reduce_or_sync(full, static_cast<unsigned>(x >> 32));
        if (lane == 0) or_word(removed, w + d, (static_cast<u64>(xh) << 32) | xl);
      }
      // Columns from w + kLag on: warp j ORs kept rows j, j + 16, .. in
      // registers, a lane per column; the result waits in pend[u].
      const int far0 = w + kLag;
      u64 acc[kFar];
#pragma unroll
      for (int f = 0; f < kFar; ++f) acc[f] = 0ULL;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int q = warp + kScanWarps * j;
        if (q < n_kept) {
          const u64* r =
              m + static_cast<size_t>(w * kBoxesPerWord + kept_list[q]) * words;
#pragma unroll
          for (int f = 0; f < kFar; ++f) {
            const int col = far0 + lane + 32 * f;
            if (col < words) acc[f] |= __ldg(r + col);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kFar; ++f) pend[u][f] = acc[f];
      // Columns past what the registers hold (N above 64 * 32 * kFar).
      if (far0 + 32 * kFar < words) {
        for (int q = warp; q < n_kept; q += kScanWarps) {
          const u64* r =
              m + static_cast<size_t>(w * kBoxesPerWord + kept_list[q]) * words;
          for (int col = far0 + lane + 32 * kFar; col < words; col += 32)
            or_word(removed, col, __ldg(r + col));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < n; i += kScanThreads) {
    const int w = i >> 6;
    out[i] = (w < done_words)
                 ? static_cast<uint8_t>((kept_w[w] >> (i & 63)) & 1ULL)
                 : static_cast<uint8_t>(0);
  }
}

}  // namespace

// boxes (B, N, 4) f32, valid (B, N) u8, mask scratch (B, N, ceil(N/64))
// u64, keep (B, N) u8 out.  The scan keeps three words per 64 boxes in
// static shared memory (kMaxWords); the wrapper bounds N to match.
extern "C" int scda_nms_keep(const void* boxes, const void* valid, void* mask,
                             void* keep, int batch, int n, float thr,
                             int max_output, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int words = (n + kBoxesPerWord - 1) / kBoxesPerWord;
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3((words + kColWords - 1) / kColWords, words, batch),
                    kMaskThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid), n,
      words, thr, static_cast<u64*>(mask));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<batch, kScanThreads, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid), n,
      words, max_output, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
