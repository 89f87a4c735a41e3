// Greedy NMS over per-row score-sorted boxes, for Hopper (sm_90a).
//
// Replaces scda_tpu/ops/pallas/nms_kernel.py:nms_sorted_pallas.  The TPU
// kernel walks score-sorted tiles in grid order, carrying the kept boxes
// in VMEM scratch from step to step; a GPU grid has no such order.  Here
// the work splits into two launches, both on the caller's stream:
//
//   1. nms_mask_kernel: one 64-thread block per (row, 64-box row block,
//      64-box column block) in the upper triangle.  Each thread writes a
//      64-bit word whose bit k says "box i suppresses box j = 64*cb + k"
//      (j > i and IoU > thr).  All N^2/2 IoUs run in parallel: at N=6000
//      that is 18M IoUs and a 4.5 MB mask per row.
//   2. nms_scan_kernel: one warp per row walks the words in score order.
//      A 64-bit candidate word (valid and not yet removed) is consumed
//      lowest bit first; each kept box ORs its mask row into the removed
//      words, which live in shared memory, one owner lane per word.  The
//      loop runs once per KEPT box, not per box, and stops at
//      max_output keeps: no host synchronisation anywhere.
//
// What bounds it on the H100: the mask pass is arithmetic on 18M pairs
// (tens of microseconds); the scan is a serial chain of at most
// max_output steps of a single warp, latency bound.  The mask is
// written once and read only for kept rows.
//
// The keep mask must equal the plain twin's bit for bit, so the IoU
// follows _iou_matrix's operation order exactly and uses the _rn
// intrinsics, which nvcc never contracts into FMAs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxesPerWord = 64;

__device__ __forceinline__ float iou_plus_one(const float* a, const float* b) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 1.0f), 0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.0f),
                                 __fadd_rn(__fsub_rn(a[3], a[1]), 1.0f));
  const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                                 __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, row = blockIdx.z;
  if (cb < rb) return;  // the scan reads only words at or after a box's own
  const int rows = min(n - rb * kBoxesPerWord, kBoxesPerWord);
  const int cols = min(n - cb * kBoxesPerWord, kBoxesPerWord);
  const float* b = boxes + static_cast<size_t>(row) * n * 4;

  __shared__ float col_boxes[kBoxesPerWord * 4];
  const int t = threadIdx.x;
  if (t < cols) {
    for (int k = 0; k < 4; ++k)
      col_boxes[t * 4 + k] = b[(cb * kBoxesPerWord + t) * 4 + k];
  }
  __syncthreads();
  if (t >= rows) return;

  const int i = rb * kBoxesPerWord + t;
  const float a[4] = {b[i * 4], b[i * 4 + 1], b[i * 4 + 2], b[i * 4 + 3]};
  unsigned long long bits = 0ULL;
  for (int k = (cb == rb) ? t + 1 : 0; k < cols; ++k) {
    if (iou_plus_one(a, &col_boxes[k * 4]) > thr) bits |= 1ULL << k;
  }
  mask[(static_cast<size_t>(row) * n + i) * words + cb] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, int max_output,
                                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int row = blockIdx.x, lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  const unsigned long long* m = mask + static_cast<size_t>(row) * n * words;
  const uint8_t* v = valid + static_cast<size_t>(row) * n;
  uint8_t* k = keep + static_cast<size_t>(row) * n;

  for (int w = lane; w < words; w += 32) removed[w] = 0ULL;
  __syncwarp();

  int count = 0;
  for (int w = 0; w < words; ++w) {
    const int i0 = w * kBoxesPerWord + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(full, i0 < n && v[i0]);
    const unsigned hi = __ballot_sync(full, i1 < n && v[i1]);
    unsigned long long cand =
        ((static_cast<unsigned long long>(hi) << 32) | lo) & ~removed[w];
    unsigned long long kept = 0ULL;
    // Warp-uniform: every lane holds the same cand and count.
    while (cand != 0ULL && count < max_output) {
      const int bit = __ffsll(static_cast<long long>(cand)) - 1;
      kept |= 1ULL << bit;
      ++count;
      const unsigned long long* r =
          m + static_cast<size_t>(w * kBoxesPerWord + bit) * words;
      cand &= ~(1ULL << bit);
      cand &= ~r[w];  // later boxes of this word that the new keep suppresses
      for (int ww = w + 1 + lane; ww < words; ww += 32) removed[ww] |= r[ww];
    }
    __syncwarp();
    if (i0 < n) k[i0] = static_cast<uint8_t>((kept >> lane) & 1ULL);
    if (i1 < n) k[i1] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ULL);
  }
}

}  // namespace

// boxes (B, N, 4) f32, valid (B, N) u8, mask scratch (B, N, ceil(N/64))
// u64, keep (B, N) u8 out.  The scan keeps ceil(N/64) words in shared
// memory; the wrapper bounds N so that fits the default 48 KB.
extern "C" int scda_nms_keep(const void* boxes, const void* valid, void* mask,
                             void* keep, int batch, int n, float thr,
                             int max_output, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int words = (n + kBoxesPerWord - 1) / kBoxesPerWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, batch), kBoxesPerWord, 0, s>>>(
      static_cast<const float*>(boxes), n, words, thr,
      static_cast<unsigned long long*>(mask));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<batch, 32, words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, words, max_output,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
