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
// on the inference path) out of H or W.  So one block per (b, r, p)
// first compacts the nonzero taps of wy[b,r,p,:] and of each wx[b,r,q,:]
// into shared memory (ballot + popc, in index order), then threads run
// along C and accumulate only those taps.  Reads of feat[b,h,w,:] are
// coalesced along C.
//
// What bounds it on the H100: with sparse weights, memory — about 16
// feat reads and one f32 write per output element, a few tens of MB at
// R=300, C=512.  Dense weights stay exact (every nonzero tap is kept),
// only slower.  Accumulation is f32 for f32 and bf16 feat alike.
//
// The backward (JAX computes it as two einsums in _contract_bwd, no
// Pallas call) is the transpose of the same sparse map:
//
//   dfeat[b,h,w,c] = sum_{r,p,q} wy[b,r,p,h] * wx[b,r,q,w] * g[b,r,p,q,c]
//
// The einsum form materialises a (B, R, P, W, C) f32 intermediate (117 MB
// per VGG16 training image).  Here one block per (b, r, p) compacts the
// taps as the forward does and scatters wy*wx*g[b,r,p,q,c] into an f32
// dfeat with atomicAdd, threads along C, so neighbouring threads add to
// neighbouring addresses.  Bound by the atomics: about 4*4*P adds per
// (r, p, c) with sparse weights, contended where rois overlap.  Rois of
// one image overlap, so the order of the adds (and the f32 rounding)
// changes from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Compact the nonzero entries of src[0:len] into (idx, val), in order.
// Called by one whole warp; returns the count in every lane.
__device__ __forceinline__ int compact_row(const float* __restrict__ src,
                                           int len, int* idx, float* val,
                                           int lane) {
  int total = 0;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    const float v = i < len ? src[i] : 0.0f;
    const unsigned nz = __ballot_sync(0xffffffffu, v != 0.0f);
    if (v != 0.0f) {
      const int pos = total + __popc(nz & ((1u << lane) - 1u));
      idx[pos] = i;
      val[pos] = v;
    }
    total += __popc(nz);
  }
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_contract_kernel(const float* __restrict__ wy,
                          const float* __restrict__ wx,
                          const T* __restrict__ feat, float* __restrict__ out,
                          int R, int P, int H, int W, int C) {
  extern __shared__ int4 smem_raw[];
  int* h_idx = reinterpret_cast<int*>(smem_raw);  // H
  float* h_val = reinterpret_cast<float*>(h_idx + H);       // H
  int* w_idx = reinterpret_cast<int*>(h_val + H);           // P * W
  float* w_val = reinterpret_cast<float*>(w_idx + P * W);   // P * W
  int* counts = reinterpret_cast<int*>(w_val + P * W);      // 1 + P

  const int brp = blockIdx.x;  // (b * R + r) * P + p
  const int br = brp / P;
  const int b = br / R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  // Job 0 compacts wy[b,r,p,:]; job 1 + q compacts wx[b,r,q,:].
  for (int job = warp; job <= P; job += warps) {
    int n;
    if (job == 0) {
      n = compact_row(wy + static_cast<size_t>(brp) * H, H, h_idx, h_val,
                      lane);
    } else {
      const int q = job - 1;
      n = compact_row(wx + (static_cast<size_t>(br) * P + q) * W, W,
                      w_idx + q * W, w_val + q * W, lane);
    }
    if (lane == 0) counts[job] = n;
  }
  __syncthreads();

  const int nh = counts[0];
  const T* fb = feat + static_cast<size_t>(b) * H * W * C;
  float* ob = out + static_cast<size_t>(brp) * P * C;
  const size_t row_stride = static_cast<size_t>(W) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int q = 0; q < P; ++q) {
      const int nw = counts[1 + q];
      const int* wi = w_idx + q * W;
      const float* wv = w_val + q * W;
      float acc = 0.0f;
      for (int k = 0; k < nw; ++k) {
        const T* col = fb + static_cast<size_t>(wi[k]) * C + c;
        float s = 0.0f;
        for (int m = 0; m < nh; ++m)
          s = fmaf(h_val[m], to_f32(col[h_idx[m] * row_stride]), s);
        acc = fmaf(wv[k], s, acc);
      }
      ob[q * C + c] = acc;
    }
  }
}

// dfeat must be zero on entry; every (b, r, p) block adds its share.
__global__ void __launch_bounds__(kThreads)
roi_align_contract_bwd_kernel(const float* __restrict__ wy,
                              const float* __restrict__ wx,
                              const float* __restrict__ g,
                              float* __restrict__ dfeat, int R, int P, int H,
                              int W, int C) {
  extern __shared__ int4 smem_raw[];
  int* h_idx = reinterpret_cast<int*>(smem_raw);
  float* h_val = reinterpret_cast<float*>(h_idx + H);
  int* w_idx = reinterpret_cast<int*>(h_val + H);
  float* w_val = reinterpret_cast<float*>(w_idx + P * W);
  int* counts = reinterpret_cast<int*>(w_val + P * W);

  const int brp = blockIdx.x;
  const int br = brp / P;
  const int b = br / R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  for (int job = warp; job <= P; job += warps) {
    int n;
    if (job == 0) {
      n = compact_row(wy + static_cast<size_t>(brp) * H, H, h_idx, h_val,
                      lane);
    } else {
      const int q = job - 1;
      n = compact_row(wx + (static_cast<size_t>(br) * P + q) * W, W,
                      w_idx + q * W, w_val + q * W, lane);
    }
    if (lane == 0) counts[job] = n;
  }
  __syncthreads();

  const int nh = counts[0];
  const float* gb = g + static_cast<size_t>(brp) * P * C;
  float* db = dfeat + static_cast<size_t>(b) * H * W * C;
  const size_t row_stride = static_cast<size_t>(W) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int q = 0; q < P; ++q) {
      const float gq = gb[q * C + c];
      if (gq == 0.0f) continue;
      const int nw = counts[1 + q];
      const int* wi = w_idx + q * W;
      const float* wv = w_val + q * W;
      for (int k = 0; k < nw; ++k) {
        const float v = wv[k] * gq;
        float* col = db + static_cast<size_t>(wi[k]) * C + c;
        for (int m = 0; m < nh; ++m)
          atomicAdd(col + h_idx[m] * row_stride, h_val[m] * v);
      }
    }
  }
}

size_t tap_smem(int P, int H, int W) {
  return static_cast<size_t>(H + P * W) * (sizeof(int) + sizeof(float)) +
         (1 + P) * sizeof(int);
}

int launch_bwd(const void* wy, const void* wx, const void* g, void* dfeat,
               int B, int R, int P, int H, int W, int C, void* stream) {
  if (B <= 0 || R <= 0 || P <= 0 || C <= 0) return cudaSuccess;
  const size_t smem = tap_smem(P, H, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roi_align_contract_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(B) * R * P;
  roi_align_contract_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                  smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wy), static_cast<const float*>(wx),
      static_cast<const float*>(g), static_cast<float*>(dfeat), R, P, H, W,
      C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* wy, const void* wx, const void* feat, void* out, int B,
           int R, int P, int H, int W, int C, void* stream) {
  if (B <= 0 || R <= 0 || P <= 0 || C <= 0) return cudaSuccess;
  const size_t smem = tap_smem(P, H, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roi_align_contract_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(B) * R * P;
  roi_align_contract_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(wy), static_cast<const float*>(wx),
          static_cast<const T*>(feat), static_cast<float*>(out), R, P, H, W,
          C);
  return static_cast<int>(cudaGetLastError());
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
