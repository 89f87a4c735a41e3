// Fused ResNet bottleneck chain for Hopper (sm_90a): N stride-1 identity
// bottlenecks with FrozenBatchNorm folded into the weights,
//
//   y1 = round(relu(x @ w1 + b1))              1x1 reduce,  C -> F
//   y2 = round(relu(conv3x3(y1, w2) + b2))     3x3 pad 1,   F -> F
//   x  = round(relu(y2 @ w3 + b3 + x))         1x1 expand,  F -> C, residual
//
// on an NHWC map, f32 accumulation, rounding to the compute type after each
// stage.  Replaces scda_tpu/ops/pallas/bottleneck_kernel.py:bottleneck_chain.
//
// Design.  The TPU kernel keeps the whole (HW, C) residual stream resident
// in 15 MiB of VMEM across the N blocks.  An H100 SM has 227 KB of shared
// memory, so here each block of the chain is three launches of one tiled
// GEMM kernel on the stream, and the chain between launches goes through
// L2 (layer3's map at 512x1024 is 4 MB in bf16, against 50 MB of L2):
//   (a) the 1x1 reduce, (HW x C) . (C x F), + b1, relu, round into y1;
//   (b) the 3x3 as an implicit GEMM (HW x 9F) . (9F x F) over y1: the A
//       tile of tap (dy, dx) reads pixel (y + dy, x + dx), and a pixel
//       outside the image is zero-filled by the copy itself (no padded
//       copy of y1); + b2, relu, round into y2;
//   (c) the 1x1 expand, (HW x F) . (F x C), + b3 + the residual read from
//       the stream, relu, written back in place.
// One C call loops over the N blocks, three launches each.  Tiles are
// 64 x 64 outputs over 32-deep K slices, double-buffered in shared memory
// with cp.async; 4 warps each own a 32 x 32 sub-tile.  bf16 runs on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); f32 runs the
// same tiles with CUDA-core FMAs.  Weights arrive transposed, (N_out, K)
// with K contiguous, so both operand tiles are K-contiguous rows and every
// fragment is a 32-bit shared-memory load.
//
// What bounds it on the H100: arithmetic, about 4.6 GFLOP per block at
// every ResNet-101 stage at 512x1024 (123 GFLOP per image over 27 blocks),
// and this first version reaches a fraction of the tensor cores' rate:
// mma.sync without wgmma or TMA, small tiles, two stages.  The map and the
// weights are read from L2 once per output tile column.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each 32 x 32 outputs

enum Mode { kReduce = 0, kConv3x3 = 1, kExpand = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// 16-byte global -> shared copy; with pred false it writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out (M, N) = epilogue(A (M, K) . wt (N, K)^T + bias).  For kConv3x3, A
// is the (M, F) map y1 of B images of H x W pixels and K = 9F, ordered
// (tap, channel) with tap = (dy + 1) * 3 + (dx + 1).  For kExpand, out is
// the residual stream, read and updated in place (each element by one
// thread).  N % 64 == 0 and K % 32 == 0 (F % 32 == 0 for kConv3x3); M is
// masked.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
chain_gemm_kernel(const T* __restrict__ a, const T* __restrict__ wt,
                  const float* __restrict__ bias, T* out, int M, int N,
                  int K, int H, int W) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // per copy
  constexpr int kLd = kBK + kChunk;  // padded shared row: no bank conflicts
  constexpr int kCpr = kBK / kChunk;             // copies per tile row
  constexpr int kRowsPerPass = kThreads / kCpr;  // tile rows per pass
  constexpr int kPasses = kBM / kRowsPerPass;
  static_assert(kBM == kBN, "A and B tiles share the copy mapping");

  __shared__ __align__(16) T as[2][kBM * kLd];
  __shared__ __align__(16) T bs[2][kBN * kLd];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kc = (tid % kCpr) * kChunk;
  const int r_base = tid / kCpr;

  // The A rows this thread copies: pixel index (or -1 past M) and, for
  // the 3x3, the pixel's row and column in its image.
  int a_pix[kPasses], a_y[kPasses], a_x[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int m = m0 + r_base + p * kRowsPerPass;
    a_pix[p] = m < M ? m : -1;
    a_y[p] = a_x[p] = 0;
    if (kMode == kConv3x3 && m < M) {
      const int rem = m % (H * W);
      a_y[p] = rem / W;
      a_x[p] = rem % W;
    }
  }
  const int f = K / 9;  // y1's width, used by the 3x3 only

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    int dy = 0, dx = 0, kin = k0;
    if (kMode == kConv3x3) {
      const int tap = k0 / f;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
      kin = k0 - tap * f;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = r_base + p * kRowsPerPass;
      bool ok = a_pix[p] >= 0;
      const T* src = a;
      if (kMode == kConv3x3) {
        const int yy = a_y[p] + dy, xx = a_x[p] + dx;
        ok = ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
        if (ok)
          src = a + static_cast<size_t>(a_pix[p] + dy * W + dx) * f + kin +
                kc;
      } else if (ok) {
        src = a + static_cast<size_t>(a_pix[p]) * K + k0 + kc;
      }
      cp_async16(&as[stage][r * kLd + kc], src, ok);
      cp_async16(&bs[stage][r * kLd + kc],
                 wt + static_cast<size_t>(n0 + r) * K + k0 + kc, true);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;

  // acc[mi][ni][i]: rows wm + 16 mi + g (+8 for i >= 2), columns
  // wn + 8 ni + 2 t + (i & 1): the mma.sync accumulator layout, kept for
  // the f32 path too so that one epilogue serves both.
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

  const int nk = K / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest: tile kt has landed
    __syncthreads();
    const T* A = as[kt & 1];
    const T* Bt = bs[kt & 1];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const T* p = A + (wm + mi * 16 + g) * kLd + kk + 2 * t;
          af[mi][0] = ld32(p);
          af[mi][1] = ld32(p + 8 * kLd);
          af[mi][2] = ld32(p + 8);
          af[mi][3] = ld32(p + 8 * kLd + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const T* q = Bt + (wn + ni * 8 + g) * kLd + kk + 2 * t;
          bf[ni][0] = ld32(q);
          bf[ni][1] = ld32(q + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[mi][h] = A[(wm + mi * 16 + g + 8 * h) * kLd + k];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bv[ni][j] = Bt[(wn + ni * 8 + 2 * t + j) * kLd + k];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                acc[mi][ni][2 * h + j] =
                    fmaf(av[mi][h], bv[ni][j], acc[mi][ni][2 * h + j]);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // Epilogue: bias (+ residual), relu, one rounding to T.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        float v0 = acc[mi][ni][2 * h] + bias[n];
        float v1 = acc[mi][ni][2 * h + 1] + bias[n + 1];
        T* o = out + static_cast<size_t>(m) * N + n;
        if (kMode == kExpand) {
          v0 += to_f32(o[0]);
          v1 += to_f32(o[1]);
        }
        store2(o, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
}

template <typename T>
int chain(void* x, const void* w1t, const void* b1, const void* w2t,
          const void* b2, const void* w3t, const void* b3, void* y1, void* y2,
          int B, int H, int W, int C, int F, int N, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gm = (M + kBM - 1) / kBM;
  T* xs = static_cast<T*>(x);
  T* y1s = static_cast<T*>(y1);
  T* y2s = static_cast<T*>(y2);
  for (int i = 0; i < N; ++i) {
    const T* w1 = static_cast<const T*>(w1t) + static_cast<size_t>(i) * F * C;
    const T* w2 =
        static_cast<const T*>(w2t) + static_cast<size_t>(i) * F * 9 * F;
    const T* w3 = static_cast<const T*>(w3t) + static_cast<size_t>(i) * C * F;
    chain_gemm_kernel<T, kReduce><<<dim3(gm, F / kBN), kThreads, 0, s>>>(
        xs, w1, static_cast<const float*>(b1) + i * F, y1s, M, F, C, H, W);
    chain_gemm_kernel<T, kConv3x3><<<dim3(gm, F / kBN), kThreads, 0, s>>>(
        y1s, w2, static_cast<const float*>(b2) + i * F, y2s, M, F, 9 * F, H,
        W);
    chain_gemm_kernel<T, kExpand><<<dim3(gm, C / kBN), kThreads, 0, s>>>(
        y2s, w3, static_cast<const float*>(b3) + i * C, xs, M, C, F, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return cudaSuccess;
}

}  // namespace

// x (B,H,W,C): the residual stream in the compute type, updated in place.
// w1t (N,F,C), w2t (N,F,9F) ordered (tap, in-channel), w3t (N,C,F): the
// folded weights transposed, in the compute type; b1, b2 (N,F), b3 (N,C)
// f32; y1, y2 (B,H,W,F) scratch in the compute type.  C % 64 == 0 and
// F % 64 == 0.
extern "C" int scda_bottleneck_chain_f32(void* x, const void* w1t,
                                         const void* b1, const void* w2t,
                                         const void* b2, const void* w3t,
                                         const void* b3, void* y1, void* y2,
                                         int B, int H, int W, int C, int F,
                                         int N, void* stream) {
  return chain<float>(x, w1t, b1, w2t, b2, w3t, b3, y1, y2, B, H, W, C, F,
                      N, stream);
}

extern "C" int scda_bottleneck_chain_bf16(void* x, const void* w1t,
                                          const void* b1, const void* w2t,
                                          const void* b2, const void* w3t,
                                          const void* b3, void* y1, void* y2,
                                          int B, int H, int W, int C, int F,
                                          int N, void* stream) {
  return chain<__nv_bfloat16>(x, w1t, b1, w2t, b2, w3t, b3, y1, y2, B, H, W,
                              C, F, N, stream);
}
