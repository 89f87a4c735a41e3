// Fused VGG16 stem for Hopper (sm_90a):
//
//   out = maxpool2x2(relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2))
//
// 3 -> 64 -> 64 channels, zero "same" padding, NHWC in and out.
// Replaces scda_tpu/ops/pallas/stem_kernel.py:vgg_stem_fused.  As on the
// TPU, the point is to stream the image once and write only the pooled
// output: the full-resolution 64-channel activations (y1 and conv1_2's
// output) never reach device memory.
//
// Design.  A persistent block per SM walks 16x8 tiles of conv1_2 output
// pixels.  Shared memory (about 200 KB, so one block per SM, opted in
// above 48 KB) holds:
//   * w2, all 576 x 64 conv1_2 weights, loaded once per block;
//   * the input tile with a 2-pixel halo (20 x 12 x 3);
//   * the y1 tile with a 1-pixel halo (64 x 18 x 10), channel-major so
//     the 2x2 quads below read it with 8-byte loads.
// Per tile: conv1_1 + bias + relu fills y1, zero outside the image (that
// is conv1_2's zero padding) and rounded once to the compute type as the
// Pallas kernel rounds it.  Then each thread computes one 2x2 quad of
// conv1_2 outputs for 16 channels (64 f32 accumulators), adds the bias,
// applies relu, max-pools the quad in registers and writes one pooled
// pixel's 16 channels.  Ragged tiles at the right and bottom edges are
// masked; any even H and W work.
//
// What bounds it on the H100: conv1_2 is 19.3 GFMA at 512x1024 and runs
// on the CUDA cores (no wgmma or TMA yet), so FMA issue and shared-memory
// bandwidth bound it; 576 FMAs per 44 shared loads per input channel.
// Device-memory traffic is just the image and the pooled output.
//
// Numerics: x, k1 and k2 arrive in the compute type T (float or bf16) and
// accumulate in f32.  conv1_1 sums its 27 taps in (dy, dx, ci) order;
// with bf16 operands every product is exact in f32, so y1 matches the
// plain twin's tap loop bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                       // channels of conv1_1 / conv1_2
constexpr int kK2 = 9 * kC;                  // conv1_2 contraction depth
constexpr int kTH = 16, kTW = 8;             // conv1_2 output tile
constexpr int kXH = kTH + 4, kXW = kTW + 4;  // input tile, 2-pixel halo
constexpr int kYH = kTH + 2, kYW = kTW + 2;  // y1 tile, 1-pixel halo
constexpr int kYPlane = kYH * kYW;
constexpr int kGroups = 4;                   // 16-channel output groups
constexpr int kThreads = (kTH / 2) * (kTW / 2) * kGroups;  // 128

constexpr int kW2Floats = kK2 * kC;
constexpr int kY1Floats = kC * kYPlane;
constexpr int kXFloats = kXH * kXW * 3;
constexpr int kW1Floats = 27 * kC;
constexpr int kSmemFloats = kW2Floats + kY1Floats + kXFloats + kW1Floats + 2 * kC;

static_assert(kThreads == 128, "one warp per channel group");
static_assert(kW2Floats % 4 == 0 && kY1Floats % 4 == 0, "16-byte alignment");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  d[1] = make_uint4(pack_bf16x2(v[8], v[9]), pack_bf16x2(v[10], v[11]),
                    pack_bf16x2(v[12], v[13]), pack_bf16x2(v[14], v[15]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
vgg_stem_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const float* __restrict__ b1, const T* __restrict__ w2,
                const float* __restrict__ b2, T* __restrict__ out, int B,
                int H, int W) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // [tap * 64 + ci][co]
  float* y1s = w2s + kW2Floats;                  // [ci][row][col]
  float* xs = y1s + kY1Floats;                   // [row][col][ci]
  float* w1s = xs + kXFloats;                    // [tap * 3 + ci][co]
  float* b1s = w1s + kW1Floats;
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  for (int i = tid; i < kW2Floats; i += kThreads) w2s[i] = to_f32(w2[i]);
  for (int i = tid; i < kW1Floats; i += kThreads) w1s[i] = to_f32(w1[i]);
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  __syncthreads();

  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int ho = H / 2, wo = W / 2;

  // conv1_1 mapping: one output channel, every other y1 pixel.
  const int co1 = tid % kC, pix0 = tid / kC;
  // conv1_2 mapping: warp = 16-channel group, lane = pooled pixel.
  const int group = tid / 32, lane = tid % 32;
  const int py = lane / (kTW / 2), px = lane % (kTW / 2);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int bi = static_cast<int>(t / (tiles_y * tiles_x));
    const int rem = static_cast<int>(t % (tiles_y * tiles_x));
    const int r0 = (rem / tiles_x) * kTH, c0 = (rem % tiles_x) * kTW;
    const T* xb = x + static_cast<size_t>(bi) * H * W * 3;

    // Input tile: image rows r0-2 .. r0+kTH+1, cols c0-2 .. c0+kTW+1.
    for (int i = tid; i < kXFloats; i += kThreads) {
      const int ci = i % 3, pix = i / 3;
      const int gy = r0 - 2 + pix / kXW, gx = c0 - 2 + pix % kXW;
      xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? to_f32(xb[(static_cast<size_t>(gy) * W + gx) * 3 + ci])
                  : 0.0f;
    }
    __syncthreads();

    // conv1_1 + bias + relu -> y1 rows r0-1 .., cols c0-1 ...
    for (int pix = pix0; pix < kYPlane; pix += kThreads / kC) {
      const int ry = pix / kYW, rx = pix % kYW;
      const int gy = r0 - 1 + ry, gx = c0 - 1 + rx;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
              acc = fmaf(xs[((ry + dy) * kXW + rx + dx) * 3 + ci],
                         w1s[((dy * 3 + dx) * 3 + ci) * kC + co1], acc);
        v = round_to<T>(fmaxf(acc + b1s[co1], 0.0f));
      }
      y1s[co1 * kYPlane + pix] = v;
    }
    __syncthreads();

    // conv1_2 on this thread's 2x2 quad for 16 channels.
    float acc[4][16];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 0; o < 16; ++o) acc[q][o] = 0.0f;

#pragma unroll 2
    for (int ci = 0; ci < kC; ++ci) {
      const float* yp = y1s + ci * kYPlane + (2 * py) * kYW + 2 * px;
      float v[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float2 lo = *reinterpret_cast<const float2*>(yp + a * kYW);
        const float2 hi = *reinterpret_cast<const float2*>(yp + a * kYW + 2);
        v[a][0] = lo.x;
        v[a][1] = lo.y;
        v[a][2] = hi.x;
        v[a][3] = hi.y;
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w2s + ((ky * 3 + kx) * kC + ci) * kC + group * 16);
          float wv[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w4 = wp[i];
            wv[4 * i] = w4.x;
            wv[4 * i + 1] = w4.y;
            wv[4 * i + 2] = w4.z;
            wv[4 * i + 3] = w4.w;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float xv = v[i + ky][j + kx];
#pragma unroll
              for (int o = 0; o < 16; ++o)
                acc[i * 2 + j][o] = fmaf(xv, wv[o], acc[i * 2 + j][o]);
            }
        }
      }
    }

    // Bias, relu and the 2x2 max-pool in registers; one pooled pixel out.
    const int oy = r0 / 2 + py, ox = c0 / 2 + px;
    if (oy < ho && ox < wo) {
      float res[16];
#pragma unroll
      for (int o = 0; o < 16; ++o) {
        const float bias = b2s[group * 16 + o];
        const float m = fmaxf(fmaxf(acc[0][o] + bias, acc[1][o] + bias),
                              fmaxf(acc[2][o] + bias, acc[3][o] + bias));
        res[o] = fmaxf(m, 0.0f);
      }
      store16(out + ((static_cast<size_t>(bi) * ho + oy) * wo + ox) * kC +
                  group * 16,
              res);
    }
    __syncthreads();  // the next tile overwrites xs and y1s
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      vgg_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>(B) * ((H + kTH - 1) / kTH) *
                          ((W + kTW - 1) / kTW);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  vgg_stem_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,H,W,3), w1 (27,64) = k1 HWIO flattened, w2 (576,64) = k2 HWIO
// flattened, all in the compute type; b1, b2 (64,) f32;
// out (B,H/2,W/2,64) in the compute type.  H and W even.
extern "C" int scda_vgg_stem_f32(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int B, int H, int W, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, B, H, W, stream);
}

extern "C" int scda_vgg_stem_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, stream);
}
