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
// bf16 design (the serving and training type).  Persistent blocks of one
// warpgroup, two to an SM, walk tiles of 16 x 8 conv1_2 output pixels.
// Shared memory (about 110 KB a block) holds
//   * w2 as bf16, transposed once per block into nine 64 x 64 K-major
//     tiles (one per tap, out-channel rows of 64 in-channels = 128 bytes)
//     in the 128-byte-swizzled layout a wgmma descriptor reads;
//   * w1, b1, b2 as f32;
//   * the input tile with a 2-pixel halo (12 x 20 x 3, f32);
//   * the y1 tile with a 1-pixel halo (10 x 18 pixels), bf16, one 128-byte
//     row of 64 channels per pixel, its 16-byte chunks swizzled by the
//     pixel's column (chunk c at c ^ ((col >> 1) & 7)) so that the
//     ldmatrix reads below never meet in a bank.
// Per tile: conv1_1 + bias + relu on the CUDA cores, each thread one pixel
// and 32 channels, summing its 27 taps in (dy, dx, ci) order so that y1
// equals the plain twin's bit for bit; zero outside the image (conv1_2's
// padding), rounded once to bf16.  conv1_2 is an implicit GEMM on the
// tensor cores: M = the tile's 128 pixels as two 64-row wgmma tiles, N =
// 64, K = 576 = 9 taps x 64 channels, f32 accumulators.  B is w2's tile of
// the tap through a shared-memory descriptor.  A comes from registers:
// the A rows of tap (dy, dx) are the y1 tile shifted by (dy * 18 + dx)
// pixels, and a descriptor whose start is not on the swizzle's 1024-byte
// period is where a shared-memory A goes wrong silently, so each warp
// gathers its 16 rows with ldmatrix (any address per row) and issues
// wgmma.mma_async with A in registers, one tap's fragments loading while
// the previous tap multiplies.  Row i of warp w in tile j is pixel
// (2 w + j, 2 (i % 8) + i / 8): a thread's accumulators for rows g and
// g + 8 of both tiles are the four pixels of one pool quad, so bias, relu
// and the 2 x 2 max stay in registers.  The pooled 4 x 8 x 64 tile goes
// through shared memory and leaves as 16-byte stores, whole 128-byte
// lines.  Ragged tiles at the right and bottom edges are masked; any
// even H and W work.  While one block of an SM runs conv1_1 on the CUDA
// cores the other can run conv1_2 on the tensor cores.
//
// What bounds it on the H100: operations.  conv1_2 is 38.7 GFLOP at
// 512x1024 (0.04 ms at the bf16 tensor peak of 989 TFLOP/s); conv1_1
// stays on the CUDA cores for the bit-equal y1, 2.5 GFLOP with the halo
// at an f32 peak of 67 TFLOP/s (0.04 ms).  Device-memory traffic is just
// the image and the pooled output (20 MB, 0.006 ms).  Measured on an H100
// 80GB HBM3 at 700 W: 0.19 ms a frame, 1.42 ms for 8.  With a phase
// compiled out (utils/kernel_probe.py) conv1_1 costs about half of that,
// conv1_2 about a quarter, and the two add up rather than overlap, since
// each block runs them in turn.
//
// f32 (the checking type) keeps the CUDA-core kernel: 16 x 8 tiles, w2 and
// a channel-major y1 tile as f32 in shared memory (about 200 KB, one
// block per SM), each thread a 2 x 2 quad of 16 channels.  TF32 would
// break the f32 gate.
//
// Numerics: x, k1 and k2 arrive in the compute type and accumulate in f32.
// conv1_1 sums its 27 taps in (dy, dx, ci) order; with bf16 operands every
// product is exact in f32, so y1 matches the plain twin's tap loop bit for
// bit.  conv1_2's sum order is the tensor cores'.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;       // channels of conv1_1 / conv1_2
constexpr int kK2 = 9 * kC;  // conv1_2 contraction depth
constexpr int kW1Floats = 27 * kC;

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// ---- bf16: conv1_2 on the tensor cores -------------------------------------

namespace tc {

constexpr int kTW = 16, kTH = 8;             // conv1_2 output tile (x, y)
constexpr int kXW = kTW + 4, kXH = kTH + 4;  // input tile, 2-pixel halo
constexpr int kYW = kTW + 2, kYH = kTH + 2;  // y1 tile, 1-pixel halo
constexpr int kYPixels = kYW * kYH;          // 180
constexpr int kThreads = 128;                // one warpgroup
constexpr int kPixelBytes = kC * 2;          // one pixel's channels: 128
constexpr int kTapBytes = kC * kPixelBytes;  // one tap of w2: 8192
constexpr int kPooled = (kTW / 2) * (kTH / 2);  // 32 pooled pixels a tile

constexpr int kW2Off = 0;                                // 1024-aligned
constexpr int kY1Off = kW2Off + 9 * kTapBytes;           // 73728
constexpr int kOutOff = kY1Off + kYPixels * kPixelBytes; // pooled tile
constexpr int kXOff = kOutOff + kPooled * kPixelBytes;
constexpr int kW1Off = kXOff + kXW * kXH * 3 * 4;
constexpr int kB1Off = kW1Off + kW1Floats * 4;
constexpr int kB2Off = kB1Off + kC * 4;
constexpr int kSmemBytes = kB2Off + kC * 4 + 1024;  // + room to align

static_assert(kThreads / 32 == kTH / 2 && kTW / 2 == 8,
              "warp = quad row, accumulator row group = quad column");
static_assert(kY1Off % 1024 == 0 && kXOff % 16 == 0, "alignment");

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; the leading-dimension offset is unused in this mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += A(64 x 16, this warp's 16 rows in registers) . B(16 x 64, shared).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 2)
vgg_stem_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const bf16* __restrict__ w2,
                     const float* __restrict__ b2, bf16* __restrict__ out,
                     int B, int H, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint8_t* w2s = smem + kW2Off;
  uint8_t* y1s = smem + kY1Off;
  uint8_t* outs = smem + kOutOff;
  float* xs = reinterpret_cast<float*>(smem + kXOff);    // [row][col][ci]
  float* w1s = reinterpret_cast<float*>(smem + kW1Off);  // [tap * 3 + ci][co]
  float* b1s = reinterpret_cast<float*>(smem + kB1Off);
  float* b2s = reinterpret_cast<float*>(smem + kB2Off);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // w2 (576, 64) = [tap * 64 + ci][co] -> per tap [co][ci], swizzled.  A
  // thread takes 8 ci x 8 co: eight 16-byte loads, transposed in
  // registers, eight 16-byte stores (chunk ci / 8 of row co).
  for (int item = tid; item < 9 * 8 * 8; item += kThreads) {
    const int cg = item % 8, ng = (item / 8) % 8, tap = item / 64;
    uint4 rows[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      rows[i] = *reinterpret_cast<const uint4*>(
          w2 + (tap * kC + cg * 8 + i) * kC + ng * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned sel = (j & 1) ? 0x7632 : 0x5410;
      unsigned o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 lo = rows[2 * q], hi = rows[2 * q + 1];
        const unsigned wl = j / 2 == 0 ? lo.x : j / 2 == 1 ? lo.y
                          : j / 2 == 2 ? lo.z : lo.w;
        const unsigned wh = j / 2 == 0 ? hi.x : j / 2 == 1 ? hi.y
                          : j / 2 == 2 ? hi.z : hi.w;
        o[q] = __byte_perm(wl, wh, sel);
      }
      const int n = ng * 8 + j;
      *reinterpret_cast<uint4*>(w2s + tap * kTapBytes + n * kPixelBytes +
                                ((cg ^ (n & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  for (int i = tid; i < kW1Floats; i += kThreads)
    w1s[i] = __bfloat162float(w1[i]);
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  fence_proxy_async();  // w2s is read through a descriptor
  __syncthreads();

  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int ho = H / 2, wo = W / 2;

  // ldmatrix rows: lane l addresses row i = l % 16 of the warp's 16, the
  // low (l < 16) or high 8 of the 16 channels of a K step.  Row i is
  // output pixel (2 warp + j, 2 (i % 8) + i / 8) of tile j.
  const int a_col = 2 * (lane % 8) + (lane % 16) / 8;
  const int a_khalf = lane / 16;
  const uint32_t y1_addr = smem_addr + kY1Off;
  const uint32_t w2_addr = smem_addr + kW2Off;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int bi = static_cast<int>(t / (tiles_y * tiles_x));
    const int rem = static_cast<int>(t % (tiles_y * tiles_x));
    const int r0 = (rem / tiles_x) * kTH, c0 = (rem % tiles_x) * kTW;
    const bf16* xb = x + static_cast<size_t>(bi) * H * W * 3;

    // Input tile: image rows r0-2 .. r0+kTH+1, cols c0-2 .. c0+kTW+1.
    for (int i = tid; i < kXH * kXW * 3; i += kThreads) {
      const int ci = i % 3, pix = i / 3;
      const int gy = r0 - 2 + pix / kXW, gx = c0 - 2 + pix % kXW;
      xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? __bfloat162float(
                        xb[(static_cast<size_t>(gy) * W + gx) * 3 + ci])
                  : 0.0f;
    }
    __syncthreads();

    // conv1_1 + bias + relu -> y1 rows r0-1 .., cols c0-1 ...  An item is
    // one pixel and one half of the channels.
    for (int item = tid; item < 2 * kYPixels; item += kThreads) {
      const int half = item / kYPixels, pix = item % kYPixels;
      const int ry = pix / kYW, rx = pix % kYW;
      const int gy = r0 - 1 + ry, gx = c0 - 1 + rx;
      float acc[32];
#pragma unroll
      for (int o = 0; o < 32; ++o) acc[o] = 0.0f;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (inside) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
              const float xv = xs[((ry + dy) * kXW + rx + dx) * 3 + ci];
              const float4* wp = reinterpret_cast<const float4*>(
                  w1s + ((dy * 3 + dx) * 3 + ci) * kC + half * 32);
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const float4 w4 = wp[q];
                acc[4 * q] = fmaf(xv, w4.x, acc[4 * q]);
                acc[4 * q + 1] = fmaf(xv, w4.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(xv, w4.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(xv, w4.w, acc[4 * q + 3]);
              }
            }
#pragma unroll
        for (int o = 0; o < 32; ++o)
          acc[o] = fmaxf(acc[o] + b1s[half * 32 + o], 0.0f);
      }
      uint8_t* row = y1s + pix * kPixelBytes;
      const int sw = (rx >> 1) & 7;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint4*>(row + (((half * 4 + q) ^ sw) << 4)) =
            make_uint4(pack_bf16x2(acc[8 * q], acc[8 * q + 1]),
                       pack_bf16x2(acc[8 * q + 2], acc[8 * q + 3]),
                       pack_bf16x2(acc[8 * q + 4], acc[8 * q + 5]),
                       pack_bf16x2(acc[8 * q + 6], acc[8 * q + 7]));
    }
    __syncthreads();

    // conv1_2: acc[j] is the 64 x 64 tile of output rows 2 warp + j.
    float acc[2][32];
#pragma unroll
    for (int o = 0; o < 32; ++o) acc[0][o] = acc[1][o] = 0.0f;
    uint32_t af[2][2][4][4];  // [buffer][tile j][K step][fragment]
    auto load_tap = [&](uint32_t (&dst)[2][4][4], int tap) {
      const int ty = tap / 3, tx = tap % 3;
      const int px = a_col + tx;
      const int sw = (px >> 1) & 7;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t row =
            y1_addr + ((2 * warp + j + ty) * kYW + px) * kPixelBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(dst[j][kk], row + (((2 * kk + a_khalf) ^ sw) << 4));
      }
    };
    load_tap(af[0], 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t db = smem_desc(w2_addr + tap * kTapBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)  // 32 bytes along K: +2 in the address field
          wgmma_m64n64k16_rs(acc[j], af[tap & 1][j][kk], db + 2 * kk);
      wgmma_commit();
      if (tap + 1 < 9) {
        wgmma_wait<1>();  // tap - 1 is done: its fragments may be replaced
        load_tap(af[(tap + 1) & 1], tap + 1);
      }
    }
    wgmma_wait<0>();

    // Bias, relu and the 2x2 max in registers: d[4 n + e] of tile j is
    // pixel (2 warp + j, 2 g + e / 2), channel 8 n + 2 t + e % 2.
    {
      const int g = lane / 4, tq = lane % 4;
      uint8_t* row = outs + (warp * 8 + g) * kPixelBytes + tq * 4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = fmaxf(fmaxf(acc[0][4 * n + e], acc[0][4 * n + 2 + e]),
                                fmaxf(acc[1][4 * n + e], acc[1][4 * n + 2 + e]));
          v[e] = fmaxf(m + b2s[8 * n + 2 * tq + e], 0.0f);
        }
        *reinterpret_cast<unsigned*>(row + ((n ^ g) << 4)) =
            pack_bf16x2(v[0], v[1]);
      }
    }
    __syncthreads();  // also: every warp is done reading y1s and xs

    // The pooled tile out: 32 pixels x 8 chunks of 16 bytes.
#pragma unroll
    for (int i = 0; i < kPooled * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int q = idx / 8, c = idx % 8;
      const int oy = r0 / 2 + q / 8, ox = c0 / 2 + q % 8;
      if (oy < ho && ox < wo)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(bi) * ho + oy) * wo + ox) * kC +
            c * 8) =
            *reinterpret_cast<const uint4*>(outs + q * kPixelBytes +
                                            ((c ^ (q & 7)) << 4));
    }
    // The next tile writes outs only after two more barriers.
  }
}

}  // namespace tc

// ---- f32: CUDA cores ---------------------------------------------------------

namespace simt {

constexpr int kTH = 16, kTW = 8;             // conv1_2 output tile
constexpr int kXH = kTH + 4, kXW = kTW + 4;  // input tile, 2-pixel halo
constexpr int kYH = kTH + 2, kYW = kTW + 2;  // y1 tile, 1-pixel halo
constexpr int kYPlane = kYH * kYW;
constexpr int kGroups = 4;                   // 16-channel output groups
constexpr int kThreads = (kTH / 2) * (kTW / 2) * kGroups;  // 128

constexpr int kW2Floats = kK2 * kC;
constexpr int kY1Floats = kC * kYPlane;
constexpr int kXFloats = kXH * kXW * 3;
constexpr int kSmemFloats = kW2Floats + kY1Floats + kXFloats + kW1Floats + 2 * kC;

static_assert(kThreads == 128, "one warp per channel group");
static_assert(kW2Floats % 4 == 0 && kY1Floats % 4 == 0, "16-byte alignment");

__global__ void __launch_bounds__(kThreads, 1)
vgg_stem_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int B, int H, int W) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // [tap * 64 + ci][co]
  float* y1s = w2s + kW2Floats;                  // [ci][row][col]
  float* xs = y1s + kY1Floats;                   // [row][col][ci]
  float* w1s = xs + kXFloats;                    // [tap * 3 + ci][co]
  float* b1s = w1s + kW1Floats;
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  for (int i = tid; i < kW2Floats; i += kThreads) w2s[i] = w2[i];
  for (int i = tid; i < kW1Floats; i += kThreads) w1s[i] = w1[i];
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
    const float* xb = x + static_cast<size_t>(bi) * H * W * 3;

    // Input tile: image rows r0-2 .. r0+kTH+1, cols c0-2 .. c0+kTW+1.
    for (int i = tid; i < kXFloats; i += kThreads) {
      const int ci = i % 3, pix = i / 3;
      const int gy = r0 - 2 + pix / kXW, gx = c0 - 2 + pix % kXW;
      xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? xb[(static_cast<size_t>(gy) * W + gx) * 3 + ci]
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
        v = fmaxf(acc + b1s[co1], 0.0f);
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
      float4* d = reinterpret_cast<float4*>(
          out + ((static_cast<size_t>(bi) * ho + oy) * wo + ox) * kC +
          group * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = make_float4(res[4 * i], res[4 * i + 1], res[4 * i + 2],
                           res[4 * i + 3]);
    }
    __syncthreads();  // the next tile overwrites xs and y1s
  }
}

}  // namespace simt

// A persistent grid: as many blocks as fit the card at once, or one per
// tile where there are fewer tiles.
template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, int tile_h, int tile_w,
           int B, int H, int W, void* stream, const void* x, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Once per kernel and device: the opt-in above 48 KB of shared memory
  // and the number of blocks the card holds at once.
  static int resident_blocks[64] = {};
  int resident = dev >= 0 && dev < 64 ? resident_blocks[dev] : 0;
  if (resident == 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    resident = sms * per_sm;
    if (dev >= 0 && dev < 64) resident_blocks[dev] = resident;
  }
  const long long tiles = static_cast<long long>(B) *
                          ((H + tile_h - 1) / tile_h) *
                          ((W + tile_w - 1) / tile_w);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  void* args[] = {&x, &w1, &b1, &w2, &b2, &out, &B, &H, &W};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                       dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,H,W,3), w1 (27,64) = k1 HWIO flattened, w2 (576,64) = k2 HWIO
// flattened, all in the compute type; b1, b2 (64,) f32;
// out (B,H/2,W/2,64) in the compute type.  H and W even; w2 and out
// 16-byte aligned.
extern "C" int scda_vgg_stem_f32(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int B, int H, int W, void* stream) {
  return launch(simt::vgg_stem_f32_kernel, simt::kThreads,
                simt::kSmemFloats * static_cast<int>(sizeof(float)),
                simt::kTH, simt::kTW, B, H, W, stream, x, w1, b1, w2, b2, out);
}

extern "C" int scda_vgg_stem_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, void* stream) {
  return launch(tc::vgg_stem_bf16_kernel, tc::kThreads, tc::kSmemBytes,
                tc::kTH, tc::kTW, B, H, W, stream, x, w1, b1, w2, b2, out);
}
