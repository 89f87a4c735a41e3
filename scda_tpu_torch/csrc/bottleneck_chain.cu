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
// One C call loops over the N blocks, three launches each.  Weights arrive
// transposed, (N_out, K) with K contiguous, so both operand tiles are
// K-contiguous rows.
//
// bf16 (the serving and training type) runs on the tensor cores with
// wgmma.  A block is one warpgroup that owns a 64 x BN output tile (BN =
// 128 where that still leaves about a block per SM, else 64) and walks K
// in 64-deep slices through a ring of shared-memory stages (six of 16 KB,
// or four of 24 KB: at most 96 KB, so two blocks share an SM and fill
// each other's prologues).  Each slice is one 128-byte row per tile row,
// written by zero-filling 16-byte cp.async copies into the
// 128-byte-swizzled K-major layout that a wgmma descriptor reads (chunk c
// of row r lands at chunk c ^ (r & 7); 8-row groups 1024 bytes apart), so
// the 3x3's shifted and padded rows are gathered by the copies and the
// descriptors never move off a 1024-byte boundary.  All but two stages
// are in flight while one slice is multiplied (wgmma.mma_async m64nBNk16,
// A and B both from shared memory, f32 accumulators in registers) and the
// one before it drains; one __syncthreads per 64-deep slice.  Row
// pointers and the nine taps' in-image bits are computed once per thread,
// so a slice costs no division.  The epilogue goes through shared memory:
// the accumulators are staged as f32, then each thread adds the bias
// (and, for the expand, the residual it alone reads from the stream) to
// 8 neighbouring channels, applies relu, rounds once and writes 16 bytes,
// so every row of the tile leaves as whole 128-byte lines.
//
// f32 (the checking type) keeps CUDA-core FMAs on 64 x 64 x 32 tiles,
// double-buffered with cp.async: TF32 would break the f32 gates.
//
// What bounds it on the H100: arithmetic on paper, about 4.6 GFLOP per
// block at every ResNet-101 stage at 512x1024 (123 GFLOP per image over
// 27 blocks, 0.13 ms at the bf16 peak of 989 TFLOP/s).  Measured on an
// H100 80GB HBM3 at 700 W, replayed from a CUDA graph: 0.095 / 0.088 /
// 0.54 ms for layer1 / layer2 / layer3 (bounds 0.010 / 0.014 / 0.10).  The
// 3N launches are short (5 to 18 us each), and at layer3 (M = 2048, 128
// blocks, under one wave) it is L2 traffic that bounds each: a 64-wide
// tile re-reads A N / 64 times and the weights M / 64 times, 32 MB per
// 1x1 and 75 MB per 3x3 at 5.6 to 7.3 TB/s.  Overlapping consecutive
// launches (programmatic dependent launch) gained nothing there.
// layer1's expand is one K slice and moves bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kReduce = 0, kConv3x3 = 1, kExpand = 2 };

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
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The pixel a tile row reads: its index (or -1 past M) and, for the 3x3,
// its row and column in its image.
struct RowPixel {
  int pix, y, x;
};
template <int kMode>
__device__ __forceinline__ RowPixel row_pixel(int m, int M, int H, int W) {
  RowPixel r = {m < M ? m : -1, 0, 0};
  if (kMode == kConv3x3 && m < M) {
    const int rem = m % (H * W);
    r.y = rem / W;
    r.x = rem % W;
  }
  return r;
}
// The source of 8 A elements of that row at K offset k0 + kc, or nullptr
// for a row past M or a 3x3 tap outside the image (copied as zeros).  For
// kConv3x3, K = 9F ordered (tap, channel), tap = (dy + 1) * 3 + (dx + 1),
// and a slice never straddles two taps (F divides by the slice depth).
template <int kMode, typename T>
__device__ __forceinline__ const T* a_source(const T* a, const RowPixel& r,
                                             int K, int k0, int kc, int H,
                                             int W) {
  if (r.pix < 0) return nullptr;
  if (kMode != kConv3x3) return a + static_cast<size_t>(r.pix) * K + k0 + kc;
  const int f = K / 9, tap = k0 / f;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int yy = r.y + dy, xx = r.x + dx;
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return nullptr;
  return a + static_cast<size_t>(r.pix + dy * W + dx) * f + (k0 - tap * f) + kc;
}

// ---- bf16: wgmma --------------------------------------------------------

constexpr int kBM = 64;        // tile rows: one wgmma M
constexpr int kBK = 64;        // K slice: one 128-byte swizzled row
constexpr int kThreads = 128;  // one warpgroup
constexpr int kRowBytes = kBK * 2;
constexpr int kATileBytes = kBM * kRowBytes;
constexpr int kStagePad = 8;   // f32 staging row padding (bank spread)

// Ring depth: at most 96 KB a block, so that two blocks share an SM.
// kStages - 2 slices are in flight while one is multiplied and the one
// before it may still be.
__host__ __device__ constexpr int stages(int bn) { return bn == 128 ? 4 : 6; }
__host__ __device__ constexpr int stage_bytes(int bn) {
  return kATileBytes + bn * kRowBytes;
}
__host__ __device__ constexpr int wgmma_smem_bytes(int bn) {
  return stages(bn) * stage_bytes(bn) + 1024;  // + room to align to 1024
}
static_assert(kBM * (128 + kStagePad) * 4 <= stages(128) * stage_bytes(128) &&
                  kBM * (64 + kStagePad) * 4 <= stages(64) * stage_bytes(64),
              "the f32 staging tile reuses the ring");

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
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Orders generic-proxy writes to shared memory (cp.async, st.shared)
// before the async proxy's reads (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A(64 x 16) . B(16 x BN), both operands from shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_m64n64k16(d, da, db);
  else wgmma_m64n128k16(d, da, db);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16x2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// out (M, N) = epilogue(A (M, K) . wt (N, K)^T + bias), bf16 in and out.
// For kExpand, out is the residual stream, read and updated in place (each
// 8-channel group by one thread of one block).  N % BN == 0, K % 64 == 0
// (F % 64 == 0 for kConv3x3); M is masked.
template <int kMode, int BN>
__global__ void __launch_bounds__(kThreads)
chain_wgmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wt,
                   const float* __restrict__ bias, bf16* out, int M, int N,
                   int K, int H, int W) {
  constexpr int kStages = stages(BN), kAhead = kStages - 2;
  constexpr int kStageBytes = stage_bytes(BN);
  constexpr int kBPasses = BN / 16;  // B rows per thread and slice
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  // A thread copies 16-byte chunk `chunk` of tile rows r_base + 16 p.  In
  // the swizzled K-major layout (tile base 1024-aligned) chunk c of row r
  // lies at r * 128 + ((c ^ (r & 7)) << 4); r & 7 is the same for all p.
  const int chunk = tid % 8, r_base = tid / 8;
  const int dst = r_base * kRowBytes + ((chunk ^ (r_base & 7)) << 4);
  constexpr int kPassBytes = 16 * kRowBytes;

  // Per A row: where its pixel's channels start, and which of the taps
  // lie inside the image (bit `tap`; a 1x1 has the one tap 0).  For
  // kConv3x3, K = 9F ordered (tap, channel), tap = (dy + 1) * 3 + (dx + 1).
  const int f = kMode == kConv3x3 ? K / 9 : K;
  const bf16* a_row[4];
  unsigned a_taps[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + r_base + 16 * p;
    a_row[p] = a;
    a_taps[p] = 0;
    if (m < M) {
      a_row[p] = a + static_cast<size_t>(m) * f + chunk * 8;
      a_taps[p] = 1;
      if (kMode == kConv3x3) {
        const int rem = m % (H * W), y = rem / W, x = rem % W;
        a_taps[p] = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) a_taps[p] |= 1u << tap;
        }
      }
    }
  }
  const bf16* b_row = wt + static_cast<size_t>(n0 + r_base) * K + chunk * 8;

  // The producer's position: slice k0, inside tap `tap` at channel `kin`
  // (a slice never straddles two taps: F divides by the slice depth).
  int ld_k0 = 0, ld_tap = 0, ld_kin = 0, ld_stage = 0;
  auto load_slice = [&]() {
    uint8_t* as = smem + ld_stage * kStageBytes + dst;
    uint8_t* bs = as + kATileBytes;
    const int a_off = kMode == kConv3x3
                          ? ((ld_tap / 3 - 1) * W + ld_tap % 3 - 1) * f + ld_kin
                          : ld_k0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const bool ok = (a_taps[p] >> ld_tap) & 1;
      cp_async16(as + p * kPassBytes, ok ? a_row[p] + a_off : a, ok);
    }
#pragma unroll
    for (int p = 0; p < kBPasses; ++p)
      cp_async16(bs + p * kPassBytes,
                 b_row + static_cast<size_t>(16 * p) * K + ld_k0, true);
    ld_k0 += kBK;
    ld_kin += kBK;
    if (kMode == kConv3x3 && ld_kin == f) {
      ld_kin = 0;
      ++ld_tap;
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load_slice();
    cp_async_commit();
  }
  int cur = 0;
  for (int kt = 0; kt < nk; ++kt) {
    // Slice kt is the oldest of at most kAhead pending groups.
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    // Refill the stage that slice kt - 2 used: its wgmmas have completed
    // in every warp (wgmma_wait<1> below, then the barrier above).
    if (kt + kAhead < nk) load_slice();
    cp_async_commit();

    const uint32_t as = smem_addr + cur * kStageBytes;
    const uint64_t da = smem_desc(as), db = smem_desc(as + kATileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes along K: +2 in the address field
      wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    cur = cur + 1 == kStages ? 0 : cur + 1;
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it

  // Stage the accumulators as f32.  wgmma's D layout: warp w holds rows
  // 16 w + g and 16 w + g + 8 (g = lane / 4), columns 8 j + 2 t, + 1
  // (t = lane % 4) in d[4 j .. 4 j + 3].
  constexpr int kLd = BN + kStagePad;
  float* stage = reinterpret_cast<float*>(smem);
  {
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    float* lo = stage + (16 * warp + g) * kLd + 2 * t;
    float* hi = lo + 8 * kLd;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(lo + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(hi + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  // Bias (+ residual), relu, one rounding; 8 channels = 16 bytes a thread.
  constexpr int kChunksPerRow = BN / 8;
#pragma unroll
  for (int i = 0; i < kBM * kChunksPerRow / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunksPerRow, c = idx % kChunksPerRow;
    const int m = m0 + r;
    if (m >= M) continue;
    const int n = n0 + 8 * c;
    const float4 s0 = *reinterpret_cast<const float4*>(stage + r * kLd + 8 * c);
    const float4 s1 = *reinterpret_cast<const float4*>(stage + r * kLd + 8 * c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
    float v[8] = {s0.x + b0.x, s0.y + b0.y, s0.z + b0.z, s0.w + b0.w,
                  s1.x + b1.x, s1.y + b1.y, s1.z + b1.z, s1.w + b1.w};
    uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n);
    if (kMode == kExpand) {
      const uint4 res = *o;
      const unsigned rw[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack_bf16x2(rw[q]);
        v[2 * q] += f.x;
        v[2 * q + 1] += f.y;
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = fmaxf(v[q], 0.0f);
    *o = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

template <int kMode, int BN>
cudaError_t launch_wgmma(const bf16* a, const bf16* wt, const float* bias,
                         bf16* out, int M, int N, int K, int H, int W,
                         int dev, cudaStream_t s) {
  constexpr int smem = wgmma_smem_bytes(BN);
  // The opt-in above 48 KB of shared memory, once per device.
  static bool opted[64] = {};
  if (dev < 0 || dev >= 64 || !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_wgmma_kernel<kMode, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
  chain_wgmma_kernel<kMode, BN>
      <<<dim3((M + kBM - 1) / kBM, N / BN), kThreads, smem, s>>>(
          a, wt, bias, out, M, N, K, H, W);
  return cudaGetLastError();
}

// 128-wide tiles re-read less of A and were the faster wherever they still
// filled the card (measured at the three ResNet-101 stages at 512x1024);
// with fewer blocks than about one per SM, 64-wide tiles win.
template <int kMode>
cudaError_t gemm_bf16(const bf16* a, const bf16* wt, const float* bias,
                      bf16* out, int M, int N, int K, int H, int W, int dev,
                      int sms, cudaStream_t s) {
  const long long wide_blocks =
      static_cast<long long>((M + kBM - 1) / kBM) * (N / 128);
  if (N % 128 == 0 && wide_blocks >= sms - sms / 8)
    return launch_wgmma<kMode, 128>(a, wt, bias, out, M, N, K, H, W, dev, s);
  return launch_wgmma<kMode, 64>(a, wt, bias, out, M, N, K, H, W, dev, s);
}

// ---- f32: CUDA-core FMAs --------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 32;
constexpr int kFThreads = 128;  // 4 warps, 2 x 2, each 32 x 32 outputs

// out (M, N) = epilogue(A (M, K) . wt (N, K)^T + bias) in f32, as above.
// N % 64 == 0 and K % 32 == 0; M is masked.
template <int kMode>
__global__ void __launch_bounds__(kFThreads)
chain_gemm_f32_kernel(const float* __restrict__ a,
                      const float* __restrict__ wt,
                      const float* __restrict__ bias, float* out, int M, int N,
                      int K, int H, int W) {
  constexpr int kChunk = 4;           // floats per 16-byte copy
  constexpr int kLd = kFBK + kChunk;  // padded shared row: no bank conflicts
  constexpr int kCpr = kFBK / kChunk;             // copies per tile row
  constexpr int kRowsPerPass = kFThreads / kCpr;  // tile rows per pass
  constexpr int kPasses = kFBM / kRowsPerPass;
  static_assert(kFBM == kFBN, "A and B tiles share the copy mapping");

  __shared__ __align__(16) float as[2][kFBM * kLd];
  __shared__ __align__(16) float bs[2][kFBN * kLd];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kFBM, n0 = blockIdx.y * kFBN;
  const int kc = (tid % kCpr) * kChunk;
  const int r_base = tid / kCpr;

  RowPixel rows[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
    rows[p] = row_pixel<kMode>(m0 + r_base + p * kRowsPerPass, M, H, W);

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kFBK;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = r_base + p * kRowsPerPass;
      const float* src = a_source<kMode>(a, rows[p], K, k0, kc, H, W);
      cp_async16(&as[stage][r * kLd + kc], src ? src : a, src != nullptr);
      cp_async16(&bs[stage][r * kLd + kc],
                 wt + static_cast<size_t>(n0 + r) * K + k0 + kc, true);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;

  // acc[mi][ni][i]: rows wm + 16 mi + g (+8 for i >= 2), columns
  // wn + 8 ni + 2 t + (i & 1).
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

  const int nk = K / kFBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kt has landed
    __syncthreads();
    const float* A = as[kt & 1];
    const float* Bt = bs[kt & 1];
#pragma unroll 8
    for (int k = 0; k < kFBK; ++k) {
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
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // Epilogue: bias (+ residual), relu.
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
        float* o = out + static_cast<size_t>(m) * N + n;
        if (kMode == kExpand) {
          v0 += o[0];
          v1 += o[1];
        }
        *reinterpret_cast<float2*>(o) =
            make_float2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
}

template <int kMode>
cudaError_t gemm_f32(const float* a, const float* wt, const float* bias,
                     float* out, int M, int N, int K, int H, int W, int, int,
                     cudaStream_t s) {
  chain_gemm_f32_kernel<kMode>
      <<<dim3((M + kFBM - 1) / kFBM, N / kFBN), kFThreads, 0, s>>>(
          a, wt, bias, out, M, N, K, H, W);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t gemm(const bf16* a, const bf16* wt, const float* bias, bf16* out,
                 int M, int N, int K, int H, int W, int dev, int sms,
                 cudaStream_t s) {
  return gemm_bf16<kMode>(a, wt, bias, out, M, N, K, H, W, dev, sms, s);
}
template <int kMode>
cudaError_t gemm(const float* a, const float* wt, const float* bias,
                 float* out, int M, int N, int K, int H, int W, int dev, int sms,
                 cudaStream_t s) {
  return gemm_f32<kMode>(a, wt, bias, out, M, N, K, H, W, dev, sms, s);
}

template <typename T>
int chain(void* x, const void* w1t, const void* b1, const void* w2t,
          const void* b2, const void* w3t, const void* b3, void* y1, void* y2,
          int B, int H, int W, int C, int F, int N, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  T* xs = static_cast<T*>(x);
  T* y1s = static_cast<T*>(y1);
  T* y2s = static_cast<T*>(y2);
  for (int i = 0; i < N; ++i) {
    const T* w1 = static_cast<const T*>(w1t) + static_cast<size_t>(i) * F * C;
    const T* w2 =
        static_cast<const T*>(w2t) + static_cast<size_t>(i) * F * 9 * F;
    const T* w3 = static_cast<const T*>(w3t) + static_cast<size_t>(i) * C * F;
    e = gemm<kReduce>(xs, w1, static_cast<const float*>(b1) + i * F, y1s, M,
                      F, C, H, W, dev, sms, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = gemm<kConv3x3>(y1s, w2, static_cast<const float*>(b2) + i * F, y2s, M,
                       F, 9 * F, H, W, dev, sms, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = gemm<kExpand>(y2s, w3, static_cast<const float*>(b3) + i * C, xs, M,
                      C, F, H, W, dev, sms, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return cudaSuccess;
}

}  // namespace

// x (B,H,W,C): the residual stream in the compute type, updated in place.
// w1t (N,F,C), w2t (N,F,9F) ordered (tap, in-channel), w3t (N,C,F): the
// folded weights transposed, in the compute type; b1, b2 (N,F), b3 (N,C)
// f32; y1, y2 (B,H,W,F) scratch in the compute type.  C % 64 == 0 and
// F % 64 == 0; every pointer 16-byte aligned.
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
