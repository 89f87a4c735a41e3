// Backward of the fused ResNet bottleneck chain (K4) for Hopper (sm_90a):
// the gradients of x and of the six folded weight stacks of
//
//   y1 = relu(x @ w1 + b1)                 1x1 reduce,  C -> F
//   y2 = relu(conv3x3(y1, w2) + b2)        3x3 pad 1,   F -> F
//   x' = relu(y2 @ w3 + b3 + x)            1x1 expand,  F -> C, residual
//
// over N blocks on an NHWC map.  Replaces the custom_vjp backward of
// scda_tpu/ops/pallas/bottleneck_kernel.py:bottleneck_chain (its `bwd`, a
// jax.vjp of chain_reference in uniform f32 on the inputs rounded to the
// forward's type): the wrapper rounds x and the weights the same way, and
// every product here runs on the tensor cores at f32-class accuracy.
//
// What it computes.  One C call does the whole backward on PyTorch's
// stream:
//   1. the remat: the chain's forward again in f32, keeping every block's
//      input x_i, y1_i and y2_i (post-relu) and the output x_N in one
//      workspace, (N * (C + 2F)) * B*H*W floats: 12.6 MB a block at
//      ResNet-101's layer3 at 512x1024 and bs 1, 277 MB for its 22 blocks;
//   2. g3 = g * [x_N > 0];
//   3. for each block from the last to the first, with g3 the cotangent
//      of the block's pre-relu output:
//        dW3 = y2^T g3,  db3 = sum_m g3
//        dy2 = (g3 W3^T) * [y2 > 0]
//        dW2[tap] = shift(y1, tap)^T dy2 (zero outside the image),
//        db2 = sum_m dy2
//        dy1 = conv3x3^T(dy2, W2) * [y1 > 0]: the forward's implicit GEMM
//              over the taps reversed, against each tap's weight
//              transposed (packed so by the wrapper)
//        dW1 = x_i^T dy1,  db1 = sum_m dy1
//        dx  = dy1 W1^T + g3, times [x_i > 0] in the same epilogue, which
//              makes it the previous block's g3 (not for block 0)
//      Only the gradients asked for are computed (a null output pointer
//      skips one); the model never asks for the biases' (they are
//      FrozenBatchNorm's).
//
// Numerics: split TF32.  A TF32 tensor-core product keeps 11 significant
// bits of each operand.  Each f32 operand is split once, where it enters
// shared memory or registers, into hi = cvt.rna.tf32(a) and lo =
// cvt.rna.tf32(a - hi), which carry 22 of its 24 bits, and a product is
// the sum of the passes
//   - data products (remat, dy2, dy1, dx): lo(a) W + hi(a) W when the
//     wrapper's dtype is bf16 (the weights are bf16 values, exact in
//     TF32: two passes), lo(a) hi(W) + hi(a) lo(W) + hi(a) hi(W) under
//     float32 (three);
//   - weight gradients: three passes, both operands being f32 maps.
// Every pass of one 32-deep slice accumulates into a fresh register tile
// in the tensor cores, which is then added to the f32 sum with a plain
// FADD: published tests of NVIDIA's tensor cores find their f32
// accumulation rounds toward zero, and a chain of thousands of such
// additions could bias the sums by about 1e-5; a slice adds at most 12.  The relative error of a product is
// then about 2^-21, against the 1e-4 gates.  The remat is no longer the
// f32 forward kernel's chain bit for bit: a relu gate whose
// pre-activation lies within rounding of 0 may flip, so the checks
// linearise the plain twin at this kernel's own remat (handed back to
// callers that ask for it) and hold the remat itself to the forward
// kernel's f32 chain.
//
// Design.
//   - Data products: one warpgroup a block owns a 64 x BN output tile (BN
//     = 128 where N allows, else 64) and walks its K range in 32-float
//     slices, one 128-byte swizzled row per tile row, through a ring of
//     three shared-memory stages filled by zero-filling 16-byte cp.async
//     copies (the 3x3 and its transpose gather shifted pixels and
//     zero-fill the padding, as the forward does).  The thread that copied
//     a 16-byte chunk splits it in place (hi over the f32, lo into a
//     second tile at the same offset), so no barrier separates the copy
//     and the split; wgmma m64nBNk8 then reads hi and lo tiles through
//     K-major 128-byte-swizzle descriptors.  Slice k + 1 is split while
//     slice k's wgmmas run; two slices are in flight behind it.  Three
//     stages of 32 KB (bf16) leave room for two blocks an SM.
//   - Filling the card at bs 1: layer3 has 2048 pixels, so 64 x 128
//     tiles over N = F = 256 give 64 blocks for 132 SMs.  A product with
//     fewer blocks than SMs splits its K range (the wrapper's
//     product_splits: the 3x3 into groups of taps, 1x1s into channel
//     ranges); each split writes its tile's partial sums to scratch in
//     register order, and the block that finishes last, found by a
//     per-tile counter, adds the partials in split order and runs the
//     epilogue.  The counter decides which block adds, never the order.
//     Running a tile's splits as one thread-block cluster that adds them
//     through distributed shared memory was measured too: 2-3 way splits
//     gained about 2 us, but co-scheduling the 8-block clusters of the
//     1x1 weight gradients cost 16 (45 against 29 us), 8.2 against 7.3
//     ms at layer3 in all.
//   - Weight gradients reduce over the pixels, and both operands are
//     stored along the channels, while TF32 wgmma reads a shared-memory
//     operand only K-major (here pixel-major).  What bounds them on
//     this card: at 4-byte operands the tensor cores' appetite for shared
//     memory.  An m64n128k8 wgmma with both operands in shared memory reads
//     6 KB for 64 cycles of work, 96 of the SM's 128 bytes a cycle, so
//     every other pass through shared memory (staging copies, the split
//     and transpose) competes with the products; and for the 3x3, whose
//     nine taps each read both operands again, L2's bandwidth.  The design:
//     128 x 128 output tiles, which halve the L2 reads of 64 x 64 ones;
//     one block an SM of three warpgroups.  Warpgroup 0 produces: it
//     copies each 32-pixel slice of both operands as they lie into a ring
//     of three stages (cp.async, two slices ahead, the 3x3's taps
//     zero-filled outside the image), and splits and transposes bm alone
//     into swizzled K-major hi and lo tiles (a thread owns one channel and
//     loads its 32 values before its first store).  Warpgroups 1 and 2
//     consume, 64 rows of A each: they take A from the stage straight into
//     registers a k-step at a time (the TF32 A fragment; rows padded so
//     that its loads hit 32 banks), split it there while the previous
//     k-step's wgmmas run, and multiply it by bm's tiles, so that their
//     wgmmas read only bm from shared memory and never wait on a split
//     pass.  mbarriers hand each stage from producer to consumers and
//     back.  The pixel axis is cut into splits only to balance waves (the
//     wrapper's wgrad_plan, from kernel_probe k4bwd-phases), added in
//     split order by the last block as above.  Measured (k4bwd-phases, a
//     launch, H100 80GB HBM3 at 700 W), the 64 x 64 kernel this replaces
//     (one warpgroup a block copying, splitting and multiplying) against
//     this one: FPN's layer3 at 1024x2048, bs 2, dW3 0.209 -> 0.103 ms and
//     dW2 0.716 -> 0.291 ms (3-pass TF32 bounds 0.052 and 0.117); its
//     layer2 0.170 -> 0.119 and 0.742 -> 0.295, layer4 0.161 -> 0.100 and
//     0.744 -> 0.332; res101-ms at bs 1, layer3 0.0275 -> 0.0235 and
//     0.0984 -> 0.0500, layer2 0.0359 -> 0.0355 and 0.0857 -> 0.0533.
//     In the FPN training step's trace the weight gradients take 13.7 ms
//     a step, against 30.8 for the 64 x 64 kernel.  Tried on the way: a
//     producer loading global memory straight into registers (no staging)
//     was latency-bound with one slice in registers (0.194 ms for layer3's
//     dW3) and spilled with two; one transposing both operands, 0.125 ms.
//   - No atomics accumulate anything: every output element is written
//     once by one thread after sums in a fixed order, so two calls on the
//     same inputs give the same bits.
//
// What bounds it on the H100: arithmetic.  The remat, the data gradients
// and the weight gradients each do the forward's operations, about 100
// GFLOP each at layer3 at bs 1; in split TF32, 2 + 2 + 3 passes of them
// at 495 TFLOP/s dense TF32 is 1.4 ms (4.5 ms at the f32 CUDA-core peak
// of 67 TFLOP/s, where the f32 FMA kernel this replaces ran, 12.3-12.7
// ms), against 13 MB of the stream and its gradient in and out.
// Measured on an H100 80GB HBM3 at 700 W (utils/kernel_probe.py k4bwd,
// the gradients the model asks for, launches alone): 1.04 ms at layer2
// and 6.12 ms at layer3 at bs 1 (1.14 and 7.28 with the 64 x 64
// weight-gradient kernel), 30.7 ms at layer3 at bs 8 and at FPN's layer3
// at bs 2 (44.9 and 44.8 with it; tensor-core bounds 0.19, 1.42 and 11.4
// ms).  What holds the data
// products back (k4bwd-phases, layer3, bs 1): each split product's launch
// and partial sums (11 us of a reduce 1x1's 15 with every phase compiled
// out); cvt.rna.tf32 measured no faster than the two integer operations
// used instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one warpgroup

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

// a rounded to TF32 as cvt.rna.tf32.f32 rounds it (nearest, ties away
// from zero) with its low 13 bits cleared, so the value is exact both as
// f32 and as a TF32 operand: half of the dropped unit added to the
// magnitude's bits carries into the kept ones exactly when the dropped
// part is at least half.  Two integer operations, the rounding that the
// tests' CPU model does bit for bit; the cvt measured no faster.
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}
// a = hi + lo to 22 significant bits.
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - hi);
}

// Whether pixel m (of B images of H x W) shifted by (dy, dx) stays inside
// its image.
__device__ __forceinline__ bool in_image(int m, int dy, int dx, int H,
                                         int W) {
  const int rem = m % (H * W), y = rem / W + dy, x = rem % W + dx;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// The block that finishes a split output tile last: every thread has
// stored its partial sums; returns true in every thread of the block that
// arrived last, which then resets the tile's counter to 0 for the next
// launch.  Which block that is decides nothing about the order in which
// the partials are added.
__device__ __forceinline__ bool last_split(int* counter, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// acc[i] (each of T threads' R registers of a tile) = the sum over the
// splits, in split order, of the partials that every split stored at
// part[(s R + i) * T + tid], this block's own included (read back, so the
// sum is the same whichever block adds).  A split's R loads are
// independent and go out together: a loop over i inside s would wait for
// L2 once per register.
template <int R, int T = kThreads>
__device__ __forceinline__ void sum_splits(float (&acc)[R],
                                           const float* part, int splits,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* src = part + static_cast<size_t>(sp) * R * T + tid;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += __ldcg(src + i * T);
  }
}
template <int R, int T = kThreads>
__device__ __forceinline__ void store_split(const float (&acc)[R],
                                            float* part, int own, int tid) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    __stcg(part + (static_cast<size_t>(own) * R + i) * T + tid, acc[i]);
}

// mbarriers in shared memory (addresses in the shared window).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Arrives with release semantics: this thread's earlier writes are seen by
// the threads that wait on the phase it completes.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// A barrier among `count` threads (whole warps) under id `id` (0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- data products: wgmma in split TF32 ---------------------------------

constexpr int kBM = 64;          // tile rows: one wgmma M
constexpr int kSlice = 32;       // K slice: 32 floats, one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kATile = kBM * kRowBytes;
constexpr int kPassBytes = 16 * kRowBytes;  // 16 tile rows a copy pass
constexpr int kStages = 3;

__host__ __device__ constexpr int b_tile_bytes(int bn) {
  return bn * kRowBytes;
}
// A (hi in place), A lo, B (hi in place) and, under f32, B lo.
__host__ __device__ constexpr int stage_bytes(int bn, bool split_b) {
  return 2 * kATile + (split_b ? 2 : 1) * b_tile_bytes(bn);
}
__host__ __device__ constexpr int product_smem_bytes(int bn, bool split_b) {
  return kStages * stage_bytes(bn, split_b) + 1024;  // + room to align
}

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

// d = (scale_d ? d : 0) + A(64 x 8) . B(8 x BN), TF32 operands from
// shared memory, f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 64) wgmma_m64n64k8(d, da, db, scale_d);
  else wgmma_m64n128k8(d, da, db, scale_d);
}

// d = (scale_d ? d : 0) + A(64 x 8) . B(8 x 128), A from registers (the
// TF32 fragment: warp w of the warpgroup holds rows 16 w + g and + 8,
// columns t and t + 4, g = lane / 4, t = lane % 4, in a[0..3] as (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)), B from shared memory.  The
// registers of a must keep their values until the wgmma has completed.
__device__ __forceinline__ void wgmma_m64n128k8_ra(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// Keeps registers that an asynchronous wgmma reads or writes where they
// are: the compiler neither reuses them nor moves their other uses across
// this point.
__device__ __forceinline__ void hold(const uint32_t (&r)[4]) {
  asm volatile("" ::"r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One data product: out (M, N) = epilogue(A (M, K) . bt (N, K)^T).  For
// kConv, K = 9f ordered (tap, channel), tap = (dy + 1) * 3 + (dx + 1),
// and the A row of pixel m at tap is pixel m + dy W + dx of the (M, f)
// map, zero outside the image.  Epilogue, each step only where its
// pointer or flag is set: + bias[n], + add[m, n], relu, then 0 where
// mask[m, n] <= 0.  The K range is cut into `splits` equal parts (for
// kConv whole groups of taps), grid.z; partial tiles go through `part`.
struct Product {
  const float* a;
  const float* bt;
  float* out;
  const float* bias;
  const float* add;
  const float* mask;
  float* part;
  int* counters;
  int M, N, K, H, W, splits, relu;
};

// N % BN == 0; K / splits % 32 == 0 (for kConv, f % 32 == 0 and 9 %
// splits == 0); M is masked.
template <bool kConv, int BN, bool kSplitB>
__global__ void __launch_bounds__(kThreads)
chain_bwd_wgmma_kernel(const Product p) {
  constexpr int kStageBytes = stage_bytes(BN, kSplitB);
  constexpr int kBTile = b_tile_bytes(BN);
  constexpr int kBPasses = BN / 16;  // B rows per thread and slice
  constexpr int kR = BN / 2;         // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int M = p.M, K = p.K, W = p.W;
  const int f = kConv ? K / 9 : K;
  const int kspan = K / p.splits, nk = kspan / kSlice;
  // A thread copies 16-byte chunk `chunk` of tile rows r_base + 16 q.  In
  // the swizzled K-major layout (tile base 1024-aligned) chunk c of row r
  // lies at r * 128 + ((c ^ (r & 7)) << 4); r & 7 is the same for all q.
  const int chunk = tid % 8, r_base = tid / 8;
  const int dst = r_base * kRowBytes + ((chunk ^ (r_base & 7)) << 4);

  // Per A row: where its pixel's channels start, and which of the taps
  // lie inside the image (bit `tap`; a 1x1 has the one tap 0).
  const float* a_row[4];
  unsigned a_taps[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + r_base + 16 * q;
    a_row[q] = p.a;
    a_taps[q] = 0;
    if (m < M) {
      a_row[q] = p.a + static_cast<size_t>(m) * f + chunk * 4;
      a_taps[q] = 1;
      if (kConv) {
        a_taps[q] = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          if (in_image(m, tap / 3 - 1, tap % 3 - 1, p.H, W))
            a_taps[q] |= 1u << tap;
      }
    }
  }
  const float* b_row = p.bt + static_cast<size_t>(n0 + r_base) * K + chunk * 4;

  // The producer's position: slice ld_k0, inside tap ld_tap at channel
  // ld_kin (a slice never straddles two taps: f divides by the slice).
  int ld_k0 = split * kspan;
  int ld_tap = kConv ? ld_k0 / f : 0, ld_kin = kConv ? ld_k0 % f : 0;
  int ld_stage = 0;
  auto load_slice = [&]() {
    uint8_t* st = smem + ld_stage * kStageBytes + dst;
    const int a_off = kConv
                          ? ((ld_tap / 3 - 1) * W + ld_tap % 3 - 1) * f + ld_kin
                          : ld_k0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (a_taps[q] >> ld_tap) & 1;
      cp_async16(st + q * kPassBytes, ok ? a_row[q] + a_off : p.a, ok);
    }
#pragma unroll
    for (int q = 0; q < kBPasses; ++q)
      cp_async16(st + 2 * kATile + q * kPassBytes,
                 b_row + static_cast<size_t>(16 * q) * K + ld_k0, true);
    ld_k0 += kSlice;
    if (kConv) {
      ld_kin += kSlice;
      if (ld_kin == f) {
        ld_kin = 0;
        ++ld_tap;
      }
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
  };
  // The chunks this thread copied into `stage`, split in place: hi over
  // the f32, lo at the same offset in the next tile.
  auto split4 = [](uint8_t* at, int lo_off) {
    const float4 v = *reinterpret_cast<const float4*>(at);
    float4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(at) = hi;
    *reinterpret_cast<float4*>(at + lo_off) = lo;
  };
  auto split_slice = [&](int stage) {
    uint8_t* st = smem + stage * kStageBytes + dst;
#pragma unroll
    for (int q = 0; q < 4; ++q) split4(st + q * kPassBytes, kATile);
    if (kSplitB) {
#pragma unroll
      for (int q = 0; q < kBPasses; ++q)
        split4(st + 2 * kATile + q * kPassBytes, kBTile);
    }
  };

  float acc[kR], tmp[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = tmp[i] = 0.0f;

  // Slice kt: copied (kt + 2 at most), split by the threads that copied
  // it while slice kt - 1 is multiplied, multiplied; its stage is
  // refilled with slice kt + 3 once every warp's wgmmas on it completed.
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nk) load_slice();
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  if (nk > 0) split_slice(0);
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt % kStages;
    const uint32_t base = smem_addr + cur * kStageBytes;
    const uint64_t a_hi = smem_desc(base), a_lo = smem_desc(base + kATile);
    const uint64_t b_hi = smem_desc(base + 2 * kATile);
    const uint64_t b_lo = smem_desc(base + 2 * kATile + kBTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {  // 32 bytes along K: +2
      wgmma_tile<BN>(tmp, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);
      if (kSplitB) wgmma_tile<BN>(tmp, a_hi + 2 * kk, b_lo + 2 * kk, 1);
      wgmma_tile<BN>(tmp, a_hi + 2 * kk, b_hi + 2 * kk, 1);
    }
    wgmma_commit();
    if (kt + 1 < nk) {
      cp_async_wait<kStages - 2>();  // slice kt + 1 has landed
      split_slice((kt + 1) % kStages);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] += tmp[i];
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages < nk) load_slice();  // into stage cur
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (p.splits > 1) {
    const int tile = blockIdx.x + gridDim.x * blockIdx.y;
    float* part = p.part + static_cast<size_t>(tile) * p.splits * kR * kThreads;
    store_split(acc, part, split, tid);
    if (!last_split(p.counters + tile, p.splits)) return;
    sum_splits(acc, part, p.splits, tid);
  }

  // wgmma's D layout: warp w holds rows 16 w + g and 16 w + g + 8 (g =
  // lane / 4), columns 8 j + 2 t, + 1 (t = lane % 4) in acc[4 j .. 4 j + 3].
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 16 * warp + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const size_t o = static_cast<size_t>(m) * p.N + n;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (p.bias) {
        v0 += p.bias[n];
        v1 += p.bias[n + 1];
      }
      if (p.add) {
        const float2 a = *reinterpret_cast<const float2*>(p.add + o);
        v0 += a.x;
        v1 += a.y;
      }
      if (p.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      if (p.mask) {
        const float2 k = *reinterpret_cast<const float2*>(p.mask + o);
        v0 = k.x > 0.0f ? v0 : 0.0f;
        v1 = k.y > 0.0f ? v1 : 0.0f;
      }
      *reinterpret_cast<float2*>(p.out + o) = make_float2(v0, v1);
    }
  }
}

// ---- weight gradients: wgmma in split TF32 ------------------------------

constexpr int kWSlice = 32;              // pixels a slice: one 128-byte row

// out (taps, Ka, Kb) = sum over the pixels m of A[m'] (x) bm[m], where m'
// = m for taps == 1 and, for taps == 9, m' is pixel m shifted by the tap
// (zero outside the image).  The pixels are cut into splits of `chunk`,
// partial tiles through `part`.
struct Wgrad {
  const float* a;
  const float* bm;
  float* out;
  float* part;
  int* counters;
  int M, Ka, Kb, H, W, chunk;
};

constexpr int kGThreads = 3 * kThreads;   // producer + two consumers
constexpr int kGTile = 128;               // output tile rows and columns
constexpr int kGOpBytes = kGTile * kRowBytes;   // bm's K-major hi or lo tile
// A as stored, 32 pixels of 128 channels, each pixel's row padded by 8
// floats: a fragment's loads (channels g, pixels t) then hit 32 banks.
constexpr int kGARow = kGTile + 8;
constexpr int kGAStage = kWSlice * kGARow * 4;
constexpr int kGBStage = kWSlice * kGTile * 4;  // bm as stored
constexpr int kGStageBytes = 2 * kGOpBytes + kGAStage + kGBStage;  // 65 KB
constexpr int kGStages = 3;
constexpr int kGBarOffset = kGStages * kGStageBytes;
constexpr int kGSmemBytes = kGBarOffset + 2 * kGStages * 8 + 1024;

// The weight gradient of Wgrad on 128 x 128 output tiles (Ka, Kb
// multiples of 64; a half tile's missing rows or columns are zero-filled
// and not stored): grid (Kb / 128, Ka / 128, splits * taps), rounded up.
// A ring of three stages, each a slice of 32 pixels: A and bm as stored
// (128 channels a pixel) and bm's swizzled K-major hi and lo tiles.
// Warpgroup 0 produces: it copies a slice of A (shifted by the tap, zero
// outside the image) and of bm into a stage two slices ahead, then
// splits and transposes bm (a thread takes one channel, reads its 32
// values, conflict-free along the channels, and writes each four pixels
// as one 16-byte chunk of the hi tile and of the lo tile) and signals the
// stage full, one arrival a warp.  Warpgroups 1 and 2 consume: each takes
// its 64 rows of A from the stage into registers a k-step at a time,
// splits them there while the previous k-step's wgmmas run, multiplies
// them by bm's tiles (wgmma m64n128k8 with A in registers, the same three
// passes a k-step as the data products), adds the slice to its sum and
// signals the stage empty.  So the consumers never wait on a split pass
// for the tensor cores, and their wgmmas read only bm from shared memory,
// whose bandwidth the operand reads would otherwise mostly take.
template <bool kShift>
__global__ void __launch_bounds__(kGThreads, 1)
chain_bwd_wgrad_tiled_kernel(const Wgrad p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = smem_addr + kGBarOffset;  // then empty, 8 bytes a stage
  const uint32_t empty = full + 8 * kGStages;
  // A and bm as stored in stage s.
  auto a_raw = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kGStageBytes + 2 * kGOpBytes);
  };
  auto b_raw = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kGStageBytes + 2 * kGOpBytes +
                                    kGAStage);
  };

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kGTile, k10 = blockIdx.y * kGTile;
  const int taps = kShift ? 9 : 1;
  const int tap = blockIdx.z % taps, split = blockIdx.z / taps;
  const int splits = gridDim.z / taps;
  const int mbeg = split * p.chunk;
  const int mend = min(p.M, mbeg + p.chunk);
  const int nk = mend > mbeg ? (mend - mbeg + kWSlice - 1) / kWSlice : 0;
  const int Ka = p.Ka, Kb = p.Kb, H = p.H, W = p.W;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(full + 8 * s, kThreads / 32);  // every producer warp
      mbar_init(empty + 8 * s, 8);             // every consumer warp
    }
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (tid < kThreads) {
    // Copies: thread moves 16-byte chunk c of slice rows r + 4 q, of A
    // and of bm; channels past Ka or Kb are zero-filled.
    const int c = tid % 32, r = tid / 32;
    const bool a_in = k10 + 4 * c < Ka, b_in = n0 + 4 * c < Kb;
    const int dy = kShift ? tap / 3 - 1 : 0, dx = kShift ? tap % 3 - 1 : 0;
    // Where pixel ld_m0 + r lies in its image (row py, column px).
    int py = 0, px = 0;
    if (kShift) {
      const int rem = (mbeg + r) % (H * W);
      py = rem / W;
      px = rem % W;
    }
    int ld_m0 = mbeg;
    auto load_slice = [&](int s) {
      float* as = a_raw(s);
      float* bs = b_raw(s);
#pragma unroll
      for (int q = 0; q < kWSlice / 4; ++q) {
        const int row = r + 4 * q, m = ld_m0 + row;
        const bool in = m < mend;
        bool ok = in && a_in;
        if (kShift) {
          int y = py, x = px + 4 * q;
          while (x >= W) {
            x -= W;
            ++y;
          }
          while (y >= H) y -= H;
          ok = ok && y + dy >= 0 && y + dy < H && x + dx >= 0 && x + dx < W;
        }
        const float* src =
            ok ? p.a + static_cast<size_t>(m + dy * W + dx) * Ka + k10 + 4 * c
               : p.a;
        cp_async16(as + row * kGARow + 4 * c, src, ok);
        const bool okb = in && b_in;
        cp_async16(bs + row * kGTile + 4 * c,
                   okb ? p.bm + static_cast<size_t>(m) * Kb + n0 + 4 * c
                       : p.bm,
                   okb);
      }
      ld_m0 += kWSlice;
      if (kShift) {
        px += kWSlice;
        while (px >= W) {
          px -= W;
          ++py;
        }
        while (py >= H) py -= H;
      }
    };
    // Thread tid takes channel tid of bm: chunk Q (pixels 4 Q .. 4 Q + 3)
    // of tile row tid lies at tid * 128 + ((Q ^ (tid & 7)) << 4).  Every
    // value is loaded before the first store: the compiler cannot move a
    // load above a store to shared memory that it may alias, and a chain
    // of load, split, store a chunk runs at one chunk per load latency.
    auto split_slice = [&](int s) {
      const float* src = b_raw(s) + tid;
      float v[kWSlice];
#pragma unroll
      for (int k = 0; k < kWSlice; ++k) v[k] = src[k * kGTile];
      uint8_t* hi = smem + s * kGStageBytes + tid * kRowBytes;
#pragma unroll
      for (int Q = 0; Q < kWSlice / 4; ++Q) {
        float4 h, l;
        split_tf32(v[4 * Q + 0], h.x, l.x);
        split_tf32(v[4 * Q + 1], h.y, l.y);
        split_tf32(v[4 * Q + 2], h.z, l.z);
        split_tf32(v[4 * Q + 3], h.w, l.w);
        const int off = (Q ^ (tid & 7)) << 4;
        *reinterpret_cast<float4*>(hi + off) = h;
        *reinterpret_cast<float4*>(hi + kGOpBytes + off) = l;
      }
    };

    // Slice kt in stage kt % 3: copied two slices ahead, once the
    // consumers have emptied the stage (of slice kt - 3); split as soon as
    // every producer thread's copies of it have landed, the proxy fence
    // and the warp barrier ordering each thread's stores before its
    // warp's arrival.
    if (nk > 0) load_slice(0);
    cp_async_commit();
    if (nk > 1) load_slice(1);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kGStages;
      cp_async_wait<1>();           // this thread's copies of slice kt
      named_sync(1, kThreads);      // every producer thread's
      split_slice(s);
      fence_proxy_async();
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(full + 8 * s);
      if (kt + 2 < nk) {
        const int s2 = (kt + 2) % kGStages;
        if (kt + 2 >= kGStages)
          mbar_wait(empty + 8 * s2, ((kt + 2) / kGStages - 1) & 1);
        load_slice(s2);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
  } else {
    const int wg = tid / kThreads - 1;
    const int g = (tid % 32) / 4, t = tid % 4;
    // This thread's rows of A's fragment (and + 8); its pixels t, t + 4.
    const int arow = 64 * wg + 16 * ((tid / 32) % 4) + g;
    float tmp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tmp[i] = 0.0f;
    uint32_t ahi[2][4], alo[2][4];
    // k-step kk's fragment of A from stage s, split into hi and lo.
    auto fragment = [&](int s, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      const float* a0 = a_raw(s) + (8 * kk + t) * kGARow + arow;
      const float* a1 = a0 + 4 * kGARow;
      const float v[4] = {a0[0], a0[8], a1[0], a1[8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h, l;
        split_tf32(v[i], h, l);
        hi[i] = __float_as_uint(h);
        lo[i] = __float_as_uint(l);
      }
    };
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kGStages;
      mbar_wait(full + 8 * s, (kt / kGStages) & 1);
      const uint64_t b_hi = smem_desc(smem_addr + s * kGStageBytes);
      const uint64_t b_lo = smem_desc(smem_addr + s * kGStageBytes + kGOpBytes);
      // k-step kk's three passes read fragment set kk % 2; the set is
      // rewritten for k-step kk + 2 once they have completed.
#pragma unroll
      for (int kk = 0; kk < kWSlice / 8; ++kk) {
        const int j = kk % 2;
        if (kk >= 2) {
          wgmma_wait<1>();
          hold(ahi[j]);
          hold(alo[j]);
        }
        fragment(s, kk, ahi[j], alo[j]);
        wgmma_fence();
        wgmma_m64n128k8_ra(tmp, alo[j], b_hi + 2 * kk, kk > 0);
        wgmma_m64n128k8_ra(tmp, ahi[j], b_lo + 2 * kk, 1);
        wgmma_m64n128k8_ra(tmp, ahi[j], b_hi + 2 * kk, 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      hold(ahi[0]);
      hold(alo[0]);
      hold(ahi[1]);
      hold(alo[1]);
      hold(tmp);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
    }
  }

  const int ct = tid - kThreads;  // the consumers' thread, 0 .. 255
  if (splits > 1) {
    const int tile = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * tap);
    float* part =
        p.part + static_cast<size_t>(tile) * splits * 64 * 2 * kThreads;
    if (ct >= 0) store_split<64, 2 * kThreads>(acc, part, split, ct);
    if (!last_split(p.counters + tile, splits)) return;
    if (ct < 0) return;
    sum_splits<64, 2 * kThreads>(acc, part, splits, ct);
  } else if (ct < 0) {
    return;
  }
  // wgmma's D layout: consumer warp w (0 .. 7) holds rows k10 + 16 w + g
  // and + 8, columns n0 + 8 j + 2 t, + 1 (g = lane / 4, t = lane % 4).
  const int warp = ct / 32, g = (ct % 32) / 4, t = ct % 4;
  float* out = p.out + static_cast<size_t>(tap) * Ka * Kb;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k10 + 16 * warp + g + 8 * h;
    if (row >= Ka) continue;
#pragma unroll
    for (int j = 0; j < kGTile / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < Kb)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * Kb + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- bias gradients and masks: sums on the CUDA cores -------------------

// part[s][n] = sum over the rows m of split s of v[m][n], m in order.
__global__ void chain_bwd_colsum_kernel(const float* __restrict__ v,
                                        float* __restrict__ part, int M,
                                        int N, int chunk) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int mbeg = blockIdx.y * chunk, mend = min(M, mbeg + chunk);
  float s = 0.0f;
  for (int m = mbeg; m < mend; ++m) s += v[static_cast<size_t>(m) * N + n];
  part[static_cast<size_t>(blockIdx.y) * N + n] = s;
}

// out[i] = sum over s < splits of part[s][i], in split order.
__global__ void chain_bwd_sum_splits_kernel(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            int splits, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  out[i] = s;
}

// out[i] = y[i] > 0 ? g[i] : 0.
__global__ void chain_bwd_relu_mask_kernel(const float* __restrict__ g,
                                           const float* __restrict__ y,
                                           float* __restrict__ out,
                                           long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i < n) out[i] = y[i] > 0.0f ? g[i] : 0.0f;
}

// ---- host side -----------------------------------------------------------

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The opt-in above 48 KB of dynamic shared memory, once per kernel and
// device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int dev, bool (&opted)[64]) {
  if (dev >= 0 && dev < 64 && opted[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev >= 0 && dev < 64) opted[dev] = true;
  return e;
}

template <bool kConv, int BN, bool kSplitB>
cudaError_t launch_product(const Product& p, int dev, cudaStream_t s) {
  constexpr int smem = product_smem_bytes(BN, kSplitB);
  static bool opted[64] = {};
  const cudaError_t e =
      opt_in(chain_bwd_wgmma_kernel<kConv, BN, kSplitB>, smem, dev, opted);
  if (e != cudaSuccess) return e;
  chain_bwd_wgmma_kernel<kConv, BN, kSplitB>
      <<<dim3(ceil_div(p.M, kBM), p.N / BN, p.splits), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// 128-wide tiles where N allows (the wrapper's product_tiles mirrors it).
template <bool kConv>
cudaError_t product(const Product& p, bool split_b, int dev, cudaStream_t s) {
  if (p.N % 128 == 0)
    return split_b ? launch_product<kConv, 128, true>(p, dev, s)
                   : launch_product<kConv, 128, false>(p, dev, s);
  return split_b ? launch_product<kConv, 64, true>(p, dev, s)
                 : launch_product<kConv, 64, false>(p, dev, s);
}

template <bool kShift>
cudaError_t wgrad(const Wgrad& p, int dev, cudaStream_t s) {
  static bool opted[64] = {};
  const cudaError_t e = opt_in(chain_bwd_wgrad_tiled_kernel<kShift>,
                               kGSmemBytes, dev, opted);
  if (e != cudaSuccess) return e;
  const int splits = ceil_div(p.M, p.chunk), taps = kShift ? 9 : 1;
  chain_bwd_wgrad_tiled_kernel<kShift>
      <<<dim3(ceil_div(p.Kb, kGTile), ceil_div(p.Ka, kGTile), splits * taps),
         kGThreads, kGSmemBytes, s>>>(p);
  return cudaGetLastError();
}

// out (N) = column sums of v (M, N), through `part`.
cudaError_t colsum(const float* v, float* out, float* part, int M, int N,
                   int chunk, cudaStream_t s) {
  const int splits = ceil_div(M, chunk);
  chain_bwd_colsum_kernel<<<dim3(ceil_div(N, 128), splits), 128, 0, s>>>(
      v, part, M, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chain_bwd_sum_splits_kernel<<<ceil_div(N, 256), 256, 0, s>>>(part, out,
                                                              splits, N);
  return cudaGetLastError();
}

long long most(long long a, long long b) { return a > b ? a : b; }

// Floats of scratch for the partial sums: a split data product's tiles
// (rows padded to 64), a weight gradient's (C and F padded to its 128 x
// 128 tiles), a bias's.
long long part_floats(int M, int C, int F, int chunk_w13, int chunk_w2,
                      int chunk_bias, int split_in, int split_3x3,
                      int split_out) {
  const long long mp = static_cast<long long>(ceil_div(M, kBM)) * kBM;
  const long long cp = static_cast<long long>(ceil_div(C, kGTile)) * kGTile;
  const long long fp = static_cast<long long>(ceil_div(F, kGTile)) * kGTile;
  long long n = most(ceil_div(M, chunk_w13) * cp * fp,
                     ceil_div(M, chunk_w2) * 9 * fp * fp);
  n = most(n, static_cast<long long>(ceil_div(M, chunk_bias)) * most(C, F));
  n = most(n, most(split_in, split_3x3) * mp * F);
  return most(n, split_out * mp * C);
}

// Counters: one per output tile of the product or weight gradient with
// the most tiles (a weight gradient's counted as 64 x 64, more than it
// has).
long long counter_slots(int M, int C, int F) {
  const long long rows = ceil_div(M, kBM);
  return most(most(rows * (most(C, F) / 64), 9LL * (F / 64) * (F / 64)),
              static_cast<long long>(C / 64) * (F / 64));
}

#define SCDA_TRY(call)                          \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace

// Floats of workspace the backward needs: x_1..x_N, y1 and y2 of every
// block (the remat, in that order), two (M, C) cotangent buffers, dy2 and
// dy1, the partial sums, and the split counters (ints).
extern "C" long long scda_bottleneck_chain_bwd_workspace(
    int B, int H, int W, int C, int F, int N, int chunk_w13, int chunk_w2,
    int chunk_bias, int split_in, int split_3x3, int split_out) {
  const long long M = static_cast<long long>(B) * H * W;
  return N * M * C + 2LL * N * M * F + 2 * M * C + 2 * M * F +
         part_floats(static_cast<int>(M), C, F, chunk_w13, chunk_w2,
                     chunk_bias, split_in, split_3x3, split_out) +
         counter_slots(static_cast<int>(M), C, F);
}

// Inputs, all f32, contiguous, 16-byte aligned: x (B,H,W,C) and g (its
// output's cotangent, same shape); the weights packed with the reduction
// axis contiguous, as (out, in) of each product: for the remat w1t
// (N,F,C), w2t (N,F,9F) with w2t[i][o][t F + c] = w2[i][t][c][o], w3t
// (N,C,F); for the data gradients w3 (N,F,C), w2r (N,F,9F) with
// w2r[i][c][t F + o] = w2[i][8 - t][c][o], w1 (N,C,F), all as the forward
// takes them rounded to its dtype; b1 (N,F), b2 (N,F), b3 (N,C).
// data_passes: 2 when every weight is exact in TF32 (bf16 values), else
// 3.  Outputs, each skipped where null: dx, dw1..db3 in the shapes of x
// and of w1 (N,C,F), b1, w2 (N,9,F,F) (tap, in, out), b2, w3 (N,F,C), b3.
// work: scda_bottleneck_chain_bwd_workspace floats.  chunk_*: pixels per
// split of the weight (w1 and w3; w2) and bias gradients; split_*: K
// splits of the reduce-side 1x1 products (remat y1, dy2), the 3x3s (a
// divisor of 9) and the expand-side ones (remat x, dx).  C % 64 == 0, F %
// 64 == 0.
extern "C" int scda_bottleneck_chain_bwd_f32(
    const void* x_, const void* w1_, const void* b1_, const void* w2t_,
    const void* b2_, const void* w3_, const void* b3_, const void* w1t_,
    const void* w2r_, const void* w3t_, const void* g_, void* dx_, void* dw1_,
    void* db1_, void* dw2_, void* db2_, void* dw3_, void* db3_, void* work_,
    int B, int H, int W, int C, int F, int N, int chunk_w13, int chunk_w2,
    int chunk_bias, int split_in, int split_3x3, int split_out,
    int data_passes, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if ((data_passes != 2 && data_passes != 3) || C % 64 || F % 64 ||
      chunk_w13 < 1 || chunk_w2 < 1 || chunk_bias < 1 ||
      split_in < 1 || C % (split_in * kSlice) || split_out < 1 ||
      F % (split_out * kSlice) || split_3x3 < 1 || 9 % split_3x3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  SCDA_TRY(cudaGetDevice(&dev));
  const bool split_b = data_passes == 3;
  const float* x = static_cast<const float*>(x_);
  const float* w1 = static_cast<const float*>(w1_);
  const float* b1 = static_cast<const float*>(b1_);
  const float* w2t = static_cast<const float*>(w2t_);
  const float* b2 = static_cast<const float*>(b2_);
  const float* w3 = static_cast<const float*>(w3_);
  const float* b3 = static_cast<const float*>(b3_);
  const float* w1t = static_cast<const float*>(w1t_);
  const float* w2r = static_cast<const float*>(w2r_);
  const float* w3t = static_cast<const float*>(w3t_);
  const float* g = static_cast<const float*>(g_);
  float* dx = static_cast<float*>(dx_);
  float* dw1 = static_cast<float*>(dw1_);
  float* db1 = static_cast<float*>(db1_);
  float* dw2 = static_cast<float*>(dw2_);
  float* db2 = static_cast<float*>(db2_);
  float* dw3 = static_cast<float*>(dw3_);
  float* db3 = static_cast<float*>(db3_);

  const size_t mc = static_cast<size_t>(M) * C, mf = static_cast<size_t>(M) * F;
  const size_t cf = static_cast<size_t>(C) * F, ff9 = 9 * static_cast<size_t>(F) * F;
  float* xs = static_cast<float*>(work_);  // x_1 .. x_N
  float* y1s = xs + N * mc;
  float* y2s = y1s + N * mf;
  float* gbuf[2] = {y2s + N * mf, y2s + N * mf + mc};
  float* dy2 = gbuf[1] + mc;
  float* dy1 = dy2 + mf;
  float* part = dy1 + mf;
  int* counters = reinterpret_cast<int*>(
      part + part_floats(M, C, F, chunk_w13, chunk_w2, chunk_bias, split_in,
                         split_3x3, split_out));
  SCDA_TRY(cudaMemsetAsync(counters, 0, counter_slots(M, C, F) * sizeof(int),
                           s));
  auto xi = [&](int i) -> const float* { return i == 0 ? x : xs + (i - 1) * mc; };
  // A product of the chain: a (M, K) . bt (N, K)^T into out (M, N).
  auto prod = [&](const float* a, const float* bt, float* out, int n, int k,
                  int splits, const float* bias, const float* add,
                  const float* mask, bool relu) {
    Product p = {a, bt, out, bias, add, mask, part, counters,
                 M, n, k, H, W, splits, relu ? 1 : 0};
    return p;
  };
  auto wg = [&](const float* a, const float* bm, float* out, int ka, int kb,
                int chunk) {
    Wgrad p = {a, bm, out, part, counters, M, ka, kb, H, W, chunk};
    return p;
  };

  // 1. The remat, in f32.
  for (int i = 0; i < N; ++i) {
    float* y1 = y1s + i * mf;
    float* y2 = y2s + i * mf;
    SCDA_TRY(product<false>(prod(xi(i), w1t + i * cf, y1, F, C, split_in,
                                 b1 + i * F, nullptr, nullptr, true),
                            split_b, dev, s));
    SCDA_TRY(product<true>(prod(y1, w2t + i * ff9, y2, F, 9 * F, split_3x3,
                                b2 + i * F, nullptr, nullptr, true),
                           split_b, dev, s));
    SCDA_TRY(product<false>(prod(y2, w3t + i * cf, xs + i * mc, C, F,
                                 split_out, b3 + i * C, xi(i), nullptr, true),
                            split_b, dev, s));
  }

  // 2. The cotangent of the last block's pre-relu output.
  chain_bwd_relu_mask_kernel<<<ceil_div(static_cast<long long>(mc), 256), 256,
                               0, s>>>(g, xi(N), gbuf[0],
                                       static_cast<long long>(mc));
  SCDA_TRY(cudaGetLastError());

  // 3. The blocks, last to first.
  const bool more2 = dw2 || db2, more1 = dw1 || db1 || dx;
  for (int i = N - 1; i >= 0; --i) {
    const float* g3 = gbuf[(N - 1 - i) % 2];
    float* next = gbuf[(N - i) % 2];
    const float* y1 = y1s + i * mf;
    const float* y2 = y2s + i * mf;
    if (dw3) SCDA_TRY(wgrad<false>(wg(y2, g3, dw3 + i * cf, F, C, chunk_w13),
                                   dev, s));
    if (db3) SCDA_TRY(colsum(g3, db3 + i * C, part, M, C, chunk_bias, s));
    if (i == 0 && !more2 && !more1) break;
    SCDA_TRY(product<false>(prod(g3, w3 + i * cf, dy2, F, C, split_in,
                                 nullptr, nullptr, y2, false),
                            split_b, dev, s));
    if (dw2) SCDA_TRY(wgrad<true>(wg(y1, dy2, dw2 + i * ff9, F, F, chunk_w2),
                                  dev, s));
    if (db2) SCDA_TRY(colsum(dy2, db2 + i * F, part, M, F, chunk_bias, s));
    if (i == 0 && !more1) break;
    SCDA_TRY(product<true>(prod(dy2, w2r + i * ff9, dy1, F, 9 * F, split_3x3,
                                nullptr, nullptr, y1, false),
                           split_b, dev, s));
    if (dw1) SCDA_TRY(wgrad<false>(wg(xi(i), dy1, dw1 + i * cf, C, F,
                                      chunk_w13), dev, s));
    if (db1) SCDA_TRY(colsum(dy1, db1 + i * F, part, M, F, chunk_bias, s));
    if (i == 0) {
      if (dx)
        SCDA_TRY(product<false>(prod(dy1, w1, dx, C, F, split_out, nullptr,
                                     g3, nullptr, false),
                                split_b, dev, s));
    } else {
      SCDA_TRY(product<false>(prod(dy1, w1 + i * cf, next, C, F, split_out,
                                   nullptr, g3, xi(i), false),
                              split_b, dev, s));
    }
  }
  return cudaSuccess;
}
