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
// everything here is f32 FMAs on the CUDA cores, with no rounding between
// stages.  No TF32 and no bf16: the f32 gradient gates would not hold.
//
// Design.  One C call does the whole backward on PyTorch's stream:
//   1. the remat: the chain's forward again in f32, keeping every block's
//      input x_i, y1_i and y2_i (post-relu) and the output x_N in one
//      workspace, (N * (C + 2F)) * B*H*W floats: 12.6 MB a block at
//      ResNet-101's layer3 at 512x1024 and bs 1, 277 MB for its 22 blocks
//      (the f32 activations that an autograd remat holds as well);
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
// Two tiled kernels do all the products, each a 64 x 64 output tile per
// 128-thread block, 16-deep slices of the reduction axis copied by
// zero-filling 16-byte cp.async copies into a ring of four shared-memory
// stages (three slices in flight while one is multiplied, one barrier a
// slice), and an 8 x 4 register tile a thread read from shared memory as
// float4s:
//   - the data products (remat and dy2, dy1, dx) reduce over channels:
//     A (pixels x K) is copied as rows along K, the 3x3 and its transpose
//     gathering shifted pixels and zero-filling the padding, B is the
//     packed weight (K x N); a thread reads its rows' A as float4s along
//     K (12 reads for 128 FMAs); the epilogue adds a bias and / or a map,
//     applies relu and / or a mask, and stores 16 bytes a thread.  Where
//     64-row tiles give fewer than two blocks an SM (layer3 at bs 1 has
//     2048 pixels), the tiles are 32 x 64 with a 4 x 4 register tile:
//     twice the warps to hide latency, every output still summed in k
//     order, so the remat stays the forward kernel's f32 chain bit for
//     bit (its f32 path sums in the same order);
//   - the weight gradients reduce over the B*H*W pixels (A^T B), both
//     operands copied as rows along the pixels (three reads for 32 FMAs
//     a pixel).  Their output has few tiles (16 to 144 at the ResNet-101
//     stages), so the pixel axis is cut into splits of `chunk` rows
//     (chosen by the wrapper: about four blocks an SM), each writing its
//     partial sums to scratch, and a second kernel adds the partials in
//     split order.  The bias sums go the same way by column.
// Nothing is accumulated with atomics: every output element is written
// once by one thread after sums in a fixed order, so two calls on the
// same inputs give the same bits.
//
// What bounds it on the H100: arithmetic.  The remat, the data gradients
// and the weight gradients each do the forward's operations, about 3 x
// 100 GFLOP at layer3 at bs 1 (4.5 ms at the f32 peak of 67 TFLOP/s),
// against 13 MB of the stream and its gradient in and out.  Measured on
// an H100 80GB HBM3 at 700 W (utils/kernel_probe.py k4bwd, the gradients
// the model asks for): 2.1-2.2 ms at layer2 and 12.3-12.7 ms at layer3 at
// bs 1, 67.7-67.8 ms at layer3 at bs 8 (f32 bounds 0.61, 4.50 and 36),
// against 25-35 ms at layer3 for the twin's remat under autograd that it
// replaced.  At bs 1 it is latency that bounds it: layer3's 3x3 products
// reach 24 TFLOP/s with 256 blocks of four warps, the same products at
// bs 8 (1024 blocks) 40.
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;        // output tile columns
constexpr int kBK = 16;        // reduction slice
constexpr int kStages = 4;     // slices in the cp.async ring
constexpr int kThreads = 128;  // 8 x 16 threads
constexpr int kLd = 64 + 4;    // padded 64-wide shared row (16-byte rows)
constexpr int kLdK = kBK + 4;  // padded kBK-wide shared row

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

// Thread t of a block owns output rows tile_row(tm, i) (i < 4 G: rows
// 32 q + 4 tm + r of a 32 G-row tile) and columns 4 tn + j (j < 4), where
// tn = lane % 16 and tm = 2 warp + lane / 16.
__device__ __forceinline__ int tile_row(int tm, int i) {
  return 32 * (i / 4) + 4 * tm + i % 4;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A slice of the data products: as[row][k] (the tile's rows, k along
// the reduction), bs[k][col].  Per 4-deep step a thread reads 4 G float4s
// of its rows (two distinct addresses a warp each) and 4 of b (16
// consecutive float4s a warp each) for 64 G FMAs; every output sums its
// products in k order.
template <int G>
__device__ __forceinline__ void mma_rows(const float (*as)[kLdK],
                                         const float (*bs)[kLd], int tm,
                                         int tn, float (&acc)[4 * G][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 av[4 * G], bv[4];
#pragma unroll
    for (int i = 0; i < 4 * G; ++i)
      av[i] = *reinterpret_cast<const float4*>(&as[tile_row(tm, i)][kk]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&bs[kk + j][4 * tn]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) {
        const float a = comp(av[i], j);
        acc[i][0] = fmaf(a, bv[j].x, acc[i][0]);
        acc[i][1] = fmaf(a, bv[j].y, acc[i][1]);
        acc[i][2] = fmaf(a, bv[j].z, acc[i][2]);
        acc[i][3] = fmaf(a, bv[j].w, acc[i][3]);
      }
  }
}

// A slice of the weight gradients: as[m][row], bs[m][col] with m the
// reduction (pixel) index.  Per step a thread reads 2 float4s of a[m] and
// one of b[m] for 32 FMAs.
__device__ __forceinline__ void mma_cols(const float (*as)[kLd],
                                         const float (*bs)[kLd], int tm,
                                         int tn, float (&acc)[8][4]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[k][4 * tm]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[k][32 + 4 * tm]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][4 * tn]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Whether pixel m (of B images of H x W) shifted by (dy, dx) stays inside
// its image.
__device__ __forceinline__ bool in_image(int m, int dy, int dx, int H,
                                         int W) {
  const int rem = m % (H * W), y = rem / W + dy, x = rem % W + dx;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// out (M, N) = epilogue(A (M, K) . bmat (K, N)) in tiles of 32 G x 64.
// For kConv, K = 9f ordered (tap, channel), tap = (dy + 1) * 3 + (dx + 1),
// and the A row of pixel m at tap is pixel m + dy W + dx of a (M, f) map,
// zero outside the image.  Epilogue, each step only where its pointer or
// flag is set: + bias[n], + add[m, n], relu, then 0 where mask[m, n] <= 0.
// N % 64 == 0, K % 16 == 0 (f % 16 == 0 for kConv); M is masked.
template <bool kConv, int G>
__global__ void __launch_bounds__(kThreads)
chain_bwd_gemm_kernel(const float* __restrict__ a,
                      const float* __restrict__ bmat, float* __restrict__ out,
                      int M, int N, int K, int H, int W,
                      const float* __restrict__ bias,
                      const float* __restrict__ add,
                      const float* __restrict__ mask, int relu) {
  __shared__ __align__(16) float as[kStages][32 * G][kLdK];
  __shared__ __align__(16) float bs[kStages][kBK][kLd];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tn = lane % 16, tm = 2 * warp + lane / 16;
  const int m0 = blockIdx.x * 32 * G, n0 = blockIdx.y * kBN;
  const int f = kConv ? K / 9 : K;

  // A: thread copies 16-byte chunk ac (4 channels) of tile rows ar + 32 p
  // (p < G); B: 16-byte chunk bc of slice rows br and br + 8.
  const int ar = tid / 4, ac = tid % 4;
  const int br = tid / 16, bc = tid % 16;
  const float* a_row[G];
  unsigned a_taps[G];  // bit tap: the shifted pixel is inside the image
#pragma unroll
  for (int p = 0; p < G; ++p) {
    const int m = m0 + ar + 32 * p;
    a_row[p] = a + static_cast<size_t>(m < M ? m : 0) * f + 4 * ac;
    a_taps[p] = 0;
    if (m < M) {
      if (kConv) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          if (in_image(m, tap / 3 - 1, tap % 3 - 1, H, W))
            a_taps[p] |= 1u << tap;
      } else {
        a_taps[p] = 1;
      }
    }
  }
  const float* b_col = bmat + n0 + 4 * bc;

  // The producer's position: slice ld_k0, inside tap ld_tap at channel
  // ld_kin (a slice never straddles two taps).
  int ld_k0 = 0, ld_tap = 0, ld_kin = 0, ld_stage = 0;
  auto load_slice = [&]() {
    const int a_off = kConv
                          ? ((ld_tap / 3 - 1) * W + ld_tap % 3 - 1) * f + ld_kin
                          : ld_k0;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      const bool ok = (a_taps[p] >> (kConv ? ld_tap : 0)) & 1;
      cp_async16(&as[ld_stage][ar + 32 * p][4 * ac],
                 ok ? a_row[p] + a_off : a, ok);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
      cp_async16(&bs[ld_stage][br + 8 * p][4 * bc],
                 b_col + static_cast<size_t>(ld_k0 + br + 8 * p) * N, true);
    ld_k0 += kBK;
    if (kConv) {
      ld_kin += kBK;
      if (ld_kin == f) {
        ld_kin = 0;
        ++ld_tap;
      }
    }
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
  };

  float acc[4 * G][4];
#pragma unroll
  for (int i = 0; i < 4 * G; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slice();
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // Slice kt is the oldest of at most kStages - 1 pending groups.
    cp_async_wait<kStages - 2>();
    // Every thread's copies of slice kt have landed, and every thread is
    // done with slice kt - 1, whose stage the next copy refills.
    __syncthreads();
    if (kt + kStages - 1 < nk) load_slice();
    cp_async_commit();
    mma_rows<G>(as[kt % kStages], bs[kt % kStages], tm, tn, acc);
  }
  cp_async_wait<0>();

  const int n = n0 + 4 * tn;
  const float4 bv = bias ? *reinterpret_cast<const float4*>(bias + n)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) {
    const int m = m0 + tile_row(tm, i);
    if (m >= M) continue;
    const size_t o = static_cast<size_t>(m) * N + n;
    float v[4] = {acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z,
                  acc[i][3] + bv.w};
    if (add) {
      const float4 t = *reinterpret_cast<const float4*>(add + o);
      v[0] += t.x;
      v[1] += t.y;
      v[2] += t.z;
      v[3] += t.w;
    }
    if (relu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], 0.0f);
    }
    if (mask) {
      const float4 t = *reinterpret_cast<const float4*>(mask + o);
      v[0] = t.x > 0.0f ? v[0] : 0.0f;
      v[1] = t.y > 0.0f ? v[1] : 0.0f;
      v[2] = t.z > 0.0f ? v[2] : 0.0f;
      v[3] = t.w > 0.0f ? v[3] : 0.0f;
    }
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// part[s][tap] (Ka, Kb) = sum over the pixels m of split s (rows
// [s chunk, min(M, (s + 1) chunk))) of A[m'] (x) bm[m], where m' = m for
// taps == 1 and, for taps == 9, m' is pixel m shifted by the tap (zero
// outside the image).  Grid: (Kb / 64, Ka / 64, splits * taps); Ka and Kb
// multiples of 64, chunk a multiple of 16.
template <bool kShift>
__global__ void __launch_bounds__(kThreads)
chain_bwd_wgrad_kernel(const float* __restrict__ a,
                       const float* __restrict__ bm, float* __restrict__ part,
                       int M, int Ka, int Kb, int H, int W, int chunk) {
  __shared__ __align__(16) float as[kStages][kBK][kLd];
  __shared__ __align__(16) float bs[kStages][kBK][kLd];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tn = lane % 16, tm = 2 * warp + lane / 16;
  const int n0 = blockIdx.x * kBN, k10 = blockIdx.y * 64;
  const int taps = kShift ? 9 : 1;
  const int tap = blockIdx.z % taps, split = blockIdx.z / taps;
  const int dy = kShift ? tap / 3 - 1 : 0, dx = kShift ? tap % 3 - 1 : 0;
  const int mbeg = split * chunk;
  const int mend = min(M, mbeg + chunk);

  // Thread copies 16-byte chunk c of slice rows r and r + 8, of A and bm.
  const int r = tid / 16, c = tid % 16;
  int ld_m0 = mbeg, ld_stage = 0;
  auto load_slice = [&]() {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int m = ld_m0 + r + 8 * p;
      const bool in = m < mend;
      const bool ok = in && (!kShift || in_image(m, dy, dx, H, W));
      const int src = ok ? m + dy * W + dx : 0;
      cp_async16(&as[ld_stage][r + 8 * p][4 * c],
                 a + static_cast<size_t>(src) * Ka + k10 + 4 * c, ok);
      cp_async16(&bs[ld_stage][r + 8 * p][4 * c],
                 bm + static_cast<size_t>(in ? m : 0) * Kb + n0 + 4 * c, in);
    }
    ld_m0 += kBK;
    ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nk = mend > mbeg ? (mend - mbeg + kBK - 1) / kBK : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slice();
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load_slice();
    cp_async_commit();
    mma_cols(as[kt % kStages], bs[kt % kStages], tm, tn, acc);
  }
  cp_async_wait<0>();

  float* base = part + (static_cast<size_t>(split) * taps + tap) * Ka * Kb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k1 = k10 + tile_row(tm, i);
    *reinterpret_cast<float4*>(base + static_cast<size_t>(k1) * Kb + n0 +
                               4 * tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

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

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// 64-row tiles where they give at least two blocks an SM, else 32-row
// ones (twice the blocks, each output still summed in k order).
template <bool kConv>
cudaError_t gemm(const float* a, const float* bmat, float* out, int M, int N,
                 int K, int H, int W, const float* bias, const float* add,
                 const float* mask, bool relu, int sms, cudaStream_t s) {
  const long long tall = static_cast<long long>(ceil_div(M, 64)) * (N / kBN);
  if (tall >= 2LL * sms)
    chain_bwd_gemm_kernel<kConv, 2><<<dim3(ceil_div(M, 64), N / kBN),
                                      kThreads, 0, s>>>(
        a, bmat, out, M, N, K, H, W, bias, add, mask, relu ? 1 : 0);
  else
    chain_bwd_gemm_kernel<kConv, 1><<<dim3(ceil_div(M, 32), N / kBN),
                                      kThreads, 0, s>>>(
        a, bmat, out, M, N, K, H, W, bias, add, mask, relu ? 1 : 0);
  return cudaGetLastError();
}

// out (taps, Ka, Kb) = A^T bm over the pixels, through `part`.
template <bool kShift>
cudaError_t wgrad(const float* a, const float* bm, float* out, float* part,
                  int M, int Ka, int Kb, int H, int W, int chunk,
                  cudaStream_t s) {
  const int splits = ceil_div(M, chunk), taps = kShift ? 9 : 1;
  chain_bwd_wgrad_kernel<kShift><<<dim3(Kb / kBN, Ka / 64, splits * taps),
                                   kThreads, 0, s>>>(a, bm, part, M, Ka, Kb,
                                                     H, W, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = static_cast<long long>(taps) * Ka * Kb;
  chain_bwd_sum_splits_kernel<<<ceil_div(n, 256), 256, 0, s>>>(part, out,
                                                              splits, n);
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

// Floats of scratch for the partial sums.
long long part_floats(int M, int C, int F, int chunk_w13, int chunk_w2,
                      int chunk_bias) {
  const long long w13 = static_cast<long long>(ceil_div(M, chunk_w13)) * C * F;
  const long long w2 = static_cast<long long>(ceil_div(M, chunk_w2)) * 9 * F * F;
  const long long bias = static_cast<long long>(ceil_div(M, chunk_bias)) *
                         (C > F ? C : F);
  long long most = w13 > w2 ? w13 : w2;
  return most > bias ? most : bias;
}

#define SCDA_TRY(call)                          \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace

// Floats of workspace the backward needs: x_1..x_N, y1 and y2 of every
// block, two (M, C) cotangent buffers, dy2 and dy1, and the partial sums.
extern "C" long long scda_bottleneck_chain_bwd_workspace(
    int B, int H, int W, int C, int F, int N, int chunk_w13, int chunk_w2,
    int chunk_bias) {
  const long long M = static_cast<long long>(B) * H * W;
  return N * M * C + 2LL * N * M * F + 2 * M * C + 2 * M * F +
         part_floats(static_cast<int>(M), C, F, chunk_w13, chunk_w2,
                     chunk_bias);
}

// Inputs, all f32, contiguous, 16-byte aligned: x (B,H,W,C) and g (its
// output's cotangent, same shape); w1 (N,C,F), b1 (N,F), w2 (N,9,F,F)
// ordered (tap, in, out), b2 (N,F), w3 (N,F,C), b3 (N,C), as the forward
// takes them; w1t = w1 transposed (N,F,C), w3t = w3 transposed (N,C,F),
// w2r (N,9,F,F) with w2r[i][t][o][c] = w2[i][8 - t][c][o].  Outputs, each
// skipped where null: dx, dw1..db3 in the shapes of x, w1..b3.  work:
// scda_bottleneck_chain_bwd_workspace floats.  chunk_*: pixels per split
// of the weight (w1 and w3; w2) and bias gradients, multiples of 16.
// C % 64 == 0, F % 64 == 0.
extern "C" int scda_bottleneck_chain_bwd_f32(
    const void* x_, const void* w1_, const void* b1_, const void* w2_,
    const void* b2_, const void* w3_, const void* b3_, const void* w1t_,
    const void* w2r_, const void* w3t_, const void* g_, void* dx_, void* dw1_,
    void* db1_, void* dw2_, void* db2_, void* dw3_, void* db3_, void* work_,
    int B, int H, int W, int C, int F, int N, int chunk_w13, int chunk_w2,
    int chunk_bias, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  SCDA_TRY(cudaGetDevice(&dev));
  SCDA_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const float* x = static_cast<const float*>(x_);
  const float* w1 = static_cast<const float*>(w1_);
  const float* b1 = static_cast<const float*>(b1_);
  const float* w2 = static_cast<const float*>(w2_);
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
  auto xi = [&](int i) -> const float* { return i == 0 ? x : xs + (i - 1) * mc; };

  // 1. The remat, in f32.
  for (int i = 0; i < N; ++i) {
    float* y1 = y1s + i * mf;
    float* y2 = y2s + i * mf;
    SCDA_TRY(gemm<false>(xi(i), w1 + i * cf, y1, M, F, C, H, W, b1 + i * F,
                         nullptr, nullptr, true, sms, s));
    SCDA_TRY(gemm<true>(y1, w2 + i * ff9, y2, M, F, 9 * F, H, W, b2 + i * F,
                        nullptr, nullptr, true, sms, s));
    SCDA_TRY(gemm<false>(y2, w3 + i * cf, xs + i * mc, M, C, F, H, W,
                         b3 + i * C, xi(i), nullptr, true, sms, s));
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
    if (dw3)
      SCDA_TRY(wgrad<false>(y2, g3, dw3 + i * cf, part, M, F, C, H, W,
                            chunk_w13, s));
    if (db3) SCDA_TRY(colsum(g3, db3 + i * C, part, M, C, chunk_bias, s));
    if (i == 0 && !more2 && !more1) break;
    SCDA_TRY(gemm<false>(g3, w3t + i * cf, dy2, M, F, C, H, W, nullptr,
                         nullptr, y2, false, sms, s));
    if (dw2)
      SCDA_TRY(wgrad<true>(y1, dy2, dw2 + i * ff9, part, M, F, F, H, W,
                           chunk_w2, s));
    if (db2) SCDA_TRY(colsum(dy2, db2 + i * F, part, M, F, chunk_bias, s));
    if (i == 0 && !more1) break;
    SCDA_TRY(gemm<true>(dy2, w2r + i * ff9, dy1, M, F, 9 * F, H, W, nullptr,
                        nullptr, y1, false, sms, s));
    if (dw1)
      SCDA_TRY(wgrad<false>(xi(i), dy1, dw1 + i * cf, part, M, C, F, H, W,
                            chunk_w13, s));
    if (db1) SCDA_TRY(colsum(dy1, db1 + i * F, part, M, F, chunk_bias, s));
    if (i == 0) {
      if (dx)
        SCDA_TRY(gemm<false>(dy1, w1t, dx, M, C, F, H, W, nullptr, g3,
                             nullptr, false, sms, s));
    } else {
      SCDA_TRY(gemm<false>(dy1, w1t + i * cf, next, M, C, F, H, W, nullptr,
                           g3, xi(i), false, sms, s));
    }
  }
  return cudaSuccess;
}
