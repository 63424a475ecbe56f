// 4-bit codebook-index GEMM with a fused epilogue, for Hopper (sm_90a).
//
//   Y[m, n] = act(sum_k X[m, k] * (codebook[idx[k, n]] * scale[n]) + bias[n])
//             + residual[m, n]
//
// Replaces the TPU kernel
//   src/repro/kernels/lut_matmul/lut_matmul.py::lut_matmul_pallas
// (body `_kernel` / `_dequant` / `_unpack_tile`). Same contract: float32
// inputs and output, the epilogue (bias, then activation, then residual)
// applied once after the whole K reduction, activations none / relu /
// tanh-gelu / silu, and the block-local nibble layout of `pack_indices`:
// within each K block of `pack_block` rows, byte row j holds index row j in
// its low nibble and row j + pack_block/2 in its high nibble.
//
// One deliberate difference: the sum is correctly rounded. Each float32
// product is exact in float64; the products are accumulated in float64
// (error ~K * 2^-53) and rounded to float32 once. A float32 sum carries
// ~sqrt(K) * 2^-24 of summation-order noise instead, and at ResNet-20 depth
// every such difference that moves an activation across a per-tensor int8
// rounding boundary cascades: two float32 implementations of the same
// fake-quant forward (cuDNN and PyTorch's native conv, both without TF32)
// differ by up to 2e-2 in the logits at batch 256. Correctly rounded sums
// agree with any other correctly rounded implementation (the port's
// fake-quant reference and the CPU path) bit for bit, except when an exact
// sum falls within ~K * 2^-53 of a float32 rounding midpoint.
//
// What bounds it on an H100. The serve path's matmuls are tall and narrow:
// at batch 256 a ResNet-20 conv is M = 16384..262144 rows of im2col patches,
// K = 128..640, N = 10..64 output channels. X is float32 and the only large
// operand (the packed weights are K*N/2 bytes). Per X element the product
// needs 2N flops (67 TFLOP/s fp32 on CUDA cores) against 4 bytes of HBM
// traffic (3.35 TB/s): the balance point is 2N/4 = 20 flop/byte, N = 40. So
// the N = 16 and N = 32 stages are bound by bytes (reading X), the N = 64
// stage by operations.
//
// What the design does about it. One thread block per (BM x BN) output tile,
// with BN chosen from N (16, 32 or 64) so that every ResNet-20 layer has one
// tile column: X is read from device memory exactly once, with 128-byte
// coalesced rows, and no block computes columns that do not exist. Per K
// chunk of 32 rows the block stages its X tile (transposed, padded against
// bank conflicts) and dequantizes its packed weights into shared memory once;
// the 16-entry codebook and the tile's scales also sit in shared memory. Each
// thread then accumulates a 4 x 4 register tile with float64 FMAs (half the
// float32 rate on an H100, so the operation-bound N = 64 shapes pay for the
// exact rounding). Ragged M, N and K edges are masked in the kernel, so the
// caller pads nothing but K to the pack block. wgmma, TMA and software
// pipelining are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 32;        // K rows staged in shared memory per step
constexpr int kCodes = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// activation codes: 0 none, 1 relu, 2 gelu (tanh form), 3 silu
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:
      return v > 0.f ? v : 0.f;
    case 2: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case 3:
      return v / (1.f + expf(-v));
    default:
      return v;
  }
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
lut_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                  const int8_t* __restrict__ codebook,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int M, int K, int N, int pack_block, int act) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int TY = BM / TM;  // threads along M
  static_assert(TX * TY == kThreads, "thread layout must cover the tile");
  static_assert((BM * kKT) % kThreads == 0, "X tile load must be even");
  static_assert((BN * kKT) % kThreads == 0, "W tile load must be even");

  __shared__ float xs[kKT][BM + 1];  // X tile, transposed; +1 against conflicts
  __shared__ float ws[kKT][BN];      // dequantized weight tile
  __shared__ float cb[kCodes];
  __shared__ float sc[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int half = pack_block / 2;

  if (tid < kCodes) cb[tid] = static_cast<float>(codebook[tid]);
  for (int j = tid; j < BN; j += kThreads) {
    const int n = n0 + j;
    sc[j] = n < N ? scale[n] : 0.f;
  }

  double acc[TM][TN];  // float64: see "correctly rounded" above
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // codebook/scales ready; previous tiles consumed
    // X tile: lanes of a warp read 32 consecutive K entries of one row
#pragma unroll
    for (int t = 0; t < BM * kKT / kThreads; ++t) {
      const int i = tid + t * kThreads;
      const int r = i / kKT, c = i % kKT;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    // weight tile: unpack the nibble of (k, n), look it up, scale it
#pragma unroll
    for (int t = 0; t < BN * kKT / kThreads; ++t) {
      const int i = tid + t * kThreads;
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < K && n < N) {
        const int blk = k / pack_block;
        const int j = k - blk * pack_block;
        const bool high = j >= half;
        const int row = blk * half + (high ? j - half : j);
        // widen the signed byte, then mask: a sign-extended shift would
        // leak the sign bit into the high nibble
        const int p = static_cast<int>(packed[(size_t)row * N + n]) & 0xFF;
        const int idx = high ? ((p >> 4) & 0xF) : (p & 0xF);
        w = cb[idx] * sc[c];
      }
      ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      double a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue, once, after the whole K reduction
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      float v = static_cast<float>(acc[i][j]);  // the one rounding
      if (bias != nullptr) v += bias[n];
      v = activate(v, act);
      const size_t o = (size_t)m * N + n;
      if (residual != nullptr) v += residual[o];
      out[o] = v;
    }
  }
}

template <typename T, int BM, int BN>
void launch(const void* x, const void* packed, const void* codebook,
            const void* scale, const void* bias, const void* residual,
            void* out, cudaStream_t stream, int M, int K, int N,
            int pack_block, int act) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  lut_matmul_kernel<T, BM, BN, 4, 4><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const int8_t*>(codebook), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), M, K, N, pack_block, act);
}

// fixed tile shapes by output width: one tile column for N <= 64
template <typename T>
void launch_for_n(const void* x, const void* packed, const void* codebook,
                  const void* scale, const void* bias, const void* residual,
                  void* out, cudaStream_t stream, int M, int K, int N,
                  int pack_block, int act) {
  if (N <= 16)
    launch<T, 256, 16>(x, packed, codebook, scale, bias, residual, out,
                       stream, M, K, N, pack_block, act);
  else if (N <= 32)
    launch<T, 128, 32>(x, packed, codebook, scale, bias, residual, out,
                       stream, M, K, N, pack_block, act);
  else
    launch<T, 64, 64>(x, packed, codebook, scale, bias, residual, out,
                      stream, M, K, N, pack_block, act);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `bias` and `residual` may be null.
// x is float32 (x_is_bf16 = 0) or bfloat16 (1), row-major (M, K); packed is
// int8 (K/2, N); codebook int8 (16,); scale and bias float32 (N,); residual
// and out float32 row-major (M, N). Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int lut_matmul_launch(const void* x, const void* packed,
                                 const void* codebook, const void* scale,
                                 const void* bias, const void* residual,
                                 void* out, void* stream, int device, int M,
                                 int K, int N, int pack_block, int activation,
                                 int x_is_bf16) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch_for_n<__nv_bfloat16>(x, packed, codebook, scale, bias, residual,
                                out, s, M, K, N, pack_block, activation);
  else
    launch_for_n<float>(x, packed, codebook, scale, bias, residual, out, s,
                        M, K, N, pack_block, activation);
  return static_cast<int>(cudaGetLastError());
}
