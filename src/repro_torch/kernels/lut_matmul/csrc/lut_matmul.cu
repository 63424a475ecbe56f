// 4-bit codebook-index GEMM with a fused epilogue, for Hopper (sm_90a).
//
//   Y[m, n] = act(sum_k X[m, k] * (codebook[idx[k, n]] * scale[n]) + bias[n])
//             + residual[m, n]
//
// Replaces the TPU kernel
//   src/repro/kernels/lut_matmul/lut_matmul.py::lut_matmul_pallas
// (body `_kernel` / `_dequant` / `_unpack_tile`). Same contract: float32 or
// bfloat16 X, float32 output, the epilogue (bias, then activation, then
// residual) applied once after the whole K reduction, activations none /
// relu / tanh-gelu / silu, and the block-local nibble layout of
// `pack_indices`: within each K block of `pack_block` rows, byte row j holds
// index row j in its low nibble and row j + pack_block/2 in its high nibble.
//
// Unpadded rows. X is (M, K_x) with K_x % 8 == 0 (every row starts on a
// 16-byte boundary in float32 and bfloat16) and K_x <= K_pad rounded up to
// 8, where K_pad = 2 * packed rows. Columns [K_x, K_pad) count as zero and
// are never read; weight rows at or past K_pad count as zero. The serve path
// builds rows round_up(K, 8) wide instead of the pack block's K_pad.
//
// One deliberate difference from the TPU kernel: the sum is correctly
// rounded. The weight is formed as the plain version forms it, the float32
// product float(codebook[idx]) * scale[n]; X and that weight are widened to
// float64 (exact), multiplied and summed in float64 (error ~K * 2^-53) and
// rounded to float32 once. A float32 sum carries ~sqrt(K) * 2^-24 of
// summation-order noise instead, and at ResNet-20 depth every such
// difference that moves an activation across a per-tensor int8 rounding
// boundary cascades to the logits. Correctly rounded sums agree with any
// other correctly rounded implementation (the port's fake-quant reference
// and the CPU path) bit for bit, except when an exact sum falls within
// ~K * 2^-53 of a float32 rounding midpoint.
//
// What bounds it on an H100. The serve path's matmuls are tall and narrow:
// at batch 256 a ResNet-20 conv is M = 16384..262144 rows of im2col patches,
// K_x = 16..576, N = 10..64 output channels. X is the only large operand
// (the packed weights are K*N/2 bytes). Per float32 X element the product
// needs 2N operations against 4 bytes of HBM traffic (3.35 TB/s); float64
// on the tensor cores (DMMA) runs at 67 TFLOP/s, so the balance point is
// 2N/4 = 20 flop/byte, N = 40: the N = 16 and N = 32 layers are bound by
// bytes (reading X), the N = 64 layers by operations. On the CUDA cores
// float64 FMAs run at half that rate, which is why the products go to the
// tensor cores.
//
// What the design does about it.
//  * Products and sums run as warp-level `mma.sync.aligned.m16n8k8 ... .f64`
//    (float64 tensor cores; wgmma has no float64). On the H100 the sm_90
//    shapes m16n8k4 / k8 / k16 ran at one speed and m8n8k4 slower
//    (PERF.md); k8 needs fewer registers than k16.
//    A operand: X, staged in shared memory in its own dtype and widened in
//    registers (exact). B operand: the weight in float64.
//  * The weight is dequantized once a call, not once a tile: a pre-pass
//    (`dequant_kernel`) writes it, widened, into a float64 scratch the
//    wrapper allocates (K_x x N rounded up to the chunk and tile column;
//    at most 295 KB for ResNet-20, so it stays in L2). Dequantizing every
//    chunk of every tile inside the GEMM cost as much as the MMAs on the
//    N = 64 layers.
//  * A persistent grid (SMs x resident blocks per SM) walks over output
//    tiles of BM x BN; BN is chosen from N (16, 32 or 64), so every
//    ResNet-20 layer has one tile column and X is read from device memory
//    once. N beyond 64 takes several tile columns. BM is 128 for N <= 32
//    and 64 above, so that ResNet-20's stage-3 layers have 256 tiles, two
//    blocks an SM.
//  * X and weight chunks of kKC columns / rows stream through one ring of
//    kStages stages, filled by 16-byte cp.async.cg copies (X zero-filled
//    past M and K_x), so the copies of chunk c + kStages - 1 are in flight
//    while chunk c is multiplied. The ring runs on across tile boundaries:
//    the next tile's first chunks load during this tile's last chunks and
//    its epilogue. One __syncthreads a chunk.
//  * Shared-memory rows are padded (X by 16 bytes, the weight by 4 doubles)
//    so the fragment loads of a warp hit 32 distinct banks.
//  * The epilogue runs from the float64 accumulators in registers: one
//    rounding to float32, + bias, the activation, + residual.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKC = 32;       // K columns a ring stage
constexpr int kStages = 4;    // ring depth
constexpr int kBM = 128;      // output rows a tile for N <= 32
constexpr int kWideBM = 64;   // and for N > 32
constexpr int kWM = 32;       // output rows a warp
constexpr int kCodes = 16;
constexpr int kMaxDevices = 16;

// ------------------------------------------------------------ float64 MMA
//
// Fragments (PTX ISA, mma .f64), g = lane / 4, t = lane % 4:
//   A (row-major, kM x kK): a[i] at row g + 8 * (i % 2), column t + 4 * (i / 2)
//   B (column-major, kK x 8): b[i] at row t + 4 * i, column g
//   C/D (kM x 8): c[i] at row g + 8 * (i / 2), column 2 * t + i % 2

struct MMA {  // m16n8k8
  static constexpr int kM = 16, kK = 8, kA = 4, kB = 2, kC = 4;
  static __device__ __forceinline__ void run(double (&d)[kC], const double (&a)[kA],
                                             const double (&b)[kB]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

// ------------------------------------------------------------ helpers

__device__ __forceinline__ double to_f64(float v) { return static_cast<double>(v); }
__device__ __forceinline__ double to_f64(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Pre-pass, once a call: the weight exactly as the plain version forms it,
// float(codebook[idx]) * scale[n] in float32, widened to float64, into a
// (Kr, Nr) row-major scratch with Kr = K_x and Nr = N rounded up to the
// chunk and the tile column; rows at or past K_x or K_pad and columns past
// N are zero, so the main loop copies whole chunks without masks.
__global__ void __launch_bounds__(256)
dequant_kernel(const int8_t* __restrict__ packed, const int8_t* __restrict__ codebook,
               const float* __restrict__ scale, double* __restrict__ w, int Kx,
               int Kpad, int N, int pack_block, int Kr, int Nr) {
  __shared__ float cb[kCodes];
  if (threadIdx.x < kCodes) cb[threadIdx.x] = static_cast<float>(codebook[threadIdx.x]);
  __syncthreads();
  const int half = pack_block >> 1;
  const long long total = static_cast<long long>(Kr) * Nr;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / Nr);
    const int n = static_cast<int>(i - static_cast<long long>(k) * Nr);
    float v = 0.f;
    if (k < Kx && k < Kpad && n < N) {
      const int blk = k / pack_block;
      const int j = k - blk * pack_block;
      const int row = blk * half + (j >= half ? j - half : j);
      // widen the signed byte, then mask: a sign-extended shift would leak
      // the sign bit into the high nibble
      const int b = static_cast<int>(packed[static_cast<size_t>(row) * N + n]) & 0xFF;
      v = __fmul_rn(cb[j >= half ? b >> 4 : b & 0xF], scale[n]);
    }
    w[i] = static_cast<double>(v);
  }
}

// Tile configuration: BM x BN outputs a block, kWM x WN a warp.
template <typename T, int BM, int BN, int WN>
struct Tile {
  static constexpr int kWarpsM = BM / kWM;
  static constexpr int kThreads = kWarpsM * (BN / WN) * 32;
  static constexpr int kVec = 16 / sizeof(T);          // X elements a copy
  static constexpr int kUnits = kKC / kVec;            // copies an X row
  static constexpr int kXCopies = BM * kUnits / kThreads;
  static constexpr int kWCopies = kKC * (BN / 2) / kThreads;
  static constexpr int kXPitch = kKC + kVec;           // +16 bytes a row
  static constexpr int kWPitch = BN + 4;               // +4 doubles a row
  static constexpr int kWBytes = kStages * kKC * kWPitch * sizeof(double);
  static constexpr int kXBytes = kStages * BM * kXPitch * sizeof(T);
  static constexpr int kSmem = kWBytes + kXBytes;
  static_assert(BM * kUnits % kThreads == 0, "X copies must be even");
  static_assert(kKC * (BN / 2) % kThreads == 0, "weight copies must be even");
  static_assert(kWM % MMA::kM == 0 && WN % 8 == 0, "warp tile vs MMA shape");
  static_assert(kKC % MMA::kK == 0, "chunk vs MMA depth");
};

// Rows of the weight scratch for K_x, and its columns for N and a tile
// column of BN.
__host__ __device__ constexpr int scratch_rows(int Kx) {
  return (Kx > kKC ? (Kx + kKC - 1) / kKC : 1) * kKC;
}
__host__ __device__ constexpr int scratch_cols(int N, int BN) {
  return (N + BN - 1) / BN * BN;
}

template <typename T, int BM, int BN, int WN>
__global__ void __launch_bounds__(Tile<T, BM, BN, WN>::kThreads, 1)
lut_matmul_kernel(const T* __restrict__ x, const double* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ residual,
                  float* __restrict__ out, int M, int Kx, int N, int act) {
  using C = Tile<T, BM, BN, WN>;
  constexpr int kMT = kWM / MMA::kM;  // MMA tiles along M a warp
  constexpr int kNT = WN / 8;         // along N

  extern __shared__ __align__(16) unsigned char smem[];
  double* ws = reinterpret_cast<double*>(smem);         // [kStages][kKC][kWPitch]
  T* xs = reinterpret_cast<T*>(smem + C::kWBytes);      // [kStages][BM][kXPitch]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % C::kWarpsM) * kWM;
  const int wn0 = (warp / C::kWarpsM) * WN;
  const int ntn = (N + BN - 1) / BN;
  const int ntiles = ((M + BM - 1) / BM) * ntn;
  const int nchunks = scratch_rows(Kx) / kKC;
  const int Nr = scratch_cols(N, BN);
  if (static_cast<int>(blockIdx.x) >= ntiles) return;
  const int iters = ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * nchunks;

  // iteration `it` of this block: its tile's origin and its chunk's first column
  struct Pos {
    int m0, n0, k0;
    bool last;
  };
  auto pos = [&](int it) {
    const int lt = it / nchunks;
    const int c = it - lt * nchunks;
    const int tile = blockIdx.x + lt * gridDim.x;
    const int tm = tile / ntn;
    return Pos{tm * BM, (tile - tm * ntn) * BN, c * kKC, c == nchunks - 1};
  };

  // the X and weight chunks of iteration `it` into ring stage it % kStages;
  // X is zero-filled past M and K_x, the weight scratch is padded already
  auto load = [&](int it) {
    const Pos p = pos(it);
    const int stage = it % kStages;
    T* xd = xs + stage * BM * C::kXPitch;
#pragma unroll
    for (int j = 0; j < C::kXCopies; ++j) {
      const int u = tid + j * C::kThreads;
      const int r = u / C::kUnits, c = u % C::kUnits;
      const int m = p.m0 + r, k = p.k0 + c * C::kVec;
      const bool ok = m < M && k < Kx;
      cp_async16(xd + r * C::kXPitch + c * C::kVec,
                 ok ? x + static_cast<size_t>(m) * Kx + k : x, ok ? 16 : 0);
    }
    double* wd = ws + stage * kKC * C::kWPitch;
#pragma unroll
    for (int j = 0; j < C::kWCopies; ++j) {
      const int u = tid + j * C::kThreads;
      const int r = u / (BN / 2), c = 2 * (u % (BN / 2));
      cp_async16(wd + r * C::kWPitch + c,
                 w + static_cast<size_t>(p.k0 + r) * Nr + p.n0 + c, 16);
    }
  };

  double acc[kMT][kNT][MMA::kC];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < MMA::kC; ++i) acc[mi][ni][i] = 0.0;

  auto compute = [&](int it, int kvalid) {
    const int stage = it % kStages;
    const T* xa = xs + (stage * BM + wm0 + g) * C::kXPitch + t;
    const double* wb = ws + (stage * kKC + t) * C::kWPitch + wn0 + g;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += MMA::kK) {
      if (kk < kvalid) {
        double a[kMT][MMA::kA], b[kNT][MMA::kB];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int i = 0; i < MMA::kA; ++i)
            a[mi][i] = to_f64(
                xa[(mi * MMA::kM + 8 * (i & 1)) * C::kXPitch + kk + 4 * (i >> 1)]);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int i = 0; i < MMA::kB; ++i)
            b[ni][i] = wb[(kk + 4 * i) * C::kWPitch + ni * 8];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) MMA::run(acc[mi][ni], a[mi], b[ni]);
      }
    }
  };

  auto epilogue = [&](const Pos& p) {  // once a tile, after its whole K
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < MMA::kC / 2; ++h) {
        const int m = p.m0 + wm0 + mi * MMA::kM + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = p.n0 + wn0 + ni * 8 + 2 * t + j;
            if (n >= N) continue;
            float v = static_cast<float>(acc[mi][ni][2 * h + j]);  // the one rounding
            if (bias != nullptr) v += bias[n];
            v = activate(v, act);
            const size_t o = static_cast<size_t>(m) * N + n;
            if (residual != nullptr) v += residual[o];
            out[o] = v;
          }
      }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int i = 0; i < MMA::kC; ++i) acc[mi][ni][i] = 0.0;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk `it` landed
    __syncthreads();  // chunk `it` visible to all; stage (it - 1) % kStages free
    if (it + kStages - 1 < iters) load(it + kStages - 1);
    cp_async_commit();
    const Pos p = pos(it);
    compute(it, Kx - p.k0);
    if (p.last) epilogue(p);
  }
  cp_async_wait<0>();
}

// Per configuration and device: the dynamic shared memory attribute is set
// and the resident blocks per SM are read once.
struct Occupancy {
  int blocks_per_sm = 0;
  int sms = 0;
};

template <typename T, int BM, int BN, int WN>
cudaError_t occupancy(int device, Occupancy* occ) {
  using C = Tile<T, BM, BN, WN>;
  static Occupancy cache[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && cache[device].blocks_per_sm > 0) {
    *occ = cache[device];
    return cudaSuccess;
  }
  auto kernel = lut_matmul_kernel<T, BM, BN, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  Occupancy o;
  err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.blocks_per_sm, kernel,
                                                      C::kThreads, C::kSmem);
  if (err != cudaSuccess) return err;
  if (o.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (cached) cache[device] = o;
  *occ = o;
  return cudaSuccess;
}

template <typename T, int BM, int BN, int WN>
cudaError_t launch(const void* x, const void* packed, const void* codebook,
                   const void* scale, const void* bias, const void* residual,
                   void* out, void* scratch, long long scratch_doubles,
                   cudaStream_t stream, int device, int M, int Kx, int Kpad,
                   int N, int pack_block, int act) {
  using C = Tile<T, BM, BN, WN>;
  Occupancy occ;
  cudaError_t err = occupancy<T, BM, BN, WN>(device, &occ);
  if (err != cudaSuccess) return err;
  const int Kr = scratch_rows(Kx), Nr = scratch_cols(N, BN);
  if (scratch_doubles < static_cast<long long>(Kr) * Nr) return cudaErrorInvalidValue;
  double* w = static_cast<double*>(scratch);
  const long long wblocks = (static_cast<long long>(Kr) * Nr + 255) / 256;
  const int dgrid = static_cast<int>(wblocks < 8LL * occ.sms ? wblocks : 8LL * occ.sms);
  dequant_kernel<<<dgrid, 256, 0, stream>>>(
      static_cast<const int8_t*>(packed), static_cast<const int8_t*>(codebook),
      static_cast<const float*>(scale), w, Kx, Kpad, N, pack_block, Kr, Nr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long ntiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const long long slots = static_cast<long long>(occ.sms) * occ.blocks_per_sm;
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  lut_matmul_kernel<T, BM, BN, WN><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out), M, Kx, N,
      act);
  return cudaGetLastError();
}

// the tile column by output width: one column for N <= 64
constexpr int block_n(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : 64; }

template <typename T>
cudaError_t launch_for_n(const void* x, const void* packed, const void* codebook,
                         const void* scale, const void* bias, const void* residual,
                         void* out, void* scratch, long long scratch_doubles,
                         cudaStream_t s, int device, int M, int Kx, int Kpad,
                         int N, int pack_block, int act) {
  switch (block_n(N)) {
    case 16:
      return launch<T, kBM, 16, 16>(x, packed, codebook, scale, bias, residual, out,
                                    scratch, scratch_doubles, s, device, M, Kx,
                                    Kpad, N, pack_block, act);
    case 32:
      return launch<T, kBM, 32, 32>(x, packed, codebook, scale, bias, residual, out,
                                    scratch, scratch_doubles, s, device, M, Kx,
                                    Kpad, N, pack_block, act);
    default:
      return launch<T, kWideBM, 64, 32>(x, packed, codebook, scale, bias, residual,
                                        out, scratch, scratch_doubles, s, device,
                                        M, Kx, Kpad, N, pack_block, act);
  }
}

template <typename T, int BM, int BN, int WN>
cudaError_t describe(int device, int* info) {
  using C = Tile<T, BM, BN, WN>;
  Occupancy occ;
  cudaError_t err = occupancy<T, BM, BN, WN>(device, &occ);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lut_matmul_kernel<T, BM, BN, WN>);
  if (err != cudaSuccess) return err;
  const int values[] = {MMA::kM, 8, MMA::kK, kStages, BM, BN, kKC, kWM, WN,
                        C::kThreads, attr.numRegs,
                        static_cast<int>(attr.localSizeBytes), C::kSmem,
                        occ.blocks_per_sm, occ.sms};
  for (int i = 0; i < static_cast<int>(sizeof(values) / sizeof(int)); ++i)
    info[i] = values[i];
  return cudaSuccess;
}

}  // namespace

// Doubles of float64 weight scratch a launch for (K_x, N) needs; -1 past
// INT_MAX.
extern "C" int lut_matmul_scratch_doubles(int Kx, int N) {
  const long long n = static_cast<long long>(scratch_rows(Kx)) * scratch_cols(N, block_n(N));
  return n > 2147483647LL ? -1 : static_cast<int>(n);
}

// Plain C entry point, loaded with ctypes. `bias` and `residual` may be null.
// x is float32 (x_is_bf16 = 0) or bfloat16 (1), row-major (M, K_x) with
// K_x % 8 == 0 and a 16-byte-aligned base; packed is int8 (K_pad/2, N);
// codebook int8 (16,); scale and bias float32 (N,); residual and out float32
// row-major (M, N); scratch float64, 16-byte aligned, at least
// lut_matmul_scratch_doubles(K_x, N) of them. Launches the dequant pre-pass
// and the GEMM on `stream`; returns the CUDA error of the launches (0 on
// success).
extern "C" int lut_matmul_launch(const void* x, const void* packed,
                                 const void* codebook, const void* scale,
                                 const void* bias, const void* residual,
                                 void* out, void* scratch, void* stream,
                                 long long scratch_doubles, int device, int M,
                                 int Kx, int Kpad, int N, int pack_block,
                                 int activation, int x_is_bf16) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    err = launch_for_n<__nv_bfloat16>(x, packed, codebook, scale, bias, residual,
                                      out, scratch, scratch_doubles, s, device, M,
                                      Kx, Kpad, N, pack_block, activation);
  else
    err = launch_for_n<float>(x, packed, codebook, scale, bias, residual, out,
                              scratch, scratch_doubles, s, device, M, Kx, Kpad, N,
                              pack_block, activation);
  return static_cast<int>(err);
}

// The configuration that serves output width N, into info[0..14]: MMA shape
// (m, n, k), ring stages, block tile (BM, BN, KC), warp tile (WM, WN),
// threads, registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes a block, resident blocks per SM, SMs.
extern "C" int lut_matmul_config(int N, int x_is_bf16, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  if (x_is_bf16) {
    if (N <= 16) return static_cast<int>(describe<bf16, kBM, 16, 16>(device, info));
    if (N <= 32) return static_cast<int>(describe<bf16, kBM, 32, 32>(device, info));
    return static_cast<int>(describe<bf16, kWideBM, 64, 32>(device, info));
  }
  if (N <= 16) return static_cast<int>(describe<float, kBM, 16, 16>(device, info));
  if (N <= 32) return static_cast<int>(describe<float, kBM, 32, 32>(device, info));
  return static_cast<int>(describe<float, kWideBM, 64, 32>(device, info));
}
