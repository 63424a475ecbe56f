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
//  * The weight is dequantized in one of two ways, a launch argument (a
//    configuration's `dequant`):
//    - "prepass": once a call. A pre-pass (`dequant_kernel`) writes it,
//      widened, into a float64 scratch the wrapper allocates (K_x x N
//      rounded up to the chunk and tile column; at most 295 KB for
//      ResNet-20, so it stays in L2). Dequantizing every chunk of every
//      tile inside the GEMM cost as much as the MMAs on ResNet-20's N = 64
//      layers, which have hundreds of tile rows.
//    - "tile": once a tile, no pre-pass and no scratch. Each chunk's packed
//      bytes stream through the ring beside X (cp.async; a chunk is 32
//      consecutive packed rows of one nibble when pack_block % 64 == 0),
//      and each thread forms its MMA B fragment from them with
//      `weight_of`, the pre-pass's arithmetic, so the values are the same.
//      At small M (a decode step: one tile row) the pre-pass's write and
//      re-read of 16 x the packed bytes and its second launch are most of
//      the call. (Forming a chunk's float64 weights in shared memory with
//      plain loads instead stalled on every load: slower than the
//      pre-pass.)
//    Either way a ring stage holds the same float64 chunk, so the products
//    and sums that follow are the same instructions on the same values.
//  * A persistent grid (SMs x resident blocks per SM) walks over output
//    tiles of BM x BN. The tile is a launch argument from a fixed table
//    (`with_tile`): BM 128, 64, 32 or 16 and BN 16, 32 or 64. A warp covers
//    32 x 16 or 32 x 32 outputs of the large tiles; in the small ones (BM
//    32 or 16) it covers 8 columns, so a tile has BN / 8 warps to share its
//    dequant and MMAs (one tile row leaves most of the card idle at small
//    M, and these warps are what is left to fill it). Without a tuner the tile follows N
//    alone: BN 16, 32 or 64, so every ResNet-20 layer has one tile column
//    and X is read from device memory once, and BM 128 for N <= 32, 64
//    above (ResNet-20's stage-3 layers: 256 tiles, two blocks an SM).
//    BM 16 / 32 are for M <= 32, where a 128-row tile multiplies mostly
//    zero rows. `repro_torch.kernels.lut_matmul.autotune` picks among them.
//  * Every configuration sums each output in one order: the chunks of kKC
//    in K order, the k8 MMA steps of a chunk in K order, one rounding. So
//    all configurations give the same output bit for bit (no split-K: it
//    would re-associate the float64 sum).
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

// The 4-bit code of the weight at (k, n), or -1 where the weight is 0: at or
// past K_x or K_pad and past N.
__device__ __forceinline__ int code_at(const int8_t* __restrict__ packed, int k, int n,
                                       int Kx, int Kpad, int N, int pack_block) {
  if (k >= Kx || k >= Kpad || n >= N) return -1;
  const int half = pack_block >> 1;
  const int blk = k / pack_block;
  const int j = k - blk * pack_block;
  const int row = blk * half + (j >= half ? j - half : j);
  // widen the signed byte, then mask: a sign-extended shift would leak the
  // sign bit into the high nibble
  const int b = static_cast<int>(packed[static_cast<size_t>(row) * N + n]) & 0xFF;
  return j >= half ? b >> 4 : b & 0xF;
}

// The weight of a code exactly as the plain version forms it,
// float(codebook[idx]) * scale[n] in float32, widened; `cb` holds the
// codebook as floats.
__device__ __forceinline__ double weight_of(const float* cb, int code, float s) {
  return code < 0 ? 0.0 : static_cast<double>(__fmul_rn(cb[code], s));
}

// Pre-pass, once a call: the weight (`weight_of`) in float64, into
// a (Kr, Nr) row-major scratch with Kr = K_x and Nr = N rounded up to the
// chunk and the tile column, so the main loop copies whole chunks without
// masks.
__global__ void __launch_bounds__(256)
dequant_kernel(const int8_t* __restrict__ packed, const int8_t* __restrict__ codebook,
               const float* __restrict__ scale, double* __restrict__ w, int Kx,
               int Kpad, int N, int pack_block, int Kr, int Nr) {
  __shared__ float cb[kCodes];
  if (threadIdx.x < kCodes) cb[threadIdx.x] = static_cast<float>(codebook[threadIdx.x]);
  __syncthreads();
  const long long total = static_cast<long long>(Kr) * Nr;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / Nr);
    const int n = static_cast<int>(i - static_cast<long long>(k) * Nr);
    w[i] = weight_of(cb, code_at(packed, k, n, Kx, Kpad, N, pack_block),
                     n < N ? scale[n] : 0.f);
  }
}

// Tile configuration: BM x BN outputs a block, WM x WN a warp.
template <typename T, int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kWarpsM = BM / WM;
  static constexpr int kThreads = kWarpsM * (BN / WN) * 32;
  static constexpr int kVec = 16 / sizeof(T);          // X elements a copy
  static constexpr int kUnits = kKC / kVec;            // copies an X row
  static constexpr int kXUnits = BM * kUnits;          // copies an X chunk
  static constexpr int kXCopies = (kXUnits + kThreads - 1) / kThreads;
  static constexpr int kWCopies = kKC * (BN / 2) / kThreads;
  static constexpr int kPUnits = kKC * BN / 16;        // packed copies a chunk
  static constexpr int kPCopies = (kPUnits + kThreads - 1) / kThreads;
  static constexpr int kXPitch = kKC + kVec;           // +16 bytes a row
  static constexpr int kWPitch = BN + 4;               // +4 doubles a row
  static constexpr int kPPitch = BN + 16;              // +16 bytes a row
  static constexpr int kXBytes = kStages * BM * kXPitch * sizeof(T);
  static constexpr int kWBytes = kStages * kKC * kWPitch * sizeof(double);
  static constexpr int kPBytes = kStages * kKC * kPPitch;
  static constexpr int kSmem = kXBytes + kWBytes;       // "prepass"
  static constexpr int kSmemTile = kXBytes + kPBytes;   // "tile"
  static_assert(BM % WM == 0 && BN % WN == 0, "warp tiles must cover the tile");
  static_assert(kKC * (BN / 2) % kThreads == 0, "weight copies must be even");
  static_assert(BN % 16 == 0 && kSmemTile <= kSmem, "packed ring vs tile");
  static_assert(WM % MMA::kM == 0 && WN % 8 == 0, "warp tile vs MMA shape");
  static_assert(kKC % MMA::kK == 0, "chunk vs MMA depth");
};

// The tile table: f(Tile<...>{}) for the configuration (bm, bn);
// cudaErrorInvalidValue for a pair outside it.
template <typename T, typename F>
cudaError_t with_tile(int bm, int bn, F&& f) {
  switch (bm * 1000 + bn) {
    case 128016: return f(Tile<T, 128, 16, 32, 16>{});
    case 128032: return f(Tile<T, 128, 32, 32, 32>{});
    case 64064: return f(Tile<T, 64, 64, 32, 32>{});
    case 32016: return f(Tile<T, 32, 16, 32, 8>{});
    case 32032: return f(Tile<T, 32, 32, 32, 8>{});
    case 32064: return f(Tile<T, 32, 64, 32, 8>{});
    case 16016: return f(Tile<T, 16, 16, 16, 8>{});
    case 16032: return f(Tile<T, 16, 32, 16, 8>{});
    case 16064: return f(Tile<T, 16, 64, 16, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

// Rows of the weight scratch for K_x, and its columns for N and a tile
// column of BN.
__host__ __device__ constexpr int scratch_rows(int Kx) {
  return (Kx > kKC ? (Kx + kKC - 1) / kKC : 1) * kKC;
}
__host__ __device__ constexpr int scratch_cols(int N, int BN) {
  return (N + BN - 1) / BN * BN;
}

// kInTile: "tile" dequant. A template argument, so that each kernel holds
// only its own dequant loop: with both in one kernel the pre-pass paid the
// in-tile loop's registers (146 -> 170 at 64x64) and 9% of its time.
template <typename C, bool kInTile>
__global__ void __launch_bounds__(C::kThreads, 1)
lut_matmul_kernel(const typename C::Elem* __restrict__ x, const double* __restrict__ w,
                  const int8_t* __restrict__ packed, const int8_t* __restrict__ codebook,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out, int M,
                  int Kx, int Kpad, int N, int pack_block, int act) {
  using T = typename C::Elem;
  constexpr int BM = C::BM, BN = C::BN, WM = C::WM, WN = C::WN;
  constexpr int kMT = WM / MMA::kM;  // MMA tiles along M a warp
  constexpr int kNT = WN / 8;        // along N

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                   // [kStages][BM][kXPitch]
  // "prepass": the float64 weight ring; "tile": the packed-byte ring
  double* ws = reinterpret_cast<double*>(smem + C::kXBytes);  // [kStages][kKC][kWPitch]
  unsigned char* ps = smem + C::kXBytes;                // [kStages][kKC][kPPitch]
  __shared__ float cb[kCodes];                          // "tile" only

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % C::kWarpsM) * WM;
  const int wn0 = (warp / C::kWarpsM) * WN;
  const int ntn = (N + BN - 1) / BN;
  const int ntiles = ((M + BM - 1) / BM) * ntn;
  const int nchunks = scratch_rows(Kx) / kKC;
  const int Nr = scratch_cols(N, BN);
  if (static_cast<int>(blockIdx.x) >= ntiles) return;
  const int iters = ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * nchunks;
  if constexpr (kInTile) {
    if (tid < kCodes) cb[tid] = static_cast<float>(codebook[tid]);
    __syncthreads();
  }

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

  // "tile": chunk rows k0 .. k0 + 31 are 32 consecutive packed rows of one
  // half of one pack block (pack_block % 64 == 0), in one nibble
  auto packed_row = [&](int k0) {
    const int half = pack_block >> 1;
    const int blk = k0 / pack_block;
    const int j = k0 - blk * pack_block;
    return blk * half + (j >= half ? j - half : j);
  };

  // the X and weight chunks of iteration `it` into ring stage it % kStages;
  // X is zero-filled past M and K_x; the weight is copied from the padded
  // scratch, or ("tile") its packed bytes, zero-filled past K_pad and N
  // (N % 16 == 0: a 16-byte piece is all in or all out)
  auto load = [&](int it) {
    const Pos p = pos(it);
    const int stage = it % kStages;
    T* xd = xs + stage * BM * C::kXPitch;
#pragma unroll
    for (int j = 0; j < C::kXCopies; ++j) {
      const int u = tid + j * C::kThreads;
      if (C::kXUnits % C::kThreads != 0 && u >= C::kXUnits) break;
      const int r = u / C::kUnits, c = u % C::kUnits;
      const int m = p.m0 + r, k = p.k0 + c * C::kVec;
      const bool ok = m < M && k < Kx;
      cp_async16(xd + r * C::kXPitch + c * C::kVec,
                 ok ? x + static_cast<size_t>(m) * Kx + k : x, ok ? 16 : 0);
    }
    if constexpr (kInTile) {
      unsigned char* pd = ps + stage * kKC * C::kPPitch;
      const int row0 = packed_row(p.k0);
#pragma unroll
      for (int j = 0; j < C::kPCopies; ++j) {
        const int u = tid + j * C::kThreads;
        if (C::kPUnits % C::kThreads != 0 && u >= C::kPUnits) break;
        const int r = u / (BN / 16), q = 16 * (u % (BN / 16));
        const int row = row0 + r, n = p.n0 + q;
        const bool ok = 2 * row < Kpad && n < N;
        cp_async16(pd + r * C::kPPitch + q,
                   ok ? packed + static_cast<size_t>(row) * N + n : packed, ok ? 16 : 0);
      }
    } else {
      double* wd = ws + stage * kKC * C::kWPitch;
#pragma unroll
      for (int j = 0; j < C::kWCopies; ++j) {
        const int u = tid + j * C::kThreads;
        const int r = u / (BN / 2), c = 2 * (u % (BN / 2));
        cp_async16(wd + r * C::kWPitch + c,
                   w + static_cast<size_t>(p.k0 + r) * Nr + p.n0 + c, 16);
      }
    }
  };

  double acc[kMT][kNT][MMA::kC];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < MMA::kC; ++i) acc[mi][ni][i] = 0.0;

  // the A fragments of k8 step kk of ring stage `stage`: X widened (exact)
  auto a_frags = [&](int stage, int kk, double (&a)[kMT][MMA::kA]) {
    const T* xa = xs + (stage * BM + wm0 + g) * C::kXPitch + t;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int i = 0; i < MMA::kA; ++i)
        a[mi][i] = to_f64(xa[(mi * MMA::kM + 8 * (i & 1)) * C::kXPitch + kk + 4 * (i >> 1)]);
  };

  // "prepass": the B fragments straight from the float64 ring
  auto compute_prepass = [&](int it, int kvalid) {
    const int stage = it % kStages;
    const double* wb = ws + (stage * kKC + t) * C::kWPitch + wn0 + g;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += MMA::kK) {
      if (kk < kvalid) {
        double a[kMT][MMA::kA], b[kNT][MMA::kB];
        a_frags(stage, kk, a);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int i = 0; i < MMA::kB; ++i) b[ni][i] = wb[(kk + 4 * i) * C::kWPitch + ni * 8];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) MMA::run(acc[mi][ni], a[mi], b[ni]);
      }
    }
  };

  // "tile": this thread's B elements formed from the packed bytes as
  // `weight_of` forms them (the pre-pass's values): its kNT columns'
  // scales, the chunk's nibble, rows past K_x or K_pad zero
  auto compute_tile = [&](int it, const Pos& p) {
    const int stage = it % kStages;
    const unsigned char* pb = ps + (stage * kKC + t) * C::kPPitch + wn0 + g;
    const int shift = p.k0 - p.k0 / pack_block * pack_block >= pack_block / 2 ? 4 : 0;
    const int kvalid = Kx - p.k0;
    const int krow = (Kx < Kpad ? Kx : Kpad) - p.k0;  // valid rows of the chunk
    float sc[kNT];
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int n = p.n0 + wn0 + ni * 8 + g;
      sc[ni] = n < N ? scale[n] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKC; kk += MMA::kK) {
      if (kk < kvalid) {
        double a[kMT][MMA::kA], b[kNT][MMA::kB];
        a_frags(stage, kk, a);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int i = 0; i < MMA::kB; ++i) {
            const int code = (pb[(kk + 4 * i) * C::kPPitch + ni * 8] >> shift) & 0xF;
            b[ni][i] = weight_of(cb, kk + t + 4 * i < krow ? code : -1, sc[ni]);
          }
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
    if constexpr (kInTile)
      compute_tile(it, p);
    else
      compute_prepass(it, Kx - p.k0);
    if (p.last) epilogue(p);
  }
  cp_async_wait<0>();
}

// A tile with its X element type.
template <typename T, typename Cfg>
struct Typed : Cfg {
  using Elem = T;
};

// Per configuration and device: the dynamic shared memory attribute is set
// and the resident blocks per SM are read once.
struct Occupancy {
  int blocks_per_sm = 0;
  int sms = 0;
};

template <typename C, bool kInTile>
constexpr int smem_bytes() {
  return kInTile ? C::kSmemTile : C::kSmem;
}

template <typename C, bool kInTile>
cudaError_t occupancy(int device, Occupancy* occ) {
  static Occupancy cache[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && cache[device].blocks_per_sm > 0) {
    *occ = cache[device];
    return cudaSuccess;
  }
  auto kernel = lut_matmul_kernel<C, kInTile>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<C, kInTile>());
  if (err != cudaSuccess) return err;
  Occupancy o;
  err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o.blocks_per_sm, kernel, C::kThreads, smem_bytes<C, kInTile>());
  if (err != cudaSuccess) return err;
  if (o.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (cached) cache[device] = o;
  *occ = o;
  return cudaSuccess;
}

struct Args {
  const void *x, *packed, *codebook, *scale, *bias, *residual;
  void *out, *scratch;
  long long scratch_doubles;
  cudaStream_t stream;
  int device, M, Kx, Kpad, N, pack_block, act, in_tile;
};

template <typename C, bool kInTile>
cudaError_t launch_as(const Args& a) {
  // "tile" copies 16-byte pieces of packed rows and reads one nibble a
  // chunk: N % 16 == 0, a 16-byte-aligned base, pack_block % 64 == 0
  if (kInTile && (a.N % 16 != 0 || a.pack_block % 64 != 0 ||
                  reinterpret_cast<uintptr_t>(a.packed) % 16 != 0))
    return cudaErrorInvalidValue;
  Occupancy occ;
  cudaError_t err = occupancy<C, kInTile>(a.device, &occ);
  if (err != cudaSuccess) return err;
  double* w = nullptr;
  if (!kInTile) {
    const int Kr = scratch_rows(a.Kx), Nr = scratch_cols(a.N, C::BN);
    if (a.scratch_doubles < static_cast<long long>(Kr) * Nr) return cudaErrorInvalidValue;
    w = static_cast<double*>(a.scratch);
    const long long wblocks = (static_cast<long long>(Kr) * Nr + 255) / 256;
    const int dgrid = static_cast<int>(wblocks < 8LL * occ.sms ? wblocks : 8LL * occ.sms);
    dequant_kernel<<<dgrid, 256, 0, a.stream>>>(
        static_cast<const int8_t*>(a.packed), static_cast<const int8_t*>(a.codebook),
        static_cast<const float*>(a.scale), w, a.Kx, a.Kpad, a.N, a.pack_block, Kr,
        Nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long ntiles = static_cast<long long>((a.M + C::BM - 1) / C::BM) *
                           ((a.N + C::BN - 1) / C::BN);
  const long long slots = static_cast<long long>(occ.sms) * occ.blocks_per_sm;
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  lut_matmul_kernel<C, kInTile><<<grid, C::kThreads, smem_bytes<C, kInTile>(), a.stream>>>(
      static_cast<const typename C::Elem*>(a.x), w,
      static_cast<const int8_t*>(a.packed), static_cast<const int8_t*>(a.codebook),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.residual), static_cast<float*>(a.out), a.M, a.Kx,
      a.Kpad, a.N, a.pack_block, a.act);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch(const Args& a) {
  return a.in_tile ? launch_as<C, true>(a) : launch_as<C, false>(a);
}

template <typename C, bool kInTile>
cudaError_t describe_as(int device, int* info) {
  Occupancy occ;
  cudaError_t err = occupancy<C, kInTile>(device, &occ);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lut_matmul_kernel<C, kInTile>);
  if (err != cudaSuccess) return err;
  const int values[] = {MMA::kM, 8, MMA::kK, kStages, C::BM, C::BN, kKC, C::WM, C::WN,
                        C::kThreads, attr.numRegs,
                        static_cast<int>(attr.localSizeBytes), smem_bytes<C, kInTile>(),
                        occ.blocks_per_sm, occ.sms};
  for (int i = 0; i < static_cast<int>(sizeof(values) / sizeof(int)); ++i)
    info[i] = values[i];
  return cudaSuccess;
}

template <typename C>
cudaError_t describe(int device, int in_tile, int* info) {
  return in_tile ? describe_as<C, true>(device, info) : describe_as<C, false>(device, info);
}

// f(Typed<T, Tile>{}) for X's type and the tile (bm, bn).
template <typename F>
cudaError_t with_config(int x_is_bf16, int bm, int bn, F&& f) {
  if (x_is_bf16)
    return with_tile<__nv_bfloat16>(bm, bn, [&](auto tile) {
      return f(Typed<__nv_bfloat16, decltype(tile)>{});
    });
  return with_tile<float>(bm, bn,
                          [&](auto tile) { return f(Typed<float, decltype(tile)>{}); });
}

}  // namespace

// Doubles of float64 weight scratch a pre-pass launch for (K_x, N) and a
// tile column of BN needs; -1 past INT_MAX.
extern "C" int lut_matmul_scratch_doubles(int Kx, int N, int BN) {
  const long long n = static_cast<long long>(scratch_rows(Kx)) * scratch_cols(N, BN);
  return n > 2147483647LL ? -1 : static_cast<int>(n);
}

// Plain C entry point, loaded with ctypes. `bias` and `residual` may be null.
// x is float32 (x_is_bf16 = 0) or bfloat16 (1), row-major (M, K_x) with
// K_x % 8 == 0 and a 16-byte-aligned base; packed is int8 (K_pad/2, N);
// codebook int8 (16,); scale and bias float32 (N,); residual and out float32
// row-major (M, N). The configuration: the tile (block_m, block_n) from the
// table of `with_tile`, and in_tile = 1 to dequantize inside the GEMM (no
// pre-pass; scratch may be null; needs N % 16 == 0, pack_block % 64 == 0
// and a 16-byte-aligned `packed`) or 0 for the pre-pass into `scratch`
// (float64, 16-byte aligned, at least lut_matmul_scratch_doubles(K_x, N,
// block_n) of them). Launches on `stream`; returns the CUDA error of the
// launches (0 on success; cudaErrorInvalidValue for a tile outside the
// table).
extern "C" int lut_matmul_launch(const void* x, const void* packed,
                                 const void* codebook, const void* scale,
                                 const void* bias, const void* residual,
                                 void* out, void* scratch, void* stream,
                                 long long scratch_doubles, int device, int M,
                                 int Kx, int Kpad, int N, int pack_block,
                                 int activation, int x_is_bf16, int block_m,
                                 int block_n, int in_tile) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, packed, codebook, scale, bias, residual, out, scratch,
               scratch_doubles, static_cast<cudaStream_t>(stream), device, M,
               Kx, Kpad, N, pack_block, activation, in_tile};
  return static_cast<int>(with_config(
      x_is_bf16, block_m, block_n, [&](auto c) { return launch<decltype(c)>(a); }));
}

// The configuration (block_m, block_n, in_tile), into info[0..14]: MMA
// shape (m, n, k), ring stages, block tile (BM, BN, KC), warp tile (WM, WN),
// threads, registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes a block, resident blocks per SM, SMs.
extern "C" int lut_matmul_config(int block_m, int block_n, int in_tile,
                                 int x_is_bf16, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_config(x_is_bf16, block_m, block_n, [&](auto c) {
    return describe<decltype(c)>(device, in_tile, info);
  }));
}
