// Systolic-array transition statistics for Hopper (sm_90a): kernel K1.
//
// For a batch of n stationary 64x64 weight tiles W (K x M, int8-valued),
// each streaming an activation block A (K x T, int8-valued), MAC (k, m)
// holds the prefix sum p[k, m, t] = sum_{k' <= k} W[k', m] * A[k', t]. For
// every MAC and every streaming transition t -> t + 1 the kernel counts
//
//   * the MAC model's four energy events, summed per weight value w + 128:
//     product toggles popc((w*a ^ w*a') & 0xFFFF), partial-product activity
//     popc((a ^ a') & 0xFF) * popc(w & 0xFF), accumulator toggles
//     popc(dp) and carry length 32 - clz(dp), dp = (p ^ p') & 0x3FFFFF, plus
//     the number of transitions (the `count` output);
//   * the 50 x 50 histogram of (group(p), group(p')) pairs, group =
//     MSB group x Hamming-weight subgroup of the 22-bit pattern;
//   * the 256 x 256 histogram of (a, a') activation pairs, once per (k, t).
//
// Tiles whose mask is 0 contribute nothing. Replaces the TPU kernel
//   src/repro/kernels/transition_energy/transition_energy.py
//     ::transition_stats_batched_pallas (body `_batched_kernel` ->
//     `_accumulate`, `_energy`, `_group_id`, `_msb22`).
// The TPU version turns every histogram into a one-hot matmul for the MXU
// and sums float32 energies. Here every output is an integer count: the
// energy of a transition is linear in the four event counts, and the weight
// fixes which branch applies (w == 0 is zero-gated), so the wrapper prices
// the per-weight event sums once in float64 (`price_event_sums`). The result
// is exact and does not depend on the order of blocks or atomics, and it
// equals the plain version (`ref.py`) bit for bit.
//
// What bounds it on an H100: integer operations. Each MAC transition costs
// about 40 integer instructions (multiplies, xors and masks, four popc/clz
// for the energy events, one popc and one clz for the group of p',
// divisions by constants, a shared-memory atomic); popc and clz issue at 16
// per clock per SM, a quarter of the ALU rate, so they set the floor. Input
// bytes are small: 4 * 64 * (64 + T) per tile.
//
// What the design does about it. The grid is (tile, slab of transitions):
// the wrapper's launch plan (`transition_energy.launch_plan`) cuts each
// tile's T - 1 transitions into slabs so that a launch of few tiles (the
// profile path's 16) still puts two blocks on every SM, and gives a launch
// of thousands of tiles one slab a tile. A block stages its tile's weights
// and its slab of activations, plus the one column the slab's last
// transition reads, as int8 in shared memory (mask-0 tiles return at once).
// Its 256 threads are 64 columns x 4 segments of 16 rows k: each thread
// starts its segment from the psums of the rows above it, then walks its 16
// rows carrying a run of up to 16 transitions' psums in registers, so there
// is no (K, M, T) array anywhere, and each psum's group is computed once and
// reused for the transition on either side. The activation toggles
// popc((a ^ a') & 0xFF), shared by the 64 MACs of a row, are counted once
// per (k, t) into a shared table. Event sums go to int32 shared bins (one
// atomic per weight per run) and the group pairs to one int32 shared
// histogram a block (a histogram per warp measured no faster, and slower
// where its shared memory cut the resident blocks); every non-zero bin is
// flushed once per block to the 64-bit global bins. The activation pairs of
// the slab go straight to the 65,536 global bins, aggregated within a warp
// over equal bins first (`__match_any_sync`), since the zeros after a relu
// make one bin hot; slabs partition the transitions, so each (k, t) pair is
// counted once per tile. The entry point zeroes the output bins on the
// stream, and raises the shared-memory opt-in once a device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kSegs = kThreads / kTile;  // row segments per column
constexpr int kSeg = kTile / kSegs;      // rows k per segment
constexpr int kRun = 16;                 // transitions a register run holds
constexpr int kMaxT = 512;               // columns a block (transition_energy.MAX_T)
constexpr int kWVals = 256;
constexpr int kEvents = 5;               // transitions, prod, pp, acc, carry
constexpr int kGroups = 50;
constexpr int kPairs = kGroups * kGroups;
constexpr unsigned kMask22 = (1u << 22) - 1;

// 1 + the index of the top set bit, 0 for zero (the JAX `_msb22(x) + 1` of a
// value already masked to 22 bits)
__device__ __forceinline__ int bit_length(unsigned v) {
  return 32 - __clz(static_cast<int>(v));
}

// MSB group x Hamming-weight subgroup of the 22-bit pattern of p. The mask
// applies before the zero test (`_msb22`): a value that is 0 mod 2^22 has
// msb value 0.
__device__ __forceinline__ int group_id(int p) {
  const unsigned m = static_cast<unsigned>(p) & kMask22;
  const int mg = min(bit_length(m) * 10 / 23, 9);
  const int hg = min(__popc(m) * 5 / 23, 4);
  return mg * 5 + hg;
}

// Dynamic shared memory of a block: the group-pair histogram, the event
// bins, the int8 weight tile, slab_len + 1 int8 activation columns and
// slab_len activation-toggle counts per row.
__host__ __device__ constexpr size_t smem_bytes(int slab_len) {
  return sizeof(int) * (kPairs + kWVals * kEvents) + kTile * kTile
         + static_cast<size_t>(kTile) * (2 * slab_len + 1);
}

__global__ void __launch_bounds__(kThreads, 4)
transition_counts_kernel(const int32_t* __restrict__ w_tiles,
                         const int32_t* __restrict__ a_blocks,
                         const float* __restrict__ mask, int t_len,
                         int slab_len,
                         unsigned long long* __restrict__ events,
                         unsigned long long* __restrict__ group_hist,
                         unsigned long long* __restrict__ act_hist) {
  const int b = blockIdx.x;
  if (mask[b] == 0.f) return;
  const int s0 = blockIdx.y * slab_len;     // first transition of the slab
  const int len = min(slab_len, t_len - 1 - s0);
  const int cols = len + 1;                 // activation columns it reads

  extern __shared__ int smem[];
  int* s_gh = smem;                          // (2500,)
  int* s_ev = s_gh + kPairs;                 // (256, kEvents)
  int8_t* s_w = reinterpret_cast<int8_t*>(s_ev + kWVals * kEvents);  // (K, M)
  int8_t* s_a = s_w + kTile * kTile;         // (K, cols)
  int8_t* s_tog = s_a + kTile * cols;        // (K, len) activation toggles

  const int tid = threadIdx.x;
  const int32_t* w_g = w_tiles + static_cast<size_t>(b) * kTile * kTile;
  const int32_t* a_g = a_blocks + static_cast<size_t>(b) * kTile * t_len + s0;
  for (int i = tid; i < kTile * kTile; i += kThreads)
    s_w[i] = static_cast<int8_t>(w_g[i]);
  for (int i = tid; i < kTile * cols; i += kThreads) {
    const int k = i / cols;
    s_a[i] = static_cast<int8_t>(a_g[static_cast<size_t>(k) * t_len
                                     + (i - k * cols)]);
  }
  for (int i = tid; i < kWVals * kEvents; i += kThreads) s_ev[i] = 0;
  for (int i = tid; i < kPairs; i += kThreads) s_gh[i] = 0;
  __syncthreads();

  // activation pairs and toggles of the slab: every lane of a warp runs the
  // same number of rounds, so the full-warp match is legal; lanes past the
  // end carry bin -1
  const int lane = tid & 31;
  const int n_act = kTile * len;
  for (int base = 0; base < n_act; base += kThreads) {
    const int i = base + tid;
    int bin = -1;
    if (i < n_act) {
      const int k = i / len;
      const int t = i - k * len;
      const int a0 = s_a[k * cols + t], a1 = s_a[k * cols + t + 1];
      bin = (a0 + 128) * kWVals + (a1 + 128);
      s_tog[i] = static_cast<int8_t>(__popc(static_cast<unsigned>(a0 ^ a1)
                                            & 0xFFu));
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&act_hist[bin], static_cast<unsigned long long>(__popc(peers)));
  }
  __syncthreads();

  // MAC transitions: column m, rows k_lo..k_lo + kSeg - 1, runs of up to
  // kRun transitions starting at r0 within the slab
  const int m = tid % kTile;
  const int k_lo = (tid / kTile) * kSeg;
  for (int r0 = 0; r0 < len; r0 += kRun) {
    const int run = min(kRun, len - r0);
    int p[kRun + 1];
#pragma unroll
    for (int j = 0; j <= kRun; ++j) p[j] = 0;
    for (int k = 0; k < k_lo; ++k) {          // the psums of the rows above
      const int w = s_w[k * kTile + m];
      const int8_t* a = s_a + k * cols + r0;
#pragma unroll
      for (int j = 0; j <= kRun; ++j)
        if (j <= run) p[j] += w * a[j];
    }
    for (int k = k_lo; k < k_lo + kSeg; ++k) {
      const int w = s_w[k * kTile + m];
      const int8_t* a = s_a + k * cols + r0;
      const int8_t* tog = s_tog + k * len + r0;
      int wa_prev = w * a[0];
      p[0] += wa_prev;
      int g_prev = group_id(p[0]);
      int prod = 0, toggles = 0, acc = 0, carry = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (j < run) {
          const int wa_cur = w * a[j + 1];
          p[j + 1] += wa_cur;
          prod += __popc(static_cast<unsigned>(wa_prev ^ wa_cur) & 0xFFFFu);
          toggles += tog[j];
          const unsigned dp = static_cast<unsigned>(p[j] ^ p[j + 1]) & kMask22;
          acc += __popc(dp);
          carry += bit_length(dp);
          const int g_cur = group_id(p[j + 1]);
          atomicAdd(&s_gh[g_prev * kGroups + g_cur], 1);
          g_prev = g_cur;
          wa_prev = wa_cur;
        }
      }
      int* ev = s_ev + (w + 128) * kEvents;
      atomicAdd(ev + 0, run);
      atomicAdd(ev + 1, prod);
      atomicAdd(ev + 2, toggles * __popc(static_cast<unsigned>(w) & 0xFFu));
      atomicAdd(ev + 3, acc);
      atomicAdd(ev + 4, carry);
    }
  }
  __syncthreads();

  for (int i = tid; i < kWVals * kEvents; i += kThreads)
    if (s_ev[i]) atomicAdd(&events[i], static_cast<unsigned long long>(s_ev[i]));
  for (int i = tid; i < kPairs; i += kThreads)
    if (s_gh[i])
      atomicAdd(&group_hist[i], static_cast<unsigned long long>(s_gh[i]));
}

// Raise the kernel's dynamic shared memory opt-in on `device`, once, to what
// the largest plan takes (one slab of T = kMaxT). Every caller
// sets the same value, so concurrent first calls cannot undo each other,
// and later launches (inside a CUDA graph capture too) make no call.
cudaError_t opt_in(int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      transition_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxT - 1)));
  if (err == cudaSuccess && device >= 0 && device < kDevices)
    done[device] = true;
  return err;
}

}  // namespace

// Registers a thread, local (spill) bytes a thread, resident blocks per SM
// and dynamic shared memory (bytes) a block at the given slab length, into
// info[0..3].
extern "C" int transition_counts_config(int slab_len, int device,
                                        int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(smem_bytes(slab_len));
  err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, transition_counts_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, transition_counts_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  info[3] = smem;
  return 0;
}

// Plain C entry point, loaded with ctypes. w_tiles int32 (n, 64, 64) and
// a_blocks int32 (n, 64, T), both contiguous with int8-range values; mask
// float32 (n,); bins 64-bit integers, the events (256, 5), then the
// group-pair histogram (2500,), then the activation-pair histogram
// (65536,), which this zeroes on the stream before the kernel adds to
// them. 2 <= T <= 512. The launch plan: `slabs` slabs of `slab_len`
// transitions a tile (slabs * slab_len >= T - 1 > (slabs - 1) * slab_len).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int transition_counts_launch(const void* w_tiles,
                                        const void* a_blocks, const void* mask,
                                        void* bins, void* stream, int device,
                                        int n_tiles, int t_len, int slabs,
                                        int slab_len) {
  if (t_len < 2 || t_len > kMaxT || slabs < 1 || slab_len < 1
      || static_cast<long long>(slabs) * slab_len < t_len - 1
      || static_cast<long long>(slabs - 1) * slab_len >= t_len - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* events = static_cast<unsigned long long*>(bins);
  unsigned long long* group_hist = events + kWVals * kEvents;
  unsigned long long* act_hist = group_hist + kPairs;
  err = cudaMemsetAsync(bins, 0, sizeof(unsigned long long)
                        * (kWVals * kEvents + kPairs + kWVals * kWVals), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(slab_len);
  err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  transition_counts_kernel<<<dim3(n_tiles, slabs), kThreads, smem, s>>>(
      static_cast<const int32_t*>(w_tiles),
      static_cast<const int32_t*>(a_blocks), static_cast<const float*>(mask),
      t_len, slab_len, events, group_hist, act_hist);
  return static_cast<int>(cudaGetLastError());
}
