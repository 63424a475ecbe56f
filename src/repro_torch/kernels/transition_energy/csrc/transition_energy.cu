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
// is exact and does not depend on the order of the atomics, and it equals
// the plain version (`ref.py`) bit for bit.
//
// What bounds it on an H100: integer operations. Each MAC transition costs
// about 40 integer instructions (two multiplies, xors and masks, four
// popc/clz for the energy events, one popc and one clz for the group of
// p', divisions by constants, a shared-memory atomic); popc and clz issue
// at 16 per clock per SM, a quarter of the ALU rate, so they set the floor.
// Input bytes are small: 4 * 64 * (64 + T) per tile.
//
// What the design does about it. One block per tile (mask-0 tiles return at
// once). The tile's weights and activations are staged in shared memory.
// Each thread owns one M column and a run of up to 16 transitions; it walks
// k = 0..63 carrying the running psums of its run in registers, so there is
// no (K, M, T) array anywhere, and each psum's group is computed once and
// reused for the transition on either side. Event sums go to per-block
// int32 shared-memory bins (one atomic per weight per run), the group-pair
// histogram to 2,500 int32 shared-memory bins (one atomic per transition),
// and both are flushed once per block to 64-bit global bins. The activation
// pairs (64 * (T - 1) per tile) go straight to the 65,536 global bins,
// aggregated within a warp over equal bins first (`__match_any_sync`), since
// the zeros after a relu make one bin hot. Per-warp private histograms,
// int8 staging and a cheaper group computation are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRuns = kThreads / kTile;  // transition runs in flight per column
constexpr int kRun = 16;                 // transitions per run
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

__global__ void __launch_bounds__(kThreads)
transition_counts_kernel(const int32_t* __restrict__ w_tiles,
                         const int32_t* __restrict__ a_blocks,
                         const float* __restrict__ mask, int t_len,
                         unsigned long long* __restrict__ events,
                         unsigned long long* __restrict__ group_hist,
                         unsigned long long* __restrict__ act_hist) {
  const int b = blockIdx.x;
  if (mask[b] == 0.f) return;

  extern __shared__ int smem[];
  int* s_w = smem;                          // (K, M)
  int* s_a = s_w + kTile * kTile;           // (K, T)
  int* s_ev = s_a + kTile * t_len;          // (256, kEvents)
  int* s_gh = s_ev + kWVals * kEvents;      // (2500,)

  const int tid = threadIdx.x;
  const int32_t* w_g = w_tiles + static_cast<size_t>(b) * kTile * kTile;
  const int32_t* a_g = a_blocks + static_cast<size_t>(b) * kTile * t_len;
  for (int i = tid; i < kTile * kTile; i += kThreads) s_w[i] = w_g[i];
  for (int i = tid; i < kTile * t_len; i += kThreads) s_a[i] = a_g[i];
  for (int i = tid; i < kWVals * kEvents; i += kThreads) s_ev[i] = 0;
  for (int i = tid; i < kPairs; i += kThreads) s_gh[i] = 0;
  __syncthreads();

  const int n_trans = t_len - 1;

  // activation pairs: every lane of a warp runs the same number of rounds,
  // so the full-warp match is legal; lanes past the end carry bin -1
  const int lane = tid & 31;
  const int n_act = kTile * n_trans;
  for (int base = 0; base < n_act; base += kThreads) {
    const int i = base + tid;
    int bin = -1;
    if (i < n_act) {
      const int k = i / n_trans;
      const int t = i - k * n_trans;
      const int* a = s_a + k * t_len + t;
      bin = (a[0] + 128) * kWVals + (a[1] + 128);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&act_hist[bin], static_cast<unsigned long long>(__popc(peers)));
  }

  // MAC transitions: column m, runs of kRun transitions starting at t0
  const int m = tid % kTile;
  for (int t0 = (tid / kTile) * kRun; t0 < n_trans; t0 += kRuns * kRun) {
    const int len = min(kRun, n_trans - t0);
    int p[kRun + 1];
#pragma unroll
    for (int j = 0; j <= kRun; ++j) p[j] = 0;
    for (int k = 0; k < kTile; ++k) {
      const int w = s_w[k * kTile + m];
      const int w_bits = __popc(static_cast<unsigned>(w) & 0xFFu);
      const int* a = s_a + k * t_len + t0;
      int a_prev = a[0];
      p[0] += w * a_prev;
      int g_prev = group_id(p[0]);
      int prod = 0, pp = 0, acc = 0, carry = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (j < len) {
          const int a_cur = a[j + 1];
          p[j + 1] += w * a_cur;
          prod += __popc(static_cast<unsigned>((w * a_prev) ^ (w * a_cur))
                         & 0xFFFFu);
          pp += __popc(static_cast<unsigned>(a_prev ^ a_cur) & 0xFFu) * w_bits;
          const unsigned dp = static_cast<unsigned>(p[j] ^ p[j + 1]) & kMask22;
          acc += __popc(dp);
          carry += bit_length(dp);
          const int g_cur = group_id(p[j + 1]);
          atomicAdd(&s_gh[g_prev * kGroups + g_cur], 1);
          g_prev = g_cur;
          a_prev = a_cur;
        }
      }
      int* ev = s_ev + (w + 128) * kEvents;
      atomicAdd(ev + 0, len);
      atomicAdd(ev + 1, prod);
      atomicAdd(ev + 2, pp);
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

}  // namespace

// Plain C entry point, loaded with ctypes. w_tiles int32 (n, 64, 64) and
// a_blocks int32 (n, 64, T), both contiguous with int8-range values; mask
// float32 (n,); events (256, 5), group_hist (2500,) and act_hist (65536,)
// are 64-bit integer bins that the kernel adds to (the caller zeroes them).
// 2 <= T <= 512. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int transition_counts_launch(const void* w_tiles,
                                        const void* a_blocks, const void* mask,
                                        void* events, void* group_hist,
                                        void* act_hist, void* stream,
                                        int device, int n_tiles, int t_len) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(int) * (kTile * kTile + kTile * t_len
                                     + kWVals * kEvents + kPairs);
  err = cudaFuncSetAttribute(transition_counts_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  transition_counts_kernel<<<n_tiles, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w_tiles),
      static_cast<const int32_t*>(a_blocks), static_cast<const float*>(mask),
      t_len, static_cast<unsigned long long*>(events),
      static_cast<unsigned long long*>(group_hist),
      static_cast<unsigned long long*>(act_hist));
  return static_cast<int>(cudaGetLastError());
}
