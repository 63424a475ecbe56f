// Fused weight fake-quantization for QAT, for Hopper (sm_90a): kernel K3.
//
// Two entry points share one chain. The per-layer kernel takes the
// per-column scale from the caller:
//
//   wm  = w * mask
//   q   = clip(rint(wm / scale[n]), -127, 127)
//   q'  = nearest of the first k codebook entries to MSR(q, msr_bits)
//         (k = 0: no projection; msr_bits = 0: no truncation)
//   out = q' * scale[n]
//
// The grouped kernel does a whole QAT forward's weights in one launch and
// computes the rest of `repro_torch.core.qat.fake_quant_weight` itself:
//
//   scale[n] = max(max_m |wm[m, n]|, 1e-8) / 127
//   out      = wm + (q' * scale[n] - wm)      (the straight-through value)
//
// over (M, N) weight matrices: a conv kernel (kh, kw, c_in, c_out) or a
// dense weight (in, out) viewed as (-1, c_out), so the scale is per column.
// An entry of the grouped table may carry C candidates of its layer (the
// batched schedule sweep trains and evaluates C comp variants of a model in
// lockstep): candidate c reads w, mask, codebook, k and msr_bits at c times
// that field's candidate stride, and writes out at c * M * N. A field's
// candidate stride is either its size (one copy a candidate) or 0 (one copy
// shared by every candidate: the sweep's non-target layers, a shared mask,
// the weights of an evaluation of several comp variants of one model), so
// the table stores one "shared" bit a field, not a stride. Each candidate
// computes what the one-candidate entry computes, bit for bit.
//
// Replaces the TPU kernel
//   src/repro/kernels/fake_quant/fake_quant.py::fake_quant_pallas
// (body `_kernel`), with the most-significant-run truncation of
// `repro.core.qat.fake_quant_weight` fused between the rounding and the
// projection. With msr_bits = 0 the per-layer kernel computes exactly what
// the TPU kernel computes. The straight-through backward (g * mask) is plain
// PyTorch, as in the JAX package; it never reads this kernel's output.
//
// Exactness. The result must equal the plain version (kernels/fake_quant/
// ref.py, the port's and the JAX package's QAT chain) bit for bit, so every
// step is an IEEE operation nvcc may not rewrite: __fmul_rn for the mask and
// the final scale (no contraction into an FMA), __fdiv_rn for the divisions
// (never --use_fast_math), rintf (round half to even, as torch.round and
// jnp.round; roundf would round half away from zero), the clip before the
// projection, a strict `<` in the nearest-value search so that a tie keeps
// the lower index (the smaller value of a sorted codebook), and __fsub_rn /
// __fadd_rn for `wm + (wq - wm)`, which is not always wq in float32. The
// column maximum is exact in any order, so a block reduction equals
// torch.amax; it passes a NaN through, as torch.amax does.
//
// What bounds it on an H100. Per weight it reads w and the mask and writes
// the output, 12 bytes, plus one codebook per layer; ResNet-20's 22 layers
// hold 270,896 weights, 3.3 MB, 0.97 us at 3.35 TB/s. A QAT forward of 22
// per-layer launches (2.5 us each) plus the eager ops around them is bound
// by launch latency, not by bytes or operations. With C candidates a
// layer, C x 3.3 MB: 5.9 us at C = 6 (the sweep's trial forwards), 62 us at
// C = 63 (its largest gathered evaluation), less where fields are shared.
//
// What the design does about it. The grouped kernel takes the forward's
// layers as a table passed by value (`__grid_constant__`, read in place
// from the parameter bank: no copy to the device, no host synchronisation)
// and launches once: one 256-thread block per (layer, candidate, slab of 8
// columns), so n candidates of 22 layers are still 22 entries and one
// launch, and more candidates fill more of the card's 132 SMs;
// 32 row phases a column, each thread with 8 loads in flight (the columns
// are short, so a dependent load a row would cost a memory latency each).
// A block reduces its columns' |w * mask| maxima through shared memory and
// divides once per column; meanwhile it builds a 256-entry table in shared
// memory, table[v + 128] = projection of MSR(v), one int8 value per thread,
// from the layer's codebook (staged in shared memory) and its k and
// msr_bits, read on the device from the comp state's scalars. MSR
// truncation and projection are functions of the int8 value alone, so the
// table gives the same result as the chain. A second pass over the same
// (L1/L2-resident) rows writes the outputs. The per-layer kernel is one
// thread per element in a grid-stride loop over the same table.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // = the 256 int8 values of the table
constexpr int kKMax = 32;      // codebook length (qat.K_MAX)
constexpr float kQMax = 127.f;
constexpr float kMinAmax = 1e-8f;          // qat._over_qmax's clamp
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSlab = 8;                   // columns a grouped block owns
constexpr int kRowPhases = kThreads / kSlab;
constexpr int kBatch = 8;                  // loads in flight a thread
constexpr int kMaxGroup = 60;              // layers a grouped launch takes
constexpr int kEntryWords = 12;            // int64 words of a host entry
constexpr int kMaxCands = 256;             // candidates an entry takes
// GroupEntry::flags: bit 0 int8 mask; bits 1-5 the field is shared by every
// candidate (candidate stride 0); bits 8-15 k, 16-23 msr_bits by value. The
// candidate count needs no field: it sets how many blocks the entry owns.
constexpr int kInt8Mask = 1, kSharedW = 2, kSharedMask = 4,
              kSharedCodebook = 8, kSharedK = 16, kSharedMsr = 32;

// Keep the top `bits` significant bits of |q|, zero the rest, keep the sign;
// bits <= 0 is the identity (qat.msr_truncate_int).
__device__ __forceinline__ int msr_truncate(int q, int bits) {
  if (bits <= 0) return q;
  const int mag = q < 0 ? -q : q;
  const int shift = max(32 - __clz(mag) - bits, 0);  // __clz(0) = 32
  const int kept = (mag >> shift) << shift;
  return q < 0 ? -kept : kept;
}

__device__ __forceinline__ float mask_value(const float* m, long long i) {
  return m[i];
}
__device__ __forceinline__ float mask_value(const int8_t* m, long long i) {
  return static_cast<float>(m[i]);
}

// The codebook into shared memory, one entry a thread, so that the table's
// search reads no device memory. The caller syncs.
__device__ __forceinline__ void stage_codebook(int* s_cb,
                                               const int32_t* codebook) {
  if (threadIdx.x < kKMax) s_cb[threadIdx.x] = __ldg(codebook + threadIdx.x);
}

// table[v + 128] = the projection of MSR(v, bits) onto the first k values
// of the staged codebook (k <= 0: MSR(v)); thread t fills entry t. The
// caller syncs.
__device__ __forceinline__ void build_table(float* table, const int* codebook,
                                            int k, int bits) {
  const int v = static_cast<int>(threadIdx.x) - 128;
  const int m = msr_truncate(v, bits);
  int best = m;
  if (k > 0) {
    const int kk = min(k, kKMax);
    int best_d = INT_MAX;
    for (int c = 0; c < kk; ++c) {
      const int cv = codebook[c];
      const int d = abs(m - cv);
      if (d < best_d) {  // strict: a tie keeps the lower index
        best_d = d;
        best = cv;
      }
    }
  }
  table[threadIdx.x] = static_cast<float>(best);
}

// max(a, b) that returns NaN if either is NaN, as torch.amax, torch.clamp
// and jnp.max do (fmaxf drops a NaN): a NaN weight makes its column's scale,
// and so the whole column, NaN, as in the plain version
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// q' * s for wm = w * mask: quantize, clip (a NaN to 0, as the plain
// version's and XLA's float-to-int conversion take it), project through the
// table
__device__ __forceinline__ float project(const float* table, float wm,
                                         float s) {
  float q = rintf(__fdiv_rn(wm, s));
  q = q != q ? 0.f : fminf(fmaxf(q, -kQMax), kQMax);
  return __fmul_rn(table[static_cast<int>(q) + 128], s);
}

template <typename MaskT>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const float* __restrict__ w, const MaskT* __restrict__ mask,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ codebook,
                  const int32_t* __restrict__ k_ptr, int k_val,
                  const int32_t* __restrict__ msr_ptr, int msr_val,
                  float* __restrict__ out, long long total, int n) {
  __shared__ float table[kThreads];
  __shared__ int s_cb[kKMax];
  stage_codebook(s_cb, codebook);
  __syncthreads();
  build_table(table, s_cb, k_ptr != nullptr ? *k_ptr : k_val,
              msr_ptr != nullptr ? *msr_ptr : msr_val);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < total; i += stride) {
    const float s = __ldg(scale + i % n);
    out[i] = project(table, __fmul_rn(__ldg(w + i), mask_value(mask, i)), s);
  }
}

// One layer of a grouped launch, with its candidates. k / msr_bits come
// from the device scalars where the pointer is set, else from the by-value
// field.
struct GroupEntry {
  const float* w;
  const void* mask;
  const int32_t* codebook;
  const int32_t* k_ptr;
  const int32_t* msr_ptr;
  float* out;
  int m, n;
  int first_block;   // this layer's first block in the grid
  int flags;         // see kInt8Mask ... above
};

struct GroupTable {
  GroupEntry e[kMaxGroup];
  int count;
};

// One block's columns c0.. of one candidate of a layer (its w, mask and out
// already offset to that candidate): the column maxima (pass 1), the
// projection table from the staged codebook while the maxima reduce, then
// the outputs (pass 2).
template <typename MaskT>
__device__ __forceinline__ void group_columns(
    const float* __restrict__ w, const MaskT* __restrict__ mask,
    float* __restrict__ out, int m, int n_cols, int c0, int k, int bits,
    const int* s_cb, float* table, float (*s_part)[kSlab], float* s_scale) {
  const int tx = threadIdx.x % kSlab, ty = threadIdx.x / kSlab;
  const int col = c0 + tx;
  const bool live = col < n_cols;
  const long long n = n_cols;
  constexpr int kStride = kRowPhases * kBatch;  // rows a batch of loads spans

  // a thread's rows are ty, ty + kRowPhases, ...; each round issues kBatch
  // independent loads before it uses any, so the round costs one memory
  // latency, not kBatch
  float amax = 0.f;
  if (live)
    for (int r0 = ty; r0 < m; r0 += kStride) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * kRowPhases;
        const long long i = r * n + col;
        v[u] = r < m ? fabsf(__fmul_rn(__ldg(w + i), mask_value(mask, i)))
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) amax = nan_max(v[u], amax);
    }
  s_part[ty][tx] = amax;
  __syncthreads();
  build_table(table, s_cb, k, bits);
  if (ty == 0) {
    for (int p = 1; p < kRowPhases; ++p) amax = nan_max(amax, s_part[p][tx]);
    s_scale[tx] = __fdiv_rn(nan_max(amax, kMinAmax), kQMax);
  }
  __syncthreads();

  if (!live) return;
  const float s = s_scale[tx];
  for (int r0 = ty; r0 < m; r0 += kStride) {
    float wm[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u * kRowPhases;
      const long long i = r * n + col;
      wm[u] = r < m ? __fmul_rn(__ldg(w + i), mask_value(mask, i)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u * kRowPhases;
      if (r < m)
        out[r * n + col] =
            __fadd_rn(wm[u], __fsub_rn(project(table, wm[u], s), wm[u]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fake_quant_group_kernel(const __grid_constant__ GroupTable table) {
  __shared__ float proj[kThreads];
  __shared__ int s_cb[kKMax];
  __shared__ float s_part[kRowPhases][kSlab];
  __shared__ float s_scale[kSlab];

  int e = 0;  // the layer this block belongs to (first_block ascends)
  while (e + 1 < table.count
         && static_cast<int>(blockIdx.x) >= table.e[e + 1].first_block)
    ++e;
  const GroupEntry& en = table.e[e];
  const int flags = en.flags;
  // this block's (candidate, slab): blocks of an entry run candidate-major
  const int slabs = (en.n + kSlab - 1) / kSlab;
  const int local = static_cast<int>(blockIdx.x) - en.first_block;
  const int cand = local / slabs;
  const int c0 = (local - cand * slabs) * kSlab;
  const long long mn = static_cast<long long>(en.m) * en.n;
  const long long at = cand * mn;  // the candidate's offset in its slices
  stage_codebook(s_cb, en.codebook + (flags & kSharedCodebook ? 0
                                                              : cand * kKMax));
  const int k = en.k_ptr != nullptr
                    ? en.k_ptr[flags & kSharedK ? 0 : cand]
                    : (flags >> 8) & 0xff;
  const int bits = en.msr_ptr != nullptr
                       ? en.msr_ptr[flags & kSharedMsr ? 0 : cand]
                       : (flags >> 16) & 0xff;
  const float* w = en.w + (flags & kSharedW ? 0 : at);
  const long long mask_at = flags & kSharedMask ? 0 : at;
  float* out = en.out + at;
  if (flags & kInt8Mask)
    group_columns<int8_t>(w, static_cast<const int8_t*>(en.mask) + mask_at,
                          out, en.m, en.n, c0, k, bits, s_cb, proj, s_part,
                          s_scale);
  else
    group_columns<float>(w, static_cast<const float*>(en.mask) + mask_at,
                         out, en.m, en.n, c0, k, bits, s_cb, proj, s_part,
                         s_scale);
}

}  // namespace

// Plain C entry point, loaded with ctypes. w float32 (m, n) and mask (m, n)
// float32 (mask_int8 = 0) or int8 (mask_int8 = 1), scale float32 (n,),
// codebook int32 (32,), out float32 (m, n), all contiguous on `device`.
// k and msr_bits are int32 device scalars at k_ptr / msr_ptr, or, where a
// pointer is null, the values k_val / msr_val. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fake_quant_launch(const void* w, const void* mask,
                                 const void* scale, const void* codebook,
                                 const void* k_ptr, const void* msr_ptr,
                                 void* out, void* stream, int device, int m,
                                 int n, int mask_int8, int k_val,
                                 int msr_val) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * n;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const int32_t* cb = static_cast<const int32_t*>(codebook);
  const int32_t* kp = static_cast<const int32_t*>(k_ptr);
  const int32_t* mp = static_cast<const int32_t*>(msr_ptr);
  float* o = static_cast<float*>(out);
  if (mask_int8) {
    fake_quant_kernel<int8_t><<<blocks, kThreads, 0, s>>>(
        wf, static_cast<const int8_t*>(mask), sc, cb, kp, k_val, mp, msr_val,
        o, total, n);
  } else {
    fake_quant_kernel<float><<<blocks, kThreads, 0, s>>>(
        wf, static_cast<const float*>(mask), sc, cb, kp, k_val, mp, msr_val,
        o, total, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Layers a grouped launch takes; the wrapper splits a larger group.
extern "C" int fake_quant_group_capacity() { return kMaxGroup; }

// Grouped entry point: `count` layers (1 <= count <= kMaxGroup), each 12
// int64 words at words[12 * i]: w, mask, codebook, k_ptr, msr_ptr, out
// (device addresses, k_ptr / msr_ptr 0 for by-value), m, n, bits (bit 0
// int8 mask; bits 1-5 w, mask, codebook, k, msr_bits shared by every
// candidate), k_val, msr_val, cands, with the per-layer kernel's layouts
// for one candidate, m, n >= 1, 1 <= cands <= kMaxCands; k_val in [0, 32]
// and msr_val in [0, 8]. A field that is not shared holds cands slices
// back to back; out always does. One launch computes every candidate's
// scale, projection and straight-through value. Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a bad count.
extern "C" int fake_quant_group_launch(const long long* words, int count,
                                       void* stream, int device) {
  if (count < 1 || count > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  GroupTable table = {};
  table.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* v = words + kEntryWords * i;
    GroupEntry& en = table.e[i];
    const long long cands = v[11];
    if (cands < 1 || cands > kMaxCands)
      return static_cast<int>(cudaErrorInvalidValue);
    en.w = reinterpret_cast<const float*>(v[0]);
    en.mask = reinterpret_cast<const void*>(v[1]);
    en.codebook = reinterpret_cast<const int32_t*>(v[2]);
    en.k_ptr = reinterpret_cast<const int32_t*>(v[3]);
    en.msr_ptr = reinterpret_cast<const int32_t*>(v[4]);
    en.out = reinterpret_cast<float*>(v[5]);
    en.m = static_cast<int>(v[6]);
    en.n = static_cast<int>(v[7]);
    en.flags = static_cast<int>((v[8] & 0x3f) | ((v[9] & 0xff) << 8)
                                | ((v[10] & 0xff) << 16));
    en.first_block = static_cast<int>(blocks);
    blocks += cands * ((en.n + kSlab - 1) / kSlab);
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  fake_quant_group_kernel<<<static_cast<int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}
