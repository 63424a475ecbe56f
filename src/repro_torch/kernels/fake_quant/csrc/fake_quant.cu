// Fused weight fake-quantization for QAT, for Hopper (sm_90a).
//
//   wm  = w * mask
//   q   = clip(rint(wm / scale[n]), -127, 127)
//   q'  = nearest of the first k codebook entries to MSR(q, msr_bits)
//         (k = 0: no projection; msr_bits = 0: no truncation)
//   out = q' * scale[n]
//
// over an (M, N) weight matrix: a conv kernel (kh, kw, c_in, c_out) or a
// dense weight (in, out) viewed as (-1, c_out), so the scale is per column.
//
// Replaces the TPU kernel
//   src/repro/kernels/fake_quant/fake_quant.py::fake_quant_pallas
// (body `_kernel`), with the most-significant-run truncation of
// `repro.core.qat.fake_quant_weight` fused between the rounding and the
// projection. With msr_bits = 0 it computes exactly what the TPU kernel
// computes. The straight-through backward (g * mask) is plain PyTorch, as
// in the JAX package; it never reads this kernel's output.
//
// Exactness. The result must equal the plain version (kernels/fake_quant/
// ref.py, the port's and the JAX package's QAT chain) bit for bit, so every
// step is an IEEE operation nvcc may not rewrite: __fmul_rn for the mask and
// the final scale (no contraction into an FMA), __fdiv_rn for the division
// (never --use_fast_math), rintf (round half to even, as torch.round and
// jnp.round; roundf would round half away from zero), the clip before the
// projection, and a strict `<` in the nearest-value search so that a tie
// keeps the lower index (the smaller value of a sorted codebook).
//
// What bounds it on an H100. Per weight it reads w and the mask and writes
// the output, 12 bytes, plus one scale per column; ResNet-20's largest layer
// holds 36,864 weights, 0.44 MB, 0.13 us at 3.35 TB/s. Every launch of the
// QAT path is therefore bound by launch latency, not by bytes or operations.
//
// What the design does about it. One thread per element in a grid-stride
// loop, one launch per weight, no host synchronisation: k and msr_bits are
// read on the device from the comp state's scalars. Each block first builds
// a 256-entry table in shared memory, table[v + 128] = projection of
// MSR(v), one int8 value per thread, instead of the TPU kernel's 32-way
// unrolled select per element; MSR truncation and projection are functions
// of the int8 value alone, so the table gives the same result as the
// chain. Each element then costs a multiply, a division, a rounding, a clip,
// a shared-memory read and a multiply.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // = the 256 int8 values of the table
constexpr int kKMax = 32;      // codebook length (qat.K_MAX)
constexpr float kQMax = 127.f;
constexpr int kMaxBlocks = 132 * 16;

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

template <typename MaskT>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const float* __restrict__ w, const MaskT* __restrict__ mask,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ codebook,
                  const int32_t* __restrict__ k_ptr, int k_val,
                  const int32_t* __restrict__ msr_ptr, int msr_val,
                  float* __restrict__ out, long long total, int n) {
  __shared__ float table[kThreads];
  {
    const int k = k_ptr != nullptr ? *k_ptr : k_val;
    const int bits = msr_ptr != nullptr ? *msr_ptr : msr_val;
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
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < total; i += stride) {
    const float s = __ldg(scale + i % n);
    const float wm = __fmul_rn(__ldg(w + i), mask_value(mask, i));
    float q = rintf(__fdiv_rn(wm, s));
    q = fminf(fmaxf(q, -kQMax), kQMax);
    out[i] = __fmul_rn(table[static_cast<int>(q) + 128], s);
  }
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
