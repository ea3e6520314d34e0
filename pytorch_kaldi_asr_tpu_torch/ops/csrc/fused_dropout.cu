// Fused dropout, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel K3 of the JAX package:
//   pytorch_kaldi_asr_tpu/ops/fused_dropout.py :: _run_kernel /
//   _fused_dropout_2d (Pallas kernel `_kernel`), the drop-in for
//   models.common.dropout whose custom VJP reruns the kernel on the
//   cotangent with the same seed.
//
// Computes, for every element i of a contiguous float32 tensor of n elements,
//   out[i] = bits(i) >= threshold ? x[i] * scale : 0
// where bits(i) is lane i % 4 of Philox4x32-10 (Salmon et al., SC'11; the
// generator cuRAND and PyTorch's CUDA dropout use) with key = the 64-bit seed
// and counter = (i / 4) as a 128-bit integer.  The mask depends only on the
// seed and the element's flat index, never on the launch shape, so the
// forward, the backward (the same call on the cotangent) and the plain
// PyTorch version (ops/fused_dropout.py, int64 arithmetic) draw the same bits.
// The TPU kernel's bits (pltpu.prng_random_bits) are TPU hardware and are not
// reproduced.  No mask is ever stored.
//
// Design (simple and correct first): one grid-stride elementwise pass; each
// thread takes one group of four elements per iteration, reads them as one
// float4, draws one Philox block (four 32-bit words) and writes one float4.
// A group that runs past n (n % 4 != 0) takes the scalar tail.  x and out are
// 16-byte aligned (the wrapper copies an unaligned input).
//
// Bound on an H100 SXM at the conformer's largest site ([51 200, 1024] f32,
// 52.4 M elements): read 4 B and write 4 B per element = 419 MB at 3.35 TB/s,
// about 0.125 ms, bound by the bytes (one float multiply per element).
// Philox costs 10 rounds of two 32x32 multiplies (lo and hi) per four
// elements on the integer units, which should stay below the memory time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float keep_or_zero(uint32_t bits, uint32_t threshold, float x,
                                              float scale) {
  return bits >= threshold ? x * scale : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
fused_dropout_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                     uint32_t k0, uint32_t k1, uint32_t threshold, float scale) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), k0, k1);
    const int64_t i = 4 * g;
    if (i + 4 <= n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      reinterpret_cast<float4*>(out)[g] = make_float4(
          keep_or_zero(bits.x, threshold, v.x, scale),
          keep_or_zero(bits.y, threshold, v.y, scale),
          keep_or_zero(bits.z, threshold, v.z, scale),
          keep_or_zero(bits.w, threshold, v.w, scale));
    } else {
      const uint32_t lane[4] = {bits.x, bits.y, bits.z, bits.w};
      for (int j = 0; i + j < n; ++j) {
        out[i + j] = keep_or_zero(lane[j], threshold, x[i + j], scale);
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int fused_dropout_f32(const void* x, void* out, long long n, uint32_t key_lo,
                                 uint32_t key_hi, uint32_t threshold, float scale,
                                 void* stream) {
  if (n <= 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = (n + 3) / 4;
  const long long wanted = (groups + kThreads - 1) / kThreads;
  // enough CTAs for 16 per SM on 132 SMs; beyond that the loop strides
  const unsigned blocks = static_cast<unsigned>(wanted < 132 * 16 ? wanted : 132 * 16);
  fused_dropout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<int64_t>(n),
      key_lo, key_hi, threshold, scale);
  return static_cast<int>(cudaGetLastError());
}
