// CPU emulation of the few CUDA features that
// pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu uses, so
// its kernels compile with g++ and run on the CPU
// (tests/test_torch_k2_emulated.py): one std::thread per CUDA thread, one
// CTA at a time; barriers for __syncthreads and the warp collectives; and
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 by its PTX fragment
// layout.  Shared memory starts filled with NaN, so a read of a word never
// written shows in the results.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
using std::max;
using std::min;
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim threadIdx;
inline Dim blockIdx;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(uint32_t x) { float f; std::memcpy(&f, &x, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t x; std::memcpy(&x, &f, 4); return x; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
typedef int cudaError_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
typedef void* cudaStream_t;
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
// an SM of 228 KB whose registers hold 3 CTAs, as the H100's hold the
// backward kernels' up to d = 64
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t smem) {
  *n = std::min<size_t>(3, 233472 / (smem + 1024));
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
struct dim3 { unsigned x; dim3(unsigned v) : x(v) {} };

struct Warp {
  std::barrier<> bar{32};
  float f[32][4];
  uint32_t u[32][6];
  int i[32];
};
struct Cta {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  int flag[1024];
  std::vector<float4> smem;
};
inline Cta* g_cta;
inline unsigned g_block;
inline float4* emu_smem() { return g_cta->smem.data(); }
inline Warp& my_warp() { return *g_cta->warps[threadIdx.x / 32]; }
inline int my_lane() { return threadIdx.x % 32; }

inline void __syncthreads() { g_cta->bar->arrive_and_wait(); }
inline int __syncthreads_or(int x) {
  __syncthreads();
  g_cta->flag[threadIdx.x] = x;
  __syncthreads();
  int r = 0;
  for (unsigned i = 0; i < g_block; ++i) r |= g_cta->flag[i];
  __syncthreads();
  return r != 0;
}
inline float __shfl_xor_sync(unsigned, float x, int m) {
  Warp& w = my_warp();
  w.f[my_lane()][0] = x;
  w.bar.arrive_and_wait();
  float r = w.f[my_lane() ^ m][0];
  w.bar.arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned, bool x) {
  Warp& w = my_warp();
  w.i[my_lane()] = x;
  w.bar.arrive_and_wait();
  bool r = false;
  for (int l = 0; l < 32; ++l) r |= w.i[l] != 0;
  w.bar.arrive_and_wait();
  return r;
}
// the tensor core reads a tf32 operand's top 19 bits
inline float tf32_value(uint32_t b) { return __uint_as_float(b & 0xFFFFE000u); }
// c += A.B; lane (g, t) = (lane / 4, lane % 4) holds A rows g and g + 8 at
// columns t and t + 4 (a0..a3), B rows t and t + 4 at column g (b0, b1),
// and C rows g and g + 8 at columns 2t and 2t + 1 (c0..c3)
inline void emu_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  Warp& w = my_warp();
  const int l = my_lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.u[l][4] = b0;
  w.u[l][5] = b1;
  w.bar.arrive_and_wait();
  float A[16][8], B[8][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln / 4, t = ln % 4;
    A[g][t] = tf32_value(w.u[ln][0]);
    A[g + 8][t] = tf32_value(w.u[ln][1]);
    A[g][t + 4] = tf32_value(w.u[ln][2]);
    A[g + 8][t + 4] = tf32_value(w.u[ln][3]);
    B[t][g] = tf32_value(w.u[ln][4]);
    B[t + 4][g] = tf32_value(w.u[ln][5]);
  }
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + (i % 2);
    for (int kk = 0; kk < 8; ++kk) c[i] += A[row][kk] * B[kk][col];
  }
  w.bar.arrive_and_wait();
}

// kernel<<<grid, block, smem, stream>>>(...) as emu_launch(grid, block,
// smem, stream, [&] { kernel(...); })
template <class F>
void emu_launch(dim3 grid, int block, size_t smem_bytes, cudaStream_t, F f) {
  for (unsigned b = 0; b < grid.x; ++b) {
    Cta cta;
    cta.bar = std::make_unique<std::barrier<>>(block);
    cta.smem.resize(smem_bytes / 16 + 1);
    std::fill(reinterpret_cast<uint32_t*>(cta.smem.data()),
              reinterpret_cast<uint32_t*>(cta.smem.data() + cta.smem.size()), 0x7FC00001u);
    for (int w = 0; w < block / 32; ++w) cta.warps.push_back(std::make_unique<Warp>());
    g_cta = &cta;
    g_block = block;
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int i = 0; i < block; ++i)
      threads.emplace_back([i, &f] { threadIdx.x = i; f(); });
    for (auto& t : threads) t.join();
  }
}
