// CPU emulation of the few CUDA features that the port's kernels
// (pytorch_kaldi_asr_tpu_torch/ops/csrc/*.cu) use, so they compile with g++
// and run on the CPU (tests/test_torch_k2_emulated.py,
// tests/test_torch_k3_emulated.py): one std::thread per CUDA thread, one
// CTA at a time; barriers for __syncthreads and the warp collectives;
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 and
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 by their PTX fragment
// layouts, with the tensor core's rounding (exact products; the tf32 sum
// with c rounded toward zero; the bfloat16 one as the H100's probe reads it,
// tc_sum_bf16); and __nv_bfloat16 with its conversions (to float exact,
// from float rounded to nearest even).  Shared memory starts filled with NaN, so a read of a word never
// written shows in the results.
// Hopper's asynchronous machinery as banded_attention_bwd_sm90.cu uses it:
// mbarriers (init, arrive, expect-tx, try-wait by phase parity), TMA tile
// copies of 3-d tensor maps (cuTensorMapEncodeTiled's fields; 128-byte
// swizzle, out-of-bounds elements read as zeros) and bulk copies, each
// landing and completing its bytes on its mbarrier only when a thread
// waits on that barrier for a phase not yet complete (so a wait on the
// wrong phase reads what the stage held before), or after
// emu_lazy_copies(0) as soon as it is issued (so a stage handed back too
// early is overwritten under the products still reading it); and
// wgmma.mma_async
// m64nNk16 on bfloat16 (shared-memory operands through their matrix
// descriptors, 128-byte swizzle, K-major or N-major; the register A
// fragment gathered across the warpgroup), run when wgmma.wait_group
// retires its group, with the bfloat16 mma's rounding.  Shared addresses
// are offsets from the CTA's 1,024-aligned shared memory, as on the card.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <unordered_map>
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
#define __align__(n) alignas(n)
#define __grid_constant__
inline void __trap() { std::abort(); }
using std::max;
using std::min;
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim threadIdx;
inline Dim blockIdx;
inline Dim gridDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return uint32_t((uint64_t(a) * b) >> 32); }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(uint32_t x) { float f; std::memcpy(&f, &x, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t x; std::memcpy(&x, &f, 4); return x; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(uint32_t(h.bits) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  const uint32_t u = __float_as_uint(f);
  if (std::isnan(f)) return {uint16_t((u >> 16) | 0x40)};
  return {uint16_t((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16)};
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
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
struct EmuBar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned completed = 0;  // phases completed
};
// wgmma's register A operands, posted by each thread of a warpgroup and
// read when the products run: a ring of slots per thread
constexpr int kEmuSlots = 64;
struct EmuGroup {
  std::unique_ptr<std::barrier<>> bar;
  uint32_t a[kEmuSlots][128][4];
};
struct Cta {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<std::unique_ptr<EmuGroup>> groups;
  int flag[1024];
  std::vector<float4> storage;
  uint8_t* smem;  // 1,024-aligned in storage
  std::mutex bar_mutex;
  std::condition_variable bar_cv;
  std::unordered_map<uint32_t, EmuBar> bars;
  // each barrier's copies in flight: each copies and returns its bytes
  std::unordered_map<uint32_t, std::vector<std::function<uint32_t()>>> copies;
};
inline Cta* g_cta;
inline unsigned g_block;
inline float4* emu_smem() { return reinterpret_cast<float4*>(g_cta->smem); }
// a shared address: the offset into the CTA's shared memory
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const uint8_t*>(p) - g_cta->smem;
}
inline uint8_t* emu_shared(uint32_t addr) { return g_cta->smem + addr; }
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
// ex2.approx.ftz.f32: 2^x, a denormal result flushed to zero
inline float emu_ex2_ftz(float x) {
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}
// the tensor core reads a tf32 operand's top 19 bits
inline float tf32_value(uint32_t b) { return __uint_as_float(b & 0xFFFFE000u); }
// the tensor core's float32 result of an exact sum: rounded toward zero
// (to nearest even after emu_round_nearest(1), which the drift tests use
// to isolate what the rounding toward zero costs)
inline bool g_round_nearest = false;
extern "C" void emu_round_nearest(int on) { g_round_nearest = on != 0; }
inline float tc_round(double sum) {
  const float rounded = float(sum);
  if (g_round_nearest) return rounded;
  return std::fabs(double(rounded)) > std::fabs(sum) ? std::nextafter(rounded, 0.f) : rounded;
}
// The bfloat16 mma's sum of its 16 exact products and c: each addend cut
// toward zero to a multiple of 2^(e - 26), e the exponent of the largest
// addend's leading bit, then the sum rounded toward zero.  Of the models
// held against the H100's outputs on 4,096 random problems (the exact sum;
// every addend or the products alone aligned and cut at 23-28 bits; two
// 8-deep halves in turn), this one matches the most (97.9 %; the exact sum
// rounded toward zero 96.2 %: 3.2 % of the card's outputs are larger than
// the exact sum).  chip_smoke.py's probe prints the sign and size of the
// card's error.
constexpr int kTcAlignBits = 26;
inline float tc_sum_bf16(const double* terms, int n) {
  double sum = 0.0, largest = 0.0;
  for (int i = 0; i < n; ++i) largest = std::max(largest, std::fabs(terms[i]));
  if (g_round_nearest || largest == 0.0) {
    for (int i = 0; i < n; ++i) sum += terms[i];
    return tc_round(sum);
  }
  int e = 0;
  std::frexp(largest, &e);  // largest = f 2^e, f in [0.5, 1)
  const double q = std::ldexp(1.0, e - 1 - kTcAlignBits);
  for (int i = 0; i < n; ++i) sum += std::trunc(terms[i] / q) * q;
  return tc_round(sum);
}
// c += A.B; lane (g, t) = (lane / 4, lane % 4) holds A rows g and g + 8 at
// columns t and t + 4 (a0..a3), B rows t and t + 4 at column g (b0, b1),
// and C rows g and g + 8 at columns 2t and 2t + 1 (c0..c3).  The products of
// tf32 operands are exact in double; the sum is rounded toward zero.
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
    double sum = c[i];
    for (int kk = 0; kk < 8; ++kk) sum += double(A[row][kk]) * double(B[kk][col]);
    c[i] = tc_round(sum);
  }
  w.bar.arrive_and_wait();
}
// The bfloat16 m16n8k16: lane (g, t) holds A rows g and g + 8 at columns
// 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3), B rows 2t, 2t + 1 (b0)
// and 2t + 8, 2t + 9 (b1) at column g, each register two bfloat16 with the
// lower index in its low half; C as m16n8k8's.
inline void emu_mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  Warp& w = my_warp();
  const int l = my_lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.u[l][4] = b0;
  w.u[l][5] = b1;
  w.bar.arrive_and_wait();
  const auto lo = [](uint32_t r) { return __uint_as_float(r << 16); };
  const auto hi = [](uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); };
  float A[16][16], B[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln / 4, t = ln % 4;
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = 2 * t + 8 * (i >> 1);
      A[row][col] = lo(w.u[ln][i]);
      A[row][col + 1] = hi(w.u[ln][i]);
    }
    B[2 * t][g] = lo(w.u[ln][4]);
    B[2 * t + 1][g] = hi(w.u[ln][4]);
    B[2 * t + 8][g] = lo(w.u[ln][5]);
    B[2 * t + 9][g] = hi(w.u[ln][5]);
  }
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + (i % 2);
    double terms[17] = {c[i]};
    for (int kk = 0; kk < 16; ++kk) terms[kk + 1] = double(A[row][kk]) * double(B[kk][col]);
    c[i] = tc_sum_bf16(terms, 17);
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
    cta.storage.resize(smem_bytes / 16 + 65);
    std::fill(reinterpret_cast<uint32_t*>(cta.storage.data()),
              reinterpret_cast<uint32_t*>(cta.storage.data() + cta.storage.size()), 0x7FC00001u);
    const uintptr_t raw = reinterpret_cast<uintptr_t>(cta.storage.data());
    cta.smem = reinterpret_cast<uint8_t*>((raw + 1023) & ~uintptr_t(1023));
    for (int w = 0; w < block / 32; ++w) cta.warps.push_back(std::make_unique<Warp>());
    for (int w = 0; w < block; w += 128) {
      cta.groups.push_back(std::make_unique<EmuGroup>());
      cta.groups.back()->bar = std::make_unique<std::barrier<>>(std::min(128, block - w));
    }
    g_cta = &cta;
    g_block = block;
    blockIdx.x = b;
    gridDim.x = grid.x;
    std::vector<std::thread> threads;
    for (int i = 0; i < block; ++i)
      threads.emplace_back([i, &f] { threadIdx.x = i; f(); });
    for (auto& t : threads) t.join();
  }
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and bulk copies
// ---------------------------------------------------------------------------

inline void emu_bar_check(EmuBar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.completed;
    b.pending = b.expected;
    g_cta->bar_cv.notify_all();
  }
}
inline void emu_mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(g_cta->bar_mutex);
  EmuBar& b = g_cta->bars[bar];
  b.expected = b.pending = static_cast<int>(count);
  b.tx = 0;
  b.completed = 0;
}
inline void emu_mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lock(g_cta->bar_mutex);
  EmuBar& b = g_cta->bars.at(bar);
  --b.pending;
  emu_bar_check(b);
}
inline void emu_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(g_cta->bar_mutex);
  EmuBar& b = g_cta->bars.at(bar);
  b.tx += bytes;
  --b.pending;
  emu_bar_check(b);
}
inline bool g_lazy_copies = true;
extern "C" void emu_lazy_copies(int on) { g_lazy_copies = on != 0; }
// a copy in flight that completes on `bar`
inline void emu_copy(uint32_t bar, std::function<uint32_t()> copy) {
  std::lock_guard<std::mutex> lock(g_cta->bar_mutex);
  if (g_lazy_copies) {
    g_cta->copies[bar].push_back(std::move(copy));
  } else {
    EmuBar& b = g_cta->bars.at(bar);
    b.tx -= copy();
    emu_bar_check(b);
  }
}
// whether the phase of parity `parity` has completed; if not, the copies
// in flight on the barrier land first; then waits up to a millisecond, as
// the card's try_wait suspends the thread a while
inline bool emu_mbar_try_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(g_cta->bar_mutex);
  const auto done = [&] { return (g_cta->bars.at(bar).completed & 1u) != parity; };
  if (done()) return true;
  EmuBar& b = g_cta->bars.at(bar);
  for (auto& copy : g_cta->copies[bar]) {
    b.tx -= copy();
    emu_bar_check(b);
  }
  g_cta->copies[bar].clear();
  return done() || g_cta->bar_cv.wait_for(lock, std::chrono::milliseconds(1), done);
}

// cuTensorMapEncodeTiled's arguments, kept as they were given
typedef int CUresult;
const CUresult CUDA_SUCCESS = 0;
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct CUtensorMap {
  const uint8_t* base;
  uint32_t rank;
  uint64_t dims[5], strides[5];  // strides in bytes, of dimensions 1..rank-1
  uint32_t box[5];
};
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* unit,
                                 CUtensorMapInterleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  // what the kernels ask for, and the encoder's own conditions on it
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || swizzle != CU_TENSOR_MAP_SWIZZLE_128B ||
      rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16 != 0 || box[0] * 2 > 128 ||
      (box[0] * 2) % 16 != 0)
    return 1;
  map->base = static_cast<const uint8_t*>(base);
  map->rank = rank;
  for (uint32_t i = 0; i < rank; ++i) {
    if (box[i] == 0 || box[i] > 256 || unit[i] != 1 || dims[i] == 0) return 1;
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16 != 0) return 1;
      map->strides[i + 1] = strides[i];
    }
  }
  map->strides[0] = 2;
  return CUDA_SUCCESS;
}
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
const unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPoint(const char* name, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* found) {
  if (std::strcmp(name, "cuTensorMapEncodeTiled") != 0) return cudaErrorInvalidValue;
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *found = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}

// The 128-byte swizzle of a shared address: its 16-byte chunk within each
// 128-byte row XORed with the row's index within 1,024 bytes.
inline uint32_t emu_swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7u) << 4); }

// a box of a 3-d bfloat16 tensor map at (c0, c1, c2), elements outside the
// tensor zero, into swizzled shared memory at `dst` (1,024-aligned)
inline void emu_tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                            int c2) {
  if (map->rank != 3 || dst % 1024 != 0) std::abort();
  emu_copy(bar, [=, m = *map] {
    const long long c[3] = {c0, c1, c2};
    uint32_t lin = 0;
    for (uint32_t z = 0; z < m.box[2]; ++z)
      for (uint32_t y = 0; y < m.box[1]; ++y)
        for (uint32_t x = 0; x < m.box[0]; ++x, lin += 2) {
          const long long at[3] = {c[0] + x, c[1] + y, c[2] + z};
          uint16_t v = 0;
          bool inside = true;
          for (int i = 0; i < 3; ++i) inside = inside && at[i] >= 0 && at[i] < (long long)m.dims[i];
          if (inside)
            std::memcpy(&v, m.base + at[0] * 2 + at[1] * m.strides[1] + at[2] * m.strides[2], 2);
          std::memcpy(emu_shared(emu_swizzle128(dst + lin)), &v, 2);
        }
    return lin;
  });
}
inline void emu_bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  if (dst % 16 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 || bytes % 16 != 0)
    std::abort();
  emu_copy(bar, [=] {
    std::memcpy(emu_shared(dst), src, bytes);
    return bytes;
  });
}

// ---------------------------------------------------------------------------
// wgmma.mma_async m64nNk16, bfloat16 operands, float32 accumulators
// ---------------------------------------------------------------------------

// Element (r, k) of a wgmma operand's 16-deep step from its matrix
// descriptor (128-byte swizzle, the layout PTX's descriptors name 1): r the
// row of A or the column of B, k in [0, 16).  K-major: rows 128 bytes
// apart in 8-row groups `sbo` apart, k inside the row; N-major (B with the
// transpose flag): r inside 64-element rows, whose groups of 64 are `lbo`
// apart, k along the rows, 8-row groups `sbo` apart.  The swizzle acts on
// the address, as TMA's does.
inline float emu_desc_elem(uint64_t desc, int r, int k, bool n_major) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0) std::abort();
  const uint32_t addr = n_major ? start + (r / 64) * lbo + (r % 64) * 2 + (k / 8) * sbo + (k % 8) * 128
                                : start + (r / 8) * sbo + (r % 8) * 128 + k * 2;
  uint16_t v;
  std::memcpy(&v, emu_shared(emu_swizzle128(addr)), 2);
  return __uint_as_float(uint32_t(v) << 16);
}

struct EmuMma {
  float* d;
  int n;
  bool scale_d, trans_a, trans_b;
  uint64_t da, db;
  int slot;  // the register A operand's slot, or -1 (A in shared memory)
};
inline thread_local std::vector<EmuMma> emu_open;              // issued since the last commit
inline thread_local std::deque<std::vector<EmuMma>> emu_groups;  // committed, not retired
inline thread_local int emu_next_slot = 0;

inline EmuGroup& emu_my_group() { return *g_cta->groups[threadIdx.x / 128]; }

// d (n / 2 accumulators of this thread) = A.B (+ d); A from the descriptor
// `da`, or, with `a` given, from the four registers of each thread of the
// warpgroup (the m16n8k16 A fragment of each warp's 16 rows); the
// transpose flags as the instruction's (trans_a: an M-major A, which no
// kernel here uses)
inline void emu_wgmma(float* d, int n, uint64_t da, uint64_t db, const uint32_t* a, int scale_d,
                      bool trans_a, bool trans_b) {
  if (trans_a || n % 8 != 0 || n > 256) std::abort();
  int slot = -1;
  if (a != nullptr) {
    slot = emu_next_slot;
    emu_next_slot = (emu_next_slot + 1) % kEmuSlots;
    std::memcpy(emu_my_group().a[slot][threadIdx.x % 128], a, 16);
  }
  emu_open.push_back({d, n, scale_d != 0, trans_a, trans_b, da, db, slot});
}
inline void emu_wgmma_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
inline void emu_run(const EmuMma& m) {
  const int tid = threadIdx.x % 128, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  EmuGroup& grp = emu_my_group();
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + g + 8 * h;
    float arow[16];
    for (int k = 0; k < 16; ++k) {
      if (m.slot < 0) {
        arow[k] = emu_desc_elem(m.da, row, k, false);
      } else {  // held by lane 4g + (k % 8) / 2 of the row's warp
        const uint32_t w = grp.a[m.slot][32 * warp + 4 * g + (k % 8) / 2][2 * (k / 8) + h];
        arow[k] = __uint_as_float(k % 2 ? w & 0xFFFF0000u : w << 16);
      }
    }
    for (int j = 0; j < m.n / 8; ++j)
      for (int i = 0; i < 2; ++i) {
        float& out = m.d[4 * j + 2 * h + i];
        double terms[17] = {m.scale_d ? out : 0.0};
        for (int k = 0; k < 16; ++k)
          terms[k + 1] = double(arow[k]) * emu_desc_elem(m.db, 8 * j + 2 * t + i, k, m.trans_b);
        out = tc_sum_bf16(terms, 17);
      }
  }
}
// Retires all but the newest n groups, running their products; collective
// over the warpgroup, whose register A operands are posted before and read
// before any thread posts again.
inline void emu_wgmma_wait(int n) {
  emu_my_group().bar->arrive_and_wait();
  while (static_cast<int>(emu_groups.size()) > n) {
    for (const EmuMma& m : emu_groups.front()) emu_run(m);
    emu_groups.pop_front();
  }
  emu_my_group().bar->arrive_and_wait();
}
