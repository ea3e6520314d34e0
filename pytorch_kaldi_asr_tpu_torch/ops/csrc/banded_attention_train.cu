// Trainable banded (time-restricted) attention, float32, for Hopper (sm_90a):
// the forward with its log-sum-exp and attention-probability dropout, and the
// two backward kernels.
//
// Replaces the TPU kernels K2a, K2b and K2c of the JAX package:
//   pytorch_kaldi_asr_tpu/ops/banded_attention.py
//     K2a  _trainable_fwd  (Pallas kernel `_fwd_kernel`)
//     K2b  _trainable_bwd, dq call    (Pallas kernel `_dq_kernel`)
//     K2c  _trainable_bwd, dk/dv call (Pallas kernel `_dkv_kernel`)
// used by the banded encoder's training step.
//
// Semantics (per batch-head b, query t, key j in [t + start, t + end] with
// key_valid[b, j] != 0):
//   p = exp(scale * q.k - m), l = sum_j p (the UNdropped probabilities),
//   out = sum_j drop(p) v / l, lse = m + log(l), or -inf for a row with no key;
//   drop(p) = keep(seed, b, t, j) ? p / (1 - rate) : 0,
// where keep() is the JAX package's `_dropout_keep` hash on global positions,
// so the three kernels regenerate one mask however they tile the work.
// Backward, with a = exp(scale * q.k - lse) and delta = rowsum(dout * out):
//   dq = scale * sum_j a (drop(dout.v) - delta) k
//   dk = scale * sum_t a (drop(dout.v) - delta) q,  dv = sum_t drop(a) dout.
// A row with lse = -inf contributes nothing, so empty rows get exact zeros.
//
// Layout: q, k, dq, dk [BH, S, D]; v, out, dout, dv [BH, S, Dv]; key_valid
// [BH, S] int32; lse, delta [BH, S] float32; all contiguous.  S is a multiple
// of 64 (the wrapper pads with invalid keys); D and Dv are multiples of 4, at
// most 128.
//
// K2a (simple and correct first), K1's layout: CTAs of 256 threads, four
// consecutive threads per row, each holding a float4 share of the row's
// vectors and reducing dot products with two shuffles; one CTA per (bh,
// 64-query tile), looping over the 64-key tiles that overlap
// [q0 + start, q0 + 63 + end], a tile's 64 scores in registers.
//
// K2b and K2c (the backward) run their tile products on the tensor cores at
// float32 accuracy: mma.sync m16n8k8 in TF32 with the 3xTF32 split
// (x = big + small, a.b ~ big.big + big.small + small.big).  A CTA of 4
// warps owns a 64-row tile, 16 rows per warp (the mma's m): K2b a query
// tile (q, dout; it also computes delta and writes it for K2c), K2c a key
// tile (k, v; one CTA per key tile, so no atomics and deterministic dk/dv).
// The owned rows wait in shared memory in the mma's fragment order; the
// other side's 64-row tiles stream through a ring of one or two stages
// filled with cp.async.  Each warp computes its scores S and dP = dout.v^T
// 32 streamed rows at a time (K2c: their transposes, so every product keeps
// the owned rows as the mma's rows), does the softmax, band, validity and
// dropout work in the accumulator's layout (each (q, k) element on one
// thread: one hash per element), and feeds dS (and K2c's drop(P)) straight
// back as the A operand of the accumulating product: the k index of that
// product is permuted so the accumulator layout is the operand layout, with
// the other side's rows read to match.  Work the band and lengths make zero is
// skipped: streamed tiles with no valid key (K2b) or no live query row
// (K2c), 16 x 8 sub-tiles wholly out of band, warps and CTAs whose own rows
// are all dead or invalid.  What hides latency (measured on the H100, see
// PERF.md): the 3xTF32 split by integer ops rather than conversions, the
// three products in passes over independent accumulators, and registers
// capped for three CTAs per SM, whose loads and math overlap.  So the ring
// takes two stages only where they cost no CTA per SM: at d = dv = 64 one
// (two stages at two CTAs per SM were slower).  The ring's loop with one
// stage also ran 7-13 % faster than the same arithmetic in a loop written
// for one buffer alone (ptxas schedules the two differently).
//
// Bound on an H100 SXM at the conformer's train shape (BH 128, S 1600, d = dv
// = 64, band (-256, 256), about 60e6 in-band pairs): K2b does 6 x 64, K2c
// 8 x 64 float32 operations per in-band pair, 23 and 31 GFLOP; at 3 x that
// on the TF32 tensor cores (495 TFLOP/s) 0.14 and 0.19 ms, under the 67
// TFLOP/s CUDA-core route; their bytes (6-7 vectors of [128, 1600, 64]
// float32, 0.3-0.4 GB) take 0.1 ms at 3.35 TB/s.  So both are bound by
// their operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;               // rows per CTA = rows per staged tile
constexpr int kTpr = 4;                  // threads per row
constexpr int kThreads = kBlock * kTpr;  // 256
constexpr int kMaxHeadDim = 128;

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // int(rate * 0xFFFFFFFF), computed by the host in double
  float keep_prob;   // 1 - rate, rounded once to float32
  int on;            // rate > 0
};

// The mixing steps of the JAX package's _dropout_keep on its linear part
// x = qpos * 2654435761 + kpos * 2246822519 + bh * 3266489917 + seed
// (uint32 wraps), which the backward kernels assemble from a term per own
// row and a term per streamed row.
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// The JAX package's _dropout_keep: a lowbias32-style hash of (seed,
// batch-head, global query position, global key position).
__device__ __forceinline__ bool keep_bit(const Dropout& dr, uint32_t bh,
                                         uint32_t qpos, uint32_t kpos) {
  return keep_mixed(qpos * 2654435761u + kpos * 2246822519u + bh * 3266489917u + dr.seed,
                    dr.thresh);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, const float a, const float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// sum over the four threads of a row (they are consecutive lanes)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 scale4(const float4 x, const float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// ---------------------------------------------------------------------------
// K2a: forward with lse and dropout
// ---------------------------------------------------------------------------

// R = float4 groups of the head dimension each thread holds (d and dv).
template <int R>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
           const float4* __restrict__ v, const int* __restrict__ key_valid,
           float4* __restrict__ out, float* __restrict__ lse, int s, int d4, int dv4,
           int start, int end, float scale, Dropout dr) {
  extern __shared__ float4 smem[];
  float4* k_tile = smem;                // [kBlock][d4]
  float4* v_tile = smem + kBlock * d4;  // [kBlock][dv4]
  int* valid_tile = reinterpret_cast<int*>(v_tile + kBlock * dv4);

  const int n_qtiles = s / kBlock;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlock;
  const int row = threadIdx.x / kTpr;
  const int sub = threadIdx.x % kTpr;
  const int qpos = q0 + row;
  const size_t base = static_cast<size_t>(bh) * s;

  float4 qr[R];
  float4 acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    qr[i] = g < d4 ? q[(base + qpos) * d4 + g] : zero4();
    acc[i] = zero4();
  }
  float m = -INFINITY;  // running max of the row's scores
  float l = 0.f;        // running sum of the undropped probabilities

  const int k_lo = max(0, q0 + start);
  const int k_hi = min(s - 1, q0 + kBlock - 1 + end);
  for (int t0 = (k_lo / kBlock) * kBlock; t0 <= k_hi; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed
    const float4* k_src = k + (base + t0) * d4;
    for (int i = threadIdx.x; i < kBlock * d4; i += kThreads) k_tile[i] = k_src[i];
    const float4* v_src = v + (base + t0) * dv4;
    for (int i = threadIdx.x; i < kBlock * dv4; i += kThreads) v_tile[i] = v_src[i];
    if (threadIdx.x < kBlock) valid_tile[threadIdx.x] = key_valid[base + t0 + threadIdx.x];
    __syncthreads();

    float sc[kBlock];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < d4) part = dot4(qr[i], k_tile[j * d4 + g], part);
      }
      part = row_sum(part);
      const int rel = t0 + j - qpos;
      const bool ok = rel >= start && rel <= end && valid_tile[j] != 0;
      sc[j] = ok ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, sc[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = scale4(acc[i], alpha);
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      const float p = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m_safe);
      l += p;
      float pa = p;
      if (dr.on) pa = keep_bit(dr, bh, qpos, t0 + j) ? p / dr.keep_prob : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < dv4) axpy4(acc[i], pa, v_tile[j * dv4 + g]);
      }
    }
    m = m_new;
  }

  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    if (g < dv4) {
      const float4 a = acc[i];
      out[(base + qpos) * dv4 + g] =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
  }
  if (sub == 0) lse[base + qpos] = l > 0.f ? m + logf(l) : -INFINITY;
}

// ---------------------------------------------------------------------------
// K2b and K2c: the backward on the tensor cores (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                 // a CTA of 4 warps owns 64 rows
constexpr int kBwdThreads = kWarps * 32;  // 128
constexpr int kChunks = kBlock / 8;       // 8-wide n-chunks of a 64-row tile
constexpr int kPass = 4;   // chunks per pass: a warp holds 16 x 32 of S and dP
constexpr int kGroup = 4;  // split B operands in flight in mma_3xtf32

// The 3xTF32 split of x: big = x rounded to tf32 (10 mantissa bits, half
// away from zero) by integer ops, small = x - big as a float.  The tensor
// core reads only a tf32 operand's top 19 bits, so small goes in as it is
// (truncated there): full-rate integer and float ops instead of two
// quarter-rate conversions, as CUTLASS's fast-F32 path does.
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t tf32_small(float x, uint32_t big) {
  return __float_as_uint(x - __uint_as_float(big));
}

// an A operand of m16n8k8 (16 x 8): registers a0..a3 as big and small tf32
struct Frag {
  uint32_t big[4];
  uint32_t small[4];
};

__device__ __forceinline__ Frag split_frag(float a0, float a1, float a2, float a3) {
  const float x[4] = {a0, a1, a2, a3};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.big[i] = tf32_big(x[i]);
    f.small[i] = tf32_small(x[i], f.big[i]);
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a.B_n at float32 accuracy for n in [N0, N0 + N) where live(n).
// B_n's two registers are the floats b[n * step] and b[n * step + off],
// split here.  The three products (small.big, big.small, big.big) go in
// three passes over the n, so consecutive mmas are independent and the
// tensor core's latency is hidden within the warp.
template <int N0, int N, int M, class Live>
__device__ __forceinline__ void mma_3xtf32_n(float (&c)[M][4], const Frag& a, const float* b,
                                             int step, int off, Live live) {
  uint32_t big[N][2], small[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!live(N0 + i)) continue;
    const float x0 = b[(N0 + i) * step], x1 = b[(N0 + i) * step + off];
    big[i][0] = tf32_big(x0);
    big[i][1] = tf32_big(x1);
    small[i][0] = tf32_small(x0, big[i][0]);
    small[i][1] = tf32_small(x1, big[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (live(N0 + i)) mma_tf32(c[N0 + i], a.small, big[i][0], big[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (live(N0 + i)) mma_tf32(c[N0 + i], a.big, small[i][0], small[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (live(N0 + i)) mma_tf32(c[N0 + i], a.big, big[i][0], big[i][1]);
}

// mma_3xtf32_n over all M accumulators, G at a time (fewer registers for
// the split operands where M is large)
template <int M, int G = (M < kGroup ? M : kGroup), int N0 = 0, class Live>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], const Frag& a, const float* b,
                                           int step, int off, Live live) {
  mma_3xtf32_n<N0, G>(c, a, b, step, off, live);
  if constexpr (N0 + G < M) mma_3xtf32<M, G, N0 + G>(c, a, b, step, off, live);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 64 rows of `w` floats (w % 4 == 0; source rows packed) into shared memory
// rows `ld` floats apart
__device__ __forceinline__ void tile_async(float* dst, int ld, const float* src, int w) {
  const int w4 = w / 4;
  for (int i = threadIdx.x; i < kBlock * w4; i += kBwdThreads) {
    const int r = i / w4, c = (i % w4) * 4;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * w + c);
  }
}

// 64 values of 4 bytes
__device__ __forceinline__ void row_async(void* dst, const void* src) {
  if (threadIdx.x < 16)
    cp_async16(static_cast<char*>(dst) + 16 * threadIdx.x,
               static_cast<const char*>(src) + 16 * threadIdx.x);
}

// The A fragments of the CTA's 64 rows of x ([64, w], rows packed), split
// into 8-column steps: float4 (a0, a1, a2, a3) of (warp, step, lane) at
// (warp * w8 + step) * 32 + lane, so each lane later reads its own with one
// 16-byte load; columns from w up to 8 * w8 are zero.
__device__ void stage_owned(float4* dst, const float* x, int w, int w8) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* r0 = x + static_cast<size_t>(warp * 16 + g) * w;
  const float* r1 = r0 + 8 * w;
  for (int ks = 0; ks < w8; ++ks) {
    const int c0 = ks * 8 + t, c1 = c0 + 4;
    dst[(warp * w8 + ks) * 32 + lane] =
        make_float4(c0 < w ? r0[c0] : 0.f, c0 < w ? r1[c0] : 0.f, c1 < w ? r0[c1] : 0.f,
                    c1 < w ? r1[c1] : 0.f);
  }
}

// columns [w, wp) of a 64-row tile whose rows are `ld` apart
__device__ void zero_columns(float* tile, int ld, int w, int wp) {
  for (int i = threadIdx.x; i < kBlock * (wp - w); i += kBwdThreads)
    tile[(i / (wp - w)) * ld + w + i % (wp - w)] = 0.f;
}

// Zero-fill rows [row0, row0 + 64) of x ([.., w], w % 4 == 0).
__device__ void zero_rows(float* x, size_t row0, int w) {
  float4* p = reinterpret_cast<float4*>(x + row0 * w);
  for (int i = threadIdx.x; i < kBlock * w / 4; i += kBwdThreads) p[i] = zero4();
}

// Shared memory of K2b and K2c, in floats: the owned rows' fragments
// (64 x 8 * w8 for each of the two owned operands), then `stages` ring
// stages of two tiles (rows padded to 8 * w8 + 4 floats, which spreads a
// fragment's reads over all 32 banks) and `extra_rows` 64-value rows, then
// one int per candidate tile.  One stage is 68 KB at d = dv = 64, so three
// CTAs share an SM.
struct BwdSmem {
  int d8, dv8, ldk, ldv, stage;
  __host__ __device__ BwdSmem(int d, int dv, int extra_rows)
      : d8((d + 7) / 8), dv8((dv + 7) / 8), ldk(d8 * 8 + 4), ldv(dv8 * 8 + 4),
        stage(kBlock * (ldk + ldv + extra_rows)) {}
  __host__ __device__ int owned() const { return kBlock * 8 * (d8 + dv8); }
  __host__ __device__ size_t bytes(int stages, int n_tiles) const {
    return sizeof(float) * (static_cast<size_t>(owned()) + static_cast<size_t>(stages) * stage) +
           sizeof(int) * n_tiles;
  }
};

// Each warp's 8-wide chunks of a streamed tile against its 16 own rows:
// whether a chunk touches the band at all, and whether it lies wholly in it.
// rel = key - query; own rows [own0, own0 + 15], streamed [str0, str0 + 63].
__device__ __forceinline__ void chunk_band(bool own_is_query, int own0, int str0, int start,
                                           int end, int n, bool& live, bool& full) {
  const int lo = str0 + 8 * n;
  const int rel_min = own_is_query ? lo - (own0 + 15) : own0 - (lo + 7);
  const int rel_max = own_is_query ? lo + 7 - own0 : own0 + 15 - lo;
  live = rel_max >= start && rel_min <= end;
  full = rel_min >= start && rel_max <= end;
}

// The index, after i, of the next candidate tile flagged live; -1 if none.
__device__ __forceinline__ int next_live(const int* flags, int n, int i) {
  for (++i; i < n; ++i)
    if (flags[i]) return i;
  return -1;
}

// ---------------------------------------------------------------------------
// K2b: dq and delta
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-query tile); MAXD8 bounds d8 and dv8 (8-column
// steps).  Registers are capped for 3 CTAs per SM up to d = 64.
template <int MAXD8>
__global__ void __launch_bounds__(kBwdThreads, MAXD8 > 8 ? 1 : 3)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ out, const float* __restrict__ lse,
          const int* __restrict__ key_valid, float* __restrict__ dq,
          float* __restrict__ delta, int s, int d, int dv, int start, int end, float scale,
          Dropout dr, int stages) {
  extern __shared__ float4 smem[];
  const BwdSmem lay(d, dv, 1);
  const int d8 = lay.d8, dv8 = lay.dv8, ldk = lay.ldk, ldv = lay.ldv;
  float4* own_q = smem;
  float4* own_do = own_q + kBlock * 2 * d8;  // 64 x 8 * d8 floats
  float* ring = reinterpret_cast<float*>(smem) + lay.owned();
  int* flags = reinterpret_cast<int*>(ring + stages * lay.stage);

  const int n_tiles = s / kBlock;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kBlock;
  const size_t base = static_cast<size_t>(bh) * s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int own0 = q0 + warp * 16;  // this warp's first query

  stage_owned(own_q, q + (base + q0) * d, d, d8);
  stage_owned(own_do, dout + (base + q0) * dv, dv, dv8);

  // delta = rowsum(dout * out) of rows own0 + g and own0 + g + 8, from the
  // dout fragments this lane holds; written for K2c, dead rows included
  const size_t row0 = base + own0 + g, row1 = row0 + 8;
  float row_delta[2] = {0.f, 0.f};
  for (int ks = 0; ks < dv8; ++ks) {
    const float4 f = own_do[(warp * dv8 + ks) * 32 + lane];
    const int c0 = ks * 8 + t, c1 = c0 + 4;
    if (c0 < dv) {
      row_delta[0] = fmaf(f.x, out[row0 * dv + c0], row_delta[0]);
      row_delta[1] = fmaf(f.y, out[row1 * dv + c0], row_delta[1]);
    }
    if (c1 < dv) {
      row_delta[0] = fmaf(f.z, out[row0 * dv + c1], row_delta[0]);
      row_delta[1] = fmaf(f.w, out[row1 * dv + c1], row_delta[1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_delta[h] += __shfl_xor_sync(0xffffffffu, row_delta[h], 1);
    row_delta[h] += __shfl_xor_sync(0xffffffffu, row_delta[h], 2);
  }
  if (t == 0) {
    delta[row0] = row_delta[0];
    delta[row1] = row_delta[1];
  }

  const float row_lse[2] = {lse[row0], lse[row1]};
  const bool live[2] = {row_lse[0] > -INFINITY, row_lse[1] > -INFINITY};
  // exp(s scale - lse) as exp2(s scale log2(e) - lse log2(e)); the hash's
  // row part; dropout's 1 / (1 - rate)
  const float scale_log2 = scale * kLog2e;
  const float lse_log2[2] = {row_lse[0] * kLog2e, row_lse[1] * kLog2e};
  const uint32_t bh_hash = static_cast<uint32_t>(bh) * 3266489917u + dr.seed;
  const uint32_t row_hash[2] = {(own0 + g) * 2654435761u + bh_hash,
                                (own0 + g + 8) * 2654435761u + bh_hash};
  const float inv_keep = 1.f / dr.keep_prob;
  const bool warp_live = __any_sync(0xffffffffu, live[0] || live[1]);
  if (!__syncthreads_or(warp_live)) {  // every row empty: dq = 0
    zero_rows(dq, base + q0, d);
    return;
  }

  // the key tiles that overlap [q0 + start, q0 + 63 + end], flagged if they
  // hold a valid key
  const int kt_lo = max(0, q0 + start) / kBlock;
  const int kt_hi = min(s - 1, q0 + kBlock - 1 + end) / kBlock;
  const int n_cand = kt_hi - kt_lo + 1;
  for (int i = threadIdx.x; i < n_cand; i += kBwdThreads) flags[i] = 0;
  for (int st = 0; st < stages; ++st) {
    zero_columns(ring + st * lay.stage, ldk, d, 8 * d8);
    zero_columns(ring + st * lay.stage + kBlock * ldk, ldv, dv, 8 * dv8);
  }
  __syncthreads();
  for (int j = kt_lo * kBlock + threadIdx.x; j < (kt_hi + 1) * kBlock; j += kBwdThreads)
    if (key_valid[base + j] != 0) flags[j / kBlock - kt_lo] = 1;
  __syncthreads();

  auto load = [&](int i, int st) {
    float* kt = ring + st * lay.stage;
    const int t0 = (kt_lo + i) * kBlock;
    tile_async(kt, ldk, k + (base + t0) * d, d);
    tile_async(kt + kBlock * ldk, ldv, v + (base + t0) * dv, dv);
    row_async(kt + kBlock * (ldk + ldv), key_valid + base + t0);
  };

  float acc[MAXD8][4];
#pragma unroll
  for (int n = 0; n < MAXD8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int cur = next_live(flags, n_cand, -1), st = 0;
  if (cur >= 0) load(cur, 0);
  cp_async_commit();
  while (cur >= 0) {
    const int nxt = next_live(flags, n_cand, cur);
    if (stages == 2) {
      if (nxt >= 0) load(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      const float* kt = ring + st * lay.stage;
      const float* vt = kt + kBlock * ldk;
      const int* valid = reinterpret_cast<const int*>(vt + kBlock * ldv);
      const int t0 = (kt_lo + cur) * kBlock;
#pragma unroll
      for (int n0 = 0; n0 < kChunks; n0 += kPass) {
        bool c_live[kPass], c_full[kPass];
        float sc[kPass][4], dp[kPass][4];
#pragma unroll
        for (int n = 0; n < kPass; ++n) {
          chunk_band(true, own0, t0, start, end, n0 + n, c_live[n], c_full[n]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
        }
        const auto chunk_live = [&](int n) { return c_live[n]; };
        // S = q k^T and dP = dout v^T, 16 queries x 32 keys per warp
#pragma unroll
        for (int ks = 0; ks < MAXD8; ++ks) {
          if (ks < d8) {
            const float4 a = own_q[(warp * d8 + ks) * 32 + lane];
            mma_3xtf32(sc, split_frag(a.x, a.y, a.z, a.w),
                       kt + (8 * n0 + g) * ldk + 8 * ks + t, 8 * ldk, 4, chunk_live);
          }
          if (ks < dv8) {
            const float4 a = own_do[(warp * dv8 + ks) * 32 + lane];
            mma_3xtf32(dp, split_frag(a.x, a.y, a.z, a.w),
                       vt + (8 * n0 + g) * ldv + 8 * ks + t, 8 * ldv, 4, chunk_live);
          }
        }
        // dS = a (drop(dP) - delta) in the accumulator layout: element e of
        // chunk n is (query own0 + g + 8 (e / 2), key t0 + 8 (n0 + n) + 2 t
        // + e % 2)
#pragma unroll
        for (int n = 0; n < kPass; ++n) {
          if (!c_live[n]) continue;
          const int c0 = 8 * (n0 + n) + 2 * t;
          const int2 ok2 = *reinterpret_cast<const int2*>(valid + c0);
          const uint32_t col[2] = {(t0 + c0) * 2246822519u, (t0 + c0 + 1) * 2246822519u};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, i = e & 1;
            const int rel = t0 + c0 + i - (own0 + g + 8 * h);
            const bool ok = live[h] && (i ? ok2.y : ok2.x) != 0 &&
                            (c_full[n] || (rel >= start && rel <= end));
            const float a = ok ? exp2f(fmaf(sc[n][e], scale_log2, -lse_log2[h])) : 0.f;
            float dpe = dp[n][e];
            if (dr.on)
              dpe = keep_mixed(row_hash[h] + col[i], dr.thresh) ? dpe * inv_keep : 0.f;
            sc[n][e] = a * (dpe - row_delta[h]);
          }
        }
        // dq += dS k.  The product's k index runs over the chunk's keys in
        // the order (0, 2, 4, 6, 1, 3, 5, 7), so dS's accumulator registers
        // are its A registers: a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g, 2t
        // + 1), a3 = (g + 8, 2t + 1); b0 and b1 read keys 2t and 2t + 1.
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          if (!c_live[j]) continue;
          mma_3xtf32(acc, split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3]),
                     kt + (8 * (n0 + j) + 2 * t) * ldk + g, 8, ldk,
                     [&](int n) { return n < d8; });
        }
      }
    }
    __syncthreads();  // the stage is consumed
    if (stages == 1 && nxt >= 0) {
      load(nxt, 0);
      cp_async_commit();
    }
    cur = nxt;
    if (stages == 2) st ^= 1;
  }

  // accumulator element (g + 8 h, 2t + i) of column step n
#pragma unroll
  for (int n = 0; n < MAXD8; ++n) {
    const int c = 8 * n + 2 * t;
    if (n < d8 && c < d) {
      *reinterpret_cast<float2*>(dq + row0 * d + c) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
      *reinterpret_cast<float2*>(dq + row1 * d + c) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K2c: dk and dv
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-key tile); as K2b, MAXD8 bounds d8 and dv8.
template <int MAXD8>
__global__ void __launch_bounds__(kBwdThreads, MAXD8 > 8 ? 1 : 3)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ key_valid, float* __restrict__ dk,
           float* __restrict__ dv_out, int s, int d, int dv, int start, int end,
           float scale, Dropout dr, int stages) {
  extern __shared__ float4 smem[];
  const BwdSmem lay(d, dv, 2);
  const int d8 = lay.d8, dv8 = lay.dv8, ldk = lay.ldk, ldv = lay.ldv;
  float4* own_k = smem;
  float4* own_v = own_k + kBlock * 2 * d8;
  float* ring = reinterpret_cast<float*>(smem) + lay.owned();
  int* flags = reinterpret_cast<int*>(ring + stages * lay.stage);

  const int n_tiles = s / kBlock;
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kBlock;
  const size_t base = static_cast<size_t>(bh) * s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int own0 = k0 + warp * 16;  // this warp's first key
  const size_t row0 = base + own0 + g, row1 = row0 + 8;

  const bool key_ok[2] = {key_valid[row0] != 0, key_valid[row1] != 0};
  // exp(s scale - lse) as exp2(s scale log2(e) - lse log2(e)); the hash's
  // row part (here the key's); dropout's 1 / (1 - rate)
  const float scale_log2 = scale * kLog2e;
  const uint32_t bh_hash = static_cast<uint32_t>(bh) * 3266489917u + dr.seed;
  const uint32_t row_hash[2] = {(own0 + g) * 2246822519u + bh_hash,
                                (own0 + g + 8) * 2246822519u + bh_hash};
  const float inv_keep = 1.f / dr.keep_prob;
  const bool warp_live = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  if (!__syncthreads_or(warp_live)) {  // every key invalid: dk = dv = 0
    zero_rows(dk, base + k0, d);
    zero_rows(dv_out, base + k0, dv);
    return;
  }
  stage_owned(own_k, k + (base + k0) * d, d, d8);
  stage_owned(own_v, v + (base + k0) * dv, dv, dv8);

  // the query tiles whose band covers a key of this tile, flagged if they
  // hold a row with finite lse
  const int qt_lo = max(0, k0 - end) / kBlock;
  const int qt_hi = min(s - 1, k0 + kBlock - 1 - start) / kBlock;
  const int n_cand = qt_hi - qt_lo + 1;
  for (int i = threadIdx.x; i < n_cand; i += kBwdThreads) flags[i] = 0;
  for (int st = 0; st < stages; ++st) {
    zero_columns(ring + st * lay.stage, ldk, d, 8 * d8);
    zero_columns(ring + st * lay.stage + kBlock * ldk, ldv, dv, 8 * dv8);
  }
  __syncthreads();
  for (int j = qt_lo * kBlock + threadIdx.x; j < (qt_hi + 1) * kBlock; j += kBwdThreads)
    if (lse[base + j] > -INFINITY) flags[j / kBlock - qt_lo] = 1;
  __syncthreads();

  auto load = [&](int i, int st) {
    float* qt = ring + st * lay.stage;
    const int t0 = (qt_lo + i) * kBlock;
    tile_async(qt, ldk, q + (base + t0) * d, d);
    tile_async(qt + kBlock * ldk, ldv, dout + (base + t0) * dv, dv);
    float* rows = qt + kBlock * (ldk + ldv);
    row_async(rows, lse + base + t0);
    row_async(rows + kBlock, delta + base + t0);
  };

  float dk_acc[MAXD8][4], dv_acc[MAXD8][4];
#pragma unroll
  for (int n = 0; n < MAXD8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int cur = next_live(flags, n_cand, -1), st = 0;
  if (cur >= 0) load(cur, 0);
  cp_async_commit();
  while (cur >= 0) {
    const int nxt = next_live(flags, n_cand, cur);
    if (stages == 2) {
      if (nxt >= 0) load(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      const float* qt = ring + st * lay.stage;
      const float* dot = qt + kBlock * ldk;
      const float* lse_t = dot + kBlock * ldv;
      const float* delta_t = lse_t + kBlock;
      const int t0 = (qt_lo + cur) * kBlock;
#pragma unroll
      for (int n0 = 0; n0 < kChunks; n0 += kPass) {
        bool c_live[kPass], c_full[kPass];
        float sc[kPass][4], pa[kPass][4];
#pragma unroll
        for (int n = 0; n < kPass; ++n) {
          chunk_band(false, own0, t0, start, end, n0 + n, c_live[n], c_full[n]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = pa[n][e] = 0.f;
        }
        const auto chunk_live = [&](int n) { return c_live[n]; };
        // S^T = k q^T and dP^T = v dout^T, 16 keys x 32 queries per warp
#pragma unroll
        for (int ks = 0; ks < MAXD8; ++ks) {
          if (ks < d8) {
            const float4 a = own_k[(warp * d8 + ks) * 32 + lane];
            mma_3xtf32(sc, split_frag(a.x, a.y, a.z, a.w),
                       qt + (8 * n0 + g) * ldk + 8 * ks + t, 8 * ldk, 4, chunk_live);
          }
          if (ks < dv8) {
            const float4 a = own_v[(warp * dv8 + ks) * 32 + lane];
            mma_3xtf32(pa, split_frag(a.x, a.y, a.z, a.w),
                       dot + (8 * n0 + g) * ldv + 8 * ks + t, 8 * ldv, 4, chunk_live);
          }
        }
        // element e of chunk n is (key own0 + g + 8 (e / 2), query
        // t0 + 8 (n0 + n) + 2 t + e % 2): sc becomes dS^T, pa drop(P)^T
#pragma unroll
        for (int n = 0; n < kPass; ++n) {
          if (!c_live[n]) continue;
          const int c0 = 8 * (n0 + n) + 2 * t;
          const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c0);
          const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + c0);
          const uint32_t col[2] = {(t0 + c0) * 2654435761u, (t0 + c0 + 1) * 2654435761u};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, i = e & 1;
            const int rel = own0 + g + 8 * h - (t0 + c0 + i);
            const float q_lse = i ? lse2.y : lse2.x;
            const bool ok = key_ok[h] && q_lse > -INFINITY &&
                            (c_full[n] || (rel >= start && rel <= end));
            const float a = ok ? exp2f(fmaf(sc[n][e], scale_log2, -q_lse * kLog2e)) : 0.f;
            float a_drop = a, dpe = pa[n][e];
            if (dr.on) {
              const bool kept = keep_mixed(row_hash[h] + col[i], dr.thresh);
              a_drop = kept ? a * inv_keep : 0.f;
              dpe = kept ? dpe * inv_keep : 0.f;
            }
            sc[n][e] = a * (dpe - (i ? delta2.y : delta2.x));
            pa[n][e] = a_drop;
          }
        }
        // dv += drop(P)^T dout and dk += dS^T q, with K2b's permuted k index
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          if (!c_live[j]) continue;
          const int r = 8 * (n0 + j) + 2 * t;
          mma_3xtf32(dv_acc, split_frag(pa[j][0], pa[j][2], pa[j][1], pa[j][3]),
                     dot + r * ldv + g, 8, ldv, [&](int n) { return n < dv8; });
          mma_3xtf32(dk_acc, split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3]),
                     qt + r * ldk + g, 8, ldk, [&](int n) { return n < d8; });
        }
      }
    }
    __syncthreads();  // the stage is consumed
    if (stages == 1 && nxt >= 0) {
      load(nxt, 0);
      cp_async_commit();
    }
    cur = nxt;
    if (stages == 2) st ^= 1;
  }

#pragma unroll
  for (int n = 0; n < MAXD8; ++n) {
    const int c = 8 * n + 2 * t;
    if (n < d8 && c < d) {
      *reinterpret_cast<float2*>(dk + row0 * d + c) =
          make_float2(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<float2*>(dk + row1 * d + c) =
          make_float2(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    }
    if (n < dv8 && c < dv) {
      *reinterpret_cast<float2*>(dv_out + row0 * dv + c) =
          make_float2(dv_acc[n][0], dv_acc[n][1]);
      *reinterpret_cast<float2*>(dv_out + row1 * dv + c) =
          make_float2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a CTA may have

// Dynamic shared memory above 48 KB needs the attribute set once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t tile_smem(int d4, int dv4, size_t extra) {
  return static_cast<size_t>(kBlock) * (d4 + dv4) * sizeof(float4) + extra;
}

bool bad_shape(int bh, int s, int d, int dv, int start, int end) {
  return bh <= 0 || s <= 0 || s % kBlock != 0 || d <= 0 || dv <= 0 || d % 4 != 0 ||
         dv % 4 != 0 || d > kMaxHeadDim || dv > kMaxHeadDim || start > 0 || end < 0;
}

// float4 groups per thread, rounded up to the instantiated 1, 2, 4 or 8
int groups_for(int d, int dv) {
  const int gd = (d / 4 + kTpr - 1) / kTpr;
  const int gv = (dv / 4 + kTpr - 1) / kTpr;
  const int g = gd > gv ? gd : gv;
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

// 8-column steps of the larger head dim, rounded up to the instantiated
// 2, 4, 8 or 16
int steps_for(int d, int dv) {
  const int m = ((d > dv ? d : dv) + 7) / 8;
  return m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
}

Dropout make_dropout(unsigned seed, unsigned thresh, float keep_prob, int on) {
  Dropout dr;
  dr.seed = seed;
  dr.thresh = thresh;
  dr.keep_prob = keep_prob;
  dr.on = on;
  return dr;
}

template <int R>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                       void* out, void* lse, int bh, int s, int d4, int dv4, int start,
                       int end, float scale, Dropout dr, cudaStream_t stream) {
  const size_t smem = tile_smem(d4, dv4, kBlock * sizeof(int));
  cudaError_t err = allow_smem(fwd_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  fwd_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<const int*>(key_valid),
      static_cast<float4*>(out), static_cast<float*>(lse), s, d4, dv4, start, end, scale,
      dr);
  return cudaGetLastError();
}

// The ring's stages and shared-memory bytes for `kernel`: two stages where
// the card runs as many of its CTAs per SM with two as with one (where the
// registers, not the shared memory, bound them: d <= 32, d = 128), else
// one (at d = dv = 64, one stage lets 3 CTAs share an SM, two would let 2).
template <typename Kernel>
cudaError_t ring_stages(Kernel kernel, const BwdSmem& lay, int s, int& stages, size_t& smem) {
  const size_t one = lay.bytes(1, s / kBlock), two = lay.bytes(2, s / kBlock);
  if (one > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, two <= kMaxSmem ? two : one);
  int per_sm[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[0], kernel, kBwdThreads, one);
  if (err == cudaSuccess && two <= kMaxSmem)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[1], kernel, kBwdThreads, two);
  stages = per_sm[1] >= per_sm[0] ? 2 : 1;
  smem = stages == 2 ? two : one;
  return err;
}

template <int MAXD8>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, const void* lse, const void* key_valid, void* dq,
                      void* delta, int bh, int s, int d, int dv, int start, int end,
                      float scale, Dropout dr, cudaStream_t stream) {
  int stages = 0;
  size_t smem = 0;
  const cudaError_t err = ring_stages(dq_kernel<MAXD8>, BwdSmem(d, dv, 1), s, stages, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dq_kernel<MAXD8><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(out), static_cast<const float*>(lse),
      static_cast<const int*>(key_valid), static_cast<float*>(dq),
      static_cast<float*>(delta), s, d, dv, start, end, scale, dr, stages);
  return cudaGetLastError();
}

template <int MAXD8>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* key_valid, void* dk,
                       void* dv_out, int bh, int s, int d, int dv, int start, int end,
                       float scale, Dropout dr, cudaStream_t stream) {
  int stages = 0;
  size_t smem = 0;
  const cudaError_t err = ring_stages(dkv_kernel<MAXD8>, BwdSmem(d, dv, 2), s, stages, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dkv_kernel<MAXD8><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(key_valid), static_cast<float*>(dk),
      static_cast<float*>(dv_out), s, d, dv, start, end, scale, dr, stages);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success).
// `seed`, `thresh`, `keep_prob` and `dropout_on` describe the dropout mask;
// with dropout_on == 0 they are ignored.

extern "C" int banded_attention_fwd_f32(const void* q, const void* k, const void* v,
                                        const void* key_valid, void* out, void* lse,
                                        int bh, int s, int d, int dv, int start, int end,
                                        float scale, unsigned seed, unsigned thresh,
                                        float keep_prob, int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d4 = d / 4, dv4 = dv / 4;
  switch (groups_for(d, dv)) {
    case 1: return launch_fwd<1>(q, k, v, key_valid, out, lse, bh, s, d4, dv4, start, end, scale, dr, st);
    case 2: return launch_fwd<2>(q, k, v, key_valid, out, lse, bh, s, d4, dv4, start, end, scale, dr, st);
    case 4: return launch_fwd<4>(q, k, v, key_valid, out, lse, bh, s, d4, dv4, start, end, scale, dr, st);
    default: return launch_fwd<8>(q, k, v, key_valid, out, lse, bh, s, d4, dv4, start, end, scale, dr, st);
  }
}

// K2b: dq [BH, S, D] and delta = rowsum(dout * out) [BH, S], which K2c reads.
extern "C" int banded_attention_dq_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* out, const void* lse,
                                       const void* key_valid, void* dq, void* delta, int bh,
                                       int s, int d, int dv, int start, int end, float scale,
                                       unsigned seed, unsigned thresh, float keep_prob,
                                       int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_dq<2>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    case 4: return launch_dq<4>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    case 8: return launch_dq<8>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    default: return launch_dq<16>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
  }
}

extern "C" int banded_attention_dkv_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, const void* key_valid, void* dk,
                                        void* dv_out, int bh, int s, int d, int dv,
                                        int start, int end, float scale, unsigned seed,
                                        unsigned thresh, float keep_prob, int dropout_on,
                                        void* stream) {
  if (bad_shape(bh, s, d, dv, start, end)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_dkv<2>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    case 4: return launch_dkv<4>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    case 8: return launch_dkv<8>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    default: return launch_dkv<16>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
  }
}
