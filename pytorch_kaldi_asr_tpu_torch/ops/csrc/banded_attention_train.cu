// Banded (time-restricted) attention, float32 and bfloat16, for Hopper
// (sm_90a): the inference forward, the trainable forward with its
// log-sum-exp and attention-probability dropout, and the two backward
// kernels on float32.  The bfloat16 backward moved to
// banded_attention_bwd_sm90.cu, a design of its own on wgmma, TMA and
// mbarriers; the bfloat16 instantiations here are K1's and K2a's.
//
// Replaces the TPU kernels K1, K2a, K2b and K2c of the JAX package:
//   pytorch_kaldi_asr_tpu/ops/banded_attention.py
//     K1   banded_attention_pallas (Pallas kernel `_kernel`)
//     K2a  _trainable_fwd  (Pallas kernel `_fwd_kernel`)
//     K2b  _trainable_bwd, dq call    (Pallas kernel `_dq_kernel`)
//     K2c  _trainable_bwd, dk/dv call (Pallas kernel `_dkv_kernel`)
// K1 serves the encoders' inference, K2 their training step.
//
// Semantics (per batch-head b, query t, key j in [t + start, t + end] with
// key_valid[b, j] != 0):
//   p = exp(scale * q.k - m), l = sum_j p (the UNdropped probabilities),
//   out = sum_j drop(p) v / l, lse = m + log(l), or -inf for a row with no key;
//   drop(p) = keep(seed, b, t, j) ? p / (1 - rate) : 0,
// where keep() is the JAX package's `_dropout_keep` hash on global positions,
// so the three K2 kernels regenerate one mask however they tile the work.  K1
// is K2a's out at rate 0, without lse.  As in the Pallas kernels, m is a
// running max over key tiles (m_safe = 0 while it is -inf, alpha = 0 from an
// empty running state) and a row with l = 0 gets exact zeros.
// Backward, with a = exp(scale * q.k - lse) and delta = rowsum(dout * out):
//   dq = scale * sum_j a (drop(dout.v) - delta) k
//   dk = scale * sum_t a (drop(dout.v) - delta) q,  dv = sum_t drop(a) dout.
// A row with lse = -inf contributes nothing, so empty rows get exact zeros.
//
// Layout: q, k, dq, dk [BH, S, D]; v, out, dout, dv [BH, S, Dv]; key_valid
// [BH, S] int32; lse, delta [BH, S] float32; all contiguous.  S is a multiple
// of 64 (the wrapper pads with invalid keys); D and Dv are multiples of 4
// (float32) or of 8 (bfloat16), at most 128.
//
// Each kernel is one template over the element type T of q, k, v, dout and
// the outputs (float or __nv_bfloat16; the backward's float only); lse,
// delta, the scores, the softmax statistics and every sum stay float32.  On
// bfloat16 the kernels compute
// the Pallas kernels' function on bfloat16 inputs: products of bfloat16
// operands summed in float32 (mma.sync m16n8k16, one mma per 16-deep step),
// and the second product's A operand rounded to bfloat16 where the Pallas
// kernels round it (`p.astype(v.dtype)`, `ds.astype(k.dtype)`,
// `a_drop.astype(do.dtype)`, `ds.astype(q.dtype)`), nowhere else; the
// outputs are rounded once to bfloat16.  The float32 path is described
// first; the bfloat16 machinery follows it below.
//
// On float32 all four kernels run their tile products on the tensor cores
// at float32 accuracy: mma.sync m16n8k8 in TF32 with the 3xTF32 split (x =
// big + small, a.b ~ big.big + big.small + small.big).  A CTA of 4 warps
// owns a 64-row tile, 16 rows per warp (the mma's m): K1, K2a and K2b a
// query tile (K2b's rows q and dout; it also computes delta and writes it
// for K2c), K2c a key tile (k, v; one CTA per key tile, so no atomics and
// deterministic dk/dv).
// The owned rows wait in shared memory in the mma's fragment order; the
// other side's 64-row tiles stream through a ring of one or two stages
// filled with cp.async.  Each warp computes its scores 32 streamed rows at a
// time (K2c: their transposes, so every product keeps the owned rows as the
// mma's rows), does the softmax, band, validity and dropout work in the
// accumulator's layout (each (q, k) element on one thread: one hash per
// element), and feeds the result straight back as the A operand of the
// accumulating product: the k index of that product is permuted so the
// accumulator layout is the operand layout, with the other side's rows read
// to match.  Work the band and lengths make zero is skipped: streamed tiles
// with no valid key (K1, K2a, K2b) or no live query row (K2c), 16 x 8
// sub-tiles wholly out of band (and the band test of those wholly in it),
// warps and CTAs whose own rows are all dead or invalid (the backward).
//
// The forward (K1 and K2a: one routine, a template flag adds lse and dropout)
// stages q scaled by scale * log2(e), so S = q k^T comes out in the exp2
// domain; per pass of 32 keys each row's max is a 4-lane shuffle (lanes 4g to
// 4g + 3 hold a row), the O accumulator ([d/8][4] registers) and l are
// rescaled once, p = exp2(s - m), l sums the undropped p (each lane its share,
// added up once at the end), and drop(p) is the A operand of P.V.  It does
// two products per pair where K2b does three.  Each 8-wide step of S and each
// 8-key chunk of P.V is summed from zero and added to S or O in float32
// (mma_3xtf32's kFresh): chained on one accumulator, the tensor core's
// rounding toward zero shrank every output by about 1e-6 of its size, a bias
// that failed a train step against the CPU (PERF.md).  The backward sums
// every product the same way (mma_bwd).
//
// What hides latency (measured on the H100, see PERF.md): the 3xTF32 split by
// integer ops rather than conversions, the products in passes over
// independent accumulators, and registers capped for three CTAs per SM, whose
// loads and math overlap.  So the ring takes two stages only where they cost
// no CTA per SM: at d = dv = 64 one (two stages at two CTAs per SM were
// slower in the backward).  The ring's loop with one stage also ran 7-13 %
// faster than the same arithmetic in a loop written for one buffer alone
// (ptxas schedules the two differently).
//
// Bounds on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 dense, at 3 passes for
// float32 accuracy, faster than the 67 TFLOP/s CUDA-core route):
//   conformer train shape (BH 128, S 1600, d = dv = 64, band (-256, 256),
//   about 60e6 in-band pairs): K2a does 4 x 64, K2b 6 x 64, K2c 8 x 64
//   operations per in-band pair, 15, 23 and 31 GFLOP: 0.093, 0.14 and 0.19
//   ms; their bytes (4-7 vectors of [128, 1600, 64] float32, 0.2-0.4 GB) take
//   0.06-0.1 ms, so all three are bound by their operations;
//   TIMIT train shape (BH 200, S 512, band (-100, 0)): K2a 0.032 ms, bound
//   by its bytes (q, k, v, out of [200, 512, 64], 0.1 GB);
//   K1 at the conformer decode shape (BH 32, S 1600, 19e6 pairs): 0.030 ms by
//   operations; at TIMIT's (BH 16, S 504, padded to 512): 0.0025 ms by bytes,
//   one wave of 128 CTAs, so its launch and latency set its time.
// On bfloat16 (989 TFLOP/s dense, half the bytes) K1 and K2a are bound by
// their bytes at these shapes: the conformer's K2a 0.032 ms, K1 0.0079 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;  // rows per CTA = rows per staged tile
constexpr int kMaxHeadDim = 128;

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // int(rate * 0xFFFFFFFF), computed by the host in double
  float keep_prob;   // 1 - rate, rounded once to float32
  int on;            // rate > 0
};

// The mixing steps of the JAX package's _dropout_keep on its linear part
// x = qpos * 2654435761 + kpos * 2246822519 + bh * 3266489917 + seed
// (uint32 wraps), which the kernels assemble from a term per own row and a
// term per streamed row.
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---------------------------------------------------------------------------
// the tensor-core tile machinery of all four kernels (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;              // a CTA of 4 warps owns 64 rows
constexpr int kThreads = kWarps * 32;  // 128
constexpr int kChunks = kBlock / 8;    // 8-wide n-chunks of a 64-row tile
constexpr int kPass = 4;   // chunks per pass: a warp holds 16 x 32 of S (and dP)
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
// tensor core's latency is hidden within the warp.  kFresh: the products
// are summed from zero and added to c by float32 adds.  (The tensor core
// rounds each mma's sum toward zero, so an accumulator that takes a long
// chain of mmas drifts toward zero: a bias of a few ulp that the forward's
// long sums would carry into every output.)
template <int N0, int N, bool kFresh, int M, class Live>
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
  if constexpr (kFresh) {
    float t[N][4] = {};
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (live(N0 + i)) mma_tf32(t[i], a.small, big[i][0], big[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (live(N0 + i)) mma_tf32(t[i], a.big, small[i][0], small[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (live(N0 + i)) mma_tf32(t[i], a.big, big[i][0], big[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[N0 + i][e] += t[i][e];
  } else {
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
}

// mma_3xtf32_n over all M accumulators, G at a time (fewer registers for
// the split operands where M is large)
template <int M, bool kFresh = false, int G = (M < kGroup ? M : kGroup), int N0 = 0, class Live>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], const Frag& a, const float* b,
                                           int step, int off, Live live) {
  mma_3xtf32_n<N0, G, kFresh>(c, a, b, step, off, live);
  if constexpr (N0 + G < M) mma_3xtf32<M, kFresh, G, N0 + G>(c, a, b, step, off, live);
}

// The backward's products (S, dP and dq in K2b; S^T, dP^T, dv and dk in
// K2c), each summed from zero and added in float32 as the forward's are,
// kBwdGroup accumulators at a time: the group sets how many fresh sums are
// live at once, so it trades registers for independent mmas (1 and 4 ran
// slower on the H100, PERF.md).  (Chained on one accumulator, dq, dk and dv
// drifted by -1.3e-6 to -2.1e-6 of their size under cuda_emu.h's model of
// the tensor core's rounding.)
constexpr int kBwdGroup = 2;
template <int M, class Live>
__device__ __forceinline__ void mma_bwd(float (&c)[M][4], const Frag& a, const float* b,
                                        int step, int off, Live live) {
  mma_3xtf32<M, true, (M < kBwdGroup ? M : kBwdGroup)>(c, a, b, step, off, live);
}

// ---------------------------------------------------------------------------
// the bfloat16 tile machinery (mma.sync m16n8k16: bf16 operands, f32 sums)
// ---------------------------------------------------------------------------
//
// One mma per 16-deep step, where float32 takes three per 8-deep step.
// Register layouts (lane = 4g + t; each register holds two bfloat16, the
// lower index in its low half): A (16 x 16) a0 = (g, 2t..2t+1), a1 = (g + 8,
// 2t..2t+1), a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9); B (16 x 8, k x
// n) b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g); C as m16n8k8's: c0, c1 =
// (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1).  So the accumulators of two
// adjacent 8-wide chunks of S, rounded in pairs, are the A operand of the
// 16-deep product that follows, with no permutation of k: chunk j gives a0
// and a1, chunk j + 1 a2 and a3.  The first product's B (rows of k) is one
// 32-bit load per register; the second's (columns of v) two 16-bit loads.  The products chain on their accumulators
// (one mma per 16 products; their drift under cuda_emu.h's model of the
// tensor core's rounding is in PERF.md).

// element traits: the mma's depth per step, and an owned A fragment (16
// bytes a lane per step)
template <class T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kK = 8;
  using Own = float4;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kK = 16;
  using Own = uint4;
};

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register's bfloat16 pair, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two consecutive bfloat16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t word_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bfloat16 of different rows as one register
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// two adjacent outputs, rounded once to bfloat16 where they are bfloat16
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// c[n] += a.B_n for n < M where live(n), B_n's rows read along the
// streamed tile's rows: `b` is element (g, 16 ks + 2t) of row 8n's block,
// rows `ld` apart (the first products: S, dP and their transposes)
template <int M, class Live>
__device__ __forceinline__ void mma_bf16_rows(float (&c)[M][4], const uint4& a,
                                              const __nv_bfloat16* b, int ld, Live live) {
  const uint32_t af[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int n = 0; n < M; ++n) {
    if (!live(n)) continue;
    const __nv_bfloat16* r = b + 8 * n * ld;
    mma_bf16(c[n], af, word_bf16(r), word_bf16(r + 8));
  }
}

// c[n] += A.B_n for n < M where live(n), A the bfloat16 rounding of the
// accumulators `lo` and `hi` of two adjacent 8-wide chunks, B_n read down
// the streamed tile's columns: `b` is element (2t, g) of the 16 rows, rows
// `ld` apart, column 8n + g (the second products: P.V, dS.K, P^T.dO,
// dS^T.Q)
template <int M, class Live>
__device__ __forceinline__ void mma_bf16_cols(float (&c)[M][4], const float (&lo)[4],
                                              const float (&hi)[4], const __nv_bfloat16* b,
                                              int ld, Live live) {
  const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                         pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
#pragma unroll
  for (int n = 0; n < M; ++n) {
    if (!live(n)) continue;
    const __nv_bfloat16* p = b + 8 * n;
    mma_bf16(c[n], a, pair_bf16(p, p + ld), pair_bf16(p + 8 * ld, p + 9 * ld));
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// 64 rows of `w` elements (16 bytes a multiple of them; source rows packed)
// into shared memory rows `ld` elements apart
template <class T>
__device__ __forceinline__ void tile_async(T* dst, int ld, const T* src, int w) {
  constexpr int kVec = 16 / sizeof(T);
  const int w4 = w / kVec;
  for (int i = threadIdx.x; i < kBlock * w4; i += kThreads) {
    const int r = i / w4, c = (i % w4) * kVec;
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
// 16-byte load; columns from w up to 8 * w8 are zero.  The values are
// multiplied by `mul`.
__device__ void stage_owned(float4* dst, const float* x, int w, int w8, float mul = 1.f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* r0 = x + static_cast<size_t>(warp * 16 + g) * w;
  const float* r1 = r0 + 8 * w;
  for (int ks = 0; ks < w8; ++ks) {
    const int c0 = ks * 8 + t, c1 = c0 + 4;
    dst[(warp * w8 + ks) * 32 + lane] =
        make_float4(c0 < w ? r0[c0] * mul : 0.f, c0 < w ? r1[c0] * mul : 0.f,
                    c1 < w ? r0[c1] * mul : 0.f, c1 < w ? r1[c1] * mul : 0.f);
  }
}

// The same on bfloat16 (w % 8 == 0): uint4 (a0, a1, a2, a3) of (warp, step,
// lane) at (warp * w16 + step) * 32 + lane, per 16-column step; columns from
// w up to 16 * w16 are zero.  No scaling: a bfloat16 operand is used as it
// is given.
__device__ void stage_owned(uint4* dst, const __nv_bfloat16* x, int w, int w16) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* r0 = x + static_cast<size_t>(warp * 16 + g) * w;
  const __nv_bfloat16* r1 = r0 + 8 * w;
  for (int ks = 0; ks < w16; ++ks) {
    const int c0 = ks * 16 + 2 * t, c1 = c0 + 8;
    dst[(warp * w16 + ks) * 32 + lane] =
        make_uint4(c0 < w ? word_bf16(r0 + c0) : 0u, c0 < w ? word_bf16(r1 + c0) : 0u,
                   c1 < w ? word_bf16(r0 + c1) : 0u, c1 < w ? word_bf16(r1 + c1) : 0u);
  }
}

// columns [w, wp) of a 64-row tile whose rows are `ld` apart
template <class T>
__device__ void zero_columns(T* tile, int ld, int w, int wp) {
  for (int i = threadIdx.x; i < kBlock * (wp - w); i += kThreads)
    tile[(i / (wp - w)) * ld + w + i % (wp - w)] = from_float<T>(0.f);
}

// Zero-fill rows [row0, row0 + 64) of x ([.., w], 16 bytes a multiple of w).
template <class T>
__device__ void zero_rows(T* x, size_t row0, int w) {
  float4* p = reinterpret_cast<float4*>(x + row0 * w);
  for (int i = threadIdx.x; i < kBlock * w / (16 / static_cast<int>(sizeof(T)));
       i += kThreads)
    p[i] = zero4();
}

// Shared memory of every kernel, in 4-byte words, for elements of `esize`
// bytes and mma steps `kk` deep: the owned rows' fragments (64 x kk * dk
// elements, and 64 x kk * dvk more where a kernel owns a second operand:
// the backward), then `stages` ring stages of two tiles (rows padded by 16
// bytes to ldk and ldv elements, which spreads a fragment's reads over all
// 32 banks) and `extra_rows` 64-value rows, then one int per candidate
// tile.  dk and dvk count the mma steps over d and dv (8 columns on
// float32, 16 on bfloat16).  On float32 one stage is 68 KB in the backward
// at d = dv = 64 (three CTAs share an SM), 51 KB in the forward; on
// bfloat16 about half.
struct RingSmem {
  int dk, dvk, ldk, ldv, own8, stage;
  __host__ __device__ RingSmem(int d, int dv, int extra_rows, bool own_dv, int kk = 8,
                               int esize = 4)
      : dk((d + kk - 1) / kk), dvk((dv + kk - 1) / kk), ldk(dk * kk + 16 / esize),
        ldv(dvk * kk + 16 / esize), own8(own_dv ? dk + dvk : dk),
        stage(kBlock * ((ldk + ldv) * esize / 4 + extra_rows)) {}
  __host__ __device__ int owned() const { return kBlock * 8 * own8; }
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
// K2a and K1: the forward
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-query tile); MAXD8 bounds d8 and dv8 (the 8-column
// chunks of d and dv).  kTrain (K2a) adds the lse and the dropout; K1 leaves
// `lse` and `dr` unread.  On bfloat16 q is staged as it is and the scores
// are scaled after the product, in float32 (the Pallas kernel's `s =
// dot(q, k) * scale`).
template <class T, int MAXD8, bool kTrain>
__device__ __forceinline__ void forward(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int* __restrict__ key_valid,
                                        T* __restrict__ out, float* __restrict__ lse, int s,
                                        int d, int dv, int start, int end, float scale,
                                        Dropout dr, int stages) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kK = Elem<T>::kK;
  constexpr int kMaxK = (8 * MAXD8 + kK - 1) / kK;  // bounds the mma steps over d
  using Own = typename Elem<T>::Own;
  extern __shared__ float4 smem[];
  const RingSmem lay(d, dv, 1, false, kK, sizeof(T));
  // d8: the steps of the products over d (8 columns on float32, 16 on
  // bfloat16); dv8: the 8-column chunks of the output
  const int d8 = lay.dk, dv8 = (dv + 7) / 8, ldk = lay.ldk, ldv = lay.ldv;
  Own* own_q = reinterpret_cast<Own*>(smem);
  float* ring = reinterpret_cast<float*>(smem) + lay.owned();
  int* flags = reinterpret_cast<int*>(ring + stages * lay.stage);

  const int n_tiles = s / kBlock;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kBlock;
  const size_t base = static_cast<size_t>(bh) * s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int own0 = q0 + warp * 16;  // this warp's first query
  const size_t row0 = base + own0 + g, row1 = row0 + 8;

  // q scale log2(e): S = q k^T comes out in the exp2 domain (on bfloat16
  // the scores are scaled instead)
  if constexpr (kF32)
    stage_owned(own_q, q + (base + q0) * d, d, d8, scale * kLog2e);
  else
    stage_owned(own_q, q + (base + q0) * d, d, d8);
  // the hash's batch-head part (its row and column parts are rebuilt per
  // element: registers are what this loop is short of); dropout's 1 / (1 -
  // rate)
  const uint32_t bh_hash = static_cast<uint32_t>(bh) * 3266489917u + dr.seed;
  const float inv_keep = 1.f / dr.keep_prob;

  // the key tiles that overlap [q0 + start, q0 + 63 + end], flagged if they
  // hold a valid key
  const int kt_lo = max(0, q0 + start) / kBlock;
  const int kt_hi = min(s - 1, q0 + kBlock - 1 + end) / kBlock;
  const int n_cand = kt_hi - kt_lo + 1;
  for (int i = threadIdx.x; i < n_cand; i += kThreads) flags[i] = 0;
  for (int st = 0; st < stages; ++st) {
    T* tile = reinterpret_cast<T*>(ring + st * lay.stage);
    zero_columns(tile, ldk, d, kK * d8);
    zero_columns(tile + kBlock * ldk, ldv, dv, kK * lay.dvk);
  }
  __syncthreads();
  for (int j = kt_lo * kBlock + threadIdx.x; j < (kt_hi + 1) * kBlock; j += kThreads)
    if (key_valid[base + j] != 0) flags[j / kBlock - kt_lo] = 1;
  __syncthreads();

  auto load = [&](int i, int st) {
    T* kt = reinterpret_cast<T*>(ring + st * lay.stage);
    const int t0 = (kt_lo + i) * kBlock;
    tile_async(kt, ldk, k + (base + t0) * d, d);
    tile_async(kt + kBlock * ldk, ldv, v + (base + t0) * dv, dv);
    row_async(kt + kBlock * (ldk + ldv), key_valid + base + t0);
  };

  // O of rows g and g + 8 (elements h = 0, 1 and 2, 3 of each column step);
  // the rows' running max (exp2 domain) and this lane's share of their l
  float acc[MAXD8][4];
#pragma unroll
  for (int n = 0; n < MAXD8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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

    const T* kt = reinterpret_cast<const T*>(ring + st * lay.stage);
    const T* vt = kt + kBlock * ldk;
    const int* valid = reinterpret_cast<const int*>(vt + kBlock * ldv);
    const int t0 = (kt_lo + cur) * kBlock;
#pragma unroll
    for (int n0 = 0; n0 < kChunks; n0 += kPass) {
      bool c_live[kPass], c_full[kPass], any_live = false;
      float sc[kPass][4];
#pragma unroll
      for (int n = 0; n < kPass; ++n) {
        chunk_band(true, own0, t0, start, end, n0 + n, c_live[n], c_full[n]);
        any_live = any_live || c_live[n];
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      }
      if (!any_live) continue;  // the same for the whole warp
      const auto chunk_live = [&](int n) { return c_live[n]; };
      // S = q k^T, 16 queries x 32 keys per warp
#pragma unroll
      for (int ks = 0; ks < kMaxK; ++ks) {
        if (ks < d8) {
          if constexpr (kF32) {
            const float4 a = own_q[(warp * d8 + ks) * 32 + lane];
            mma_3xtf32<kPass, true>(sc, split_frag(a.x, a.y, a.z, a.w),
                                    kt + (8 * n0 + g) * ldk + 8 * ks + t, 8 * ldk, 4,
                                    chunk_live);
          } else {
            mma_bf16_rows(sc, own_q[(warp * d8 + ks) * 32 + lane],
                          kt + (8 * n0 + g) * ldk + 16 * ks + 2 * t, ldk, chunk_live);
          }
        }
      }
      if constexpr (!kF32) {  // into the exp2 domain
#pragma unroll
        for (int n = 0; n < kPass; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] *= scale * kLog2e;
      }
      // band and validity in the accumulator layout: element e of chunk n
      // is (query own0 + g + 8 (e / 2), key t0 + 8 (n0 + n) + 2 t + e % 2);
      // then each row's max over its four lanes
      float pass_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kPass; ++n) {
        if (!c_live[n]) continue;
        const int c0 = 8 * (n0 + n) + 2 * t;
        const int2 ok2 = *reinterpret_cast<const int2*>(valid + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, i = e & 1;
          const int rel = t0 + c0 + i - (own0 + g + 8 * h);
          const bool ok = (i ? ok2.y : ok2.x) != 0 &&
                          (c_full[n] || (rel >= start && rel <= end));
          sc[n][e] = ok ? sc[n][e] : -INFINITY;
          pass_max[h] = fmaxf(pass_max[h], sc[n][e]);
        }
      }
      // the online rescale, once per pass
      float m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pass_max[h] = fmaxf(pass_max[h], __shfl_xor_sync(0xffffffffu, pass_max[h], 1));
        pass_max[h] = fmaxf(pass_max[h], __shfl_xor_sync(0xffffffffu, pass_max[h], 2));
        const float m_new = fmaxf(m[h], pass_max[h]);
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = m[h] == -INFINITY ? 0.f : exp2f(m[h] - m_safe[h]);
        m[h] = m_new;
        l[h] *= alpha;
#pragma unroll
        for (int n = 0; n < MAXD8; ++n) {
          acc[n][2 * h] *= alpha;
          acc[n][2 * h + 1] *= alpha;
        }
      }
      // p (0 where masked), l, and drop(p) in place of the scores
#pragma unroll
      for (int n = 0; n < kPass; ++n) {
        if (!c_live[n]) continue;
        const int c0 = t0 + 8 * (n0 + n) + 2 * t;
        const uint32_t col[2] = {c0 * 2246822519u + bh_hash, (c0 + 1) * 2246822519u + bh_hash};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, i = e & 1;
          float p = exp2f(sc[n][e] - m_safe[h]);
          l[h] += p;
          if constexpr (kTrain)
            if (dr.on)
              p = keep_mixed((own0 + g + 8 * h) * 2654435761u + col[i], dr.thresh) ? p * inv_keep
                                                                                  : 0.f;
          sc[n][e] = p;
        }
      }
      // O += drop(P) v, with K2b's permuted k index: drop(P)'s accumulator
      // registers are its A registers, b0 and b1 read keys 2t and 2t + 1
      // (bfloat16: drop(P) rounded, two chunks per 16-deep step)
      if constexpr (kF32) {
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          if (!c_live[j]) continue;
          mma_3xtf32<MAXD8, true>(acc, split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3]),
                                  vt + (8 * (n0 + j) + 2 * t) * ldv + g, 8, ldv,
                                  [&](int n) { return n < dv8; });
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPass; j += 2) {
          if (!c_live[j] && !c_live[j + 1]) continue;
          mma_bf16_cols(acc, sc[j], sc[j + 1], vt + (8 * (n0 + j) + 2 * t) * ldv + g, ldv,
                        [&](int n) { return n < dv8; });
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

  // out = O / l (exact zeros where l = 0: O is 0 there), lse = m + log(l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float denom[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
#pragma unroll
  for (int n = 0; n < MAXD8; ++n) {
    const int c = 8 * n + 2 * t;
    if (n < dv8 && c < dv) {
      store_pair(out + row0 * dv + c, acc[n][0] / denom[0], acc[n][1] / denom[0]);
      store_pair(out + row1 * dv + c, acc[n][2] / denom[1], acc[n][3] / denom[1]);
    }
  }
  if constexpr (kTrain) {
    if (t == 0) {
      lse[row0] = l[0] > 0.f ? m[0] * kLn2 + logf(l[0]) : -INFINITY;
      lse[row1] = l[1] > 0.f ? m[1] * kLn2 + logf(l[1]) : -INFINITY;
    }
  }
}

// K2a.  Registers are capped for 2 CTAs per SM up to d = 64: capped for 3
// (170 registers), its dropout path spilled 4 bytes at d = 64.
template <class T, int MAXD8>
__global__ void __launch_bounds__(kThreads, MAXD8 > 8 ? 1 : 2)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ key_valid, T* __restrict__ out, float* __restrict__ lse,
           int s, int d, int dv, int start, int end, float scale, Dropout dr, int stages) {
  forward<T, MAXD8, true>(q, k, v, key_valid, out, lse, s, d, dv, start, end, scale, dr,
                          stages);
}

// K1: the same signature, so one launch helper serves both.
template <class T, int MAXD8>
__global__ void __launch_bounds__(kThreads, MAXD8 > 8 ? 1 : 3)
banded_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ key_valid,
                        T* __restrict__ out, float* __restrict__ lse, int s, int d, int dv,
                        int start, int end, float scale, Dropout dr, int stages) {
  forward<T, MAXD8, false>(q, k, v, key_valid, out, lse, s, d, dv, start, end, scale, dr,
                           stages);
}

// ---------------------------------------------------------------------------
// K2b: dq and delta
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-query tile); MAXD8 bounds the 8-column chunks of d
// and dv.  Registers are capped for 3 CTAs per SM up to d = 64.  Float32
// only: the bfloat16 K2b is banded_attention_bwd_sm90.cu's.
template <class T, int MAXD8>
__global__ void __launch_bounds__(kThreads, MAXD8 > 8 ? 1 : 3)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const T* __restrict__ out,
          const float* __restrict__ lse, const int* __restrict__ key_valid,
          T* __restrict__ dq, float* __restrict__ delta, int s, int d, int dv, int start,
          int end, float scale, Dropout dr, int stages) {
  static_assert(std::is_same<T, float>::value, "the bfloat16 K2b is in its own source");
  constexpr int kK = Elem<T>::kK;
  constexpr int kMaxK = (8 * MAXD8 + kK - 1) / kK;  // bounds the mma steps over d, dv
  using Own = typename Elem<T>::Own;
  extern __shared__ float4 smem[];
  const RingSmem lay(d, dv, 1, true, kK, sizeof(T));
  // d8, dv8: the 8-column steps of the products over d and dv; dq8: the
  // 8-column chunks of dq
  const int d8 = lay.dk, dv8 = lay.dvk, ldk = lay.ldk, ldv = lay.ldv;
  const int dq8 = d8;
  Own* own_q = reinterpret_cast<Own*>(smem);
  Own* own_do = own_q + kBlock * 2 * d8;  // 64 x kK * d8 elements
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
    const Own f = own_do[(warp * dv8 + ks) * 32 + lane];
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
  for (int i = threadIdx.x; i < n_cand; i += kThreads) flags[i] = 0;
  for (int st = 0; st < stages; ++st) {
    T* tile = reinterpret_cast<T*>(ring + st * lay.stage);
    zero_columns(tile, ldk, d, kK * d8);
    zero_columns(tile + kBlock * ldk, ldv, dv, kK * dv8);
  }
  __syncthreads();
  for (int j = kt_lo * kBlock + threadIdx.x; j < (kt_hi + 1) * kBlock; j += kThreads)
    if (key_valid[base + j] != 0) flags[j / kBlock - kt_lo] = 1;
  __syncthreads();

  auto load = [&](int i, int st) {
    T* kt = reinterpret_cast<T*>(ring + st * lay.stage);
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
      const T* kt = reinterpret_cast<const T*>(ring + st * lay.stage);
      const T* vt = kt + kBlock * ldk;
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
        for (int ks = 0; ks < kMaxK; ++ks) {
          if (ks < d8) {
            const float4 a = own_q[(warp * d8 + ks) * 32 + lane];
            mma_bwd(sc, split_frag(a.x, a.y, a.z, a.w),
                    kt + (8 * n0 + g) * ldk + 8 * ks + t, 8 * ldk, 4, chunk_live);
          }
          if (ks < dv8) {
            const float4 a = own_do[(warp * dv8 + ks) * 32 + lane];
            mma_bwd(dp, split_frag(a.x, a.y, a.z, a.w),
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
          mma_bwd(acc, split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3]),
                  kt + (8 * (n0 + j) + 2 * t) * ldk + g, 8, ldk,
                  [&](int n) { return n < dq8; });
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
    if (n < dq8 && c < d) {
      store_pair(dq + row0 * d + c, acc[n][0] * scale, acc[n][1] * scale);
      store_pair(dq + row1 * d + c, acc[n][2] * scale, acc[n][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K2c: dk and dv
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-key tile); as K2b, MAXD8 bounds the 8-column chunks
// of d and dv, with registers capped for 3 CTAs per SM up to d = 64.  There
// the float32 fresh sums spill (about 0.5 KB a thread), and still run faster
// than spill-free at 2 CTAs (PERF.md); above d = 64 they spill at one CTA
// too (untimed).  Float32 only: the bfloat16 K2c is
// banded_attention_bwd_sm90.cu's.
template <class T, int MAXD8>
__global__ void __launch_bounds__(kThreads, MAXD8 > 8 ? 1 : 3)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const int* __restrict__ key_valid,
           T* __restrict__ dk, T* __restrict__ dv_out, int s, int d, int dv, int start,
           int end, float scale, Dropout dr, int stages) {
  static_assert(std::is_same<T, float>::value, "the bfloat16 K2c is in its own source");
  constexpr int kK = Elem<T>::kK;
  constexpr int kMaxK = (8 * MAXD8 + kK - 1) / kK;  // bounds the mma steps over d, dv
  using Own = typename Elem<T>::Own;
  extern __shared__ float4 smem[];
  const RingSmem lay(d, dv, 2, true, kK, sizeof(T));
  // d8, dv8: the 8-column steps of the products over d and dv; dk8, dv8c:
  // the 8-column chunks of dk and dv
  const int d8 = lay.dk, dv8 = lay.dvk, ldk = lay.ldk, ldv = lay.ldv;
  const int dk8 = d8, dv8c = dv8;
  Own* own_k = reinterpret_cast<Own*>(smem);
  Own* own_v = own_k + kBlock * 2 * d8;
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
  for (int i = threadIdx.x; i < n_cand; i += kThreads) flags[i] = 0;
  for (int st = 0; st < stages; ++st) {
    T* tile = reinterpret_cast<T*>(ring + st * lay.stage);
    zero_columns(tile, ldk, d, kK * d8);
    zero_columns(tile + kBlock * ldk, ldv, dv, kK * dv8);
  }
  __syncthreads();
  for (int j = qt_lo * kBlock + threadIdx.x; j < (qt_hi + 1) * kBlock; j += kThreads)
    if (lse[base + j] > -INFINITY) flags[j / kBlock - qt_lo] = 1;
  __syncthreads();

  auto load = [&](int i, int st) {
    T* qt = reinterpret_cast<T*>(ring + st * lay.stage);
    const int t0 = (qt_lo + i) * kBlock;
    tile_async(qt, ldk, q + (base + t0) * d, d);
    tile_async(qt + kBlock * ldk, ldv, dout + (base + t0) * dv, dv);
    float* rows = reinterpret_cast<float*>(qt + kBlock * (ldk + ldv));
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
      const T* qt = reinterpret_cast<const T*>(ring + st * lay.stage);
      const T* dot = qt + kBlock * ldk;
      const float* lse_t = reinterpret_cast<const float*>(dot + kBlock * ldv);
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
        for (int ks = 0; ks < kMaxK; ++ks) {
          if (ks < d8) {
            const float4 a = own_k[(warp * d8 + ks) * 32 + lane];
            mma_bwd(sc, split_frag(a.x, a.y, a.z, a.w),
                    qt + (8 * n0 + g) * ldk + 8 * ks + t, 8 * ldk, 4, chunk_live);
          }
          if (ks < dv8) {
            const float4 a = own_v[(warp * dv8 + ks) * 32 + lane];
            mma_bwd(pa, split_frag(a.x, a.y, a.z, a.w),
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
          mma_bwd(dv_acc, split_frag(pa[j][0], pa[j][2], pa[j][1], pa[j][3]),
                  dot + r * ldv + g, 8, ldv, [&](int n) { return n < dv8c; });
          mma_bwd(dk_acc, split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3]),
                  qt + r * ldk + g, 8, ldk, [&](int n) { return n < dk8; });
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
    if (n < dk8 && c < d) {
      store_pair(dk + row0 * d + c, dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      store_pair(dk + row1 * d + c, dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    }
    if (n < dv8c && c < dv) {
      store_pair(dv_out + row0 * dv + c, dv_acc[n][0], dv_acc[n][1]);
      store_pair(dv_out + row1 * dv + c, dv_acc[n][2], dv_acc[n][3]);
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

// the shapes the kernels take: d and dv multiples of 16 bytes' worth of
// elements / 4 (float32: 4; bfloat16, whose rows load 8 at a time: 8)
bool bad_shape(int bh, int s, int d, int dv, int start, int end, int vec) {
  return bh <= 0 || s <= 0 || s % kBlock != 0 || d <= 0 || dv <= 0 || d % vec != 0 ||
         dv % vec != 0 || d > kMaxHeadDim || dv > kMaxHeadDim || start > 0 || end < 0;
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

// The ring's stages and shared-memory bytes for `kernel`: two stages where
// the card runs as many of its CTAs per SM with two as with one (where the
// registers, not the shared memory, bound them: d <= 32, d = 128), else
// one (at d = dv = 64, one stage lets 3 CTAs share an SM, two would let 2).
template <typename Kernel>
cudaError_t ring_stages(Kernel kernel, const RingSmem& lay, int s, int& stages, size_t& smem) {
  const size_t one = lay.bytes(1, s / kBlock), two = lay.bytes(2, s / kBlock);
  if (one > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, two <= kMaxSmem ? two : one);
  int per_sm[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[0], kernel, kThreads, one);
  if (err == cudaSuccess && two <= kMaxSmem)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[1], kernel, kThreads, two);
  stages = per_sm[1] >= per_sm[0] ? 2 : 1;
  smem = stages == 2 ? two : one;
  return err;
}

// K2a (kTrain) or K1
template <class T, int MAXD8, bool kTrain>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                       void* out, void* lse, int bh, int s, int d, int dv, int start, int end,
                       float scale, Dropout dr, cudaStream_t stream) {
  const auto kernel = kTrain ? fwd_kernel<T, MAXD8> : banded_attention_kernel<T, MAXD8>;
  int stages = 0;
  size_t smem = 0;
  const cudaError_t err = ring_stages(
      kernel, RingSmem(d, dv, 1, false, Elem<T>::kK, sizeof(T)), s, stages, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(key_valid), static_cast<T*>(out), static_cast<float*>(lse), s, d,
      dv, start, end, scale, dr, stages);
  return cudaGetLastError();
}

template <class T, int MAXD8>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, const void* lse, const void* key_valid, void* dq,
                      void* delta, int bh, int s, int d, int dv, int start, int end,
                      float scale, Dropout dr, cudaStream_t stream) {
  int stages = 0;
  size_t smem = 0;
  const cudaError_t err = ring_stages(
      dq_kernel<T, MAXD8>, RingSmem(d, dv, 1, true, Elem<T>::kK, sizeof(T)), s, stages, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dq_kernel<T, MAXD8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(out), static_cast<const float*>(lse),
      static_cast<const int*>(key_valid), static_cast<T*>(dq), static_cast<float*>(delta), s,
      d, dv, start, end, scale, dr, stages);
  return cudaGetLastError();
}

template <class T, int MAXD8>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* key_valid, void* dk,
                       void* dv_out, int bh, int s, int d, int dv, int start, int end,
                       float scale, Dropout dr, cudaStream_t stream) {
  int stages = 0;
  size_t smem = 0;
  const cudaError_t err = ring_stages(
      dkv_kernel<T, MAXD8>, RingSmem(d, dv, 2, true, Elem<T>::kK, sizeof(T)), s, stages,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dkv_kernel<T, MAXD8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(key_valid),
      static_cast<T*>(dk), static_cast<T*>(dv_out), s, d, dv, start, end, scale, dr, stages);
  return cudaGetLastError();
}

// The entry points' bodies, one per kernel, over the element type T: the
// shape check, then the instantiation for the head dims.
template <class T>
int k1_entry(const void* q, const void* k, const void* v, const void* key_valid, void* out,
             int bh, int s, int d, int dv, int start, int end, float scale, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end, 16 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout off = make_dropout(0, 0, 1.f, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_fwd<T, 2, false>(q, k, v, key_valid, out, nullptr, bh, s, d, dv, start, end, scale, off, st);
    case 4: return launch_fwd<T, 4, false>(q, k, v, key_valid, out, nullptr, bh, s, d, dv, start, end, scale, off, st);
    case 8: return launch_fwd<T, 8, false>(q, k, v, key_valid, out, nullptr, bh, s, d, dv, start, end, scale, off, st);
    default: return launch_fwd<T, 16, false>(q, k, v, key_valid, out, nullptr, bh, s, d, dv, start, end, scale, off, st);
  }
}

template <class T>
int fwd_entry(const void* q, const void* k, const void* v, const void* key_valid, void* out,
              void* lse, int bh, int s, int d, int dv, int start, int end, float scale,
              unsigned seed, unsigned thresh, float keep_prob, int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end, 16 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_fwd<T, 2, true>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end, scale, dr, st);
    case 4: return launch_fwd<T, 4, true>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end, scale, dr, st);
    case 8: return launch_fwd<T, 8, true>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end, scale, dr, st);
    default: return launch_fwd<T, 16, true>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end, scale, dr, st);
  }
}

template <class T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* out,
             const void* lse, const void* key_valid, void* dq, void* delta, int bh, int s,
             int d, int dv, int start, int end, float scale, unsigned seed, unsigned thresh,
             float keep_prob, int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end, 16 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_dq<T, 2>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    case 4: return launch_dq<T, 4>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    case 8: return launch_dq<T, 8>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
    default: return launch_dq<T, 16>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end, scale, dr, st);
  }
}

template <class T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* key_valid, void* dk, void* dv_out, int bh, int s,
              int d, int dv, int start, int end, float scale, unsigned seed, unsigned thresh,
              float keep_prob, int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end, 16 / sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps_for(d, dv)) {
    case 2: return launch_dkv<T, 2>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    case 4: return launch_dkv<T, 4>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    case 8: return launch_dkv<T, 8>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
    default: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start, end, scale, dr, st);
  }
}

#ifndef BA_UNIT_F32
// One m16n8k16 bfloat16 mma per CTA of one warp, problem p = blockIdx.x:
// d = a.b + c with a [16, 16] and b [16, 8] bfloat16, c and d [16, 8]
// float32, row-major and packed one problem after another.  mma_bf16 as
// the kernels issue it, so chip_smoke.py can read the tensor core's
// rounding off d against a float64 sum.
__global__ void mma_bf16_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                      const __nv_bfloat16* __restrict__ b,
                                      const float* __restrict__ c, float* __restrict__ d) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* A = a + blockIdx.x * 256;
  const __nv_bfloat16* B = b + blockIdx.x * 128;
  const float* C = c + blockIdx.x * 128;
  float* D = d + blockIdx.x * 128;
  const uint32_t af[4] = {word_bf16(A + g * 16 + 2 * t), word_bf16(A + (g + 8) * 16 + 2 * t),
                          word_bf16(A + g * 16 + 2 * t + 8),
                          word_bf16(A + (g + 8) * 16 + 2 * t + 8)};
  float acc[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(g + 8) * 8 + 2 * t],
                  C[(g + 8) * 8 + 2 * t + 1]};
  mma_bf16(acc, af, pair_bf16(B + 2 * t * 8 + g, B + (2 * t + 1) * 8 + g),
           pair_bf16(B + (2 * t + 8) * 8 + g, B + (2 * t + 9) * 8 + g));
  D[g * 8 + 2 * t] = acc[0];
  D[g * 8 + 2 * t + 1] = acc[1];
  D[(g + 8) * 8 + 2 * t] = acc[2];
  D[(g + 8) * 8 + 2 * t + 1] = acc[3];
}
#endif  // BA_UNIT_F32

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success).
// `seed`, `thresh`, `keep_prob` and `dropout_on` describe the dropout mask;
// with dropout_on == 0 they are ignored.  The _f32 entry points take float32
// q, k, v, dout and outputs, the _bf16 ones bfloat16; lse and delta are
// float32 in both.

// The source builds whole, or as one translation unit per element type,
// which ops/_build.py compiles at once: -DBA_UNIT_F32 keeps the float32
// entry points, -DBA_UNIT_BF16 the bfloat16 ones (K1, K2a) and the probe.  Each
// kernel is compiled from the same template either way.
#ifndef BA_UNIT_BF16

// K1: out [BH, S, Dv].
extern "C" int banded_attention_f32(const void* q, const void* k, const void* v,
                                    const void* key_valid, void* out, int bh, int s, int d,
                                    int dv, int start, int end, float scale, void* stream) {
  return k1_entry<float>(q, k, v, key_valid, out, bh, s, d, dv, start, end, scale, stream);
}

// K2a: out [BH, S, Dv] and lse [BH, S].
extern "C" int banded_attention_fwd_f32(const void* q, const void* k, const void* v,
                                        const void* key_valid, void* out, void* lse,
                                        int bh, int s, int d, int dv, int start, int end,
                                        float scale, unsigned seed, unsigned thresh,
                                        float keep_prob, int dropout_on, void* stream) {
  return fwd_entry<float>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end, scale, seed,
                          thresh, keep_prob, dropout_on, stream);
}

// K2b: dq [BH, S, D] and delta = rowsum(dout * out) [BH, S], which K2c reads.
extern "C" int banded_attention_dq_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* out, const void* lse,
                                       const void* key_valid, void* dq, void* delta, int bh,
                                       int s, int d, int dv, int start, int end, float scale,
                                       unsigned seed, unsigned thresh, float keep_prob,
                                       int dropout_on, void* stream) {
  return dq_entry<float>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start,
                         end, scale, seed, thresh, keep_prob, dropout_on, stream);
}

// K2c: dk [BH, S, D] and dv [BH, S, Dv].
extern "C" int banded_attention_dkv_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, const void* key_valid, void* dk,
                                        void* dv_out, int bh, int s, int d, int dv,
                                        int start, int end, float scale, unsigned seed,
                                        unsigned thresh, float keep_prob, int dropout_on,
                                        void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv,
                          start, end, scale, seed, thresh, keep_prob, dropout_on, stream);
}
#endif  // BA_UNIT_BF16

#ifndef BA_UNIT_F32

// bfloat16 twins of K1's and K2a's entry points above (the bfloat16 K2b
// and K2c: banded_attention_bwd_sm90.cu).
extern "C" int banded_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* key_valid, void* out, int bh, int s, int d,
                                     int dv, int start, int end, float scale, void* stream) {
  return k1_entry<__nv_bfloat16>(q, k, v, key_valid, out, bh, s, d, dv, start, end, scale,
                                 stream);
}

extern "C" int banded_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                         const void* key_valid, void* out, void* lse,
                                         int bh, int s, int d, int dv, int start, int end,
                                         float scale, unsigned seed, unsigned thresh,
                                         float keep_prob, int dropout_on, void* stream) {
  return fwd_entry<__nv_bfloat16>(q, k, v, key_valid, out, lse, bh, s, d, dv, start, end,
                                  scale, seed, thresh, keep_prob, dropout_on, stream);
}

// The bfloat16 mma probe: `n` problems (see mma_bf16_probe_kernel).
extern "C" int mma_bf16_probe(const void* a, const void* b, const void* c, void* d, int n,
                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mma_bf16_probe_kernel<<<grid, 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(c), static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
#endif  // BA_UNIT_F32
