// Banded (time-restricted) attention's backward on bfloat16 for Hopper
// (sm_90a): K2b (dq and delta) and K2c (dk and dv) on wgmma, TMA and
// mbarriers.
//
// Replaces, on bfloat16, the TPU kernels K2b and K2c of the JAX package:
//   pytorch_kaldi_asr_tpu/ops/banded_attention.py
//     K2b  _trainable_bwd, dq call    (Pallas kernel `_dq_kernel`)
//     K2c  _trainable_bwd, dk/dv call (Pallas kernel `_dkv_kernel`)
// with the function, layout and C entry points of the bfloat16 pair that
// banded_attention_train.cu held before (the float32 pair, the forward and
// K1 stay there).  Per batch-head b, query t and key j in [t + start, t +
// end] with key_valid[b, j] != 0, a = exp(scale q.k - lse) (0 elsewhere
// and on rows with lse = -inf), delta = rowsum(dout * out):
//   dq = scale * sum_j a (drop(dout.v) - delta) k,
//   dk = scale * sum_t a (drop(dout.v) - delta) q,  dv = sum_t drop(a) dout,
// drop(x) = keep(seed, b, t, j) ? x / (1 - rate) : 0 with the JAX package's
// `_dropout_keep` hash on global positions.  q, k, v, dout, out and the
// outputs bfloat16; lse, delta and every sum float32; dS and drop(a)
// rounded to bfloat16 before their products (the Pallas kernels'
// `ds.astype(k.dtype)`, `a_drop.astype(do.dtype)`, `ds.astype(q.dtype)`),
// nowhere else; the outputs rounded once.  Rows with lse = -inf and
// invalid keys get exact zeros.  Layout: q, k, dq, dk [BH, S, D]; v, out,
// dout, dv [BH, S, Dv]; key_valid [BH, S] int32; lse, delta [BH, S]
// float32; contiguous and 16-byte aligned.  S a multiple of 64; D and Dv
// multiples of 8, at most 128.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bfloat16 dense) at the
// conformer train shape (BH 128, S 1600, d = dv = 64, band (-256, 256),
// about 6e7 in-band pairs): each kernel moves six [128, 1600, 64] bfloat16
// tensors and three [128, 1600] rows, 0.048 ms; K2b's 6 x 64 and K2c's 8 x
// 64 tensor operations per pair take 0.023 and 0.031 ms.  So both are bound
// by their bytes, but the work per in-band pair outside the tensor cores
// (exp2, the band and validity tests, the dropout hash, the roundings:
// some 15-20 instructions) is 0.04-0.05 ms of the CUDA cores, as much as
// the bytes: it has to overlap the products, not follow them.
//
// The design.  A CTA is one warpgroup and owns 64 rows (K2b query rows,
// K2c key rows).  Its thread 0 loads the owned tiles once (q and dout, or
// k and v) and streams the other side's 64-row tiles (k, v and key_valid,
// or q, dout, lse and delta) through a ring of stages with TMA, each stage
// completing an mbarrier (`full`) that the warpgroup waits on; it refills
// a stage once every thread has arrived on the stage's `empty` barrier,
// past the products that read it.  Tiles land in 128-byte swizzled shared
// memory, 64-column blocks of 64 rows (TMA's out-of-bounds fill zeroes the
// columns past d or dv), which wgmma reads through matrix descriptors.
// Per streamed tile the warpgroup runs, with its own rows as the wgmma's M
// (so K2c computes S^T = K Q^T and dP^T = V dO^T and needs no transpose):
//   S = own.tile^T and dP (wgmma m64n64k16, A and B from shared memory,
//     both K-major);
//   the elementwise pass in the accumulator layout: thread (warp w, lane
//     4g + t) holds rows 16w + g and 16w + g + 8 at columns 8j + 2t and
//     8j + 2t + 1 of each 8-wide chunk j, which is also the layout of a
//     register A operand once two chunks are rounded in pairs to
//     bfloat16: so dS (and K2c's drop(a)) go to the tensor core without a
//     shuffle;
//   dq += dS.K, dk += dS^T.Q and dv += drop(P)^T.dO (A from registers, B
//     the streamed tile, which is N-contiguous: the transpose flag), issued
//     with the next tile's S and dP behind them.
// The tensor core's work and the CUDA cores' overlap across CTAs: K2b
// takes 142 registers a thread, so three CTAs share an SM, K2c 188, two
// (at d, dv <= 64; PERF.md).  Measured on the H100 and dropped (PERF.md):
// issuing the next tile's S and dP before the elementwise pass, within the
// warpgroup, which held two tiles' S and dP (K2b 210, K2c 254 registers,
// two CTAs) and ran slower; and a producer warp or warpgroup beside the
// consumers giving them its registers with setmaxnreg, for which ptxas
// kept the consumers' code within the launch bounds' budget (128 at two
// CTAs of 256 threads, 168 at one of 384) and spilled.  Work the band and
// lengths make zero is skipped: streamed tiles with no valid key (K2b) or
// no live query (K2c), tiles wholly out of band, and CTAs whose rows are
// all dead or invalid; each warp's band test runs only on tiles that the
// band crosses; at rate 0 the hash is skipped by a branch taken once per
// tile.  One CTA per owned tile writes its rows: no atomics, and two runs
// give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kRows = 64;      // rows of a tile, the wgmma's M
constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxHeadDim = 128;
constexpr int kBlockBytes = kRows * 128;  // 64 rows of 64 bfloat16, 128-byte rows
constexpr int kRowBytes = kRows * 4;      // 64 int32 or float32 values
constexpr uint32_t kWaitLimit = 1u << 25;  // tries before a lost mbarrier phase traps
constexpr float kLog2e = 1.4426950408889634f;

struct Dropout {
  uint32_t seed;
  uint32_t thresh;   // int(rate * 0xFFFFFFFF), computed by the host in double
  float keep_prob;   // 1 - rate, rounded once to float32
  int on;            // rate > 0
};

// The mixing steps of the JAX package's _dropout_keep on its linear part
// x = qpos * 2654435761 + kpos * 2246822519 + bh * 3266489917 + seed
// (uint32 wraps), assembled from a term per own row and a term per column.
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// two floats as one register's bfloat16 pair, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special function unit alone (exp2f adds a rescale for
// denormal results, three more instructions per pair; here they flush to
// zero, far below a bfloat16 ulp of any row's scale)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a register's two bfloat16 as floats (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// ---------------------------------------------------------------------------
// Hopper's asynchronous machinery, one PTX instruction per helper
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive, expecting `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// whether the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that outlasts any tile's arrival by orders of magnitude traps, so a
// lost phase fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == kWaitLimit) __trap();
}

// a [64, 64] bfloat16 box of a [BH, S, w] tensor map at (column c0, row
// c1, batch-head c2) into shared memory, completing `bar`'s bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the sums' zeroing below the first
// products' issue, or their reads above the last wait: ptxas serializes
// the products (its warning C7515) where an instruction other than wgmma
// writes a product's registers between an issue and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A matrix descriptor of 128-byte swizzled shared memory at shared address
// `addr`: leading and stride byte offsets `lbo` and `sbo`.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// Step ks (16 columns) of a K-major operand, a tile of 64-column blocks:
// rows 128 bytes apart in 8-row groups of 1,024 bytes, the step's 32 bytes
// inside each row.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks / 4) * kBlockBytes + (ks % 4) * 32, 16, 1024);
}

// Step ks (16 rows) of an N-contiguous operand, block cb (64 columns) of
// a tile: 8-row groups of 1,024 bytes along the k dimension.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int cb, int ks) {
  return sw128_desc(tile + cb * kBlockBytes + ks * 16 * 128, kBlockBytes, 1024);
}

// d = a.b^T (scale_d 0) or d += a.b^T over 16 columns: 64 rows of a, 64 of
// b, both K-major in shared memory; d in the accumulator layout.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A.b over 16 rows of b: A in registers (a0..a3, the m16n8k16 A
// fragment of each warp's 16 rows), b 64 N-contiguous columns in shared
// memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// shared memory and the CTA's set-up
// ---------------------------------------------------------------------------

// Byte offsets from the CTA's 1,024-aligned base, for tiles of CB
// 64-column blocks: two owned tiles, the ring's stages (two streamed tiles
// each), each stage's two 64-value rows (K2b: key_valid; K2c: lse and
// delta), the mbarriers (full[stages], empty[stages], own), then the
// number of streamed tiles and their indices.
template <int CB>
struct Smem {
  static constexpr int kStages = CB == 1 ? 3 : 2;
  static constexpr int kTile = CB * kBlockBytes;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kRowsArea = kRing + kStages * 2 * kTile;
  static constexpr int kBars = kRowsArea + kStages * 2 * kRowBytes;
  static constexpr int kList = kBars + 8 * (2 * kStages + 1);
  static size_t bytes(int s) { return 1024 + kList + 4 * (s / kRows + 1); }
};

// What a CTA copies: its owned tiles (maps own_a and own_b at rows [r0, r0
// + 64) of batch-head bh), and per listed tile the streamed tiles (maps
// str_a and str_b) and one or two 64-value rows (rows_a, and rows_b unless
// null, from row base + the tile's first row).
struct Sources {
  const CUtensorMap *own_a, *own_b, *str_a, *str_b;
  const void *rows_a, *rows_b;
  int r0, bh;
  size_t base;
};

// Thread 0's copies of listed tile i into its stage, completing the stage's
// `full` barrier.
template <int CB>
__device__ __forceinline__ void load_tile(uint8_t* sm, const Sources& src, int i) {
  using L = Smem<CB>;
  const int* meta = reinterpret_cast<const int*>(sm + L::kList);
  const uint32_t sb = smem_u32(sm);
  const int st = i % L::kStages, t0 = meta[1 + i] * kRows;
  const uint32_t full = sb + L::kBars + 8 * st;
  const uint32_t tile = sb + L::kRing + st * 2 * L::kTile;
  const uint32_t rows = sb + L::kRowsArea + st * 2 * kRowBytes;
  mbar_expect_tx(full, 2 * L::kTile + (src.rows_b ? 2 : 1) * kRowBytes);
  for (int cb = 0; cb < CB; ++cb) {
    tma_load_3d(tile + cb * kBlockBytes, src.str_a, full, 64 * cb, t0, src.bh);
    tma_load_3d(tile + L::kTile + cb * kBlockBytes, src.str_b, full, 64 * cb, t0, src.bh);
  }
  bulk_load(rows, static_cast<const char*>(src.rows_a) + 4 * (src.base + t0), kRowBytes, full);
  if (src.rows_b)
    bulk_load(rows + kRowBytes, static_cast<const char*>(src.rows_b) + 4 * (src.base + t0),
              kRowBytes, full);
}

// The set-up: thread 0 starts the mbarriers and, where `any` (the CTA has
// a live row or valid key), loads the owned tiles; meanwhile the candidate
// tiles [lo, hi] whose 64 values satisfy `take` (by global row) are listed,
// in order, after their count (none where not `any`), and thread 0 fills
// the ring's first stages.
template <int CB, class Take>
__device__ __forceinline__ void setup(uint8_t* sm, const Sources& src, int lo, int hi, bool any,
                                      Take take) {
  using L = Smem<CB>;
  int* meta = reinterpret_cast<int*>(sm + L::kList);
  const int n_cand = hi - lo + 1;
  if (threadIdx.x == 0) {
    const uint32_t sb = smem_u32(sm), bars = sb + L::kBars, own = bars + 16 * L::kStages;
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(bars + 8 * st, 1);                         // full: the copies
      mbar_init(bars + 8 * (L::kStages + st), kThreads);  // empty: every thread
    }
    mbar_init(own, 1);
    fence_mbar_init();
    if (any) {
      mbar_expect_tx(own, 2 * L::kTile);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load_3d(sb + cb * kBlockBytes, src.own_a, own, 64 * cb, src.r0, src.bh);
        tma_load_3d(sb + L::kTile + cb * kBlockBytes, src.own_b, own, 64 * cb, src.r0, src.bh);
      }
    }
  }
  for (int i = threadIdx.x; i < n_cand; i += kThreads) meta[1 + i] = 0;
  __syncthreads();
  if (any)
    for (int j = threadIdx.x; j < n_cand * kRows; j += kThreads)
      if (take(lo * kRows + j)) meta[1 + j / kRows] = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < n_cand; ++i)
      if (meta[1 + i]) meta[1 + n++] = lo + i;
    meta[0] = n;
    for (int i = 0; i < L::kStages && i < n; ++i) load_tile<CB>(sm, src, i);
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// The loop over the CTA's listed tiles: S and dP of each tile (own tiles 0
// and 1 against its two streamed tiles, over all 64 CB columns: TMA's zero
// fill makes the steps past d or dv add nothing), then `elementwise` of the
// tile (its first row, its rows in shared memory, S, dP) and `accumulate`
// (its shared address), which issues the tile's accumulating products.
// Once every thread is past a tile's products (its stage's `empty`
// barrier), thread 0 loads the next tile into that stage.  No product is
// issued under a condition that the loop could merge: ptxas would copy its
// registers while it runs, and serialize the products (C7515).
template <int CB, class Elementwise, class Accumulate>
__device__ __forceinline__ void consume(uint8_t* sm, const Sources& src, bool any,
                                        Elementwise elementwise, Accumulate accumulate) {
  using L = Smem<CB>;
  const int* meta = reinterpret_cast<const int*>(sm + L::kList);
  const int n_live = meta[0];
  const uint32_t sb = smem_u32(sm);
  const uint32_t full = sb + L::kBars, empty = full + 8 * L::kStages,
                 own = full + 16 * L::kStages;
  if (any) mbar_wait(own, 0);  // setup's copies land before the CTA may end
  if (n_live == 0) return;

  float sc[32], dp[32];  // S and dP of a tile
  const auto issue = [&](int i) {
    const int st = i % L::kStages;
    mbar_wait(full + 8 * st, (i / L::kStages) & 1);
    const uint32_t tile = sb + L::kRing + st * 2 * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * CB; ++ks)
      wgmma_ss(sc, kmajor_desc(sb, ks), kmajor_desc(tile, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4 * CB; ++ks)
      wgmma_ss(dp, kmajor_desc(sb + L::kTile, ks), kmajor_desc(tile + L::kTile, ks), ks > 0);
    wgmma_commit();
  };
  // tile i, whose S and dP were issued; where `next` is true, then the
  // next tile's S and dP, which run with tile i's accumulating products
  const auto step = [&](auto next, int i) {
    wgmma_wait<0>();
    // tile i - 1's products are complete: its stage takes the next tile
    if (i > 0) {
      const int done = i - 1, st = done % L::kStages;
      mbar_arrive(empty + 8 * st);
      if (threadIdx.x == 0 && done + L::kStages < n_live) {
        mbar_wait(empty + 8 * st, (done / L::kStages) & 1);
        load_tile<CB>(sm, src, done + L::kStages);
      }
    }
    const int st = i % L::kStages;
    const uint32_t tile = sb + L::kRing + st * 2 * L::kTile;
    elementwise(meta[1 + i] * kRows, sm + L::kRowsArea + st * 2 * kRowBytes, sc, dp);
    accumulate(tile);
    if constexpr (decltype(next)::value) {
      // at 128 columns the next tile's S and dP have registers only once
      // this tile's products are done with their operands
      if constexpr (CB == 2) wgmma_wait<0>();
      issue(i + 1);
    }
  };

  issue(0);
  for (int i = 0; i + 1 < n_live; ++i) step(std::true_type(), i);
  step(std::false_type(), n_live - 1);
  wgmma_wait<0>();
}

// The band's reach from a warp's 16 own rows [own0, own0 + 15] into a
// streamed tile [t0, t0 + 63]: whether any of its pairs is in band, and
// whether all are.  rel = key - query.
__device__ __forceinline__ void warp_band(bool own_is_query, int own0, int t0, int start,
                                          int end, bool& any, bool& all) {
  const int rel_min = own_is_query ? t0 - (own0 + 15) : own0 - (t0 + 63);
  const int rel_max = own_is_query ? t0 + 63 - own0 : own0 + 15 - t0;
  any = rel_max >= start && rel_min <= end;
  all = rel_min >= start && rel_max <= end;
}

// accumulator elements e (rows g + 8 (e / 2), columns 2t + e % 2) of 8-wide
// chunks 2s and 2s + 1, rounded in pairs: step s's register A operand
__device__ __forceinline__ void to_frag(uint32_t (&frag)[16], int j, const float (&x)[4]) {
  frag[4 * (j / 2) + 2 * (j & 1)] = pack_bf16(x[0], x[1]);
  frag[4 * (j / 2) + 2 * (j & 1) + 1] = pack_bf16(x[2], x[3]);
}

// acc (CB blocks of 64 columns) times `mul` into rows row0 and row0 + 8 of
// x ([.., w] bfloat16), columns below w
template <int CB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* x, size_t row0, int w,
                                           const float (&acc)[CB][32], float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * cb + 8 * j + 2 * t;
      if (c < w) {
        *reinterpret_cast<uint32_t*>(x + row0 * w + c) =
            pack_bf16(acc[cb][4 * j] * mul, acc[cb][4 * j + 1] * mul);
        *reinterpret_cast<uint32_t*>(x + (row0 + 8) * w + c) =
            pack_bf16(acc[cb][4 * j + 2] * mul, acc[cb][4 * j + 3] * mul);
      }
    }
}

// rowsum(a * b) over this thread's quarter of a row of w bfloat16 (16-byte
// chunks t, t + 4, ...), summed over the row's four lanes
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, const __nv_bfloat16* b, int w,
                                         int t) {
  float sum = 0.f;
  for (int c = 8 * t; c < w; c += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum = fmaf(bf16_lo(xs[i]), bf16_lo(ys[i]), sum);
      sum = fmaf(bf16_hi(xs[i]), bf16_hi(ys[i]), sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  return sum;
}

// ---------------------------------------------------------------------------
// K2b: dq and delta
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-query tile); CB 64-column blocks of d and dv.
template <int CB>
__global__ void __launch_bounds__(kThreads, 2)
dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ out,
               const float* __restrict__ lse, const int* __restrict__ key_valid,
               __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int s, int d, int dv,
               int start, int end, float scale, Dropout dr) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int n_tiles = s / kRows;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const size_t base = static_cast<size_t>(bh) * s;

  // the key tiles that overlap [q0 + start, q0 + 63 + end] and hold a valid
  // key; none when every row of the tile is dead
  const bool any =
      __syncthreads_or(threadIdx.x < kRows && lse[base + q0 + threadIdx.x] > -INFINITY);
  const Sources src = {&tm_q, &tm_do, &tm_k, &tm_v, key_valid, nullptr, q0, bh, base};
  setup<CB>(sm, src, max(0, q0 + start) / kRows, min(s - 1, q0 + kRows - 1 + end) / kRows, any,
            [&](int j) { return key_valid[base + j] != 0; });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int own0 = q0 + warp * 16;  // this warp's first query
  const size_t row0 = base + own0 + g, row1 = row0 + 8;

  // delta = rowsum(dout * out) of rows own0 + g and own0 + g + 8; written
  // for K2c, dead rows included
  const float row_delta[2] = {row_dot(dout + row0 * dv, out + row0 * dv, dv, t),
                              row_dot(dout + row1 * dv, out + row1 * dv, dv, t)};
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

  float acc[CB][32];  // dq
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    pin(acc[cb]);  // zeroed here, not sunk past the first products' issue
  }
  uint32_t frag[16];  // dS of the current tile, bfloat16

  // dS = a (drop(dP) - delta): element e of chunk j is (query own0 + g + 8
  // (e / 2), key t0 + 8j + 2t + e % 2)
  const auto ds_tile = [&](auto drop, int t0, const int* valid, const float (&sc)[32],
                           const float (&dp)[32], bool all) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int2 ok2 = *reinterpret_cast<const int2*>(valid + c);
      const uint32_t col = (t0 + c) * 2246822519u;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = e & 1;
        const int rel = t0 + c + i - (own0 + g + 8 * h);
        const bool ok = live[h] && (i ? ok2.y : ok2.x) != 0 &&
                        (all || (rel >= start && rel <= end));
        const float a = ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse_log2[h])) : 0.f;
        float dpe = dp[4 * j + e];
        if constexpr (decltype(drop)::value)
          dpe = keep_mixed(row_hash[h] + col + i * 2246822519u, dr.thresh) ? dpe * inv_keep : 0.f;
        x[e] = a * (dpe - row_delta[h]);
      }
      to_frag(frag, j, x);
    }
  };
  const auto elementwise = [&](int t0, const uint8_t* rows, const float (&sc)[32],
                               const float (&dp)[32]) {
    bool any_pair, all;
    warp_band(true, own0, t0, start, end, any_pair, all);
    const int* valid = reinterpret_cast<const int*>(rows);
    if (!any_pair) {
#pragma unroll
      for (int i = 0; i < 16; ++i) frag[i] = 0u;
    } else if (dr.on) {
      ds_tile(std::true_type(), t0, valid, sc, dp, all);
    } else {
      ds_tile(std::false_type(), t0, valid, sc, dp, all);
    }
  };
  // dq += dS k: B the tile's keys (rows) by d (N-contiguous)
  const auto accumulate = [&](uint32_t tile) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        wgmma_rs(acc[cb], frag[4 * ks], frag[4 * ks + 1], frag[4 * ks + 2], frag[4 * ks + 3],
                 mnmajor_desc(tile, cb, ks));
    wgmma_commit();
  };
  consume<CB>(sm, src, any, elementwise, accumulate);
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) pin(acc[cb]);
  store_rows<CB>(dq, row0, d, acc, scale);
}

// ---------------------------------------------------------------------------
// K2c: dk and dv
// ---------------------------------------------------------------------------

// One CTA per (bh, 64-key tile); CB 64-column blocks of d and dv.
template <int CB>
__global__ void __launch_bounds__(kThreads, 2)
dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ key_valid, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv_out, int s, int d, int dv, int start, int end,
                float scale, Dropout dr) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int n_tiles = s / kRows;
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const size_t base = static_cast<size_t>(bh) * s;

  // the query tiles whose band covers a key of this tile and that hold a
  // row with finite lse; none when every key of the tile is invalid
  const bool any =
      __syncthreads_or(threadIdx.x < kRows && key_valid[base + k0 + threadIdx.x] != 0);
  const Sources src = {&tm_k, &tm_v, &tm_q, &tm_do, lse, delta, k0, bh, base};
  setup<CB>(sm, src, max(0, k0 - end) / kRows, min(s - 1, k0 + kRows - 1 - start) / kRows, any,
            [&](int j) { return lse[base + j] > -INFINITY; });
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

  float dk_acc[CB][32], dv_acc[CB][32];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[cb][i] = dv_acc[cb][i] = 0.f;
    pin(dk_acc[cb]);  // zeroed here, not sunk past the first products' issue
    pin(dv_acc[cb]);
  }
  uint32_t ds_frag[16], p_frag[16];  // dS^T and drop(P)^T of the current tile

  // element e of chunk j is (key own0 + g + 8 (e / 2), query t0 + 8j + 2t +
  // e % 2): dS^T = a (drop(dP^T) - delta) and drop(a)
  const auto tile_pass = [&](auto drop, int t0, const float* lse_t, const float* delta_t,
                             const float (&sc)[32], const float (&dp)[32], bool all) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + c);
      const uint32_t col = (t0 + c) * 2654435761u;
      float xs[4], xp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = e & 1;
        const int rel = own0 + g + 8 * h - (t0 + c + i);
        const float q_lse = i ? lse2.y : lse2.x;
        const bool ok = key_ok[h] && q_lse > -INFINITY && (all || (rel >= start && rel <= end));
        const float a = ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -q_lse * kLog2e)) : 0.f;
        float a_drop = a, dpe = dp[4 * j + e];
        if constexpr (decltype(drop)::value) {
          const bool kept = keep_mixed(row_hash[h] + col + i * 2654435761u, dr.thresh);
          a_drop = kept ? a * inv_keep : 0.f;
          dpe = kept ? dpe * inv_keep : 0.f;
        }
        xs[e] = a * (dpe - (i ? delta2.y : delta2.x));
        xp[e] = a_drop;
      }
      to_frag(ds_frag, j, xs);
      to_frag(p_frag, j, xp);
    }
  };
  const auto elementwise = [&](int t0, const uint8_t* rows, const float (&sc)[32],
                               const float (&dp)[32]) {
    bool any_pair, all;
    warp_band(false, own0, t0, start, end, any_pair, all);
    const float* lse_t = reinterpret_cast<const float*>(rows);
    if (!any_pair) {
#pragma unroll
      for (int i = 0; i < 16; ++i) ds_frag[i] = p_frag[i] = 0u;
    } else if (dr.on) {
      tile_pass(std::true_type(), t0, lse_t, lse_t + kRows, sc, dp, all);
    } else {
      tile_pass(std::false_type(), t0, lse_t, lse_t + kRows, sc, dp, all);
    }
  };
  // dv += drop(P)^T dout and dk += dS^T q: B the tile's queries (rows) by
  // dv or d (N-contiguous)
  const auto accumulate = [&](uint32_t tile) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        wgmma_rs(dv_acc[cb], p_frag[4 * ks], p_frag[4 * ks + 1], p_frag[4 * ks + 2],
                 p_frag[4 * ks + 3], mnmajor_desc(tile + Smem<CB>::kTile, cb, ks));
        wgmma_rs(dk_acc[cb], ds_frag[4 * ks], ds_frag[4 * ks + 1], ds_frag[4 * ks + 2],
                 ds_frag[4 * ks + 3], mnmajor_desc(tile, cb, ks));
      }
    wgmma_commit();
  };
  consume<CB>(sm, src, any, elementwise, accumulate);
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
    pin(dk_acc[cb]);
    pin(dv_acc[cb]);
  }
  store_rows<CB>(dk, row0, d, dk_acc, scale);
  store_rows<CB>(dv_out, row0, dv, dv_acc, 1.f);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a CTA may have

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// x [bh, s, w] bfloat16 as a tensor map of [64 rows, 64 columns] boxes,
// 128-byte swizzled; columns past w read as zeros
bool tile_map(CUtensorMap* map, const void* x, int bh, int s, int w) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 2,
                                 static_cast<cuuint64_t>(s) * w * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory attribute, which above 48 KB must be set.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

Dropout make_dropout(unsigned seed, unsigned thresh, float keep_prob, int on) {
  Dropout dr;
  dr.seed = seed;
  dr.thresh = thresh;
  dr.keep_prob = keep_prob;
  dr.on = on;
  return dr;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the shapes and operands the kernels take
bool bad_input(int bh, int s, int d, int dv, int start, int end,
               std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return true;
  return bh <= 0 || s <= 0 || s % kRows != 0 || d <= 0 || dv <= 0 || d % 8 != 0 ||
         dv % 8 != 0 || d > kMaxHeadDim || dv > kMaxHeadDim || start > 0 || end < 0;
}

template <int CB>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, const void* lse, const void* key_valid, void* dq,
                      void* delta, int bh, int s, int d, int dv, int start, int end, float scale,
                      Dropout dr, cudaStream_t stream) {
  // the runtime's call first: it makes the device's context current in this
  // thread (PyTorch's autograd runs a backward in a thread of its own), as
  // the driver's tensor map encoder needs
  const auto kernel = dq_sm90_kernel<CB>;
  const size_t smem = Smem<CB>::bytes(s);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map(&mq, q, bh, s, d) || !tile_map(&mk, k, bh, s, d) ||
      !tile_map(&mv, v, bh, s, dv) || !tile_map(&mdo, dout, bh, s, dv))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), static_cast<const float*>(lse),
      static_cast<const int*>(key_valid), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(delta), s, d, dv, start, end, scale, dr);
  return cudaGetLastError();
}

template <int CB>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* key_valid, void* dk,
                       void* dv_out, int bh, int s, int d, int dv, int start, int end,
                       float scale, Dropout dr, cudaStream_t stream) {
  // the runtime's call first: it makes the device's context current in this
  // thread (PyTorch's autograd runs a backward in a thread of its own), as
  // the driver's tensor map encoder needs
  const auto kernel = dkv_sm90_kernel<CB>;
  const size_t smem = Smem<CB>::bytes(s);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map(&mq, q, bh, s, d) || !tile_map(&mk, k, bh, s, d) ||
      !tile_map(&mv, v, bh, s, dv) || !tile_map(&mdo, dout, bh, s, dv))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(key_valid), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv_out), s, d, dv, start, end, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), the signatures of
// banded_attention_train.cu's float32 twins.  Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success); a shape or operand the kernels do not take returns
// cudaErrorInvalidValue.  `seed`, `thresh`, `keep_prob` and `dropout_on`
// describe the dropout mask; with dropout_on == 0 they are ignored.

// K2b: dq [BH, S, D] and delta = rowsum(dout * out) [BH, S], which K2c reads.
extern "C" int banded_attention_dq_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* out, const void* lse,
                                        const void* key_valid, void* dq, void* delta, int bh,
                                        int s, int d, int dv, int start, int end, float scale,
                                        unsigned seed, unsigned thresh, float keep_prob,
                                        int dropout_on, void* stream) {
  if (bad_input(bh, s, d, dv, start, end, {q, k, v, dout, out, lse, key_valid, dq, delta}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d > 64 || dv > 64
          ? launch_dq<2>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end,
                         scale, dr, st)
          : launch_dq<1>(q, k, v, dout, out, lse, key_valid, dq, delta, bh, s, d, dv, start, end,
                         scale, dr, st));
}

// K2c: dk [BH, S, D] and dv [BH, S, Dv].
extern "C" int banded_attention_dkv_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, const void* key_valid, void* dk,
                                         void* dv_out, int bh, int s, int d, int dv,
                                         int start, int end, float scale, unsigned seed,
                                         unsigned thresh, float keep_prob, int dropout_on,
                                         void* stream) {
  if (bad_input(bh, s, d, dv, start, end, {q, k, v, dout, lse, delta, key_valid, dk, dv_out}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d > 64 || dv > 64
          ? launch_dkv<2>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start,
                          end, scale, dr, st)
          : launch_dkv<1>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d, dv, start,
                          end, scale, dr, st));
}
