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
// Design (simple and correct first), K1's layout throughout: CTAs of 256
// threads, four consecutive threads per row, each holding a float4 share of
// the row's vectors and reducing dot products with two shuffles.
//  - K2a and K2b: one CTA per (bh, 64-query tile), looping over the 64-key
//    tiles that overlap [q0 + start, q0 + 63 + end]; K/V tiles in shared
//    memory.  K2a keeps a tile's 64 scores in registers (as K1 does); K2b
//    keeps q, dout, lse, delta and the dq accumulator per row.
//  - K2c: one CTA per (bh, 64-key tile) owning k, v and the dk/dv
//    accumulators of its rows, so no atomics; it loops over the query tiles
//    that overlap [k0 - end, k0 + 63 - start], staging q, dout, lse and delta
//    in shared memory.
//
// Bound on an H100 SXM at the training slice's shape (BH 200 = batch 100 x 2
// heads, S 504 padded to 512, d = dv = 64, band (-100, 0)), per kernel: the
// bytes (inputs read once, outputs written once) are 4 to 7 vectors of
// 200 x 512 x 64 float32, 26-46 MB, about 8-14 us at 3.35 TB/s; the
// operations are 4-8 x 64 float32 per in-band pair (about 8.5e6 pairs), about
// 2.2-4.4 GFLOP, 32-65 us at 67 TFLOP/s outside the tensor cores.  So each
// kernel is bound by its float32 operations.  These kernels run those on the
// CUDA cores over whole 64 x 64 tiles (about twice the in-band pairs) and
// hash the dropout mask per pair; the tensor-core redesign is a later PR.

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

// The JAX package's _dropout_keep: a lowbias32-style hash of (seed,
// batch-head, global query position, global key position); uint32 wraps.
__device__ __forceinline__ bool keep_bit(const Dropout& dr, uint32_t bh,
                                         uint32_t qpos, uint32_t kpos) {
  uint32_t x = qpos * 2654435761u + kpos * 2246822519u + bh * 3266489917u + dr.seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= dr.thresh;
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
// K2b: dq
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
          const float4* __restrict__ v, const float4* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ key_valid, float4* __restrict__ dq, int s, int d4,
          int dv4, int start, int end, float scale, Dropout dr) {
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
  float4 dor[R];
  float4 acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    qr[i] = g < d4 ? q[(base + qpos) * d4 + g] : zero4();
    dor[i] = g < dv4 ? dout[(base + qpos) * dv4 + g] : zero4();
    acc[i] = zero4();
  }
  const float row_lse = lse[base + qpos];
  const bool live = row_lse > -INFINITY;  // an empty row contributes nothing
  const float lse_safe = live ? row_lse : 0.f;
  const float row_delta = delta[base + qpos];

  const int k_lo = max(0, q0 + start);
  const int k_hi = min(s - 1, q0 + kBlock - 1 + end);
  for (int t0 = (k_lo / kBlock) * kBlock; t0 <= k_hi; t0 += kBlock) {
    __syncthreads();
    const float4* k_src = k + (base + t0) * d4;
    for (int i = threadIdx.x; i < kBlock * d4; i += kThreads) k_tile[i] = k_src[i];
    const float4* v_src = v + (base + t0) * dv4;
    for (int i = threadIdx.x; i < kBlock * dv4; i += kThreads) v_tile[i] = v_src[i];
    if (threadIdx.x < kBlock) valid_tile[threadIdx.x] = key_valid[base + t0 + threadIdx.x];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float sdot = 0.f;
      float pdot = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < d4) sdot = dot4(qr[i], k_tile[j * d4 + g], sdot);
        if (g < dv4) pdot = dot4(dor[i], v_tile[j * dv4 + g], pdot);
      }
      sdot = row_sum(sdot);
      pdot = row_sum(pdot);
      const int kpos = t0 + j;
      const int rel = kpos - qpos;
      const bool ok = live && rel >= start && rel <= end && valid_tile[j] != 0;
      const float a = ok ? expf(sdot * scale - lse_safe) : 0.f;
      float dp = pdot;
      if (dr.on) dp = keep_bit(dr, bh, qpos, kpos) ? pdot / dr.keep_prob : 0.f;
      const float ds = a * (dp - row_delta);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < d4) axpy4(acc[i], ds, k_tile[j * d4 + g]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    if (g < d4) dq[(base + qpos) * d4 + g] = scale4(acc[i], scale);
  }
}

// ---------------------------------------------------------------------------
// K2c: dk and dv
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
           const float4* __restrict__ v, const float4* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ key_valid, float4* __restrict__ dk,
           float4* __restrict__ dv, int s, int d4, int dv4, int start, int end,
           float scale, Dropout dr) {
  extern __shared__ float4 smem[];
  float4* q_tile = smem;                  // [kBlock][d4]
  float4* do_tile = smem + kBlock * d4;   // [kBlock][dv4]
  float* lse_tile = reinterpret_cast<float*>(do_tile + kBlock * dv4);
  float* delta_tile = lse_tile + kBlock;

  const int n_ktiles = s / kBlock;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kBlock;
  const int row = threadIdx.x / kTpr;
  const int sub = threadIdx.x % kTpr;
  const int kpos = k0 + row;
  const size_t base = static_cast<size_t>(bh) * s;

  float4 kr[R];
  float4 vr[R];
  float4 dk_acc[R];
  float4 dv_acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    kr[i] = g < d4 ? k[(base + kpos) * d4 + g] : zero4();
    vr[i] = g < dv4 ? v[(base + kpos) * dv4 + g] : zero4();
    dk_acc[i] = zero4();
    dv_acc[i] = zero4();
  }
  const bool key_ok = key_valid[base + kpos] != 0;

  // queries whose band [t + start, t + end] covers a key of this tile
  const int q_lo = max(0, k0 - end);
  const int q_hi = min(s - 1, k0 + kBlock - 1 - start);
  for (int t0 = (q_lo / kBlock) * kBlock; t0 <= q_hi; t0 += kBlock) {
    __syncthreads();
    const float4* q_src = q + (base + t0) * d4;
    for (int i = threadIdx.x; i < kBlock * d4; i += kThreads) q_tile[i] = q_src[i];
    const float4* do_src = dout + (base + t0) * dv4;
    for (int i = threadIdx.x; i < kBlock * dv4; i += kThreads) do_tile[i] = do_src[i];
    if (threadIdx.x < kBlock) {
      lse_tile[threadIdx.x] = lse[base + t0 + threadIdx.x];
      delta_tile[threadIdx.x] = delta[base + t0 + threadIdx.x];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float sdot = 0.f;
      float pdot = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < d4) sdot = dot4(q_tile[j * d4 + g], kr[i], sdot);
        if (g < dv4) pdot = dot4(do_tile[j * dv4 + g], vr[i], pdot);
      }
      sdot = row_sum(sdot);
      pdot = row_sum(pdot);
      const int qpos = t0 + j;
      const int rel = kpos - qpos;
      const float row_lse = lse_tile[j];
      const bool live = row_lse > -INFINITY;
      const bool ok = key_ok && live && rel >= start && rel <= end;
      const float a = ok ? expf(sdot * scale - (live ? row_lse : 0.f)) : 0.f;
      float a_drop = a;
      float dp = pdot;
      if (dr.on) {
        const bool kept = keep_bit(dr, bh, qpos, kpos);
        a_drop = kept ? a / dr.keep_prob : 0.f;
        dp = kept ? pdot / dr.keep_prob : 0.f;
      }
      const float ds = a * (dp - delta_tile[j]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < dv4) axpy4(dv_acc[i], a_drop, do_tile[j * dv4 + g]);
        if (g < d4) axpy4(dk_acc[i], ds, q_tile[j * d4 + g]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    if (g < d4) dk[(base + kpos) * d4 + g] = scale4(dk_acc[i], scale);
    if (g < dv4) dv[(base + kpos) * dv4 + g] = dv_acc[i];
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

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

template <int R>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* key_valid, void* dq,
                      int bh, int s, int d4, int dv4, int start, int end, float scale,
                      Dropout dr, cudaStream_t stream) {
  const size_t smem = tile_smem(d4, dv4, kBlock * sizeof(int));
  cudaError_t err = allow_smem(dq_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dq_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<const float4*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(key_valid), static_cast<float4*>(dq), s, d4, dv4, start,
      end, scale, dr);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* key_valid, void* dk,
                       void* dv, int bh, int s, int d4, int dv4, int start, int end,
                       float scale, Dropout dr, cudaStream_t stream) {
  const size_t smem = tile_smem(d4, dv4, 2 * kBlock * sizeof(float));
  cudaError_t err = allow_smem(dkv_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  dkv_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<const float4*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(key_valid), static_cast<float4*>(dk),
      static_cast<float4*>(dv), s, d4, dv4, start, end, scale, dr);
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

extern "C" int banded_attention_dq_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* key_valid, void* dq, int bh, int s, int d,
                                       int dv, int start, int end, float scale,
                                       unsigned seed, unsigned thresh, float keep_prob,
                                       int dropout_on, void* stream) {
  if (bad_shape(bh, s, d, dv, start, end)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr = make_dropout(seed, thresh, keep_prob, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d4 = d / 4, dv4 = dv / 4;
  switch (groups_for(d, dv)) {
    case 1: return launch_dq<1>(q, k, v, dout, lse, delta, key_valid, dq, bh, s, d4, dv4, start, end, scale, dr, st);
    case 2: return launch_dq<2>(q, k, v, dout, lse, delta, key_valid, dq, bh, s, d4, dv4, start, end, scale, dr, st);
    case 4: return launch_dq<4>(q, k, v, dout, lse, delta, key_valid, dq, bh, s, d4, dv4, start, end, scale, dr, st);
    default: return launch_dq<8>(q, k, v, dout, lse, delta, key_valid, dq, bh, s, d4, dv4, start, end, scale, dr, st);
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
  const int d4 = d / 4, dv4 = dv / 4;
  switch (groups_for(d, dv)) {
    case 1: return launch_dkv<1>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d4, dv4, start, end, scale, dr, st);
    case 2: return launch_dkv<2>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d4, dv4, start, end, scale, dr, st);
    case 4: return launch_dkv<4>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d4, dv4, start, end, scale, dr, st);
    default: return launch_dkv<8>(q, k, v, dout, lse, delta, key_valid, dk, dv_out, bh, s, d4, dv4, start, end, scale, dr, st);
  }
}
