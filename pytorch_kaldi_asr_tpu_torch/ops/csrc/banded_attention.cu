// Banded (time-restricted) attention forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of the JAX package:
//   pytorch_kaldi_asr_tpu/ops/banded_attention.py :: banded_attention_pallas
//   (Pallas kernel `_kernel`), used by banded-encoder inference.
//
// Computes, for every batch-head b and query t,
//   out[b, t] = softmax_k(scale * q[b, t] . k[b, k]) @ v[b, :]
// over the keys k in [t + start, t + end] with key_valid[b, k] != 0; a query
// with no such key gets exact zeros.  Softmax statistics and accumulation are
// float32, online over key tiles exactly as the Pallas kernel's m/l/acc
// scratch: m_safe = 0 while the running max is -inf, alpha = 0 from an empty
// running state, and the final division guards a zero denominator.
//
// Layout: q, k [BH, S, D], v [BH, S, Dv], key_valid [BH, S] int32, out
// [BH, S, Dv], all contiguous.  S is a multiple of 64 (the wrapper pads with
// invalid keys); D and Dv are multiples of 4, at most 128.
//
// Design (simple and correct first): one CTA of 256 threads per (bh, 64-query
// tile); four consecutive threads own one query row and split its head
// dimension in float4 groups, reducing dot products with two shuffles.  The
// CTA loops over only the 64-key tiles that overlap [q0 + start, q0 + 63 + end]
// within [0, S); each K/V tile is staged in shared memory and its 64 scores
// per row are kept in registers, so the running max and the rescale happen
// once per tile, not per key.
//
// Bound on an H100 SXM at the slice's shapes (BH 16 = 8 utterances x 2 heads,
// S 500, d = dv = 64, band (-100, 0)):
//   bytes: q + k + v + out = 4 x 16 x 500 x 64 x 4 B = 8.2 MB, at 3.35 TB/s
//          about 2.4 us;
//   operations: about 7.3e5 in-band (q, k) pairs x 4 x 64 = 0.19 GFLOP, at
//          67 TFLOP/s float32 outside the tensor cores about 2.8 us;
//   so about 3 us, bound by the float32 operations; 16 x 8 = 128 CTAs fill
//   one wave on the 132 SMs.
// This kernel does its dot products on the CUDA cores and evaluates whole
// 64 x 64 tiles (about twice the in-band pairs), so it sits well above that
// bound.  A later PR moves QK^T and PV onto the tensor cores (TF32 or bf16
// mma/wgmma with TMA-fed K/V tiles) and skips the out-of-band tile halves.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 64;               // queries per CTA = keys per tile
constexpr int kTpr = 4;                  // threads per query row
constexpr int kThreads = kBlock * kTpr;  // 256
constexpr int kMaxHeadDim = 128;

// R = float4 groups of the head dimension each thread holds (d and dv).
template <int R>
__global__ void __launch_bounds__(kThreads)
banded_attention_kernel(const float4* __restrict__ q,
                        const float4* __restrict__ k,
                        const float4* __restrict__ v,
                        const int* __restrict__ key_valid,
                        float4* __restrict__ out, int s, int d4, int dv4,
                        int start, int end, float scale) {
  extern __shared__ float4 smem[];
  float4* k_tile = smem;                 // [kBlock][d4]
  float4* v_tile = smem + kBlock * d4;   // [kBlock][dv4]
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
    qr[i] = g < d4 ? q[(base + qpos) * d4 + g] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;  // running max of the row's scores
  float l = 0.f;        // running softmax denominator

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
        if (g < d4) {
          const float4 kk = k_tile[j * d4 + g];
          part = fmaf(qr[i].x, kk.x, part);
          part = fmaf(qr[i].y, kk.y, part);
          part = fmaf(qr[i].z, kk.z, part);
          part = fmaf(qr[i].w, kk.w, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
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
    for (int i = 0; i < R; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      const float p = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m_safe);
      l += p;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int g = sub + i * kTpr;
        if (g < dv4) {
          const float4 vv = v_tile[j * dv4 + g];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
    m = m_new;
  }

  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = sub + i * kTpr;
    if (g < dv4) {
      out[(base + qpos) * dv4 + g] = make_float4(acc[i].x / denom, acc[i].y / denom,
                                                 acc[i].z / denom, acc[i].w / denom);
    }
  }
}

template <int R>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid,
                   void* out, int bh, int s, int d4, int dv4, int start, int end,
                   float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlock) * (d4 + dv4) * sizeof(float4) +
                      kBlock * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(banded_attention_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(bh) * static_cast<unsigned>(s / kBlock));
  banded_attention_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<const int*>(key_valid),
      static_cast<float4*>(out), s, d4, dv4, start, end, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int banded_attention_f32(const void* q, const void* k, const void* v,
                                    const void* key_valid, void* out, int bh, int s,
                                    int d, int dv, int start, int end, float scale,
                                    void* stream) {
  if (bh <= 0 || s <= 0 || s % kBlock != 0 || d % 4 != 0 || dv % 4 != 0 || d <= 0 ||
      dv <= 0 || d > kMaxHeadDim || dv > kMaxHeadDim || start > 0 || end < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d4 = d / 4;
  const int dv4 = dv / 4;
  const int groups_d = (d4 + kTpr - 1) / kTpr;
  const int groups_dv = (dv4 + kTpr - 1) / kTpr;
  const int groups = groups_d > groups_dv ? groups_d : groups_dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (groups <= 1) {
    err = launch<1>(q, k, v, key_valid, out, bh, s, d4, dv4, start, end, scale, st);
  } else if (groups <= 2) {
    err = launch<2>(q, k, v, key_valid, out, bh, s, d4, dv4, start, end, scale, st);
  } else if (groups <= 4) {
    err = launch<4>(q, k, v, key_valid, out, bh, s, d4, dv4, start, end, scale, st);
  } else {
    err = launch<8>(q, k, v, key_valid, out, bh, s, d4, dv4, start, end, scale, st);
  }
  return static_cast<int>(err);
}
