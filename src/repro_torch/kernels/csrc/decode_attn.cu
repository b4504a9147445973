// Single-query flash-decode attention over the contiguous slot KV arena,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/decode_attn.py::_kernel` (launched
// by `decode_attn_pallas` through `pl.pallas_call`). For each slot b and KV
// head h it computes, for the g = H / KVh query heads that share h,
//
//   o = softmax(q k^T / sqrt(dh), masked to rows < n_valid) v,
//   n_valid = min(pos[b] + 1, S),
//
// and writes f32 (B, KVh, g, dh).
//
// What bounds it: the bytes of the valid K and V rows, read once per step:
// sum_b n_valid_b * KVh * dh * 2 (K and V) * itemsize. There are ~4 FLOPs
// per byte, far below the card's ratio, so HBM bandwidth is the roofline.
//
// What the design does about it:
// - One block per (b, h); all g query heads of that KV head are handled in
//   the block, so each K/V row is read from HBM once, not once per head.
// - The arena is walked in chunks of 64 rows with an online softmax: a
//   running max m and denominator l per query head, and the output rescaled
//   by expf(m_prev - m_new), so no S-long score row is ever materialized.
// - Chunks that start at or past n_valid are never visited; columns past
//   n_valid inside the last chunk are masked to -1e30 and get probability 0.
// - Latency hiding inside the block: a warp scores 4 rows per pass (a lane
//   has 4 independent K loads in flight), the chunk's max and sum are warp
//   reductions, and the P.V loop over a chunk's rows is unrolled by 8.
// - K and V are read through strides, so the kernel takes a per-layer view
//   of the stacked (L, B, S, KVh, dh) cache without a copy.
// Known limit, the first thing a later PR fixes: the grid is only B * KVh
// blocks (32-64 at full width) on 132 SMs, so most SMs idle; split S across
// blocks and combine the partial (m, l, o) in a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one thread per output column of dh
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // arena rows per online-softmax step
constexpr int kRowsPerPass = 4; // K rows a warp scores per pass
constexpr int kGMax = 8;        // query heads per KV head
constexpr int kDhMax = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid (KVh, B), block 128.
template <typename KT>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int32_t* __restrict__ pos,
                   float* __restrict__ out, int S, int KVh, int g, int dh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   float scale) {
  __shared__ float qs[kGMax][kDhMax];
  __shared__ float ps[kGMax][kChunk];   // scores, then probabilities
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_valid = min(pos[b] + 1, S);

  const float* qb = q + ((long long)b * KVh + h) * g * dh;
  for (int i = tid; i < g * dh; i += kThreads) qs[i / dh][i % dh] = qb[i];
  if (tid < g) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }
  const KT* kb = k + b * k_sb + h * k_sh;
  const KT* vb = v + b * v_sb + h * v_sh;

  float o[kGMax];
#pragma unroll
  for (int j = 0; j < kGMax; ++j) o[j] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
    const int rows = min(kChunk, n_valid - c0);
    // scores: each warp takes kRowsPerPass rows at a time, lanes split dh,
    // so a lane has kRowsPerPass independent K loads in flight
    for (int r0 = warp * kRowsPerPass; r0 < kChunk;
         r0 += kWarps * kRowsPerPass) {
      float acc[kRowsPerPass][kGMax];
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
#pragma unroll
        for (int j = 0; j < kGMax; ++j) acc[u][j] = 0.f;
      for (int d = lane; d < dh; d += 32) {
        float kv[kRowsPerPass];
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u)
          kv[u] = r0 + u < rows ? to_f32(kb[(c0 + r0 + u) * k_ss + d]) : 0.f;
#pragma unroll
        for (int j = 0; j < kGMax; ++j) {
          if (j >= g) continue;
          const float qv = qs[j][d];
#pragma unroll
          for (int u = 0; u < kRowsPerPass; ++u)
            acc[u][j] = fmaf(qv, kv[u], acc[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
#pragma unroll
        for (int j = 0; j < kGMax; ++j) {
          if (j >= g) continue;
          float s = acc[u][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) ps[j][r0 + u] = r0 + u < rows ? s * scale : kNegInf;
        }
    }
    __syncthreads();
    // online softmax, one warp per query head: rescale by exp(m_prev - m_new)
    for (int j = warp; j < g; j += kWarps) {
      float mx = fmaxf(ps[j][lane], ps[j][lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(ps[j][lane] - m_new);
      const float p1 = expf(ps[j][lane + 32] - m_new);
      ps[j][lane] = p0;
      ps[j][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[j] = alpha;
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + sum;
      }
    }
    __syncthreads();
    if (tid < dh) {
#pragma unroll
      for (int j = 0; j < kGMax; ++j)
        if (j < g) o[j] *= alpha_s[j];
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const float vv = to_f32(vb[(c0 + r) * v_ss + tid]);
#pragma unroll
        for (int j = 0; j < kGMax; ++j)
          if (j < g) o[j] = fmaf(ps[j][r], vv, o[j]);
      }
    }
    __syncthreads();
  }

  if (tid < dh) {
    float* ob = out + ((long long)b * KVh + h) * g * dh;
#pragma unroll
    for (int j = 0; j < kGMax; ++j)
      if (j < g) ob[j * dh + tid] = o[j] / fmaxf(l_s[j], 1e-30f);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q is (B, KVh, g, dh)
// f32 contiguous; k/v are (B, S, KVh, dh) with the given element strides
// for b, s and h and unit stride on dh; kv_dtype 0 = f32, 1 = bf16;
// pos is (B,) int32; out is (B, KVh, g, dh) f32. Requires g <= 8 and
// dh <= 128.
extern "C" int repro_decode_attn(const float* q, const void* k, const void* v,
                                 int kv_dtype, const int32_t* pos, float* out,
                                 int B, int S, int KVh, int g, int dh,
                                 long long k_sb, long long k_ss,
                                 long long k_sh, long long v_sb,
                                 long long v_ss, long long v_sh, float scale,
                                 void* stream) {
  if (g > kGMax || dh > kDhMax || g < 1 || dh < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(KVh, B);
  if (kv_dtype == 0) {
    decode_attn_kernel<float><<<grid, kThreads, 0, st>>>(
        q, static_cast<const float*>(k), static_cast<const float*>(v), pos,
        out, S, KVh, g, dh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  } else if (kv_dtype == 1) {
    decode_attn_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        q, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pos, out, S, KVh, g, dh, k_sb,
        k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
