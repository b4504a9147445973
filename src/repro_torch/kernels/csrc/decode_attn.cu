// Single-query flash-decode attention for Hopper (sm_90a), over the
// contiguous slot KV arena and over the paged KV pool.
//
// Replaces two TPU kernels, both launched through `pl.pallas_call`:
// - `repro/kernels/decode_attn.py::_kernel` (`decode_attn_pallas`), over the
//   contiguous arena: row r of slot b is k[b, r];
// - `repro/kernels/decode_attn.py::_paged_kernel`
//   (`paged_decode_attn_pallas`), over shared page pools: row r of slot b is
//   pool[table[b, r / P], r % P], and int8 or int4 pages are decoded right
//   after the load (`_page_dequant`), times the row's scale.
// For each slot b and KV head h both compute, for the g = H / KVh query
// heads that share h,
//
//   o = softmax(q k^T / sqrt(dh), masked to rows < n_valid) v,
//   n_valid = min(pos[b] + 1, S),
//
// and write f32 (B, KVh, g, dh). S is the arena length (contiguous) or the
// logical arena length seq_len (paged).
//
// What bounds it: the bytes of the valid K and V rows (codes and scales when
// quantized), read once per step. There are ~4 FLOPs per byte, far below
// the card's ratio, so HBM bandwidth is the roofline.
//
// What the design does about it:
// - One block per (b, h); all g query heads of that KV head are handled in
//   the block, so each K/V row is read from HBM once, not once per head.
// - The rows are walked in chunks of 64 with an online softmax: a running
//   max m and denominator l per query head, and the output rescaled by
//   expf(m_prev - m_new), so no S-long score row is ever materialized.
// - Chunks that start at or past n_valid are never visited; columns past
//   n_valid inside the last chunk are masked to -1e30 and get probability 0.
// - Latency hiding inside the block: a warp scores 4 rows per pass (a lane
//   has 4 independent K loads in flight), the chunk's max and sum are warp
//   reductions, and the P.V loop over a chunk's rows is unrolled by 8.
// - One kernel body serves both arenas: only the row address (and the
//   decode of a quantized row) differs, through the `Src` policy. The
//   arithmetic and its order are the same code, so on f32 or bf16 pages the
//   paged kernel's output is bitwise the contiguous kernel's on the gathered
//   view, which makes paged engine tokens equal contiguous engine tokens.
//   A chunk may span several pages (P = 16 < 64): at the start of each
//   chunk the block resolves its 64 rows' physical addresses (and scales)
//   through the page table once, into shared memory.
// - The contiguous arena is read through strides, so the kernel takes a
//   per-layer view of the stacked (L, B, S, KVh, dh) cache without a copy.
// Known limit, the first thing a later PR fixes: the grid is only B * KVh
// blocks (32-64 at full width) on 132 SMs, so most SMs idle; split S across
// blocks and combine the partial (m, l, o) in a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one thread per output column of dh
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // rows per online-softmax step
constexpr int kRowsPerPass = 4; // K rows a warp scores per pass
constexpr int kGMax = 8;        // query heads per KV head
constexpr int kDhMax = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One K or V row, read column by column as f32; `make` builds it from the
// row's first element and its scale (unused for f32 and bf16 rows).
template <typename T>
struct DenseRow {
  using Elem = T;
  const T* p;
  static __device__ __forceinline__ DenseRow make(const T* p, float) {
    return {p};
  }
  __device__ __forceinline__ float at(int d) const { return to_f32(p[d]); }
};

struct Int8Row {     // codes times the row's scale
  using Elem = int8_t;
  const int8_t* p;
  float s;
  static __device__ __forceinline__ Int8Row make(const int8_t* p, float s) {
    return {p, s};
  }
  __device__ __forceinline__ float at(int d) const {
    return static_cast<float>(p[d]) * s;
  }
};

struct Int4Row {     // two codes per byte, low nibble first, sign-extended
  using Elem = int8_t;
  const int8_t* p;
  float s;
  static __device__ __forceinline__ Int4Row make(const int8_t* p, float s) {
    return {p, s};
  }
  __device__ __forceinline__ float at(int d) const {
    const int byte = p[d >> 1];
    const int nib = (d & 1) ? (byte >> 4) : (((byte & 0xF) ^ 8) - 8);
    return static_cast<float>(nib) * s;
  }
};

// The contiguous arena: (B, S, KVh, dh) K and V with element strides.
template <typename T>
struct ContiguousSrc {
  using Row = DenseRow<T>;
  static constexpr bool kPerChunk = false;
  struct Chunk {};
  const T* k;
  const T* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;

  __device__ void resolve(Chunk&, int, int, int) const {}
  __device__ __forceinline__ Row krow(const Chunk&, int b, int h, int c0,
                                      int r) const {
    return {k + b * k_sb + (long long)(c0 + r) * k_ss + h * k_sh};
  }
  __device__ __forceinline__ Row vrow(const Chunk&, int b, int h, int c0,
                                      int r) const {
    return {v + b * v_sb + (long long)(c0 + r) * v_ss + h * v_sh};
  }
};

// The paged pool: contiguous (n_pages, P, KVh, dhs) K and V pools, a (B, Lp)
// page table and, for quantized rows, (n_pages, P, KVh) f32 scales. `R` is
// DenseRow<T> (dhs = dh), Int8Row (dhs = dh) or Int4Row (dhs = dh / 2).
template <typename R>
struct PagedSrc {
  using Row = R;
  using E = typename R::Elem;
  static constexpr bool kPerChunk = true;
  struct Chunk {
    long long row[kChunk];   // physical row: page * P + r % P
    float ks[kChunk], vs[kChunk];
  };
  const E* k;
  const E* v;
  const float* k_scale;      // null for f32/bf16 pages
  const float* v_scale;
  const int32_t* table;
  int Lp, P, KVh, dhs;

  // threads 0..63 resolve the chunk's rows through the page table; a row
  // past the table (only past n_valid, never read) clamps to its last page
  __device__ void resolve(Chunk& c, int b, int h, int c0) const {
    const int t = threadIdx.x;
    if (t < kChunk) {
      const int r = c0 + t;
      const int lp = min(r / P, Lp - 1);
      const long long row = (long long)table[(long long)b * Lp + lp] * P
                            + r % P;
      c.row[t] = row;
      if (k_scale != nullptr) {
        c.ks[t] = k_scale[row * KVh + h];
        c.vs[t] = v_scale[row * KVh + h];
      }
    }
  }
  __device__ __forceinline__ Row krow(const Chunk& c, int, int h, int,
                                      int r) const {
    return Row::make(k + (c.row[r] * KVh + h) * dhs, c.ks[r]);
  }
  __device__ __forceinline__ Row vrow(const Chunk& c, int, int h, int,
                                      int r) const {
    return Row::make(v + (c.row[r] * KVh + h) * dhs, c.vs[r]);
  }
};

// grid (KVh, B), block 128.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const Src src,
                    const int32_t* __restrict__ pos, float* __restrict__ out,
                    int S, int KVh, int g, int dh, float scale) {
  __shared__ float qs[kGMax][kDhMax];
  __shared__ float ps[kGMax][kChunk];   // scores, then probabilities
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  __shared__ typename Src::Chunk chunk;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_valid = min(pos[b] + 1, S);

  const float* qb = q + ((long long)b * KVh + h) * g * dh;
  for (int i = tid; i < g * dh; i += kThreads) qs[i / dh][i % dh] = qb[i];
  if (tid < g) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }

  float o[kGMax];
#pragma unroll
  for (int j = 0; j < kGMax; ++j) o[j] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
    const int rows = min(kChunk, n_valid - c0);
    if constexpr (Src::kPerChunk) {
      src.resolve(chunk, b, h, c0);
      __syncthreads();
    }
    // scores: each warp takes kRowsPerPass rows at a time, lanes split dh,
    // so a lane has kRowsPerPass independent K loads in flight
    for (int r0 = warp * kRowsPerPass; r0 < kChunk;
         r0 += kWarps * kRowsPerPass) {
      float acc[kRowsPerPass][kGMax];
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
#pragma unroll
        for (int j = 0; j < kGMax; ++j) acc[u][j] = 0.f;
      typename Src::Row kr[kRowsPerPass];
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
        kr[u] = src.krow(chunk, b, h, c0, min(r0 + u, rows - 1));
      for (int d = lane; d < dh; d += 32) {
        float kv[kRowsPerPass];
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u)
          kv[u] = r0 + u < rows ? kr[u].at(d) : 0.f;
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
        const float vv = src.vrow(chunk, b, h, c0, r).at(tid);
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

template <typename Src>
int launch(const Src& src, const float* q, const int32_t* pos, float* out,
           int B, int S, int KVh, int g, int dh, float scale, void* stream) {
  dim3 grid(KVh, B);
  flash_decode_kernel<Src><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, src, pos, out, S, KVh, g, dh, scale);
  return cudaGetLastError();
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
  if (kv_dtype == 0) {
    ContiguousSrc<float> src{static_cast<const float*>(k),
                             static_cast<const float*>(v),
                             k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    return launch(src, q, pos, out, B, S, KVh, g, dh, scale, stream);
  }
  if (kv_dtype == 1) {
    ContiguousSrc<__nv_bfloat16> src{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    return launch(src, q, pos, out, B, S, KVh, g, dh, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// Returns the cudaError_t of the launch (0 on success). q is (B, KVh, g, dh)
// f32 contiguous; kpool/vpool are contiguous (n_pages, P, KVh, dhs) pools:
// kind 0 = f32 and 1 = bf16 rows (dhs = dh), 2 = int8 codes (dhs = dh),
// 3 = int4 nibble pairs (dhs = dh / 2); k_scale/v_scale are contiguous
// (n_pages, P, KVh) f32 for kinds 2 and 3 (ignored otherwise); table is the
// contiguous (B, Lp) int32 page table with every entry < n_pages; pos is
// (B,) int32; seq_len <= Lp * P; out is (B, KVh, g, dh) f32. Requires
// g <= 8 and dh <= 128.
extern "C" int repro_paged_decode_attn(
    const float* q, const void* kpool, const void* vpool,
    const float* k_scale, const float* v_scale, int kind,
    const int32_t* table, const int32_t* pos, float* out, int B, int KVh,
    int g, int dh, int P, int Lp, int seq_len, float scale, void* stream) {
  if (g > kGMax || dh > kDhMax || g < 1 || dh < 1 || P < 1 ||
      (long long)Lp * P < seq_len)
    return cudaErrorInvalidValue;
  const int32_t* t = table;
  if (kind == 0) {
    PagedSrc<DenseRow<float>> src{
        static_cast<const float*>(kpool), static_cast<const float*>(vpool),
        nullptr, nullptr, t, Lp, P, KVh, dh};
    return launch(src, q, pos, out, B, seq_len, KVh, g, dh, scale, stream);
  }
  if (kind == 1) {
    PagedSrc<DenseRow<__nv_bfloat16>> src{
        static_cast<const __nv_bfloat16*>(kpool),
        static_cast<const __nv_bfloat16*>(vpool), nullptr, nullptr, t, Lp, P,
        KVh, dh};
    return launch(src, q, pos, out, B, seq_len, KVh, g, dh, scale, stream);
  }
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (kind == 2) {
    PagedSrc<Int8Row> src{
        static_cast<const int8_t*>(kpool), static_cast<const int8_t*>(vpool),
        k_scale, v_scale, t, Lp, P, KVh, dh};
    return launch(src, q, pos, out, B, seq_len, KVh, g, dh, scale, stream);
  }
  if (kind == 3) {
    if (dh % 2) return cudaErrorInvalidValue;
    PagedSrc<Int4Row> src{
        static_cast<const int8_t*>(kpool), static_cast<const int8_t*>(vpool),
        k_scale, v_scale, t, Lp, P, KVh, dh / 2};
    return launch(src, q, pos, out, B, seq_len, KVh, g, dh, scale, stream);
  }
  return cudaErrorInvalidValue;
}
