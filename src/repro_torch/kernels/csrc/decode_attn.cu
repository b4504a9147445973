// Split-rows flash-decode attention for Hopper (sm_90a), over the
// contiguous slot KV arena and over the paged KV pool.
//
// Replaces two TPU kernels, both launched through `pl.pallas_call`:
// - `repro/kernels/decode_attn.py::_kernel` (`decode_attn_pallas`), over the
//   contiguous arena: row r of slot b is k[b, r];
// - `repro/kernels/decode_attn.py::_paged_kernel`
//   (`paged_decode_attn_pallas`), over shared page pools: row r of slot b is
//   pool[table[b, r / P], r % P], and int8 or int4 pages are decoded after
//   the load (`_page_dequant`), times the row's scale.
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
// quantized), read once per step: ~1 us at B = 4, S = 576. With g = 2 query
// rows there are ~2 FLOPs per byte, so an mma tile would be 1/8 full and
// tensor cores buy nothing: the scores and P.V are f32 FMAs. What held the
// single-pass design back was latency, not bandwidth: 32 blocks on 132 SMs,
// each walking its slot's rows chunk after chunk with one dependent HBM load
// round per few rows.
//
// What the design does about it:
// - Split the rows across blocks. The grid is (n_splits, KVh, B) with
//   n_splits = ceil(S / R) from the host's S (never from `pos`, which lives
//   on the device: reading it would sync every layer). Split c covers rows
//   [c R, min((c + 1) R, n_valid)); a block whose first row is at or past
//   n_valid returns at once. At B = 4 with pos {575, 0, 300, 63} and R = 64,
//   128 blocks do work: one wave.
// - Stage a split in shared memory with cp.async: every thread issues its
//   16-byte copies of the split's K rows (one commit group) and V rows (a
//   second) before the first wait, so all loads of the block are in flight
//   together; scoring waits only for K, so V lands while K is scored. The
//   paged source resolves each row's physical row through the page table
//   first (the per-row scales ride in the same groups as 4-byte copies).
// - Score from registers and shared memory: a lane holds 4 consecutive dh
//   columns of q for every query head, a warp scores its rows with one
//   vector read of shared memory per row (4 bf16, 4 int8 or 4 int4 codes
//   per read) and warp reductions. The split's softmax is local: max m,
//   sum l and unnormalized o = sum exp(s - m) v, written as f32 partials.
// - Combine deterministically: a second kernel over (KVh, B) reads splits
//   0 .. ceil(n_valid / R) - 1 in order, M = max m_i, w_i = exp(m_i - M),
//   out = sum w_i o_i / max(sum w_i l_i, 1e-30). No atomics; both launches
//   come from the one C entry, the combine as the split kernel's
//   programmatic dependent (Hopper), so its launch overlaps the split's
//   tail.
// - One kernel body serves both arenas through the `Src` policy; the split
//   plan depends only on S (or seq_len) and R, so on f32 or bf16 pages the
//   paged output is bitwise the contiguous kernel's on the gathered rows.
// - q is read as bf16 or f32 and pos as int32 or int64 (any stride), so the
//   caller converts neither.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;         // query heads per KV head
constexpr int kDhMax = 128;      // 32 lanes x 4 columns
constexpr int kRMax = 128;       // rows per split
constexpr int kRowsPerPass = 4;  // rows a warp scores per pass
constexpr int kCombineChunk = 256;    // splits per head the combine stages
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One piece of a row into shared memory: 16-byte pieces asynchronously,
// narrower ones (rows or strides that are not 16-byte aligned) by plain
// loads and stores.
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           int unit) {
  switch (unit) {
    case 16: cp_async16(dst, src); break;
    case 8: *reinterpret_cast<uint2*>(dst) =
                *reinterpret_cast<const uint2*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src); break;
    case 2: *reinterpret_cast<uint16_t*>(dst) =
                *reinterpret_cast<const uint16_t*>(src); break;
    default: *dst = *src;
  }
}

// Row formats: the bytes of one (row, head) and the decode of the 4
// consecutive columns 4c .. 4c + 3 from a row staged in shared memory.
struct F32Rows {
  static constexpr bool kScaled = false;
  static int row_bytes(int dh) { return dh * 4; }
  static __device__ __forceinline__ void dec4(const unsigned char* row,
                                              int c, float, float (&x)[4]) {
    const float4 w = reinterpret_cast<const float4*>(row)[c];
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  }
};

struct Bf16Rows {     // bf16 -> f32 is exact: the bits in the high half
  static constexpr bool kScaled = false;
  static int row_bytes(int dh) { return dh * 2; }
  static __device__ __forceinline__ void dec4(const unsigned char* row,
                                              int c, float, float (&x)[4]) {
    const uint2 w = reinterpret_cast<const uint2*>(row)[c];
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xFFFF0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xFFFF0000u);
  }
};

struct Int8Rows {     // codes times the row's scale
  static constexpr bool kScaled = true;
  static int row_bytes(int dh) { return dh; }
  static __device__ __forceinline__ void dec4(const unsigned char* row,
                                              int c, float s, float (&x)[4]) {
    const int w = reinterpret_cast<const int*>(row)[c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = static_cast<float>(
                 static_cast<int>(static_cast<uint32_t>(w) << (24 - 8 * i))
                 >> 24) * s;
  }
};

struct Int4Rows {     // two codes per byte, low nibble first, sign-extended
  static constexpr bool kScaled = true;
  static int row_bytes(int dh) { return dh / 2; }
  static __device__ __forceinline__ void dec4(const unsigned char* row,
                                              int c, float s, float (&x)[4]) {
    const int w = reinterpret_cast<const uint16_t*>(row)[c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = static_cast<float>((((w >> (4 * i)) & 0xF) ^ 8) - 8) * s;
  }
};

// The contiguous arena: (B, S, KVh, dh) K and V with byte strides.
struct ContiguousSrc {
  static constexpr bool kPaged = false;
  const unsigned char* k;
  const unsigned char* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;

  __device__ __forceinline__ const unsigned char* krow(
      const long long*, int b, int h, int row, int) const {
    return k + b * k_sb + row * k_ss + h * k_sh;
  }
  __device__ __forceinline__ const unsigned char* vrow(
      const long long*, int b, int h, int row, int) const {
    return v + b * v_sb + row * v_ss + h * v_sh;
  }
};

// The paged pool: contiguous (n_pages, P, KVh, dhs) K and V pools, a (B, Lp)
// page table and, for quantized rows, (n_pages, P, KVh) f32 scales.
struct PagedSrc {
  static constexpr bool kPaged = true;
  const unsigned char* k;
  const unsigned char* v;
  const float* k_scale;      // null for f32/bf16 pages
  const float* v_scale;
  const int32_t* table;
  int Lp, P, KVh;
  long long row_bytes;

  // the physical row of logical row `row`; a row past the table (only past
  // n_valid, never read) clamps to its last page
  __device__ __forceinline__ long long phys(int b, int row) const {
    const int lp = min(row / P, Lp - 1);
    return (long long)table[(long long)b * Lp + lp] * P + row % P;
  }
  __device__ __forceinline__ const unsigned char* krow(
      const long long* ph, int, int h, int, int r) const {
    return k + (ph[r] * KVh + h) * row_bytes;
  }
  __device__ __forceinline__ const unsigned char* vrow(
      const long long* ph, int, int h, int, int r) const {
    return v + (ph[r] * KVh + h) * row_bytes;
  }
  __device__ __forceinline__ const float* kscale(const long long* ph, int h,
                                                 int r) const {
    return k_scale + ph[r] * KVh + h;
  }
  __device__ __forceinline__ const float* vscale(const long long* ph, int h,
                                                 int r) const {
    return v_scale + ph[r] * KVh + h;
  }
};

__device__ __forceinline__ int valid_rows(const void* pos, int pos64,
                                          long long pos_stride, int b,
                                          int S) {
  const long long p =
      pos64 ? static_cast<const long long*>(pos)[b * pos_stride]
            : static_cast<const int32_t*>(pos)[b * pos_stride];
  return static_cast<int>(min(p + 1, static_cast<long long>(S)));
}

// Sums N values of each lane over the warp with N - 1 + log2(32 / N)
// shuffles, none of them under a branch: each xor step sends the half of
// the values a lane does not keep and adds the half it receives. Lane l
// ends with the sum of value l / (32 / N) over the 32 lanes.
template <int N>
__device__ __forceinline__ float warp_sum_transpose(float (&v)[N], int lane) {
#pragma unroll
  for (int half = N / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / N; off > 0; off /= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

// grid (n_splits, KVh, B), block 128; dynamic shared memory: the K and V
// tiles (R rows of `pitch` bytes each), then the warps' P.V sums (kWarps, g,
// dh) f32. Split c of (b, h) writes part[b, h, c, j, 0:dh] = o, [dh] = m,
// [dh + 1] = l.
// G is the query heads per KV head rounded up to 1, 2, 4 or 8 (g <= G), so
// the per-head loops unroll with no runtime guard around a shuffle.
template <typename Rows, typename Src, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const void* __restrict__ q, int q_bf16, const Src src,
                   const void* __restrict__ pos, int pos64,
                   long long pos_stride, float* __restrict__ part, int S,
                   int R, int n_splits, int KVh, int g, int dh, int row_bytes,
                   int pitch, int unit, float scale) {
  extern __shared__ __align__(16) unsigned char tiles[];
  __shared__ float ps[kGMax][kRMax];        // scores, then probabilities
  __shared__ long long phys_s[kRMax];
  __shared__ float ks_s[kRMax], vs_s[kRMax];
  __shared__ float m_s[kGMax], l_s[kGMax];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = split * R;
  // the combine pass may start now: it waits for this grid's partials
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  unsigned char* ktile = tiles;
  unsigned char* vtile = tiles + (size_t)R * pitch;
  float* red = reinterpret_cast<float*>(tiles + (size_t)2 * R * pitch);

  // q, the page table and pos have no dependence on each other: all three
  // loads are in flight together. This lane's 4 columns of q for every
  // query head stay in registers.
  const bool active = lane * 4 < dh;
  float qr[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = 0.f;
      if (active && j < g) {
        const long long i = ((long long)(b * KVh + h) * g + j) * dh
                            + lane * 4 + c;
        x = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[i])
                   : static_cast<const float*>(q)[i];
      }
      qr[j][c] = x;
    }
  }
  if constexpr (Src::kPaged)
    for (int r = tid; r < R; r += kThreads) phys_s[r] = src.phys(b, c0 + r);
  const int n_valid = valid_rows(pos, pos64, pos_stride, b, S);
  if (c0 >= n_valid) return;
  const int rows = min(R, n_valid - c0);
  if constexpr (Src::kPaged) __syncthreads();
  // every copy of the block in flight before the first wait: K (and its
  // scales) in group 1, V in group 2. Thread t copies pieces t, t + 128,
  // ... of the split's rows; (row, piece) advance without a division.
  const int pieces = row_bytes / unit;
  const int dr = kThreads / pieces, dc = kThreads % pieces;
  const int r_first = tid / pieces, c_first = tid % pieces;
  if constexpr (Rows::kScaled)
    for (int r = tid; r < rows; r += kThreads)
      cp_async4(&ks_s[r], src.kscale(phys_s, h, r));
  for (int r = r_first, c = c_first; r < rows;) {
    const unsigned char* from = src.krow(phys_s, b, h, c0 + r, r) + c * unit;
    unsigned char* to = ktile + r * pitch + c * unit;
    if (unit == 16) cp_async16(to, from);
    else copy_piece(to, from, unit);
    r += dr;
    c += dc;
    if (c >= pieces) { c -= pieces; ++r; }
  }
  cp_async_commit();
  if constexpr (Rows::kScaled)
    for (int r = tid; r < rows; r += kThreads)
      cp_async4(&vs_s[r], src.vscale(phys_s, h, r));
  for (int r = r_first, c = c_first; r < rows;) {
    const unsigned char* from = src.vrow(phys_s, b, h, c0 + r, r) + c * unit;
    unsigned char* to = vtile + r * pitch + c * unit;
    if (unit == 16) cp_async16(to, from);
    else copy_piece(to, from, unit);
    r += dr;
    c += dc;
    if (c >= pieces) { c -= pieces; ++r; }
  }
  cp_async_commit();

  cp_async_wait<1>();
  __syncthreads();
  // scores: a warp takes kRowsPerPass consecutive rows per pass; lane
  // l ends with score (u, j) = (i / G, i % G), i = l / (32 / N)
  constexpr int N = kRowsPerPass * G;
  for (int r0 = warp * kRowsPerPass; r0 < rows;
       r0 += kWarps * kRowsPerPass) {
    float acc[N];
#pragma unroll
    for (int u = 0; u < kRowsPerPass; ++u) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      const int r = r0 + u;
      if (active && r < rows)
        Rows::dec4(ktile + r * pitch, lane, Rows::kScaled ? ks_s[r] : 1.f,
                   x);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) a = fmaf(qr[j][c], x[c], a);
        acc[u * G + j] = a;
      }
    }
    const float sc = warp_sum_transpose<N>(acc, lane);
    const int i = lane / (32 / N), u = i / G, j = i % G;
    if (lane % (32 / N) == 0 && j < g && r0 + u < rows)
      ps[j][r0 + u] = sc * scale;
  }
  __syncthreads();
  // the split's softmax, one warp per query head
  for (int j = warp; j < g; j += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ps[j][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float p = expf(ps[j][r] - mx);
      ps[j][r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[j] = mx;
      l_s[j] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // P.V: warp w takes rows w, w + 4, ...; lane its 4 columns
  float o[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  if (active) {
#pragma unroll 4
    for (int r = warp; r < rows; r += kWarps) {
      float x[4];
      Rows::dec4(vtile + r * pitch, lane, Rows::kScaled ? vs_s[r] : 1.f, x);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float p = j < g ? ps[j][r] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) o[j][c] = fmaf(p, x[c], o[j][c]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g)
        *reinterpret_cast<float4*>(&red[(warp * g + j) * dh + lane * 4]) =
            make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  __syncthreads();
  // the warps' sums in a fixed order, then the partials
  float* pb = part + (((long long)b * KVh + h) * n_splits + split) * g
                     * (dh + 2);
  for (int i = tid; i < g * dh; i += kThreads) {
    const int j = i / dh, d = i - j * dh;
    float s = red[j * dh + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(w * g + j) * dh + d];
    pb[j * (dh + 2) + d] = s;
  }
  if (tid < g) {
    pb[tid * (dh + 2) + dh] = m_s[tid];
    pb[tid * (dh + 2) + dh + 1] = l_s[tid];
  }
}

// grid (KVh, B), block g * dh threads rounded up to a warp (thread
// t < g * dh owns output (t / dh, t % dh)), launched as the split kernel's
// programmatic dependent: its blocks start while the split kernel runs,
// read pos, and wait (griddepcontrol.wait) for the split kernel's
// partials. The ns = ceil(n_valid / R) splits of (b, h) hold rows; they
// are taken kCombineChunk at a time, in order. The first chunk's m and l
// are loaded all at once into shared memory. Then, per query head,
// M = max m_i over them and over the m of any later chunk (read from the
// partials), and w_i = exp(m_i - M) in place of m_i; the sums
// L = sum w_i l_i and O = sum w_i o_i run over i in order, chunk after
// chunk, unrolled so that the loads of several splits are in flight
// together. Any number of splits takes the same arithmetic in the same
// order.
__global__ void __launch_bounds__(kGMax * kDhMax)
flash_decode_combine(const float* __restrict__ part,
                     const void* __restrict__ pos, int pos64,
                     long long pos_stride, float* __restrict__ out, int S,
                     int R, int n_splits, int KVh, int g, int dh) {
  __shared__ float w_s[kGMax][kCombineChunk];    // m_i, then w_i
  __shared__ float l_s[kGMax][kCombineChunk];
  __shared__ float M_s[kGMax], L_s[kGMax];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nt = blockDim.x, nw = nt / 32;
  const int n_valid = valid_rows(pos, pos64, pos_stride, b, S);
  const int ns = n_valid > 0 ? (n_valid + R - 1) / R : 0;
  const long long step = (long long)g * (dh + 2);
  const float* pb = part + ((long long)b * KVh + h) * n_splits * step;
  // (m, l) of split i, query head j
  auto ml = [&](int i, int j) { return pb + i * step + j * (dh + 2) + dh; };
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int n0 = min(ns, kCombineChunk);
  for (int t = tid; t < 2 * g * n0; t += nt) {
    const int which = t / (g * n0), u = t - which * g * n0;
    const int j = u / n0, i = u - j * n0;
    (which ? l_s : w_s)[j][i] = ml(i, j)[which];
  }
  __syncthreads();
  for (int j = warp; j < g; j += nw) {
    float M = kNegInf;
    for (int i = lane; i < n0; i += 32) M = fmaxf(M, w_s[j][i]);
    for (int i = n0 + lane; i < ns; i += 32) M = fmaxf(M, ml(i, j)[0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    for (int i = lane; i < n0; i += 32) w_s[j][i] = expf(w_s[j][i] - M);
    __syncwarp();
    if (lane == 0) {
      float L = 0.f;
#pragma unroll 8
      for (int i = 0; i < n0; ++i) L = fmaf(w_s[j][i], l_s[j][i], L);
      M_s[j] = M;
      L_s[j] = L;
    }
  }
  const bool owner = tid < g * dh;
  const int j = tid / dh, d = tid - j * dh;
  float O = 0.f;
  for (int i0 = 0; i0 < ns; i0 += kCombineChunk) {
    const int n = min(kCombineChunk, ns - i0);
    __syncthreads();      // w and L of the chunk, or the last chunk spent
    if (i0 > 0) {
      for (int t = tid; t < g * n; t += nt) {
        const int jj = t / n, i = t - jj * n;
        const float* e = ml(i0 + i, jj);
        l_s[jj][i] = e[1];
        w_s[jj][i] = expf(e[0] - M_s[jj]);
      }
      __syncthreads();
      if (tid < g) {
        float L = L_s[tid];
        for (int i = 0; i < n; ++i) L = fmaf(w_s[tid][i], l_s[tid][i], L);
        L_s[tid] = L;
      }
    }
    if (owner) {
      const float* o = pb + i0 * step + j * (dh + 2) + d;
#pragma unroll 8
      for (int i = 0; i < n; ++i) O = fmaf(w_s[j][i], o[i * step], O);
    }
  }
  __syncthreads();
  if (owner)
    out[((long long)b * KVh + h) * g * dh + tid] = O / fmaxf(L_s[j], 1e-30f);
}

// The widest piece (16, 8, 4, 2 or 1 bytes) that divides every value.
int copy_unit(std::initializer_list<long long> values) {
  long long unit = 16;
  for (long long x : values)
    while (unit > 1 && x % unit != 0) unit /= 2;
  return static_cast<int>(unit);
}

struct Plan {
  const void* q;
  int q_bf16;
  const void* pos;
  int pos64;
  long long pos_stride;
  float* out;
  float* part;
  int B, S, R, n_splits, KVh, g, dh;
  float scale;
};

bool bad_plan(const Plan& p) {
  return p.g < 1 || p.g > kGMax || p.dh < 4 || p.dh > kDhMax || p.dh % 4
         || p.R < 1 || p.R > kRMax || p.S < 1 || p.B < 1 || p.KVh < 1
         || (long long)p.n_splits * p.R < p.S
         || (long long)(p.n_splits - 1) * p.R >= p.S;
}

// The split kernel's dynamic shared bytes: R rows of K and of V at a
// 16-byte pitch, then the warps' P.V sums.
int split_smem(int row_bytes, int R, int g, int dh) {
  const int pitch = (row_bytes + 15) / 16 * 16;
  return 2 * R * pitch + kWarps * g * dh * 4;
}

template <typename Kern>
int func_attributes(Kern kern, int dynamic, int* out) {
  cudaFuncAttributes a;
  const int err = cudaFuncGetAttributes(&a, kern);
  if (err != 0) return err;
  out[0] = static_cast<int>(a.sharedSizeBytes);
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  out[3] = dynamic;
  return 0;
}

template <typename Rows, typename Src, int G>
int launch(const Src& src, const Plan& p, int unit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_bytes = Rows::row_bytes(p.dh);
  const int pitch = (row_bytes + 15) / 16 * 16;
  const int smem = split_smem(row_bytes, p.R, p.g, p.dh);
  // a block may hold more than 48 KB of shared memory, static and dynamic
  // together, only after opting in (g = 6, dh = 128: 44 KB dynamic beside
  // the kernel's ~6 KB of static arrays)
  static int static_bytes = -1;
  if (static_bytes < 0) {
    cudaFuncAttributes fa;
    const int err = cudaFuncGetAttributes(&fa,
                                          flash_decode_split<Rows, Src, G>);
    if (err != 0) return err;
    static_bytes = (int)fa.sharedSizeBytes;
  }
  if (smem + static_bytes > 48 * 1024) {
    const int err = cudaFuncSetAttribute(
        flash_decode_split<Rows, Src, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
  }
  flash_decode_split<Rows, Src, G><<<dim3(p.n_splits, p.KVh, p.B),
                                     kThreads, smem, st>>>(
      p.q, p.q_bf16, src, p.pos, p.pos64, p.pos_stride, p.part, p.S, p.R,
      p.n_splits, p.KVh, p.g, p.dh, row_bytes, pitch, unit, p.scale);
  const int err = cudaGetLastError();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.KVh, p.B);
  cfg.blockDim = dim3((p.g * p.dh + 31) / 32 * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine,
                            static_cast<const float*>(p.part), p.pos,
                            p.pos64, p.pos_stride, p.out, p.S, p.R,
                            p.n_splits, p.KVh, p.g, p.dh);
}

template <typename Rows, typename Src>
int launch(const Src& src, const Plan& p, int unit, void* stream) {
  if (p.g <= 1) return launch<Rows, Src, 1>(src, p, unit, stream);
  if (p.g <= 2) return launch<Rows, Src, 2>(src, p, unit, stream);
  if (p.g <= 4) return launch<Rows, Src, 4>(src, p, unit, stream);
  return launch<Rows, Src, 8>(src, p, unit, stream);
}

// The split kernel `launch<Rows, Src>` picks for g, and its dynamic bytes
template <typename Rows, typename Src>
int split_attributes(int g, int dh, int R, int* out) {
  const int smem = split_smem(Rows::row_bytes(dh), R, g, dh);
  if (g <= 1)
    return func_attributes(flash_decode_split<Rows, Src, 1>, smem, out);
  if (g <= 2)
    return func_attributes(flash_decode_split<Rows, Src, 2>, smem, out);
  if (g <= 4)
    return func_attributes(flash_decode_split<Rows, Src, 4>, smem, out);
  return func_attributes(flash_decode_split<Rows, Src, 8>, smem, out);
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Both entries take
// q (B, KVh, g, dh) contiguous, bf16 (q_bf16 = 1) or f32; pos (B,) int64
// (pos64 = 1) or int32 with element stride pos_stride; out (B, KVh, g, dh)
// f32; part an f32 workspace of B * KVh * n_splits * g * (dh + 2), where
// n_splits = ceil(S / R) for R rows per split, 1 <= R <= 128. Require
// g <= 8, dh <= 128 and dh % 4 == 0.
//
// Contiguous arena: k/v (B, S, KVh, dh) with the given element strides for
// b, s and h and unit stride on dh; kv_dtype 0 = f32, 1 = bf16.
extern "C" int repro_decode_attn(const void* q, int q_bf16, const void* k,
                                 const void* v, int kv_dtype,
                                 const void* pos, int pos64,
                                 long long pos_stride, float* out,
                                 float* part, int B, int S, int KVh, int g,
                                 int dh, long long k_sb, long long k_ss,
                                 long long k_sh, long long v_sb,
                                 long long v_ss, long long v_sh, int R,
                                 int n_splits, float scale, void* stream) {
  const Plan p{q, q_bf16, pos, pos64, pos_stride, out, part, B, S, R,
               n_splits, KVh, g, dh, scale};
  if (bad_plan(p) || (kv_dtype != 0 && kv_dtype != 1))
    return cudaErrorInvalidValue;
  const long long e = kv_dtype == 0 ? 4 : 2;
  const ContiguousSrc src{static_cast<const unsigned char*>(k),
                          static_cast<const unsigned char*>(v),
                          k_sb * e, k_ss * e, k_sh * e,
                          v_sb * e, v_ss * e, v_sh * e};
  const int unit = copy_unit({dh * e, (long long)(uintptr_t)k,
                              (long long)(uintptr_t)v, src.k_sb, src.k_ss,
                              src.k_sh, src.v_sb, src.v_ss, src.v_sh});
  return kv_dtype == 0 ? launch<F32Rows>(src, p, unit, stream)
                       : launch<Bf16Rows>(src, p, unit, stream);
}

// Paged pool: kpool/vpool contiguous (n_pages, P, KVh, dhs): kind 0 = f32
// and 1 = bf16 rows (dhs = dh), 2 = int8 codes (dhs = dh), 3 = int4 nibble
// pairs (dhs = dh / 2); k_scale/v_scale contiguous (n_pages, P, KVh) f32
// for kinds 2 and 3 (ignored otherwise); table the contiguous (B, Lp) int32
// page table with every entry < n_pages; S is seq_len <= Lp * P.
extern "C" int repro_paged_decode_attn(
    const void* q, int q_bf16, const void* kpool, const void* vpool,
    const float* k_scale, const float* v_scale, int kind,
    const int32_t* table, const void* pos, int pos64, long long pos_stride,
    float* out, float* part, int B, int KVh, int g, int dh, int P, int Lp,
    int S, int R, int n_splits, float scale, void* stream) {
  const Plan p{q, q_bf16, pos, pos64, pos_stride, out, part, B, S, R,
               n_splits, KVh, g, dh, scale};
  if (bad_plan(p) || P < 1 || Lp < 1 || (long long)Lp * P < S ||
      kind < 0 || kind > 3 || (kind >= 2 && (!k_scale || !v_scale)))
    return cudaErrorInvalidValue;
  const long long row_bytes = kind == 0 ? F32Rows::row_bytes(dh)
                              : kind == 1 ? Bf16Rows::row_bytes(dh)
                              : kind == 2 ? Int8Rows::row_bytes(dh)
                                          : Int4Rows::row_bytes(dh);
  const PagedSrc src{static_cast<const unsigned char*>(kpool),
                     static_cast<const unsigned char*>(vpool),
                     kind >= 2 ? k_scale : nullptr,
                     kind >= 2 ? v_scale : nullptr, table, Lp, P, KVh,
                     row_bytes};
  const int unit = copy_unit({row_bytes, (long long)(uintptr_t)kpool,
                              (long long)(uintptr_t)vpool});
  switch (kind) {
    case 0: return launch<F32Rows>(src, p, unit, stream);
    case 1: return launch<Bf16Rows>(src, p, unit, stream);
    case 2: return launch<Int8Rows>(src, p, unit, stream);
    default: return launch<Int4Rows>(src, p, unit, stream);
  }
}

// The attributes of a kernel of the pair a call launches, read with
// cudaFuncGetAttributes and without launching anything: the combine kernel
// (combine = 1), or the split kernel of row format `kind` (as the paged
// entry's; 0 and 1 only for the contiguous arena, paged = 0) for g query
// heads, head width dh and R rows a split. out[0] sharedSizeBytes, out[1]
// numRegs, out[2] maxThreadsPerBlock, out[3] the dynamic shared bytes the
// launcher passes. `decode_attn.describe` builds these arguments.
extern "C" int repro_decode_attn_attributes(int kind, int paged, int g,
                                            int dh, int R, int combine,
                                            int* out) {
  if (combine) return func_attributes(flash_decode_combine, 0, out);
  if (g < 1 || g > kGMax || dh < 4 || dh > kDhMax || R < 1 || R > kRMax)
    return cudaErrorInvalidValue;
  if (!paged) {
    if (kind == 0)
      return split_attributes<F32Rows, ContiguousSrc>(g, dh, R, out);
    if (kind == 1)
      return split_attributes<Bf16Rows, ContiguousSrc>(g, dh, R, out);
    return cudaErrorInvalidValue;
  }
  switch (kind) {
    case 0: return split_attributes<F32Rows, PagedSrc>(g, dh, R, out);
    case 1: return split_attributes<Bf16Rows, PagedSrc>(g, dh, R, out);
    case 2: return split_attributes<Int8Rows, PagedSrc>(g, dh, R, out);
    case 3: return split_attributes<Int4Rows, PagedSrc>(g, dh, R, out);
  }
  return cudaErrorInvalidValue;
}
