// GEMM core with a fused weight-decoding epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/gemm_core.py::_make_kernel`
// (launched by `gemm()` through `pl.pallas_call`): y = x @ T(w) with f32
// accumulation, where T decodes each weight element right after its load:
//
//   EPI_FAKE_QUANT  w f32/bf16 (K, N)     T(w) = d*rint(clip^t(|w|)/d)*sgn(w)
//   EPI_DEQUANT     w int8/16/32 (K, N)   T(w) = codes * scale[n]
//   EPI_UNPACK      w int32 (ceil(K/cpw), N) K-packed words, cpw = 32/bits
//                                         T(w) = sext(field) * scale[n]
//   EPI_NONE        w f32/bf16 (K, N)     T(w) = w
//   EPI_COL_MASK    w f32/bf16 (K, N)     T(w) = w * m[n]
//   EPI_FQ_MASK     w f32/bf16 (K, N)     T(w) = fake_quant(w) * m[n]
//
// The last three serve training: the backward GEMMs x.T @ g (out f32) and
// g @ w.T, and the column-masked forward of the GETA joint stage (`m` is
// the f32 (N,) column mask, passed in the `scale` slot).
//
// Three variants; the wrapper (`kernels/gemm_core.py`) picks one by M and
// x's dtype, never by the epilogue:
//
// - Small-M (M <= 8, decode; `gemm_small_m`). Bound by the bytes of W read
//   from HBM (bf16 2 B, int8 1 B, 4-bit 0.5 B per element): each weight is
//   read once and feeds at most 8 FMAs, at most 16 operations per byte
//   against the card's ~295, so what counts is bytes in flight and
//   launches. One launch: the blocks that split a 128-column strip's K range
//   form one thread-block cluster (at most 8) and reduce over DSMEM in rank
//   order, so there is no workspace and no second pass. Each thread copies
//   16-byte chunks (8 bf16, 16 int8 or 4 words) by cp.async into its own
//   slots of a shared-memory ring (three stages in flight while one
//   decodes) and decodes each weight once, in registers; int codes and
//   packed fields convert by integer tricks, not the slow int-to-float
//   unit, and fake-quant codes divide by a rounded reciprocal of d with an
//   exact fallback (`fq_chunk`). x's rows for the block's K range are
//   staged once in shared memory as f32. The epilogue's factor (d,
//   scale[n], m[n]) multiplies each output once. Measured on the H100 the
//   variant is bound by instructions (4 FMAs a weight at M = 4 plus its
//   decode), not by bytes: packed words take as long as int8 codes.
// - Tensor-core (M > 8 with bf16 x: prefill and training; `gemm_tc`).
//   At M = 2048 a GEMM does 2*M FLOPs per weight byte or more, far above
//   the card's ~295 FLOP per HBM byte: bound by operations, and only wgmma
//   reaches the bf16 tensor-core rate (989 TFLOP/s dense). A BM x 128
//   output tile per block (BM = 256 where that takes fewer waves over the
//   SMs than 128, `gemm_core.tc_block_m`), K in steps of 64 through a ring
//   of shared-memory stages that one producer thread fills with TMA (x's
//   tile and the raw weight tile, completion on an mbarrier per stage).
//   Four consumer warpgroups: two per 64-column group, each over half the
//   rows. A column group's two warpgroups decode its columns of the raw
//   weight tile into the 128-byte-swizzled bf16 layout wgmma reads, half
//   each, then issue m64n64k16 wgmma over their rows. bf16 weights under
//   `none` / `col_mask` skip the decode: TMA writes them swizzled.
//   What bounds it: with a decode, the decode. Each block decodes every
//   weight tile it reads, 8 times per weight at M = 2048 with BM = 256 (16
//   in the SIMT variant's 128-row tile), and a fake-quant decode costs an
//   IEEE divide and a rint per weight, and a `powf` at t != 1, on the CUDA
//   cores. Hence BM = 256 and 16 decoding warps. The wgmma batch of a step
//   is retired before the next decode (a batch left in flight across it
//   makes ptxas serialize every wgmma, C7515); the other warpgroups' decode
//   and products overlap it.
//   Exactness: T(w) is factored as (an integer code, or w) times a scale
//   that is one per column or per tensor: fake-quant codes q =
//   rint(clip^t(|w|)/d)*sgn(w) (`fq_code`, the same powf, IEEE divide and
//   rintf as the other variants, so the codes are the plain version's bit
//   for bit), int codes, packed fields, or w itself. The decode writes
//   v as bf16 pieces p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 -
//   p1): each difference is exact in f32, and each piece takes 8 of v's at
//   most 24 significant bits, so p0 + p1 + p2 == v for every f32 v (from
//   2^-102 up). int8 codes, packed fields (|v| <= 128) and bf16 weights
//   need p0 alone, int16 codes p0 and p1. With bf16 x each product is
//   exact in the f32 accumulator, and the epilogue multiplies by d,
//   scale[n] or m[n] once per output. Shared memory holds p0 and p1; the
//   p1 batch runs for a 64-deep K step only when the column group's vote
//   finds a nonzero p1 in its tile (adding x @ 0 would change nothing), and
//   a second vote, after those products, decodes the tile again with p2
//   over p0 and runs a third batch where a p2 may be nonzero: an f32
//   weight, or a code of 2^17 or more (below 2^17 the residual of p0 is an
//   integer of at most 256), found by the tile's max |v|. Fake-quant codes
//   reach 2^17 only with a quantizer above about 18 bits (warm-up reaches
//   24.75), known from (d, q_m, t) before the K loop: a call below that
//   runs a K loop without the third pass, which costs the others nothing.
//   So the products are x @ T(w) exactly; only the f32 accumulation
//   rounds.
//   TMA reads x and w in place, row-major or as a transposed view (x.T for
//   dw and dwq, w.T for dx): wgmma reads bf16 operands K-major or
//   MN-major, and the decode writes its tile in the raw tile's major
//   order. After the decode's generic-proxy stores, each thread runs
//   `fence.proxy.async.shared::cta` before the column group's barrier, so
//   the wgmma (async proxy) sees them.
// - SIMT (M > 8 with f32 x; `gemm_general`): a register-tiled SGEMM in f32
//   FMAs on the CUDA cores, bound by their 67 TFLOP/s: 128 x 128 tiles, 8 x
//   8 outputs per thread, two blocks per SM (registers capped at 128), x's
//   tile through a cp.async ring, the weight tile loaded one K step ahead
//   in 16-byte chunks and decoded once per block (16 times per weight at
//   M = 2048). Kept for f32 x: the f32
//   configuration's 1e-4 card-vs-CPU parity rests on f32 products, which
//   bf16 tensor cores do not give; it decodes T(w) element by element as
//   the plain version does.
//
// Determinism: no atomics, and no split-K at M > 8. The K order and the
// tiles depend only on (M, N, K) and the SM count, never on the epilogue:
// EPI_DEQUANT and EPI_UNPACK decode identical codes, so their outputs are
// bitwise equal and packed serving emits the same tokens as int8 serving.
// Rounding uses rintf (ties to even, like torch.round and jnp.round).
// Packed fields decode only for k < K; the zero tail of the last word is
// never relied on.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I16 = 3, DT_I32 = 4 };
enum Epi {
  EPI_FAKE_QUANT = 0, EPI_DEQUANT = 1, EPI_UNPACK = 2, EPI_NONE = 3,
  EPI_COL_MASK = 4, EPI_FQ_MASK = 5
};

constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) { return v; }
__device__ __forceinline__ float to_f32(int32_t v) { return (float)v; }

// Eqs (1)-(2) with `clip_qmt` in its power form; d and qm arrive clamped.
// t == 1 (every quantizer's init) skips powf and keeps c, which is what the
// plain version's torch.pow(c, 1) gives on the card for every positive
// float (test_pow_of_one_is_identity_on_card, tests/test_torch_gpu.py).
// fq_code is the integer code q = rint(clip^t(|w|)/d) * sgn(w), so that
// fake_quant = d * q; d * (r * s) is (d * r) * s bit for bit, s = -1, 0, 1.
__device__ __forceinline__ float fq_code(float w, float d, float qm,
                                         float t) {
  float a = fabsf(w);
  float c = fmaxf(fminf(a, qm), kEps);
  float xt = (t == 1.f ? c : powf(c, t)) * (a > 0.f ? 1.f : 0.f);
  float s = w > 0.f ? 1.f : (w < 0.f ? -1.f : 0.f);
  return rintf(xt / d) * s;
}

// fq_code in fewer operations, bit for bit, with POW == (t != 1) decided
// once per call. Sign: where a > 0 the (a > 0) factor is 1 and the sign
// product is copysign; where it fails (w = +-0 or NaN) fq_code's s is 0 and
// both give +0. Quotient: fq_code_near takes y = xt * r, r = 1 / d rounded
// (__frcp_rn). y is within Q 2^-23 (1 + 2^-25) of Q = xt / d and the IEEE
// quotient fl(Q) within Q 2^-24, so the two lie within y 2^-22 of each
// other and round to the same integer unless a half-integer lies that
// close to y. `near` is set where one may lie within y 2^-20 (|y - rint(y)|
// is exact, Sterbenz); fq_code_exact then divides (rare at the codes of a
// quantizer of up to ~12 bits, every time past y = 2^19).
template <bool POW>
__device__ __forceinline__ float fq_code_near(float w, float r, float qm,
                                              float t, bool& near) {
  const float a = fabsf(w);
  const float c = fmaxf(fminf(a, qm), kEps);
  const float y = (POW ? powf(c, t) : c) * r;
  const float q = rintf(y);
  near |= fabsf(y - q) >= fmaf(y, -0x1p-20f, 0.5f);
  return a > 0.f ? copysignf(q, w) : 0.f;
}
template <bool POW>
__device__ __forceinline__ float fq_code_exact(float w, float d, float qm,
                                               float t) {
  const float a = fabsf(w);
  const float c = fmaxf(fminf(a, qm), kEps);
  const float q = rintf((POW ? powf(c, t) : c) / d);
  return a > 0.f ? copysignf(q, w) : 0.f;
}

// Sign-extend the `f`-th BITS-wide field of a packed word.
template <int BITS>
__device__ __forceinline__ float unpack_field(int word, int f) {
  constexpr int kMask = (1 << BITS) - 1;
  constexpr int kSign = 1 << (BITS - 1);
  int v = (word >> (f * BITS)) & kMask;
  return (float)((v ^ kSign) - kSign);
}

struct EpiArgs {
  const float* scale;   // dequant / unpack: scale[n * scale_stride];
                        // col_mask / fq_mask: the mask m[n]
  int scale_stride;     // 1 for a per-column (N,) scale, 0 for one scale
  const float* fq_d;    // 0-d device scalars for fake-quant
  const float* fq_qm;
  const float* fq_t;
};

// ---- 16-byte weight chunks (the small-M and SIMT variants) ----------------
// A chunk is 16 bytes of one raw weight row: 16 / sizeof(WT) adjacent
// columns of a dense weight, or 4 adjacent columns of K-packed words.
template <int EPI, typename WT, int BITS>
struct ChunkTraits {
  static constexpr bool kPacked = EPI == EPI_UNPACK;
  static constexpr bool kFq = EPI == EPI_FAKE_QUANT || EPI == EPI_FQ_MASK;
  static constexpr int kCpw = kPacked ? 32 / BITS : 1;   // K rows per raw row
  static constexpr int kCols = kPacked ? 4 : 16 / (int)sizeof(WT);
};

// Read-only, streamed once: no L1 allocation. Volatile, so the load
// issues where it is written (a step ahead of its use), not where its
// value is first needed.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// The chunk of `row` at columns col .. col + C - 1, C = 16 / sizeof(WT),
// col a multiple of C; zero past N. With `vec` (16-byte aligned rows, so
// N % C == 0) one 16-byte load; otherwise one load per 4 columns, which
// N % 4 == 0 keeps aligned.
template <typename WT>
__device__ __forceinline__ uint4 load_chunk(const WT* row, int col, int N,
                                            bool vec) {
  constexpr int C = 16 / (int)sizeof(WT);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (C == 4 || vec) {
    if (col < N) r = ld_stream(row + col);
  } else if constexpr (C == 8) {
    const uint2* p = reinterpret_cast<const uint2*>(row + col);
    if (col < N) {
      const uint2 t = __ldg(p);
      r.x = t.x; r.y = t.y;
    }
    if (col + 4 < N) {
      const uint2 t = __ldg(p + 1);
      r.z = t.x; r.w = t.y;
    }
  } else {
    const unsigned* p = reinterpret_cast<const unsigned*>(row + col);
    if (col < N) r.x = __ldg(p);
    if (col + 4 < N) r.y = __ldg(p + 1);
    if (col + 8 < N) r.z = __ldg(p + 2);
    if (col + 12 < N) r.w = __ldg(p + 3);
  }
  return r;
}

// The 16 / sizeof(WT) values of a dense chunk as f32, integer codes exactly.
// int8: byte b of u ^ 0x80808080 is code + 128, and under the exponent of
// 1.5 * 2^23 it reads as 12582912 + code + 128 (two integer instructions a
// code instead of a conversion, which runs at a sixteenth of the FMA rate).
template <typename WT>
__device__ __forceinline__ void chunk_values(const uint4& r,
                                             float (&v)[16 / sizeof(WT)]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<WT, float>::value) {
      v[i] = __uint_as_float(u[i]);
    } else if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    } else if constexpr (std::is_same<WT, int8_t>::value) {
      const uint32_t b = u[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * i + j] =
            __uint_as_float(__byte_perm(b, 0x4B400000u, 0x7650u | j)) -
            12583040.f;
    } else if constexpr (std::is_same<WT, int16_t>::value) {
      v[2 * i] = (float)(int16_t)(u[i] & 0xFFFFu);
      v[2 * i + 1] = (float)((int32_t)u[i] >> 16);
    } else {
      v[i] = (float)(int32_t)u[i];
    }
  }
}

// The fake-quant codes of a dense chunk (fq_code bit for bit): the whole
// chunk again by exact division where one of its values may round apart.
template <typename WT, bool POW>
__device__ __forceinline__ void fq_chunk(const uint4& raw,
                                         float (&v)[16 / sizeof(WT)],
                                         float d, float r, float qm,
                                         float t) {
  constexpr int C = 16 / sizeof(WT);
  float w[C];
  chunk_values<WT>(raw, w);
  bool near = false;
#pragma unroll
  for (int q = 0; q < C; ++q) v[q] = fq_code_near<POW>(w[q], r, qm, t, near);
  if (near) {
#pragma unroll
    for (int q = 0; q < C; ++q) v[q] = fq_code_exact<POW>(w[q], d, qm, t);
  }
}

// The top bit of every BITS-wide field of a packed word.
template <int BITS>
__host__ __device__ constexpr uint32_t field_signs() {
  uint32_t m = 0;
  for (int f = 0; f < 32 / BITS; ++f) m |= 1u << (BITS * f + BITS - 1);
  return m;
}

// Field f of a packed word whose field sign bits were flipped (word ^
// field_signs): code + 2^(BITS-1), read under 1.5 * 2^23 as for int8.
template <int BITS>
__device__ __forceinline__ float field_value(uint32_t flipped, int f) {
  constexpr uint32_t kMask = (1u << BITS) - 1;
  constexpr float kBias = 12582912.f + (float)(1 << (BITS - 1));
  return __uint_as_float(((flipped >> (BITS * f)) & kMask) | 0x4B400000u) -
         kBias;
}

__device__ __forceinline__ void store_out(void* out, int out_bf16,
                                          long long i, float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// cp.async of 16, 8 or 4 bytes into shared memory; `bytes` 0 zero-fills
// the destination (and reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The chunk at p (C = 16 / sizeof(WT) columns from col, a multiple of C)
// into dst by cp.async; the columns past N are not copied: they feed only
// outputs past N, which are never stored. With `vec` (16-byte aligned rows:
// N % C == 0) one 16-byte copy; otherwise one copy per 4 columns, which
// N % 4 == 0 keeps aligned.
template <typename WT>
__device__ __forceinline__ void copy_chunk(uint4* dst, const WT* p, int col,
                                           int N, bool vec) {
  constexpr int C = 16 / (int)sizeof(WT);
  if (C == 4 || vec) {
    if (col < N) cp_async16(dst, p, 16);
  } else {
#pragma unroll
    for (int g = 0; g < C / 4; ++g) {
      if (col + 4 * g >= N) break;
      if constexpr (C == 8)
        cp_async8(reinterpret_cast<uint2*>(dst) + g, p + 4 * g, 8);
      else
        cp_async4(reinterpret_cast<uint32_t*>(dst) + g, p + 4 * g, 4);
    }
  }
}

// ---- small-M variant (M <= 8) ---------------------------------------------
// grid (cluster, ceil(N / 128)), cluster (cluster, 1, 1), 256 threads. The
// blocks of a cluster share one strip of 128 columns; block (cluster rank)
// r sums K rows [r k_slice, (r + 1) k_slice). A thread owns 16 columns of
// the strip (chunk c at columns CC (8c + tn) .. +CC, so 8 adjacent threads
// read 128 adjacent bytes of a row) and one of 32 K-groups: within each
// window of up to SM_WINDOW rows of the block's slice, K-group g sums rows
// [g rg, (g + 1) rg), rg = window / 32, in ascending order. The weights
// stream through a ring of SM_STAGES shared-memory stages of SM_LOADS
// chunks per thread, each thread copying (cp.async) and later reading only
// its own slots: SM_STAGES - 1 stages in flight while one decodes, with no
// registers held and no barrier. The K-groups of a warp are its four lane
// octets (kl = lane / 8). Reduction, in a fixed order: octets by shuffles
// ((0 + 1) + (2 + 3)), then warps 0..7 through shared memory into the
// block's partial, then, after a cluster barrier, the ranks' partials in
// rank order over DSMEM, each rank writing its share of the strip's
// outputs, times the epilogue's per-output factor (d, scale or mask).
constexpr int SM_MMAX = 8;
constexpr int SM_THREADS = 256;
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_BN = 128;                       // columns per strip
constexpr int SM_COLS = 16;                      // columns per thread
constexpr int SM_TN = SM_BN / SM_COLS;           // threads along N
constexpr int SM_GROUPS = SM_THREADS / SM_TN;    // K-groups per block
constexpr int SM_WINDOW = 2048;                  // K rows of x staged at once
constexpr int SM_CLUSTER_MAX = 8;                // the portable cluster size
constexpr int SM_LOADS = 4;                      // chunks per thread a stage
constexpr int SM_STAGES = 4;
constexpr int SM_RING_BYTES = SM_STAGES * SM_LOADS * SM_THREADS * 16;

// Shared memory of one block in bytes: the ring, x's window (k rows x MT,
// f32; reused for the warps' partials), the block's partial (MT x 128).
template <int MT>
__host__ __device__ constexpr int sm_part_offset(int win) {
  return win * MT > SM_WARPS * MT * SM_BN ? win * MT : SM_WARPS * MT * SM_BN;
}
template <int MT>
__host__ __device__ constexpr int sm_smem_bytes(int win) {
  return SM_RING_BYTES + (sm_part_offset<MT>(win) + MT * SM_BN) * 4;
}

// MT = 4 keeps its registers within 128 so two blocks share an SM
template <int EPI, typename WT, int BITS, int MT>
__global__ void __launch_bounds__(SM_THREADS, MT <= 4 ? 2 : 1)
gemm_small_m(const void* __restrict__ x, int x_bf16,
             const void* __restrict__ w, EpiArgs e, void* __restrict__ out,
             int out_bf16, int M, int N, int K, int k_slice) {
  using Tr = ChunkTraits<EPI, WT, BITS>;
  constexpr int CPW = Tr::kCpw, CC = Tr::kCols, NCH = SM_COLS / CC;
  constexpr int STEP = SM_LOADS / NCH;           // raw rows a stage
  extern __shared__ float4 smem4[];
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* xs = reinterpret_cast<float*>(smem4) + SM_RING_BYTES / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = lane % SM_TN, kl = lane / SM_TN;
  const int group = warp * (32 / SM_TN) + kl;
  const int n0 = blockIdx.y * SM_BN;
  const int kb = blockIdx.x * k_slice, ke = min(K, kb + k_slice);
  const int win = min(k_slice, SM_WINDOW), rg = win / SM_GROUPS;
  const WT* wp = static_cast<const WT*>(w);
  const bool vec = (N * (int)sizeof(WT)) % 16 == 0;
  const bool x_vec =
      K % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (x_bf16 ? 8 : 16) == 0;
  int col[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) col[c] = n0 + CC * (c * SM_TN + tn);
  float d = 1.f, rd = 1.f, qm = 0.f, tt = 1.f;
  if constexpr (Tr::kFq) {
    d = fmaxf(*e.fq_d, kEps);
    rd = __frcp_rn(d);
    qm = fmaxf(*e.fq_qm, kEps);
    tt = *e.fq_t;
  }
  float acc[MT * SM_COLS];
#pragma unroll
  for (int i = 0; i < MT * SM_COLS; ++i) acc[i] = 0.f;

  // acc[m][j] += x[m][k] * v[j], x's row k at xs + kx * MT
  auto fma_row = [&](int kx, const float (&v)[SM_COLS]) {
    float xv[MT];
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(xs + kx * MT)[q];
      xv[4 * q] = t.x; xv[4 * q + 1] = t.y;
      xv[4 * q + 2] = t.z; xv[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < SM_COLS; ++j)
        acc[m * SM_COLS + j] = fmaf(xv[m], v[j], acc[m * SM_COLS + j]);
  };
  // The K loop, instantiated with a powf per fake-quant code (t != 1) and
  // without: a call takes one, the same in every thread
  auto k_loop = [&](auto pow_tag) {
    constexpr bool POW = decltype(pow_tag)::value;
    for (int wb = kb; wb < ke; wb += win) {
      const int we = min(ke, wb + win);
      const int lo = min(we, wb + group * rg), hi = min(we, lo + rg);
      // the thread's raw rows (K rows, or the word rows its K rows span)
      const int llo = lo / CPW, lhi = lo < hi ? (hi - 1) / CPW + 1 : llo;
      const int nsteps = (lhi - llo + STEP - 1) / STEP;
      // stages are issued in order: the next raw row to copy, its slot
      const WT* src = wp + (long long)llo * N;
      int next = llo, slot = 0;
      auto issue = [&]() {
        uint4* dst = ring + slot * SM_LOADS * SM_THREADS + tid;
#pragma unroll
        for (int i = 0; i < STEP; ++i) {
          if (next < lhi)
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              copy_chunk<WT>(dst + (i * NCH + c) * SM_THREADS, src + col[c],
                             col[c], N, vec);
          src += N;
          ++next;
        }
        slot = slot == SM_STAGES - 1 ? 0 : slot + 1;
        cp_async_commit();
      };
#pragma unroll
      for (int s = 0; s < SM_STAGES - 1; ++s) issue();
      // x rows [wb, we) as xs[(k - wb) * MT + m] in f32, zero for m >= M,
      // staged while the first stages are in flight
      const int nk = we - wb;
      if (x_vec) {
        const int nq = nk / 4;
        for (int i = tid; i < MT * nq; i += SM_THREADS) {
          const int m = i / nq, q = i - m * nq;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          if (m < M) {
            const long long o = (long long)m * K + wb + 4 * q;
            if (x_bf16) {
              const uint2 u = *reinterpret_cast<const uint2*>(
                  static_cast<const __nv_bfloat16*>(x) + o);
              t[0] = __uint_as_float(u.x << 16);
              t[1] = __uint_as_float(u.x & 0xFFFF0000u);
              t[2] = __uint_as_float(u.y << 16);
              t[3] = __uint_as_float(u.y & 0xFFFF0000u);
            } else {
              const float4 f = *reinterpret_cast<const float4*>(
                  static_cast<const float*>(x) + o);
              t[0] = f.x; t[1] = f.y; t[2] = f.z; t[3] = f.w;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) xs[(4 * q + j) * MT + m] = t[j];
        }
      } else {
        for (int i = tid; i < MT * nk; i += SM_THREADS) {
          const int m = i / nk, kk = i - m * nk;
          float t = 0.f;
          if (m < M) {
            const long long o = (long long)m * K + wb + kk;
            t = x_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(x)[o])
                       : static_cast<const float*>(x)[o];
          }
          xs[kk * MT + m] = t;
        }
      }
      __syncthreads();
      for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<SM_STAGES - 2>();       // this thread's stage s
        uint4 r[STEP][NCH];
        const uint4* cur =
            ring + (s % SM_STAGES) * SM_LOADS * SM_THREADS + tid;
#pragma unroll
        for (int i = 0; i < STEP; ++i)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            r[i][c] = cur[(i * NCH + c) * SM_THREADS];
        issue();                      // into the slot read one step ago
#pragma unroll
        for (int i = 0; i < STEP; ++i) {
          const int lr = llo + s * STEP + i;
          if (lr >= lhi) break;
          if constexpr (!Tr::kPacked) {
            float v[SM_COLS];
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              float u[CC];
              if constexpr (Tr::kFq)
                fq_chunk<WT, POW>(r[i][c], u, d, rd, qm, tt);
              else
                chunk_values<WT>(r[i][c], u);
#pragma unroll
              for (int q = 0; q < CC; ++q) v[c * CC + q] = u[q];
            }
            fma_row(lr - wb, v);
          } else {
            constexpr uint32_t kSigns = field_signs<BITS>();
#pragma unroll
            for (int f = 0; f < CPW; ++f) {
              const int k = lr * CPW + f;
              if (k < lo || k >= hi) continue;
              float v[SM_COLS];
#pragma unroll
              for (int c = 0; c < NCH; ++c) {
                v[c * 4] = field_value<BITS>(r[i][c].x ^ kSigns, f);
                v[c * 4 + 1] = field_value<BITS>(r[i][c].y ^ kSigns, f);
                v[c * 4 + 2] = field_value<BITS>(r[i][c].z ^ kSigns, f);
                v[c * 4 + 3] = field_value<BITS>(r[i][c].w ^ kSigns, f);
              }
              fma_row(k - wb, v);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();
    }
  };
  if (Tr::kFq && tt != 1.f)
    k_loop(std::true_type{});
  else
    k_loop(std::false_type{});

  // the four K-groups of a warp: lane octet kl keeps a quarter of the
  // MT x 16 sums, (octets 0 + 1) + (octets 2 + 3) (each pair sum is
  // commutative, so the lane computing it does not change its bits)
  constexpr int NV = MT * SM_COLS, H = NV / 2, Q = NV / 4;
  const bool b0 = kl & 1, b1 = kl & 2;
  float h[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float mine = b0 ? acc[i + H] : acc[i];
    const float other = b0 ? acc[i] : acc[i + H];
    h[i] = mine + __shfl_xor_sync(0xFFFFFFFFu, other, SM_TN);
  }
  float* red = xs;                 // [warp][MT][SM_BN]
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float mine = b1 ? h[i + Q] : h[i];
    const float other = b1 ? h[i] : h[i + Q];
    const float s = mine + __shfl_xor_sync(0xFFFFFFFFu, other, 2 * SM_TN);
    const int vi = (b0 ? H : 0) + (b1 ? Q : 0) + i;
    const int m = vi / SM_COLS, j = vi % SM_COLS;
    red[(warp * MT + m) * SM_BN + CC * ((j / CC) * SM_TN + tn) + j % CC] = s;
  }
  __syncthreads();
  float* part = xs + sm_part_offset<MT>(win);
  for (int o = tid; o < M * SM_BN; o += SM_THREADS) {
    const int m = o / SM_BN, c = o % SM_BN;
    float s = red[m * SM_BN + c];
#pragma unroll
    for (int wi = 1; wi < SM_WARPS; ++wi) s += red[(wi * MT + m) * SM_BN + c];
    part[o] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int o = rank * SM_THREADS + tid; o < M * SM_BN; o += cs * SM_THREADS) {
    const int m = o / SM_BN, n = n0 + o % SM_BN;
    if (n >= N) continue;
    float s = cluster.map_shared_rank(part, 0)[o];
    for (int r = 1; r < cs; ++r) s += cluster.map_shared_rank(part, r)[o];
    if (Tr::kFq) s *= d;
    if (e.scale != nullptr) s *= e.scale[(long long)n * e.scale_stride];
    store_out(out, out_bf16, (long long)m * N + n, s);
  }
  cluster.sync();      // no block leaves while a peer reads its partial
}

// ---- SIMT variant (M > 8, f32 x) -------------------------------------------
// grid (ceil(N / 128), ceil(M / 128)), 256 threads as 16 x 16, 8 x 8
// outputs each (rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and
// 64 + 4 tx + j: the float4 reads of a warp fall on distinct banks). K in
// steps of 16: x's tile through a ring of GM_STAGES shared-memory stages
// filled by cp.async, two steps ahead; the weight tile's 16-byte chunks
// loaded into registers one step ahead, decoded to T(w) in f32 and stored
// row-major (16 x 128) in one of two buffers. Every output sums its K range
// in one thread, in order, in f32 FMAs: no split-K, no tensor cores.
constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 16, GM_STAGES = 3;
constexpr int GM_THREADS = 256;
constexpr int GM_APITCH = GM_BK + 4;     // floats per staged x row

template <int EPI, typename WT, int BITS>
struct GmTraits : ChunkTraits<EPI, WT, BITS> {
  using Base = ChunkTraits<EPI, WT, BITS>;
  static constexpr int kPerRow = GM_BN / Base::kCols;    // chunks per raw row
  // raw rows a 16-row K step reads: 16, or the word rows 16 rows can span
  static constexpr int kRows =
      !Base::kPacked              ? GM_BK
      : GM_BK % Base::kCpw == 0 ? GM_BK / Base::kCpw
                                : GM_BK / Base::kCpw + 2;
  static constexpr int kChunks = kRows * kPerRow;
  static constexpr int kPerThread = (kChunks + GM_THREADS - 1) / GM_THREADS;
};

template <int EPI, typename WT, int BITS>
__global__ void __launch_bounds__(GM_THREADS, 2)
gemm_general(const float* __restrict__ x, const void* __restrict__ w,
             EpiArgs e, void* __restrict__ out, int out_bf16, int M, int N,
             int K) {
  using Tr = GmTraits<EPI, WT, BITS>;
  constexpr int CC = Tr::kCols, PT = Tr::kPerThread, CPW = Tr::kCpw;
  __shared__ __align__(16) float As[GM_STAGES][GM_BM][GM_APITCH];
  __shared__ __align__(16) float Bs[2][GM_BK][GM_BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  const int nsteps = (K + GM_BK - 1) / GM_BK;
  const WT* wp = static_cast<const WT*>(w);
  const bool vec = (N * (int)sizeof(WT)) % 16 == 0;
  const bool x_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int raw_rows = (K + CPW - 1) / CPW;
  // the thread's chunks are q = tid + i * 256 of a step's kRows x kPerRow;
  // 256 is a multiple of kPerRow, so their columns are the same every step
  const int cl = (tid % Tr::kPerRow) * CC, ccol = n0 + cl;
  float d = 1.f, rd = 1.f, qm = 0.f, tt = 1.f;
  if constexpr (Tr::kFq) {
    d = fmaxf(*e.fq_d, kEps);
    rd = __frcp_rn(d);
    qm = fmaxf(*e.fq_qm, kEps);
    tt = *e.fq_t;
  }
  float cs[CC];     // the columns' scale or mask
#pragma unroll
  for (int q = 0; q < CC; ++q)
    cs[q] = e.scale != nullptr && ccol + q < N
                ? e.scale[(long long)(ccol + q) * e.scale_stride] : 1.f;

  uint4 raw[PT];
  auto load_w = [&](int step) {
    const int r0 = step * GM_BK / CPW;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int q = tid + i * GM_THREADS;
      const int rr = r0 + q / Tr::kPerRow;
      raw[i] = q < Tr::kChunks && rr < raw_rows
                   ? load_chunk<WT>(wp + (long long)rr * N, ccol, N, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // T(w) of the step's chunks into Bs[buf]; rows past K are zero. POW ==
  // (t != 1), decided once per call
  auto decode_w = [&](int step, int buf, auto pow_tag) {
    constexpr bool POW = decltype(pow_tag)::value;
    const int k0 = step * GM_BK, r0 = k0 / CPW;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int q = tid + i * GM_THREADS;
      if (q >= Tr::kChunks) break;
      const int rr = r0 + q / Tr::kPerRow;
      if constexpr (!Tr::kPacked) {
        float v[CC];
        if constexpr (Tr::kFq)
          fq_chunk<WT, POW>(raw[i], v, d, rd, qm, tt);
        else
          chunk_values<WT>(raw[i], v);
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          if (Tr::kFq) v[j] = d * v[j];
          if (e.scale != nullptr) v[j] = v[j] * cs[j];
        }
#pragma unroll
        for (int j = 0; j < CC; j += 4)
          *reinterpret_cast<float4*>(&Bs[buf][rr - k0][cl + j]) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else {
        constexpr uint32_t kSigns = field_signs<BITS>();
        const uint32_t f4[4] = {raw[i].x ^ kSigns, raw[i].y ^ kSigns,
                                raw[i].z ^ kSigns, raw[i].w ^ kSigns};
#pragma unroll
        for (int f = 0; f < CPW; ++f) {
          const int k = rr * CPW + f;
          if (k < k0 || k >= k0 + GM_BK) continue;
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < K)
            t = make_float4(field_value<BITS>(f4[0], f) * cs[0],
                            field_value<BITS>(f4[1], f) * cs[1],
                            field_value<BITS>(f4[2], f) * cs[2],
                            field_value<BITS>(f4[3], f) * cs[3]);
          *reinterpret_cast<float4*>(&Bs[buf][k - k0][cl]) = t;
        }
      }
    }
  };
  // x's 128 x 16 tile of the step: 512 chunks of 4 floats, zero-filled past
  // M and K
  auto load_x = [&](int step, int stage) {
    const int k0 = step * GM_BK;
#pragma unroll
    for (int i = 0; i < GM_BM * GM_BK / 4 / GM_THREADS; ++i) {
      const int q = tid + i * GM_THREADS;
      const int r = q >> 2, c = (q & 3) * 4, m = m0 + r, k = k0 + c;
      float* dst = &As[stage][r][c];
      if (x_vec) {
        const bool ok = m < M && k < K;
        cp_async16(dst, ok ? x + (long long)m * K + k : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = m < M && k + j < K;
          cp_async4(dst + j, ok ? x + (long long)m * K + k + j : x,
                    ok ? 4 : 0);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load_w(0);
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < nsteps) load_x(s, s);
    cp_async_commit();
  }
  auto k_loop = [&](auto pow_tag) {
    for (int st = 0; st < nsteps; ++st) {
      cp_async_wait<GM_STAGES - 2>();      // this thread's copies of step st
      decode_w(st, st & 1, pow_tag);
      // every thread's copies and decode of step st are in, and every thread
      // is past step st - 1's products (its stages may be refilled)
      __syncthreads();
      if (st + GM_STAGES - 1 < nsteps)
        load_x(st + GM_STAGES - 1, (st + GM_STAGES - 1) % GM_STAGES);
      cp_async_commit();
      if (st + 1 < nsteps) load_w(st + 1);
      const float(*A)[GM_APITCH] = As[st % GM_STAGES];
      const float(*B)[GM_BN] = Bs[st & 1];
#pragma unroll
      for (int kq = 0; kq < GM_BK / 4; ++kq) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(&A[ty * 4 + i][kq * 4]);
          a[4 + i] =
              *reinterpret_cast<const float4*>(&A[64 + ty * 4 + i][kq * 4]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 p =
              *reinterpret_cast<const float4*>(&B[kq * 4 + kk][tx * 4]);
          const float4 q =
              *reinterpret_cast<const float4*>(&B[kq * 4 + kk][64 + tx * 4]);
          const float b[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
    }
  };
  if (Tr::kFq && tt != 1.f)
    k_loop(std::true_type{});
  else
    k_loop(std::false_type{});
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;      // N % 4 == 0: all four or none
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      const float* v = &acc[i][4 * h];
      if (out_bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
        q[0] = __floats2bfloat162_rn(v[0], v[1]);
        q[1] = __floats2bfloat162_rn(v[2], v[3]);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---- tensor-core variant (M > 8, bf16 x) ----------------------------------
// Block tile BM x 128 x 64, BM = 128 or 256 rows. Warps 0-15 are four
// consumer warpgroups, two per column group: column group g owns the tile's
// columns [64g, 64g + 64), and its warpgroup r the rows [r BM/2, (r+1) BM/2)
// (BM / 128 m64n64k16 wgmma per 16-deep K step). The two warpgroups of a
// column group decode its columns of the weight tile together, half each,
// and sync on their own named barrier: the column groups never wait for
// each other, and 16 warps share the decode. Warp 16 is the producer: one
// thread keeps the TMA loads of x's tile and the raw weight tile in flight
// through a ring of stages, each with a `full` and an `empty` mbarrier.
constexpr int TC_BN = 128, TC_BK = 64;
constexpr int TC_THREADS = 4 * 128 + 32;
constexpr int TC_SUB = 64 * 128;    // one 64-row tile of 128-byte rows, 8 KB
constexpr int TC_SMEM_MAX = 232448;

// How the weight tile reaches the tensor cores:
//   TC_DIRECT  bf16 w: TMA writes it in the swizzled layout wgmma reads
//   TC_VALUE   f32 w or int codes: v = w, split into bf16 pieces
//   TC_FQ      f32/bf16 w: v = fq_code(w), split into bf16 pieces
//   TC_UNPACK  K-packed int32 words: v = the sign-extended field
enum TcKind { TC_DIRECT = 0, TC_VALUE = 1, TC_FQ = 2, TC_UNPACK = 3 };

template <int KIND, typename WT, int BITS, int BM>
struct TcTraits {
  static constexpr int kCpw = KIND == TC_UNPACK ? 32 / BITS : 1;
  // raw rows per stage: K rows, or the packed word rows 64 K rows can span
  static constexpr int kRawRows =
      KIND != TC_UNPACK  ? TC_BK
      : TC_BK % kCpw == 0 ? TC_BK / kCpw
                          : TC_BK / kCpw + 2;
  // bf16 pieces per decoded value: one holds a bf16 weight, an int8 code or
  // a packed field (|v| <= 128) exactly; two an int16 code; three any f32
  // value (an f32 weight, an int32 code, a fake-quant code). Shared memory
  // holds two piece tiles; a third piece is written over the first once
  // the first two have been multiplied (`kThird`)
  static constexpr int kPieces =
      (KIND == TC_DIRECT || KIND == TC_UNPACK || sizeof(WT) == 1) ? 1 : 2;
  static constexpr bool kThird =
      KIND == TC_FQ || (KIND == TC_VALUE && sizeof(WT) == 4);
  static constexpr int kABytes = BM * TC_BK * 2;
  static constexpr int kBBytes =
      KIND == TC_DIRECT ? TC_BN * TC_BK * 2
                        : kRawRows * TC_BN * (int)sizeof(WT);
  static constexpr int kStageBytes = (kABytes + kBBytes + 1023) / 1024 * 1024;
  // decoded tiles [column group][2 buffers][piece]: a warpgroup decodes
  // step kt + 1 while its partner's products of step kt may still read
  static constexpr int kDecodedBytes =
      KIND == TC_DIRECT ? 0 : 2 * 2 * kPieces * TC_SUB;
  static constexpr int kFit =
      (TC_SMEM_MAX - 1024 - 256 - kDecodedBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kDecodedBytes + 256;
  static_assert(kStages >= 2, "shared memory holds fewer than two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)), "r"(bytes) : "memory");
}
// one 2-D TMA box at coordinates (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO). LBO: 16 bytes for a K-major
// operand (unused there), 8192 for an MN-major one (the next 64-wide atom;
// never reached, each wgmma reads 64 rows or columns).
template <bool MN>
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t lbo = MN ? 8192 : 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// bytes from one 16-deep K step to the next: along a K-major row, or down
// 16 rows of an MN-major tile
template <bool MN>
__host__ __device__ constexpr uint32_t k_step_bytes() {
  return MN ? 16 * 128 : 32;
}

// Byte offset of element j (0..63) of row r in a 128-byte-swizzled tile, the
// layout TMA's SWIZZLE_128B writes: 16-byte chunk (j / 8) xor (r % 8).
__device__ __forceinline__ int sw128_off(int r, int j) {
  return r * 128 + ((((j >> 3) ^ r) & 7) << 4) + ((j & 7) << 1);
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
// d (64 x 64 f32, the wgmma fragment) += A (64 x 16) * B (16 x 64), bf16
// operands in shared memory; TA / TB: 1 for an MN-major operand
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
// Pin the accumulators around a batch of wgmma: without it the compiler may
// copy them between asynchronous wgmma, and ptxas then serializes every
// wgmma (C7515), so the decode no longer overlaps the tensor cores.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Sync the column group's 256 threads on named barrier `bar`, OR-reducing
// `any` on the way: the result is the same in every thread of the group.
// The decode writes shared memory through the generic proxy and wgmma reads
// it through the async proxy: each writing thread fences before this sync.
__device__ __forceinline__ bool group_any(bool any, int bar) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 256, q;\nselp.u32 %0, 1, 0, p;\n}"
      : "=r"(r) : "r"(static_cast<uint32_t>(any)), "r"(bar) : "memory");
  return r != 0;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(bits)));
}

// Write V decoded values, elements j .. j + V - 1 of row r, as bf16 pieces
// p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1). Each difference
// is exact in f32 (a value less its own rounding), and an f32 value's 24
// significant bits fill at most 8 per piece, so p0 + p1 + p2 == v for any
// f32 v of magnitude 2^-102 or more (integer codes, and weights: below
// that, p2 may be subnormal and lose bits). For an integer |v| < 2^17,
// v - p0 is an integer of at most 256, so p2 == 0. PASS 0 writes p0 and,
// with NP == 2 tiles, p1, and returns whether some p1 is nonzero; PASS 1
// writes p2 over p0's tile.
template <int V, int NP, int PASS>
__device__ __forceinline__ bool put_pieces(uint8_t* hi_tile, uint8_t* lo_tile,
                                           int r, int j, const float (&v)[V]) {
  uint32_t hi[V / 2], lo[V / 2];
  bool any = false;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const uint32_t h0 = bf16_bits(v[2 * i]), h1 = bf16_bits(v[2 * i + 1]);
    hi[i] = h0 | (h1 << 16);
    if (NP == 2) {
      const float r0 = v[2 * i] - bf16_value(h0);
      const float r1 = v[2 * i + 1] - bf16_value(h1);
      const uint32_t l0 = bf16_bits(r0), l1 = bf16_bits(r1);
      lo[i] = l0 | (l1 << 16);
      any |= (lo[i] & 0x7FFF7FFFu) != 0;
      if (PASS == 1)
        hi[i] = bf16_bits(r0 - bf16_value(l0)) |
                (bf16_bits(r1 - bf16_value(l1)) << 16);
    }
  }
  constexpr bool kLo = NP == 2 && PASS == 0;
  constexpr int kChunks = V < 8 ? 1 : V / 8;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int off = sw128_off(r, j + 8 * q);
    if (V == 4) {
      *reinterpret_cast<uint2*>(hi_tile + off) = make_uint2(hi[0], hi[1]);
      if (kLo)
        *reinterpret_cast<uint2*>(lo_tile + off) = make_uint2(lo[0], lo[1]);
    } else {
      *reinterpret_cast<uint4*>(hi_tile + off) = make_uint4(
          hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
      if (kLo)
        *reinterpret_cast<uint4*>(lo_tile + off) = make_uint4(
            lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
    }
  }
  return any;
}

template <typename WT, int V>
__device__ __forceinline__ void cvt16(const uint4& raw, float (&v)[V]) {
  const WT* p = reinterpret_cast<const WT*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
}

// Decode column group g's 64 columns of the raw weight tile of K rows
// k0 .. k0+63, shared by its 256 threads (tp: the thread's index among them)
// into bf16 pieces (the tile of piece p at bd + p * TC_SUB; PASS 1: the
// third piece, at bd), in the layout of the raw tile: N-major (w row-major:
// raw rows are K rows of TC_BN elements) or K-major (w a transposed view:
// raw rows are the tile's columns, TC_BK elements each). Consecutive
// threads read consecutive 16 bytes of a raw row and write consecutive
// swizzled chunks: no bank conflicts. Ends with the group's sync. Returns
// (PASS 0) bit 0: a second piece is nonzero somewhere in the group's tile
// (the same in every thread of the group), and with THIRD bit 1: this
// thread's part may need a third piece (an f32 weight, or an integer code
// of 2^17 or more, by a running max |v|).
template <int KIND, typename WT, int BITS, bool B_MN, int PASS, bool THIRD>
__device__ __forceinline__ int decode_tile(const uint8_t* raw, uint8_t* bd,
                                           int g, int tp, int k0, int K,
                                           float d, float qm, float tt) {
  using Tr = TcTraits<KIND, WT, BITS, 128>;   // the raw tile's shape only
  constexpr bool kWeights = KIND == TC_VALUE && std::is_same<WT, float>::value;
  bool any = false;
  float vmax = 0.f;
  if constexpr (KIND == TC_UNPACK) {
    constexpr int cpw = Tr::kCpw;
    const int kw0 = k0 / cpw;
#pragma unroll
    for (int i = 0; i < TC_BK * 16 / 256; ++i) {
      const int it = tp + i * 256;
      const int r = it >> 4, c = it & 15, k = k0 + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < K) {     // fields past K in the last word are never read
        const int4 wd = *reinterpret_cast<const int4*>(
            raw + ((k / cpw - kw0) * TC_BN + g * 64 + c * 4) * 4);
        const int f = k - (k / cpw) * cpw;
        v[0] = unpack_field<BITS>(wd.x, f);
        v[1] = unpack_field<BITS>(wd.y, f);
        v[2] = unpack_field<BITS>(wd.z, f);
        v[3] = unpack_field<BITS>(wd.w, f);
      }
      put_pieces<4, 1, 0>(bd, bd, r, c * 4, v);
    }
  } else {
    constexpr int V = 16 / sizeof(WT), CH = 64 / V;
    constexpr int ld = (B_MN ? TC_BN : TC_BK) * sizeof(WT);
    const uint8_t* seg =
        raw + (B_MN ? g * 64 * static_cast<int>(sizeof(WT)) : g * 64 * ld);
#pragma unroll
    for (int i = 0; i < 64 * CH / 256; ++i) {
      const int it = tp + i * 256;
      const int r = it / CH, c = it % CH;
      float v[V];
      cvt16<WT, V>(*reinterpret_cast<const uint4*>(seg + r * ld + c * 16), v);
      if constexpr (KIND == TC_FQ) {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = fq_code(v[q], d, qm, tt);
      }
      if constexpr (THIRD && !kWeights && PASS == 0) {
#pragma unroll
        for (int q = 0; q < V; ++q) vmax = fmaxf(vmax, fabsf(v[q]));
      }
      any |= put_pieces<V, Tr::kPieces, PASS>(bd, bd + TC_SUB, r, c * V, v);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const bool third = THIRD && (kWeights || vmax >= 131072.f);
  return (group_any(any, 1 + g) ? 1 : 0) | (third ? 2 : 0);
}

// grid (ceil(N/128), ceil(M/BM)), block TC_THREADS. ta: x's tile (K-major,
// box 64 x BM, or with A_MN the M-major view, BM / 64 boxes 64 x 64); tb: the
// weight tile (TC_DIRECT: swizzled bf16 boxes as for x; else the raw tile,
// unswizzled). out (M, N) row-major, f32 or (out_bf16) bf16:
// out = acc * d (TC_FQ) * e.scale[n * e.scale_stride] (when e.scale is set).
template <int KIND, typename WT, int BITS, int BM, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc(const __grid_constant__ CUtensorMap ta,
        const __grid_constant__ CUtensorMap tb, EpiArgs e, void* out,
        int out_bf16, int M, int N, int K) {
  using Tr = TcTraits<KIND, WT, BITS, BM>;
  constexpr int S = Tr::kStages;
  constexpr int H = BM / 128;      // 64-row slabs of x per warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* decoded = smem + S * Tr::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(decoded + Tr::kDecodedBytes);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);     // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 512) {                // producer warp
    if (tid == 512) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S, k0 = kt * TC_BK;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], Tr::kABytes + Tr::kBBytes);
        uint8_t* a = smem + s * Tr::kStageBytes;
        uint8_t* b = a + Tr::kABytes;
        if (A_MN) {
          for (int h = 0; h < BM / 64; ++h)
            tma_load(&ta, a + h * TC_SUB, &full[s], m0 + 64 * h, k0);
        } else {
          tma_load(&ta, a, &full[s], k0, m0);
        }
        if (KIND == TC_DIRECT && B_MN) {
          tma_load(&tb, b, &full[s], n0, k0);
          tma_load(&tb, b + TC_SUB, &full[s], n0 + 64, k0);
        } else if (B_MN) {
          tma_load(&tb, b, &full[s], n0, k0 / Tr::kCpw);
        } else {
          tma_load(&tb, b, &full[s], k0, n0);
        }
      }
    }
    return;
  }

  // column group g, row half r; t: the thread's index in its warpgroup
  const int g = (tid >> 7) & 1, r = tid >> 8, t = tid & 127;
  float acc[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float d = 1.f, qm = 0.f, tt = 1.f;
  if constexpr (KIND == TC_FQ) {
    d = fmaxf(*e.fq_d, kEps);
    qm = fmaxf(*e.fq_qm, kEps);
    tt = *e.fq_t;
  }
  // The K loop, instantiated with the third-piece pass and without: the
  // pass's mere presence in the loop made fake-quant at 8 bits 15-30%
  // slower on the H100, though it never ran there. A call takes it only
  // where a third piece is possible: f32 weights and int32 codes always,
  // fake-quant codes when the quantizer's largest code, rint(max(qm^t,
  // eps^t) / d), reaches 2^17 (within 2^-10, for powf's last-bit error);
  // the choice is the same in every thread of the grid.
  auto k_loop = [&](auto third) {
    constexpr bool kThirdPass = decltype(third)::value;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const uint8_t* st = smem + s * Tr::kStageBytes;
      const uint32_t a = smem_u32(st);
      // the decoded tiles of this step
      auto tiles = [&] {
        return decoded + (g * 2 + (kt & 1)) * Tr::kPieces * TC_SUB;
      };
      uint32_t b;
      int votes = 0;
      if constexpr (KIND == TC_DIRECT) {
        b = smem_u32(st + Tr::kABytes + g * TC_SUB);
      } else {
        votes = decode_tile<KIND, WT, BITS, B_MN, 0, kThirdPass>(
            st + Tr::kABytes, tiles(), g, r * 128 + t, kt * TC_BK, K, d, qm,
            tt);
        b = smem_u32(tiles());
      }
      // one batch of wgmma per bf16 piece of the weight tile at b_piece; the
      // second piece's batch only where the group's vote found one nonzero
      // (votes & 1 is uniform over the group)
      auto products = [&](uint32_t b_piece) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
          const uint64_t db =
              sw128_desc<B_MN>(b_piece + kk * k_step_bytes<B_MN>());
#pragma unroll
          for (int h = 0; h < H; ++h)
            wgmma_m64n64k16<A_MN, B_MN>(
                acc[h],
                sw128_desc<A_MN>(a + (r * H + h) * TC_SUB +
                                 kk * k_step_bytes<A_MN>()),
                db);
        }
        wgmma_commit();
      };
#pragma unroll
      for (int h = 0; h < H; ++h) fence_operands(acc[h]);
      products(b);
      if (Tr::kPieces == 2 && (votes & 1)) products(b + TC_SUB);
      // With a decode, step kt's products finish before the next decode: a
      // wgmma batch left in flight across the decode makes ptxas serialize
      // every wgmma (C7515). The two groups still overlap each other's decode
      // and products. Without one, step kt - 1's products are done here.
      if constexpr (KIND == TC_DIRECT) {
        wgmma_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(&empty[(kt - 1) % S]);
      } else {
        wgmma_wait<0>();
        // A third piece only where the group's second vote finds one may be
        // nonzero (a code of 2^17 or more, or an f32 weight). The vote's
        // sync also means the partner's products of this step are done, so
        // the third piece may overwrite the first; the raw tile is still in
        // stage s, which is released only after this.
        if constexpr (kThirdPass) {
          if ((votes & 1) && group_any(votes & 2, 1 + g)) {
            decode_tile<KIND, WT, BITS, B_MN, 1, true>(
                smem + s * Tr::kStageBytes + Tr::kABytes, tiles(), g,
                r * 128 + t, kt * TC_BK, K, d, qm, tt);
#pragma unroll
            for (int h = 0; h < H; ++h) fence_operands(acc[h]);
            products(b);
            wgmma_wait<0>();
          }
        }
        if (t == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) fence_operands(acc[h]);
    }
  };
  if constexpr (KIND == TC_FQ) {
    const float top = fmaxf(tt == 1.f ? qm : powf(qm, tt), powf(kEps, tt));
    if (rintf(top / d) >= 131072.f * (1.f - 0x1p-10f))
      k_loop(std::true_type{});
    else
      k_loop(std::false_type{});
  } else {
    k_loop(std::integral_constant<bool, Tr::kThird>{});
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < H; ++h) fence_operands(acc[h]);

  // fragment of m64n64: thread (warp w, lane l) holds rows 16w + l/4 (+8)
  // and columns 8j + 2(l%4) (+1) of each 64 x 64 accumulator
  const int w = t >> 5, l = t & 31;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + (r * H + h) * 64 + w * 16 + (l >> 2) + half * 8;
        const int col = n0 + g * 64 + j * 8 + (l & 3) * 2;
        if (row >= M || col >= N) continue;     // N is even: col + 1 < N
        float v0 = acc[h][j * 4 + half * 2] * d;
        float v1 = acc[h][j * 4 + half * 2 + 1] * d;
        if (e.scale != nullptr) {
          v0 *= e.scale[col * e.scale_stride];
          v1 *= e.scale[(col + 1) * e.scale_stride];
        }
        const long long o = static_cast<long long>(row) * N + col;
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
      }
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map over (inner, outer) elements, rows `stride` bytes apart, read in
// boxes of (box_inner, box_outer); out-of-bounds elements read as zero.
bool tensor_map(CUtensorMap* m, CUtensorMapDataType dt, const void* p,
                long long inner, long long outer, long long stride,
                int box_inner, int box_outer, bool swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                       static_cast<cuuint32_t>(box_outer)};
  cuuint32_t unit[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(p), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename WT> constexpr CUtensorMapDataType tma_dtype();
template <> constexpr CUtensorMapDataType tma_dtype<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType tma_dtype<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType tma_dtype<int8_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}
template <> constexpr CUtensorMapDataType tma_dtype<int16_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT16;
}
template <> constexpr CUtensorMapDataType tma_dtype<int32_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_INT32;
}

struct TcCall {
  const void* x; long long lda; bool a_mn;
  const void* w; long long ldb; bool b_mn;
  EpiArgs e; void* out; int out_bf16; int M, N, K, bm;
  cudaStream_t st;
};

template <int KIND, typename WT, int BITS, int BM, bool A_MN, bool B_MN>
cudaError_t launch_tc(const TcCall& c) {
  using Tr = TcTraits<KIND, WT, BITS, BM>;
  // A runtime call first: it makes the device's primary context current in
  // this thread, which cuTensorMapEncodeTiled needs (in a thread whose
  // first CUDA call this is, such as autograd's worker, it fails without
  // one).
  auto kern = gemm_tc<KIND, WT, BITS, BM, A_MN, B_MN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tr::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  bool ok = A_MN ? tensor_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.x, c.M,
                              c.K, c.lda * 2, 64, TC_BK, true)
                 : tensor_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.x, c.K,
                              c.M, c.lda * 2, TC_BK, BM, true);
  const long long es = sizeof(WT);
  const long long rows = (c.K + Tr::kCpw - 1) / Tr::kCpw;
  if (KIND == TC_DIRECT)
    ok = ok && (B_MN ? tensor_map(&tb, tma_dtype<WT>(), c.w, c.N, c.K,
                                  c.ldb * es, 64, TC_BK, true)
                     : tensor_map(&tb, tma_dtype<WT>(), c.w, c.K, c.N,
                                  c.ldb * es, TC_BK, TC_BN, true));
  else
    ok = ok && (B_MN ? tensor_map(&tb, tma_dtype<WT>(), c.w, c.N, rows,
                                  c.ldb * es, TC_BN, Tr::kRawRows, false)
                     : tensor_map(&tb, tma_dtype<WT>(), c.w, c.K, c.N,
                                  c.ldb * es, TC_BK, TC_BN, false));
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((c.N + TC_BN - 1) / TC_BN, (c.M + BM - 1) / BM);
  kern<<<grid, TC_THREADS, Tr::kSmem, c.st>>>(ta, tb, c.e, c.out, c.out_bf16,
                                              c.M, c.N, c.K);
  return cudaGetLastError();
}

// The block height by c.bm (128 or 256)
template <int KIND, typename WT, int BITS, bool A_MN, bool B_MN>
cudaError_t tc_rows(const TcCall& c) {
  if (c.bm == 256) return launch_tc<KIND, WT, BITS, 256, A_MN, B_MN>(c);
  if (c.bm == 128) return launch_tc<KIND, WT, BITS, 128, A_MN, B_MN>(c);
  return cudaErrorInvalidValue;
}

// x's layout by c.a_mn; w's by c.b_mn, where the kind takes both (int codes
// and packed words come row-major only)
template <int KIND, typename WT, int BITS>
cudaError_t tc_layouts(const TcCall& c) {
  constexpr bool kRowMajorOnly =
      KIND == TC_UNPACK ||
      (KIND == TC_VALUE && !std::is_same<WT, float>::value);
  if constexpr (kRowMajorOnly) {
    if (!c.b_mn) return cudaErrorInvalidValue;
    return c.a_mn ? tc_rows<KIND, WT, BITS, true, true>(c)
                  : tc_rows<KIND, WT, BITS, false, true>(c);
  } else {
    if (c.a_mn)
      return c.b_mn ? tc_rows<KIND, WT, BITS, true, true>(c)
                    : tc_rows<KIND, WT, BITS, true, false>(c);
    return c.b_mn ? tc_rows<KIND, WT, BITS, false, true>(c)
                  : tc_rows<KIND, WT, BITS, false, false>(c);
  }
}

cudaError_t tc_by_epilogue(int epi, int w_dtype, int bits, const TcCall& c) {
  if (epi == EPI_NONE || epi == EPI_COL_MASK) {
    if (w_dtype == DT_BF16) return tc_layouts<TC_DIRECT, __nv_bfloat16, 0>(c);
    if (w_dtype == DT_F32) return tc_layouts<TC_VALUE, float, 0>(c);
  } else if (epi == EPI_FAKE_QUANT || epi == EPI_FQ_MASK) {
    if (w_dtype == DT_BF16) return tc_layouts<TC_FQ, __nv_bfloat16, 0>(c);
    if (w_dtype == DT_F32) return tc_layouts<TC_FQ, float, 0>(c);
  } else if (epi == EPI_DEQUANT) {
    if (w_dtype == DT_I8) return tc_layouts<TC_VALUE, int8_t, 0>(c);
    if (w_dtype == DT_I16) return tc_layouts<TC_VALUE, int16_t, 0>(c);
    if (w_dtype == DT_I32) return tc_layouts<TC_VALUE, int32_t, 0>(c);
  } else if (epi == EPI_UNPACK && w_dtype == DT_I32) {
    if (bits == 2) return tc_layouts<TC_UNPACK, int32_t, 2>(c);
    if (bits == 3) return tc_layouts<TC_UNPACK, int32_t, 3>(c);
    if (bits == 4) return tc_layouts<TC_UNPACK, int32_t, 4>(c);
    if (bits == 8) return tc_layouts<TC_UNPACK, int32_t, 8>(c);
  }
  return cudaErrorInvalidValue;
}

struct GemmCall {
  const void* x; int x_bf16; const void* w; EpiArgs e; void* out;
  int out_bf16; int M, N, K, cluster, k_slice;
  cudaStream_t st;
};

template <int EPI, typename WT, int BITS, int MT>
cudaError_t launch_small_m(const GemmCall& c) {
  auto kern = gemm_small_m<EPI, WT, BITS, MT>;
  const int win = c.k_slice < SM_WINDOW ? c.k_slice : SM_WINDOW;
  const int smem = sm_smem_bytes<MT>(win);     // above 48 KB: opt in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cluster, (c.N + SM_BN - 1) / SM_BN);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, c.x, c.x_bf16, c.w, c.e, c.out,
                            c.out_bf16, c.M, c.N, c.K, c.k_slice);
}

// M <= 8: the small-M variant, with 4 or 8 rows of accumulators; M > 8
// (f32 x only): the SIMT variant
template <int EPI, typename WT, int BITS>
cudaError_t launch(const GemmCall& c) {
  if (c.M <= 4) return launch_small_m<EPI, WT, BITS, 4>(c);
  if (c.M <= SM_MMAX) return launch_small_m<EPI, WT, BITS, 8>(c);
  if (c.x_bf16) return cudaErrorInvalidValue;
  dim3 grid((c.N + GM_BN - 1) / GM_BN, (c.M + GM_BM - 1) / GM_BM);
  gemm_general<EPI, WT, BITS><<<grid, GM_THREADS, 0, c.st>>>(
      static_cast<const float*>(c.x), c.w, c.e, c.out, c.out_bf16, c.M, c.N,
      c.K);
  return cudaGetLastError();
}

cudaError_t by_epilogue(int epi, int w_dtype, int bits, const GemmCall& c) {
#define L(E, W, B) launch<E, W, B>(c)
  if (epi == EPI_FAKE_QUANT) {
    if (w_dtype == DT_F32) return L(EPI_FAKE_QUANT, float, 0);
    if (w_dtype == DT_BF16) return L(EPI_FAKE_QUANT, __nv_bfloat16, 0);
  } else if (epi == EPI_DEQUANT) {
    if (w_dtype == DT_I8) return L(EPI_DEQUANT, int8_t, 0);
    if (w_dtype == DT_I16) return L(EPI_DEQUANT, int16_t, 0);
    if (w_dtype == DT_I32) return L(EPI_DEQUANT, int32_t, 0);
  } else if (epi == EPI_NONE) {
    if (w_dtype == DT_F32) return L(EPI_NONE, float, 0);
    if (w_dtype == DT_BF16) return L(EPI_NONE, __nv_bfloat16, 0);
  } else if (epi == EPI_COL_MASK) {
    if (w_dtype == DT_F32) return L(EPI_COL_MASK, float, 0);
    if (w_dtype == DT_BF16) return L(EPI_COL_MASK, __nv_bfloat16, 0);
  } else if (epi == EPI_FQ_MASK) {
    if (w_dtype == DT_F32) return L(EPI_FQ_MASK, float, 0);
    if (w_dtype == DT_BF16) return L(EPI_FQ_MASK, __nv_bfloat16, 0);
  } else if (epi == EPI_UNPACK && w_dtype == DT_I32) {
    if (bits == 2) return L(EPI_UNPACK, int32_t, 2);
    if (bits == 3) return L(EPI_UNPACK, int32_t, 3);
    if (bits == 4) return L(EPI_UNPACK, int32_t, 4);
    if (bits == 8) return L(EPI_UNPACK, int32_t, 8);
  }
#undef L
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers; x is (M, K) row-major (f32 or bf16; f32 only when M > 8), w
// (K, N) or (ceil(K/cpw), N) row-major, out (M, N) row-major (f32 or bf16);
// scale has N floats (scale_stride 1) or one (scale_stride 0). N must be a
// multiple of 4 and w 16-byte aligned. When M <= 8, `cluster` blocks of
// `k_slice` K rows each share a column strip (gemm_core.small_m_plan):
// 1 <= cluster <= 8, k_slice a multiple of 256 and, above 2048, of 2048,
// and every block holds a row of K.
extern "C" int repro_gemm(const void* x, int x_dtype, const void* w,
                          int w_dtype, int epi, int bits, const float* scale,
                          int scale_stride, const float* fq_d,
                          const float* fq_qm, const float* fq_t, void* out,
                          int out_dtype, int M, int N, int K, int cluster,
                          int k_slice, void* stream) {
  const bool dt_ok = (x_dtype == DT_F32 || x_dtype == DT_BF16) &&
                     (out_dtype == DT_F32 || out_dtype == DT_BF16);
  const bool plan_ok =
      M > SM_MMAX ||
      (cluster >= 1 && cluster <= SM_CLUSTER_MAX && k_slice > 0 &&
       k_slice % (SM_GROUPS * 8) == 0 &&
       (k_slice <= SM_WINDOW || k_slice % SM_WINDOW == 0) &&
       (long long)(cluster - 1) * k_slice < K &&
       (long long)cluster * k_slice >= K);
  if (!dt_ok || !plan_ok || M < 1 || N < 1 || K < 1 || N % 4)
    return cudaErrorInvalidValue;
  const GemmCall c{x, x_dtype == DT_BF16, w,
                   EpiArgs{scale, scale_stride, fq_d, fq_qm, fq_t}, out,
                   out_dtype == DT_BF16, M, N, K, cluster, k_slice,
                   static_cast<cudaStream_t>(stream)};
  return by_epilogue(epi, w_dtype, bits, c);
}

// The tensor-core variant, for M > 8 and bf16 x. x is (M, K) with rows lda
// elements apart, or with x_transposed the view of a (K, M) array with rows
// lda apart; w is (K, N) (or (ceil(K/cpw), N) words) with rows ldb apart,
// or with w_transposed (float weights only) the view of an (N, K) array.
// Both base addresses and row strides must be multiples of 16 bytes, and N
// even. bm: rows per block, 128 or 256 (`gemm_core.tc_block_m`); it never
// changes the sums, only how the rows are shared out. No split-K, no
// workspace. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a combination it does not take or a tensor map
// the driver refuses.
extern "C" int repro_gemm_tc(const void* x, long long lda, int x_transposed,
                             const void* w, int w_dtype, long long ldb,
                             int w_transposed, int epi, int bits,
                             const float* scale, int scale_stride,
                             const float* fq_d, const float* fq_qm,
                             const float* fq_t, void* out, int out_dtype,
                             int M, int N, int K, int bm, void* stream) {
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return cudaErrorInvalidValue;
  const TcCall c{x, lda, x_transposed != 0, w, ldb, w_transposed == 0,
                 EpiArgs{scale, scale_stride, fq_d, fq_qm, fq_t}, out,
                 out_dtype == DT_BF16, M, N, K, bm,
                 static_cast<cudaStream_t>(stream)};
  return tc_by_epilogue(epi, w_dtype, bits, c);
}
