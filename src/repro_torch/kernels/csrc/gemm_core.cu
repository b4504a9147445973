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
//   from HBM (bf16 2 B, int8 1 B, 4-bit 0.5 B per element): each weight
//   feeds at most 8 FMAs. A block owns 128 columns and 8 K-groups of 16
//   rows per 128-row chunk; threads map along N, 4 adjacent columns per
//   vector load, so a warp reads whole 128-byte lines. For int codes a
//   thread starts all 16 of its rows' loads (or the at most 5 packed word
//   rows they span) before it decodes any; fake-quant, whose decode (an
//   IEEE divide and a rint per element) is heavier, goes row by row. The
//   grid splits K across blocks so narrow N still fills the SMs; K-groups
//   reduce through shared memory and K-splits through an f32 workspace
//   and a second launch (`reduce_splits`), both in a fixed order.
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
//   weight tile it reads, 8 times per weight at M = 2048 with BM = 256 (32
//   in the SIMT variant's 64-row tile), and a fake-quant decode costs an
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
// - SIMT (M > 8 with f32 x; `gemm_general`): a 64 x 64 tile in f32 FMAs
//   on the CUDA cores, 16-row K steps through shared memory, 4 x 4 outputs
//   per thread. Kept for f32 x: the f32 configuration's 1e-4 card-vs-CPU
//   parity rests on f32 products, which bf16 tensor cores do not give.
//
// Determinism: no atomics, and no split-K at M > 8. The K order and the
// tiles depend only on (M, N, K), never on the epilogue: EPI_DEQUANT and
// EPI_UNPACK decode identical codes, so their outputs are bitwise equal
// and packed serving emits the same tokens as int8 serving. Rounding uses
// rintf (ties to even, like torch.round and jnp.round). Packed fields
// decode only for k < K; the zero tail of the last word is never relied on.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I16 = 3, DT_I32 = 4 };
enum Epi {
  EPI_FAKE_QUANT = 0, EPI_DEQUANT = 1, EPI_UNPACK = 2, EPI_NONE = 3,
  EPI_COL_MASK = 4, EPI_FQ_MASK = 5
};

constexpr float kEps = 1e-12f;

// ---- raw loads of 4 adjacent elements, and their conversion to f32 -------
template <typename WT> struct Raw4;
template <> struct Raw4<float> { using T = float4; };
template <> struct Raw4<__nv_bfloat16> { using T = uint2; };
template <> struct Raw4<int8_t> { using T = char4; };
template <> struct Raw4<int16_t> { using T = short4; };
template <> struct Raw4<int32_t> { using T = int4; };

template <typename WT>
__device__ __forceinline__ typename Raw4<WT>::T ld4(const WT* p) {
  return *reinterpret_cast<const typename Raw4<WT>::T*>(p);
}

__device__ __forceinline__ void cvt4(float4 t, float v[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void cvt4(uint2 t, float v[4]) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void cvt4(char4 t, float v[4]) {
  v[0] = (float)t.x; v[1] = (float)t.y; v[2] = (float)t.z; v[3] = (float)t.w;
}
__device__ __forceinline__ void cvt4(short4 t, float v[4]) {
  v[0] = (float)t.x; v[1] = (float)t.y; v[2] = (float)t.z; v[3] = (float)t.w;
}
__device__ __forceinline__ void cvt4(int4 t, float v[4]) {
  v[0] = (float)t.x; v[1] = (float)t.y; v[2] = (float)t.z; v[3] = (float)t.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) { return v; }
__device__ __forceinline__ float to_f32(int32_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
__device__ __forceinline__ float fake_quant(float w, float d, float qm,
                                            float t) {
  return d * fq_code(w, d, qm, t);
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

// Rows [kb, kb + nk) of an (rows, N) array at 4 adjacent columns, every raw
// load started before any conversion so R loads are in flight.
template <int R, typename WT>
__device__ __forceinline__ void dense_rows(const WT* p, int N, int kb, int nk,
                                           float (&v)[R][4]) {
  typename Raw4<WT>::T raw[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < nk) raw[i] = ld4(p + (long long)(kb + i) * N);
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < nk) cvt4(raw[i], v[i]);
}

// The weight operand of one epilogue, at the 4 columns starting at n:
// `rows<R>(kb, nk, v)` yields decoded f32 rows kb .. kb + nk - 1 (nk <= R).
template <int EPI, typename WT, int BITS>
struct Weights;

template <typename WT>
struct Weights<EPI_FAKE_QUANT, WT, 0> {
  const WT* p; int N; float d, qm, t;
  __device__ Weights(const void* w, int N_, int n, const EpiArgs& e)
      : p(reinterpret_cast<const WT*>(w) + n), N(N_),
        d(fmaxf(*e.fq_d, kEps)), qm(fmaxf(*e.fq_qm, kEps)), t(*e.fq_t) {}
  template <int R>
  __device__ void rows(int kb, int nk, float (&v)[R][4]) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= nk) break;
      cvt4(ld4(p + (long long)(kb + i) * N), v[i]);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i][c] = fake_quant(v[i][c], d, qm, t);
    }
  }
};

template <typename WT>
struct Weights<EPI_DEQUANT, WT, 0> {
  const WT* p; int N; float s[4];
  __device__ Weights(const void* w, int N_, int n, const EpiArgs& e)
      : p(reinterpret_cast<const WT*>(w) + n), N(N_) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = e.scale[(n + c) * e.scale_stride];
  }
  template <int R>
  __device__ void rows(int kb, int nk, float (&v)[R][4]) const {
    dense_rows<R>(p, N, kb, nk, v);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= nk) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i][c] = v[i][c] * s[c];
    }
  }
};

template <int BITS>
struct Weights<EPI_UNPACK, int32_t, BITS> {
  static constexpr int kCpw = 32 / BITS;
  const int32_t* p; int N; float s[4];
  __device__ Weights(const void* w, int N_, int n, const EpiArgs& e)
      : p(reinterpret_cast<const int32_t*>(w) + n), N(N_) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = e.scale[(n + c) * e.scale_stride];
  }
  // rows kb .. kb + R - 1 span at most NW word rows; load those first
  template <int R>
  __device__ void rows(int kb, int nk, float (&v)[R][4]) const {
    constexpr int NW = (R - 1) / kCpw + 2;
    const int kw0 = kb / kCpw, kwl = (kb + nk - 1) / kCpw;
    int4 words[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      words[j] = kw0 + j <= kwl ? ld4(p + (long long)(kw0 + j) * N)
                                : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= nk) break;
      const int k = kb + i, kw = k / kCpw, f = k - kw * kCpw;
      int4 wd = words[0];
#pragma unroll
      for (int j = 1; j < NW; ++j)
        if (kw - kw0 == j) wd = words[j];
      v[i][0] = unpack_field<BITS>(wd.x, f) * s[0];
      v[i][1] = unpack_field<BITS>(wd.y, f) * s[1];
      v[i][2] = unpack_field<BITS>(wd.z, f) * s[2];
      v[i][3] = unpack_field<BITS>(wd.w, f) * s[3];
    }
  }
};

template <typename WT>
struct Weights<EPI_NONE, WT, 0> {
  const WT* p; int N;
  __device__ Weights(const void* w, int N_, int n, const EpiArgs&)
      : p(reinterpret_cast<const WT*>(w) + n), N(N_) {}
  template <int R>
  __device__ void rows(int kb, int nk, float (&v)[R][4]) const {
    dense_rows<R>(p, N, kb, nk, v);
  }
};

// w * m[n]: the dequant decode on a float weight (one multiply per element,
// as the plain version's w * mask[None, :])
template <typename WT>
struct Weights<EPI_COL_MASK, WT, 0> : Weights<EPI_DEQUANT, WT, 0> {
  __device__ Weights(const void* w, int N_, int n, const EpiArgs& e)
      : Weights<EPI_DEQUANT, WT, 0>(w, N_, n, e) {}
};

template <typename WT>
struct Weights<EPI_FQ_MASK, WT, 0> : Weights<EPI_FAKE_QUANT, WT, 0> {
  float m[4];
  __device__ Weights(const void* w, int N_, int n, const EpiArgs& e)
      : Weights<EPI_FAKE_QUANT, WT, 0>(w, N_, n, e) {
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = e.scale[(n + c) * e.scale_stride];
  }
  template <int R>
  __device__ void rows(int kb, int nk, float (&v)[R][4]) const {
    Weights<EPI_FAKE_QUANT, WT, 0>::template rows<R>(kb, nk, v);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= nk) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i][c] = v[i][c] * m[c];
    }
  }
};

// ---- small-M variant -------------------------------------------------------
constexpr int SM_MMAX = 8;     // rows of x per launch
constexpr int SM_TX = 32;      // threads along N, 4 columns each
constexpr int SM_BN = SM_TX * 4;
constexpr int SM_TY = 8;       // K-groups per block
constexpr int SM_KB = 16;      // rows per K-group per chunk
constexpr int SM_BK = SM_TY * SM_KB;

// grid (ceil(N/128), splits), block (32, 8). Split s covers chunks
// [s*cps, (s+1)*cps) of SM_BK rows. With one split the block writes `out`;
// otherwise it writes ws[s][m][n] for the reduce kernel.
template <typename XT, typename OT, int EPI, typename WT, int BITS>
__global__ void __launch_bounds__(SM_TX * SM_TY)
gemm_small_m(const XT* __restrict__ x, const void* __restrict__ w,
             EpiArgs e, OT* __restrict__ out, float* __restrict__ ws,
             int M, int N, int K, int chunks_per_split) {
  __shared__ float xs[SM_MMAX][SM_BK];
  __shared__ float red[SM_TY][SM_MMAX][SM_BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * SM_TX + tx;
  const int n0 = blockIdx.x * SM_BN;
  const int n = n0 + tx * 4;
  const int split = blockIdx.y;
  const int nchunks = (K + SM_BK - 1) / SM_BK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(nchunks, c_begin + chunks_per_split);

  float acc[SM_MMAX][4];
#pragma unroll
  for (int m = 0; m < SM_MMAX; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const bool live = n < N;
  const Weights<EPI, WT, BITS> wt(w, N, live ? n : 0, e);

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int k0 = ch * SM_BK;
    for (int i = tid; i < SM_MMAX * SM_BK; i += SM_TX * SM_TY) {
      int m = i / SM_BK, kk = i - m * SM_BK, k = k0 + kk;
      xs[m][kk] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int kb = k0 + ty * SM_KB;
    const int ke = min(kb + SM_KB, K);
    // int codes decode the group's SM_KB rows before their FMAs (SM_KB
    // loads in flight); fake-quant, whose decode is heavier, goes row by row
    constexpr int R = (EPI == EPI_FAKE_QUANT || EPI == EPI_FQ_MASK) ? 1 : SM_KB;
    for (int r0 = kb; live && r0 < ke; r0 += R) {
      const int nk = min(R, ke - r0);
      float v[R][4];
      wt.template rows<R>(r0, nk, v);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i >= nk) break;
        const int kk = r0 - k0 + i;
#pragma unroll
        for (int m = 0; m < SM_MMAX; ++m) {
          if (m < M) {
            float xv = xs[m][kk];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m][c] = fmaf(xv, v[i][c], acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < SM_MMAX; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][m][tx * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < M * SM_BN; i += SM_TX * SM_TY) {
    int m = i / SM_BN, col = i - m * SM_BN, nn = n0 + col;
    if (nn >= N) continue;
    float s = red[0][m][col];
#pragma unroll
    for (int g = 1; g < SM_TY; ++g) s += red[g][m][col];
    if (gridDim.y == 1)
      store(out + (long long)m * N + nn, s);
    else
      ws[((long long)split * M + m) * N + nn] = s;
  }
}

// out[m, n] = sum over splits, in split order.
template <typename OT>
__global__ void reduce_splits(const float* __restrict__ ws,
                              OT* __restrict__ out, int MN, int splits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += ws[(long long)j * MN + i];
  store(out + i, s);
}

// ---- general variant -------------------------------------------------------
constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16;

// grid (ceil(N/64), ceil(M/64)), block 256: 16x16 threads, 4x4 outputs.
template <typename XT, typename OT, int EPI, typename WT, int BITS>
__global__ void __launch_bounds__(256)
gemm_general(const XT* __restrict__ x, const void* __restrict__ w,
             EpiArgs e, OT* __restrict__ out, int M, int N, int K) {
  __shared__ float As[GM_BK][GM_BM + 4];
  __shared__ float Bs[GM_BK][GM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;

  // this thread's weight loads: row `wr` of each K step, 4 columns at `wn`
  const int wr = tid / 16, wn = n0 + (tid % 16) * 4;
  const bool wlive = wn < N;
  const Weights<EPI, WT, BITS> wt(w, N, wlive ? wn : 0, e);
  // this thread's x loads: row `xr`, 4 k's at `xk`
  const int xr = tid / 4, xk = (tid % 4) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    const int m = m0 + xr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int k = k0 + xk + j;
      As[xk + j][xr] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    const int k = k0 + wr;
    float v[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    if (wlive && k < K) wt.template rows<1>(k, 1, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) Bs[wr][(tid % 16) * 4 + c] = v[0][c];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int nn = n0 + tx * 4 + j;
      if (nn < N) store(out + (long long)m * N + nn, acc[i][j]);
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
  auto kern = gemm_tc<KIND, WT, BITS, BM, A_MN, B_MN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tr::kSmem);
  if (err != cudaSuccess) return err;
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

template <typename XT, typename OT, int EPI, typename WT, int BITS>
cudaError_t launch(const void* x, const void* w, const EpiArgs& e, void* out,
                   float* ws, int M, int N, int K, int splits, int cps,
                   cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  OT* op = static_cast<OT*>(out);
  if (M <= SM_MMAX) {
    dim3 grid((N + SM_BN - 1) / SM_BN, splits), block(SM_TX, SM_TY);
    gemm_small_m<XT, OT, EPI, WT, BITS><<<grid, block, 0, st>>>(
        xp, w, e, op, ws, M, N, K, cps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    int MN = M * N;
    reduce_splits<OT><<<(MN + 255) / 256, 256, 0, st>>>(ws, op, MN, splits);
    return cudaGetLastError();
  }
  dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  gemm_general<XT, OT, EPI, WT, BITS><<<grid, 256, 0, st>>>(xp, w, e, op, M,
                                                            N, K);
  return cudaGetLastError();
}

template <typename XT, typename OT>
cudaError_t by_epilogue(int epi, int w_dtype, int bits, const void* x,
                        const void* w, const EpiArgs& e, void* out, float* ws,
                        int M, int N, int K, int splits, int cps,
                        cudaStream_t st) {
#define L(E, W, B) \
  launch<XT, OT, E, W, B>(x, w, e, out, ws, M, N, K, splits, cps, st)
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
// pointers; x is (M, K) row-major, w (K, N) or (ceil(K/cpw), N) row-major,
// out (M, N) row-major; scale has N floats (scale_stride 1) or one
// (scale_stride 0). When M <= 8 the grid has `splits` K-splits of `cps`
// 128-row chunks each, none empty (gemm_core.k_splits picks them), and ws
// holds splits*M*N floats when splits > 1.
// N must be a multiple of 4 and w 16-byte aligned.
extern "C" int repro_gemm(const void* x, int x_dtype, const void* w,
                          int w_dtype, int epi, int bits, const float* scale,
                          int scale_stride, const float* fq_d,
                          const float* fq_qm,
                          const float* fq_t, void* out, int out_dtype,
                          float* ws, int M, int N, int K, int splits,
                          int cps, void* stream) {
  EpiArgs e{scale, scale_stride, fq_d, fq_qm, fq_t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32 && out_dtype == DT_F32)
    return by_epilogue<float, float>(epi, w_dtype, bits, x, w, e, out, ws, M,
                                     N, K, splits, cps, st);
  if (x_dtype == DT_F32 && out_dtype == DT_BF16)
    return by_epilogue<float, __nv_bfloat16>(epi, w_dtype, bits, x, w, e, out,
                                             ws, M, N, K, splits, cps, st);
  if (x_dtype == DT_BF16 && out_dtype == DT_F32)
    return by_epilogue<__nv_bfloat16, float>(epi, w_dtype, bits, x, w, e, out,
                                             ws, M, N, K, splits, cps, st);
  if (x_dtype == DT_BF16 && out_dtype == DT_BF16)
    return by_epilogue<__nv_bfloat16, __nv_bfloat16>(
        epi, w_dtype, bits, x, w, e, out, ws, M, N, K, splits, cps, st);
  return cudaErrorInvalidValue;
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
