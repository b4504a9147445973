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
// the f32 (N,) column mask, passed in the `scale` slot). Training runs at
// M = B*S tokens (or M = K_in for x.T @ g), so it takes the general
// variant.
//
// What bounds it: at decode M is the number of active slots (4-8), so each
// weight element feeds at most 8 FMAs and the GEMM is bound by the bytes
// of W read from HBM (bf16 2 B, int8 1 B, 4-bit 0.5 B per element). The
// fake-quant epilogue adds a divide and a rint per weight element (and a
// powf when t != 1), which puts it near the compute line at M = 4. The
// general variant decodes each weight once per 64-row M-tile. At prefill
// (M up to 2048) it is bound by
// f32 FMA throughput on the CUDA cores: this first version uses no tensor
// cores (no wgmma, no TMA).
//
// What the design does about it:
// - Threads map along N, the contiguous axis of the (K, N) weights, and
//   each thread loads 4 adjacent columns in one vector load, so a warp
//   reads whole 128-byte lines of bf16, int8 codes or int32 words.
// - Decoding happens in registers between the load and the FMA; nothing
//   decoded is written back to memory.
// - Small-M variant (M <= 8): a block owns 128 columns and 8 K-groups of
//   16 rows per 128-row chunk. For int codes a thread starts all 16 of its
//   rows' loads (or the at most 5 packed word rows they span) before it
//   decodes any, so 16 loads are in flight; fake-quant, whose decode (an
//   IEEE divide and a rint per element) is heavier, goes row by row, which
//   measured faster. The grid also splits K across blocks so
//   narrow N still fills the SMs. The K-groups reduce through shared
//   memory and the K-splits through an f32 workspace, both in a fixed
//   order: no atomics, so results are deterministic.
// - General variant (M > 8): a 64x64 output tile per block, K walked in
//   16-row steps through shared memory, 4x4 outputs per thread.
// - The K loop order and the tiles depend only on (M, N, K), never on the
//   epilogue. EPI_DEQUANT and EPI_UNPACK decode identical f32 weights
//   from the same codes, so their outputs are bitwise identical: packed
//   serving emits the same tokens as int8 serving.
// - Rounding uses rintf (ties to even, like torch.round and jnp.round).
//   Packed fields decode only for k < K; the zero tail of the last word is
//   never relied on.
// Known limits, for a later PR: no tensor cores at prefill; the small-M
// variant's f32 workspace pass adds a second launch when K is split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Eqs (1)-(2) with `clip_qmt` in its power form; d and qm arrive clamped.
// t == 1 (every quantizer's init) skips powf and keeps c, which is what the
// plain version's torch.pow(c, 1) gives on the card for every positive
// float (test_pow_of_one_is_identity_on_card, tests/test_torch_gpu.py).
__device__ __forceinline__ float fake_quant(float w, float d, float qm,
                                            float t) {
  float a = fabsf(w);
  float c = fmaxf(fminf(a, qm), kEps);
  float xt = (t == 1.f ? c : powf(c, t)) * (a > 0.f ? 1.f : 0.f);
  float s = w > 0.f ? 1.f : (w < 0.f ? -1.f : 0.f);
  return d * rintf(xt / d) * s;
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
