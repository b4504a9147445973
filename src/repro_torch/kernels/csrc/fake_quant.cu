// Fake-quant forward and backward (paper Eqs 1-2 and 4-6), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `repro/kernels/fake_quant.py::_fwd_kernel` and
// `::_bwd_kernel` (launched by `fake_quant_fwd_pallas` /
// `fake_quant_bwd_pallas` through `pl.pallas_call`):
//
//   forward   y  = d * rint(clip^t(|x|) / d) * sgn(x), in x's dtype
//   backward  dx = g where |x| <= q_m, else 0, in x's dtype, and the sums
//             dd   = sum g * sgn(x) * (rint(v) - v),  v = clip^t(|x|) / d
//             dq_m = sum g * (0 inside, sgn(x) * t * q_m^(t-1) outside)
//             dt   = sum g * sgn(x) * base^t * log(base),
//                    base = max(|x|, eps) inside, q_m outside
//
// x and g are f32 or bf16; d, q_m, t are 0-d f32 tensors on the device,
// read by every block (no host round trip).
//
// What bounds it: one elementwise pass that reads x (and g) and writes y
// (dx) once, 0.23 ms of bytes for the 2048 x 92672 bf16 head at 3.35 TB/s,
// and the instructions an element takes: the forward ~20 at t = 1 (an IEEE
// divide, a rint), under the bytes; the backward ~60 (the divide and a
// logf), above them in bf16; a powf adds ~90 when t != 1, which then bounds
// both (its SASS, `tools/time_fq_rows.py --sass`).
//
// What the design does about it:
// - 16-byte accesses: a thread moves a "slot" of V elements, V = 16 bytes
//   of the narrower operand (8 bf16 or 4 f32; a wider operand takes two
//   16-byte words a slot), 2 slots in flight before it computes any, so an
//   SM holds tens of KB of loads outstanding (4 slots, and 16384-element
//   backward blocks, ran up to 10% slower on the H100: more registers per
//   thread, fewer blocks per wave).
// - t == 1 is decided once per block from the device scalar: each kernel
//   holds two loop bodies, `POW` false and true, and only the second calls
//   powf (t = 1 is the quantizers' init, every weight's t until QASSO
//   moves it).
// - Bitwise the plain versions (`kernels.ref`): clip^t in `clip_qmt`'s
//   power form (the identity at t == 1, where torch.pow(c, 1) == c; powf
//   otherwise), an IEEE divide and rintf (ties to even, as torch.round).
//   The Pallas kernel's exp(t * log a) is not used: it rounds differently
//   and flips round ties by a whole step d.
// - The backward takes one powf an element: inside the clip the clipped
//   magnitude max(min(|x|, q_m), eps) is max(|x|, eps), and outside it is
//   q_m, so it is dt's `base`, and clip^t = base^t for |x| > 0.
// - Forward: any alignment. The wrapper allocates y at x's offset from
//   16-byte alignment; the launcher moves the elements before the first
//   16-byte boundary and after the last whole slot one at a time (block 0)
//   and the rest in slots.
// - Backward, one launch and no atomics in a sum: block b owns the
//   elements [b * kChunk, (b + 1) * kChunk). Thread k of a block owns the
//   slots (element ranges [s * V, s * V + V)) s = b * kChunk / V + k + i *
//   kThreads, i = 0, 1, ..., and sums its elements' terms in index order
//   (the slot of a ragged tail last). Each warp folds its threads by a
//   shuffle tree into lane 0, the block its 8 warps in order, and thread 0
//   writes the block's (dd, dq_m, dt) row. Then it takes a ticket
//   (atomicAdd on a counter the wrapper keeps per device and stream, which
//   the last block resets to 0); the block that takes the last one folds
//   all rows the same way (thread k the rows k, k + kThreads, ...) and
//   writes the sums. The ticket only picks which block folds; no sum goes
//   through an atomic (ROADMAP's port rule: any sum that feeds a QASSO
//   decision is deterministic, with no atomics), and the fold order is a
//   function of n alone (and of the dtypes, which fix V), never of the SM
//   count or of timing: the sums repeat bit for bit run to run and across
//   cards (QASSO's decisions consume them). A base pointer off 16-byte
//   alignment takes the same slots with scalar loads, so it gives the
//   same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;              // slots in flight per thread
constexpr long long kChunk = 8192;      // elements per backward block

template <typename T>
struct Words {                          // 16-byte words of T
  static constexpr int kPer = 16 / (int)sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// elements [O, O + 16 / sizeof(T)) of v from one 16-byte word
template <int O, int V>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[V],
                                       const float*) {
  v[O] = __uint_as_float(r.x);
  v[O + 1] = __uint_as_float(r.y);
  v[O + 2] = __uint_as_float(r.z);
  v[O + 3] = __uint_as_float(r.w);
}
template <int O, int V>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[V],
                                       const __nv_bfloat16*) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[O + 2 * i] = __uint_as_float(u[i] << 16);
    v[O + 2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
template <int O, int V>
__device__ __forceinline__ uint4 pack(const float (&v)[V], const float*) {
  return make_uint4(__float_as_uint(v[O]), __float_as_uint(v[O + 1]),
                    __float_as_uint(v[O + 2]), __float_as_uint(v[O + 3]));
}
template <int O, int V>
__device__ __forceinline__ uint4 pack(const float (&v)[V],
                                      const __nv_bfloat16*) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[O + 2 * i],
                                                   v[O + 2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// One slot of V elements of T at p (16-byte aligned): W raw words, then
// their values.
template <typename T, int V>
struct Slot {
  static constexpr int W = V / Words<T>::kPer;
  uint4 w[W];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void values(float (&v)[V]) const {
    unpack<0>(w[0], v, (const T*)nullptr);
    if constexpr (W > 1) unpack<Words<T>::kPer>(w[1], v, (const T*)nullptr);
  }
};

template <typename T, int V>
__device__ __forceinline__ void store_slot(T* p, const float (&v)[V]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = pack<0>(v, (const T*)nullptr);
  if constexpr (V / Words<T>::kPer > 1)
    q[1] = pack<Words<T>::kPer>(v, (const T*)nullptr);
}

struct Scalars {
  float d, qm, t;
  float tq;       // t * q_m^(t-1), Eq (6)'s factor outside the clip
};

// At t == 1 (POW false) q_m^0 is 1 without a powf: pow(x, 0) == 1.
// sgn(x) * t * q_m^(t-1) == sgn(x) * tq bit for bit: sgn is +-1 or 0.
template <bool POW>
__device__ __forceinline__ Scalars load_scalars(const float* d,
                                                const float* qm, float t) {
  const float q = fmaxf(*qm, kEps);
  return {fmaxf(*d, kEps), q, t, t * (POW ? powf(q, t - 1.f) : 1.f)};
}

// torch.sign: +-1, and +0 at x == +-0 (and NaN), from x's sign bit
__device__ __forceinline__ float sgn(float x) {
  const float one = __int_as_float((__float_as_int(x) & 0x80000000) |
                                   0x3F800000);
  return fabsf(x) > 0.f ? one : 0.f;
}

// base^t for the clipped magnitude base = max(min(|x|, q_m), eps) (base
// itself at t == 1, as torch.pow(c, 1) == c); clip^t of Eq (13) is this,
// and 0 at |x| == 0 (the callers' select).
template <bool POW>
__device__ __forceinline__ float pow_t(float base, const Scalars& s) {
  return POW ? powf(base, s.t) : base;
}

template <bool POW>
__device__ __forceinline__ float fq(float x, const Scalars& s) {
  const float ax = fabsf(x);
  const float xt = ax > 0.f ? pow_t<POW>(fmaxf(fminf(ax, s.qm), kEps), s)
                            : 0.f;
  return s.d * rintf(xt / s.d) * sgn(x);
}

// ---- forward ---------------------------------------------------------------

template <typename T, bool POW>
__device__ __forceinline__ void fwd_tile(const T* __restrict__ x,
                                         T* __restrict__ y, long long nslots,
                                         const Scalars& s) {
  constexpr int V = Words<T>::kPer;
  const long long s0 = (long long)blockIdx.x * kThreads * kUnroll +
                       threadIdx.x;
  Slot<T, V> r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s0 + (long long)u * kThreads;
    if (i < nslots) r[u].load(x + i * V);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s0 + (long long)u * kThreads;
    if (i < nslots) {
      float v[V];
      r[u].values(v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = fq<POW>(v[e], s);
      store_slot(y + i * V, v);
    }
  }
}

// x + head and y + head 16-byte aligned; block 0 also moves the head and
// the tail past the last whole slot one element a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fq_fwd(const T* __restrict__ x, T* __restrict__ y, long long n, int head,
       const float* d, const float* qm, const float* t) {
  constexpr int V = Words<T>::kPer;
  const long long nslots = (n - head) / V;
  const float tv = *t;
  if (tv == 1.f) {
    const Scalars s = load_scalars<false>(d, qm, tv);
    fwd_tile<T, false>(x + head, y + head, nslots, s);
  } else {
    const Scalars s = load_scalars<true>(d, qm, tv);
    fwd_tile<T, true>(x + head, y + head, nslots, s);
  }
  if (blockIdx.x == 0) {
    const long long tail = head + nslots * V;
    const long long i = (int)threadIdx.x < head
                            ? (long long)threadIdx.x
                            : tail + ((long long)threadIdx.x - head);
    if ((int)threadIdx.x < head || i < n) {
      const float v = to_f32(x[i]);
      store(y + i, tv == 1.f ? fq<false>(v, load_scalars<false>(d, qm, tv))
                             : fq<true>(v, load_scalars<true>(d, qm, tv)));
    }
  }
}

// ---- backward --------------------------------------------------------------

// One element's terms: dx's value, and the three sums' terms added in.
template <bool POW>
__device__ __forceinline__ float bwd_elem(float xv, float gv, const Scalars& s,
                                          float (&acc)[3]) {
  const float ax = fabsf(xv), sign = sgn(xv);
  const bool inside = ax <= s.qm;
  const float base = fmaxf(fminf(ax, s.qm), kEps);
  const float pw = pow_t<POW>(base, s);
  const float v = (ax > 0.f ? pw : 0.f) / s.d;
  acc[0] += gv * (sign * (rintf(v) - v));
  acc[1] += gv * (inside ? 0.f : sign * s.tq);
  acc[2] += gv * (sign * pw * logf(base));
  return inside ? gv : 0.f;
}

// Elements per slot: 16 bytes of the narrower of T and G.
template <typename T, typename G>
__host__ __device__ constexpr int slot_elems() {
  return Words<T>::kPer > Words<G>::kPer ? Words<T>::kPer : Words<G>::kPer;
}

// Block `blockIdx.x`'s chunk, thread by thread in the fixed order of the
// file's header. VEC: x, g and dx 16-byte aligned (slots by vector loads);
// else the same slots element by element.
template <typename T, typename G, bool VEC, bool POW>
__device__ __forceinline__ void bwd_chunk(const T* __restrict__ x,
                                          const G* __restrict__ g,
                                          T* __restrict__ dx, long long n,
                                          const Scalars& s, float (&acc)[3]) {
  constexpr int V = slot_elems<T, G>();
  constexpr long long kSlots = kChunk / V;
  constexpr int kRounds = (int)(kSlots / (kThreads * kUnroll));
  const long long full = n / V;                   // whole slots
  const long long s0 = (long long)blockIdx.x * kSlots + threadIdx.x;
#pragma unroll 1
  for (int j = 0; j < kRounds; ++j) {
    const long long sj = s0 + (long long)j * kThreads * kUnroll;
    if constexpr (VEC) {
      Slot<T, V> xr[kUnroll];
      Slot<G, V> gr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = sj + (long long)u * kThreads;
        if (i < full) {
          xr[u].load(x + i * V);
          gr[u].load(g + i * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = sj + (long long)u * kThreads;
        if (i < full) {
          float xv[V], gv[V];
          xr[u].values(xv);
          gr[u].values(gv);
#pragma unroll
          for (int e = 0; e < V; ++e) xv[e] = bwd_elem<POW>(xv[e], gv[e], s, acc);
          store_slot(dx + i * V, xv);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = sj + (long long)u * kThreads;
        if (i < full) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const long long k = i * V + e;
            store(dx + k, bwd_elem<POW>(to_f32(x[k]), to_f32(g[k]), s, acc));
          }
        }
      }
    }
  }
  // the ragged tail's slot, last in its owner's order
  const long long o = full - (long long)blockIdx.x * kSlots;
  if (n % V != 0 && o >= 0 && o < kSlots && o % kThreads == threadIdx.x) {
    for (long long k = full * V; k < n; ++k)
      store(dx + k, bwd_elem<POW>(to_f32(x[k]), to_f32(g[k]), s, acc));
  }
}

// Lane 0 gets the warp's sum, in a fixed shuffle tree.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Fixed-order fold of the block's threads' three sums; thread 0 ends with
// them in acc.
__device__ __forceinline__ void block_fold(float (&acc)[3],
                                           float (*sh)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = warp_sum(acc[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sh[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = sh[0][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += sh[w][c];
      acc[c] = v;
    }
  }
}

template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(kThreads)
fq_bwd(const T* __restrict__ x, const G* __restrict__ g, T* __restrict__ dx,
       float* __restrict__ rows, unsigned* __restrict__ ticket,
       float* __restrict__ out, long long n, const float* d, const float* qm,
       const float* t) {
  __shared__ float sh[kWarps][3];
  __shared__ bool last;
  float acc[3] = {0.f, 0.f, 0.f};
  const float tv = *t;
  if (tv == 1.f)
    bwd_chunk<T, G, VEC, false>(x, g, dx, n, load_scalars<false>(d, qm, tv),
                                acc);
  else
    bwd_chunk<T, G, VEC, true>(x, g, dx, n, load_scalars<true>(d, qm, tv),
                               acc);
  block_fold(acc, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rows[(long long)blockIdx.x * 3 + c] = acc[c];
    __threadfence();              // the row is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float r[3] = {0.f, 0.f, 0.f};
  for (long long b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c] += __ldcg(rows + b * 3 + c);
  }
  block_fold(r, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = r[c];
    *ticket = 0u;                 // for the next call on this stream
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* xp, void* yp, long long n, const float* d,
                       const float* qm, const float* t, cudaStream_t st) {
  constexpr int V = Words<T>::kPer;
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  if ((ax - reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  long long head = (long long)((16 - ax % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long nslots = (n - head) / V;
  const long long per_block = (long long)kThreads * kUnroll;
  const long long blocks = nslots > 0 ? (nslots + per_block - 1) / per_block
                                      : 1;
  fq_fwd<T><<<(unsigned)blocks, kThreads, 0, st>>>(x, y, n, (int)head, d, qm,
                                                   t);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_bwd(const void* x, const void* g, void* dx, float* rows,
                       unsigned* ticket, float* out, long long n,
                       const float* d, const float* qm, const float* t,
                       cudaStream_t st) {
  const long long blocks = (n + kChunk - 1) / kChunk;
  const bool vec = aligned16(x) && aligned16(g) && aligned16(dx);
  auto kern = vec ? fq_bwd<T, G, true> : fq_bwd<T, G, false>;
  kern<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const G*>(g), static_cast<T*>(dx),
      rows, ticket, out, n, d, qm, t);
  return cudaGetLastError();
}

}  // namespace

// y = fake_quant(x) over n contiguous elements; x and y share a dtype and
// their offset from 16-byte alignment (cudaErrorMisalignedAddress if not).
// One launch. Returns the cudaError_t of the launch.
extern "C" int repro_fake_quant_fwd(const void* x, int dtype, void* y,
                                    long long n, const float* d,
                                    const float* qm, const float* t,
                                    void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_fwd<float>(x, y, n, d, qm, t, st);
  if (dtype == DT_BF16)
    return launch_fwd<__nv_bfloat16>(x, y, n, d, qm, t, st);
  return cudaErrorInvalidValue;
}

// dx (x's dtype) and out[0..2] = (dd, dq_m, dt) over n contiguous
// elements, in one launch: rows holds ceil(n / 8192) * 3 floats (one row
// per block); ticket is a 32-bit counter that is 0 before the call and 0
// again after it, used by no other call running at the same time.
extern "C" int repro_fake_quant_bwd(const void* x, int x_dtype, const void* g,
                                    int g_dtype, void* dx, float* rows,
                                    unsigned* ticket, float* out, long long n,
                                    const float* d, const float* qm,
                                    const float* t, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L(T, G) \
  launch_bwd<T, G>(x, g, dx, rows, ticket, out, n, d, qm, t, st)
  if (x_dtype == DT_F32 && g_dtype == DT_F32) return L(float, float);
  if (x_dtype == DT_F32 && g_dtype == DT_BF16) return L(float, __nv_bfloat16);
  if (x_dtype == DT_BF16 && g_dtype == DT_F32) return L(__nv_bfloat16, float);
  if (x_dtype == DT_BF16 && g_dtype == DT_BF16)
    return L(__nv_bfloat16, __nv_bfloat16);
#undef L
  return cudaErrorInvalidValue;
}
