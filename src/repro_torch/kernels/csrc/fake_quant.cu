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
// read by every thread (no host round trip).
//
// What bounds it: one elementwise pass; each element costs a handful of
// flops (a divide, a rint, and a powf/logf when t != 1), so both kernels
// are bound by the bytes of x (and g, dx) read and written once.
//
// What the design does about it:
// - The forward is a grid-stride loop over the flattened tensor, 4
//   consecutive elements a thread per step.
// - clip^t is computed as the plain version (`kernels.ref`) computes it:
//   the identity at t == 1 and powf otherwise, then an IEEE divide and
//   rintf (ties to even, as torch.round). The Pallas kernel's
//   exp(t * log a) is not used: it rounds differently and flips round ties
//   by a whole step d. So the forward gives the plain version's bits.
// - The backward writes dx in the same pass and reduces the three sums
//   without atomics, in a fixed order: block b owns elements
//   [b * kChunk, (b + 1) * kChunk), each thread sums its elements in index
//   order, the block folds its threads in a fixed shared-memory tree and
//   writes one (dd, dq_m, dt) row to a (blocks, 3) f32 buffer; a second
//   one-block launch folds the rows in the same fixed way. The grid
//   depends only on the element count, so the sums are bitwise
//   reproducible run to run (QASSO's decisions consume them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;   // elements per backward block
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Scalars {
  float d, qm, t;
  float qm_pow;   // q_m^(t-1), Eq (6)'s factor outside the clip
};

__device__ __forceinline__ Scalars load_scalars(const float* d,
                                                const float* qm,
                                                const float* t) {
  const float q = fmaxf(*qm, kEps), tv = *t;
  return {fmaxf(*d, kEps), q, tv, powf(q, tv - 1.f)};
}

// clip_{q_m}^t(|x|) of Eq (13) in the power form, with the identity at
// t == 1: torch.pow(c, 1) == c on the card for every positive float.
__device__ __forceinline__ float clip_t(float a, float qm, float t) {
  float c = fmaxf(fminf(a, qm), kEps);
  return (t == 1.f ? c : powf(c, t)) * (a > 0.f ? 1.f : 0.f);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float fq(float x, const Scalars& s) {
  float xt = clip_t(fabsf(x), s.qm, s.t);
  return s.d * rintf(xt / s.d) * sgn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fq_fwd(const T* __restrict__ x, T* __restrict__ y, long long n,
       const float* d, const float* qm, const float* t) {
  const Scalars s = load_scalars(d, qm, t);
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    if (i + 4 <= n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) store(y + i + c, fq(to_f32(x[i + c]), s));
    } else {
      for (long long j = i; j < n; ++j) store(y + j, fq(to_f32(x[j]), s));
    }
  }
}

// Per-element backward terms; writes dx and adds to the three sums.
template <typename T, typename G>
__device__ __forceinline__ void bwd_elem(const T* x, const G* g, T* dx,
                                         long long i, const Scalars& s,
                                         float acc[3]) {
  const float xv = to_f32(x[i]), gv = to_f32(g[i]);
  const float ax = fabsf(xv), sign = sgn(xv);
  const bool inside = ax <= s.qm;
  store(dx + i, inside ? gv : 0.f);
  const float v = clip_t(ax, s.qm, s.t) / s.d;
  acc[0] += gv * (sign * (rintf(v) - v));
  acc[1] += gv * (inside ? 0.f : sign * s.t * s.qm_pow);
  const float base = inside ? fmaxf(ax, kEps) : s.qm;
  const float pw = s.t == 1.f ? base : powf(base, s.t);
  acc[2] += gv * (sign * pw * logf(base));
}

// Fixed-order tree over a block's threads of three sums in `sh`.
__device__ __forceinline__ void block_tree(float (*sh)[3], int nthreads) {
  for (int w = nthreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sh[threadIdx.x][c] += sh[threadIdx.x + w][c];
    }
    __syncthreads();
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
fq_bwd(const T* __restrict__ x, const G* __restrict__ g, T* __restrict__ dx,
       float* __restrict__ partials, long long n, const float* d,
       const float* qm, const float* t) {
  __shared__ float sh[kThreads][3];
  const Scalars s = load_scalars(d, qm, t);
  float acc[3] = {0.f, 0.f, 0.f};
  // thread k of block b visits b * kChunk + k + j * kThreads, j = 0..15:
  // coalesced across the warp, index order within the thread
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i < n) bwd_elem(x, g, dx, i, s, acc);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) sh[threadIdx.x][c] = acc[c];
  __syncthreads();
  block_tree(sh, kThreads);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) partials[(long long)blockIdx.x * 3 + c] = sh[0][c];
  }
}

// One block: out[c] = sum over rows of partials[row][c], rows visited in
// thread-strided order, then the fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
fq_bwd_reduce(const float* __restrict__ partials, int rows,
              float* __restrict__ out) {
  __shared__ float sh[kReduceThreads][3];
  float acc[3] = {0.f, 0.f, 0.f};
  for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += partials[(long long)r * 3 + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) sh[threadIdx.x][c] = acc[c];
  __syncthreads();
  block_tree(sh, kReduceThreads);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = sh[0][c];
  }
}

template <typename T, typename G>
cudaError_t launch_bwd(const void* x, const void* g, void* dx,
                       float* partials, float* out, long long n,
                       const float* d, const float* qm, const float* t,
                       cudaStream_t st) {
  const long long blocks = (n + kChunk - 1) / kChunk;
  fq_bwd<T, G><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const G*>(g), static_cast<T*>(dx),
      partials, n, d, qm, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fq_bwd_reduce<<<1, kReduceThreads, 0, st>>>(partials, (int)blocks, out);
  return cudaGetLastError();
}

}  // namespace

// y = fake_quant(x) over n contiguous elements; x and y share a dtype.
// Returns the cudaError_t of the launch.
extern "C" int repro_fake_quant_fwd(const void* x, int dtype, void* y,
                                    long long n, const float* d,
                                    const float* qm, const float* t,
                                    int sm_count, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long want = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  const unsigned grid = (unsigned)(want < 16LL * sm_count ? want
                                                          : 16LL * sm_count);
  if (dtype == DT_F32)
    fq_fwd<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                             static_cast<float*>(y), n, d, qm,
                                             t);
  else if (dtype == DT_BF16)
    fq_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, d, qm, t);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dx (x's dtype) and out[0..2] = (dd, dq_m, dt) over n contiguous
// elements; partials holds ceil(n / 4096) * 3 floats (one row per block
// of the first pass, kChunk = 4096 elements each).
// Two launches: the elementwise pass and the one-block reduce.
extern "C" int repro_fake_quant_bwd(const void* x, int x_dtype, const void* g,
                                    int g_dtype, void* dx, float* partials,
                                    float* out, long long n, const float* d,
                                    const float* qm, const float* t,
                                    void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define L(T, G) launch_bwd<T, G>(x, g, dx, partials, out, n, d, qm, t, st)
  if (x_dtype == DT_F32 && g_dtype == DT_F32) return L(float, float);
  if (x_dtype == DT_F32 && g_dtype == DT_BF16) return L(float, __nv_bfloat16);
  if (x_dtype == DT_BF16 && g_dtype == DT_F32) return L(__nv_bfloat16, float);
  if (x_dtype == DT_BF16 && g_dtype == DT_BF16)
    return L(__nv_bfloat16, __nv_bfloat16);
#undef L
  return cudaErrorInvalidValue;
}
