// The generic streamed op's backward: the cotangent of a block's log weights
// from the cotangents of its rows' (logsumexp(lw), logsumexp(2 lw)) pair.
//
// Replaces the reduction side of gwinferno_tpu/ops/streamed.py::bwd_kernel
// (and bwd_kernel_c), the Pallas TPU kernels that pull a block's pair
// cotangents back through the caller's log-weight chain.  CUDA has no
// in-kernel autodiff, so the port splits that work: this kernel writes
//   w[r, j] = g1[r] exp(lw[r, j] - l1[r]) + 2 g2[r] exp(2 lw[r, j] - l2[r])
// for every row r of a contiguous (rows, n) block lw, and the caller pulls w
// back through its torch chain.  A row whose l1 (l2) is not finite takes
// g1 = 0 and l1 = 0 (g2, l2), as the JAX core_bwd sanitises its residuals,
// so an all -inf row gets a zero cotangent, never NaN.  A -inf entry gets 0.
//
// Bound: bytes.  Each entry is read once and written once with two
// exponentials and a few operations, far below the card's arithmetic and
// special-function rates.  Design, for that floor: a block takes one tile
// of kThreads * kPerThread entries of one row (blocks run over rows times
// tiles, so a few long rows fill the card as many short ones do); the row's
// four scalars are read once a thread, and each thread issues its
// kPerThread loads (coalesced across the warp) before it computes.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kPerThread;

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) lse_vjp_kernel(const T* __restrict__ lw, const T* __restrict__ g1,
                                                           const T* __restrict__ g2, const T* __restrict__ l1,
                                                           const T* __restrict__ l2, T* __restrict__ w, long long n,
                                                           long long tiles) {
  const long long row = blockIdx.x / tiles;
  const long long t = blockIdx.x - row * tiles;
  T a1 = g1[row], b1 = l1[row], a2 = g2[row], b2 = l2[row];
  if (!isfinite(b1)) a1 = T(0), b1 = T(0);
  if (!isfinite(b2)) a2 = T(0), b2 = T(0);
  a2 = T(2) * a2;
  const T* x = lw + row * n;
  T* out = w + row * n;
  const long long j0 = t * kTile + threadIdx.x;
  T v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = j0 + static_cast<long long>(i) * kThreads;
    v[i] = j < n ? __ldcs(x + j) : T(0);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = j0 + static_cast<long long>(i) * kThreads;
    if (j < n) __stcs(out + j, a1 * gw_exp(v[i] - b1) + a2 * gw_exp(T(2) * v[i] - b2));
  }
}

template <typename T>
int launch(const T* lw, const T* g1, const T* g2, const T* l1, const T* l2, T* w, long long rows, long long n,
           void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (rows * tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  lse_vjp_kernel<T><<<static_cast<unsigned int>(rows * tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lw, g1, g2, l1, l2, w, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int gw_lse_vjp_f32(const float* lw, const float* g1, const float* g2, const float* l1, const float* l2, float* w,
                   long long rows, long long n, void* stream) {
  return launch<float>(lw, g1, g2, l1, l2, w, rows, n, stream);
}

int gw_lse_vjp_f64(const double* lw, const double* g1, const double* g2, const double* l1, const double* l2, double* w,
                   long long rows, long long n, void* stream) {
  return launch<double>(lw, g1, g2, l1, l2, w, rows, n, stream);
}

// the launch floor: an empty kernel with lse_vjp's grid and threads on a
// (rows, n) block
int gw_lse_vjp_empty(long long rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long blocks = rows * ((n + kTile - 1) / kTile);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  empty_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
