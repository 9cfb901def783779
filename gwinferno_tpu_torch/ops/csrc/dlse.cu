// K1: the paired importance-weight reduction of the hierarchical likelihood.
//
// Replaces gwinferno_tpu/ops/fused.py::_dlse_kernel (the Pallas TPU kernel
// launched by _dlse_pallas_2d).  For every row of a contiguous (rows, n)
// array it writes (logsumexp(x), logsumexp(2x)) in ONE pass over the row:
// each thread keeps an online (max m, s1 = sum e^(x-m), s2 = sum e^(2(x-m)))
// and rescales both sums when m moves; the per-thread states are merged by
// warp shuffle, then through shared memory across warps, with
//   m  = max(ma, mb)
//   s1 = s1a e^(ma-m)  + s1b e^(mb-m)
//   s2 = s2a e^2(ma-m) + s2b e^2(mb-m).
// -inf entries contribute nothing, and a row that is all -inf (a masked
// event) gives -inf in both outputs, never NaN.
//
// Bound: bytes.  The kernel reads each input once and does ~10 operations
// per element, far below the card's arithmetic rate, so its floor is the row
// bank over the memory rate.  Design: one block per row, threads striding
// the row so neighbouring threads read neighbouring addresses.  Few long
// rows (the (C, N_found) injection row at C = 16) fill only C of the SMs; a
// split-row two-stage reduction is the fix for that shape.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }

template <typename T>
struct State {
  T m, s1, s2;
};

template <typename T>
__device__ __forceinline__ State<T> merge(State<T> a, State<T> b) {
  const T m = a.m > b.m ? a.m : b.m;
  if (m == -INFINITY) return a;  // both empty
  const T ea = gw_exp(a.m - m);  // 0 when a is empty
  const T eb = gw_exp(b.m - m);
  return {m, a.s1 * ea + b.s1 * eb, a.s2 * ea * ea + b.s2 * eb * eb};
}

template <typename T>
__device__ __forceinline__ State<T> warp_merge(State<T> st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    State<T> o;
    o.m = __shfl_down_sync(0xffffffffu, st.m, off);
    o.s1 = __shfl_down_sync(0xffffffffu, st.s1, off);
    o.s2 = __shfl_down_sync(0xffffffffu, st.s2, off);
    st = merge(st, o);
  }
  return st;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dlse_kernel(const T* __restrict__ x, T* __restrict__ lse1,
                                                        T* __restrict__ lse2, long long n) {
  const long long row = blockIdx.x;
  const T* xr = x + row * n;

  State<T> st{-INFINITY, T(0), T(0)};
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    const T v = xr[j];
    if (v == -INFINITY) continue;
    if (v > st.m) {
      const T r = gw_exp(st.m - v);  // 0 while the state is empty
      st.s1 = st.s1 * r + T(1);
      st.s2 = st.s2 * r * r + T(1);
      st.m = v;
    } else {
      const T e = gw_exp(v - st.m);
      st.s1 += e;
      st.s2 += e * e;
    }
  }

  st = warp_merge(st);
  __shared__ T sm[kWarps], ss1[kWarps], ss2[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm[warp] = st.m;
    ss1[warp] = st.s1;
    ss2[warp] = st.s2;
  }
  __syncthreads();
  if (warp == 0) {
    st = lane < kWarps ? State<T>{sm[lane], ss1[lane], ss2[lane]} : State<T>{-INFINITY, T(0), T(0)};
    st = warp_merge(st);
    if (lane == 0) {
      // empty row: m = -inf and s = 0, so both outputs are -inf
      lse1[row] = st.m + gw_log(st.s1);
      lse2[row] = T(2) * st.m + gw_log(st.s2);
    }
  }
}

template <typename T>
int launch(const T* x, T* lse1, T* lse2, long long rows, long long n, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dlse_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lse1, lse2, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gw_dlse_f32(const float* x, float* lse1, float* lse2, long long rows, long long n, void* stream) {
  return launch<float>(x, lse1, lse2, rows, n, stream);
}

int gw_dlse_f64(const double* x, double* lse1, double* lse2, long long rows, long long n, void* stream) {
  return launch<double>(x, lse1, lse2, rows, n, stream);
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
