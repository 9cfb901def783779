// K3: the fused B-spline log-weight product and double logsumexp.
//
// Replaces gwinferno_tpu/ops/fused.py::_fused_kernel (the Pallas TPU kernel
// driven by _flw_core).  For chains c, design rows k and the flattened bank
// n = e * S + s of E events with S samples each it computes
//   logw[c, n] = sum_k coefs[c, k] * design[k, n] + nlp[n]
// and, for every (chain, event), the raw pair
//   lse1[c, e] = logsumexp_s logw[c, e*S + s],  lse2[c, e] = logsumexp_s 2 logw,
// without writing logw to device memory.  The product runs in this kernel's
// own body: each thread walks its samples, reads the K design entries of a
// sample (neighbouring threads on neighbouring samples, so every read is
// coalesced), forms the chains' dot products in registers from coefficients
// staged in shared memory, adds nlp and updates a per-chain online state
// (max m, s1 = sum e^(x-m), s2 = sum e^(2(x-m))).  A sample whose nlp is
// -inf (a sample mask) weighs exactly 0 and is skipped before the product;
// a tile, an event or padding with no live sample stays empty and gives
// -inf, never NaN (the Pallas kernel gives NaN there).
//
// Grid: one block per (event, tile of samples); the tile is chosen by the
// caller so that even one long row (the injection bank, one "event" of
// N_found samples) spreads over many blocks.  Each block merges its threads'
// states per chain (warp shuffle, then across warps in a fixed order) and
// writes per-(chain, event, tile) partials; a second kernel merges the
// partials of each (chain, event) in tile order.  No float atomics: the
// result does not depend on the order in which blocks run.  Chains beyond
// 16 run in further launches of the first kernel, 16 at a time.
//
// Bound: bytes.  The kernel reads the design matrix once (K values a
// sample) and does 2 C K operations a sample: at C = 16 in float32 that is
// 8 operations per byte read, under the card's ~20 float32 operations per
// byte of memory rate.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing (the caller passes the partials
// buffer), returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChains = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }
__device__ __forceinline__ float gw_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double gw_fma(double a, double b, double c) { return fma(a, b, c); }

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
__device__ __forceinline__ void push(State<T>& st, T v) {
  if (v == -INFINITY) return;
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

// One block: event e = blockIdx.x / tiles, samples [t * tile, min(S, (t+1) * tile)).
// coefs: (nc, K) of this chain group; part: (nc, E, tiles, 3) of this group.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flw_partial_kernel(const T* __restrict__ coefs,
                                                               const T* __restrict__ design,
                                                               const T* __restrict__ nlp, T* __restrict__ part,
                                                               int nc, long long K, long long E, long long S,
                                                               long long tile, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (K, NC): the chains' coefficients of row k side by side
  __shared__ T red_m[kWarps][NC], red_s1[kWarps][NC], red_s2[kWarps][NC];

  const long long e = blockIdx.x / tiles;
  const long long t = blockIdx.x - e * tiles;
  const long long N = E * S;

  for (long long i = threadIdx.x; i < K * NC; i += kThreads) {
    const long long k = i / NC;
    const int c = static_cast<int>(i - k * NC);
    cs[i] = c < nc ? coefs[c * K + k] : T(0);
  }
  __syncthreads();

  State<T> st[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) st[c] = {-INFINITY, T(0), T(0)};

  const long long s_end = (t + 1) * tile < S ? (t + 1) * tile : S;
  for (long long s = t * tile + threadIdx.x; s < s_end; s += kThreads) {
    const long long n = e * S + s;
    const T lp = nlp[n];
    if (lp == -INFINITY) continue;  // a masked sample weighs exactly 0
    T acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = T(0);
    const T* col = design + n;
#pragma unroll 4
    for (long long k = 0; k < K; ++k) {
      const T d = col[k * N];
      const T* ck = cs + k * NC;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = gw_fma(ck[c], d, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) push(st[c], acc[c] + lp);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const State<T> w = warp_merge(st[c]);
    if (lane == 0) {
      red_m[warp][c] = w.m;
      red_s1[warp][c] = w.s1;
      red_s2[warp][c] = w.s2;
    }
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    const int c = threadIdx.x;
    State<T> acc{red_m[0][c], red_s1[0][c], red_s2[0][c]};
    for (int w = 1; w < kWarps; ++w) acc = merge(acc, State<T>{red_m[w][c], red_s1[w][c], red_s2[w][c]});
    T* out = part + ((c * E + e) * tiles + t) * 3;
    out[0] = acc.m;
    out[1] = acc.s1;
    out[2] = acc.s2;
  }
}

// One thread per (chain, event): merge the tiles' partials in tile order.
template <typename T>
__global__ void flw_merge_kernel(const T* __restrict__ part, T* __restrict__ lse1, T* __restrict__ lse2,
                                 long long rows, long long tiles) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= rows) return;
  const T* p = part + r * tiles * 3;
  State<T> acc{-INFINITY, T(0), T(0)};
  for (long long t = 0; t < tiles; ++t) acc = merge(acc, State<T>{p[3 * t], p[3 * t + 1], p[3 * t + 2]});
  // an empty (chain, event): m = -inf and s = 0, so both outputs are -inf
  lse1[r] = acc.m + gw_log(acc.s1);
  lse2[r] = T(2) * acc.m + gw_log(acc.s2);
}

template <typename T, int NC>
cudaError_t launch_group(const T* coefs, const T* design, const T* nlp, T* part, int nc, long long K, long long E,
                         long long S, long long tile, long long tiles, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * NC * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(flw_partial_kernel<T, NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  flw_partial_kernel<T, NC><<<static_cast<unsigned int>(E * tiles), kThreads, smem, stream>>>(
      coefs, design, nlp, part, nc, K, E, S, tile, tiles);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* coefs, const T* design, const T* nlp, T* part, T* lse1, T* lse2, long long C, long long K,
           long long E, long long S, long long tile, void* stream_ptr) {
  if (C <= 0 || E <= 0) return 0;
  if (K <= 0 || S <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (S + tile - 1) / tile;
  if (E * tiles > 2147483647LL || C * E > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (long long c0 = 0; c0 < C; c0 += kMaxChains) {
    const int nc = static_cast<int>(C - c0 < kMaxChains ? C - c0 : kMaxChains);
    const T* cg = coefs + c0 * K;
    T* pg = part + c0 * E * tiles * 3;
    cudaError_t err;
    if (nc == 1) {
      err = launch_group<T, 1>(cg, design, nlp, pg, nc, K, E, S, tile, tiles, stream);
    } else if (nc == 2) {
      err = launch_group<T, 2>(cg, design, nlp, pg, nc, K, E, S, tile, tiles, stream);
    } else if (nc <= 4) {
      err = launch_group<T, 4>(cg, design, nlp, pg, nc, K, E, S, tile, tiles, stream);
    } else if (nc <= 8) {
      err = launch_group<T, 8>(cg, design, nlp, pg, nc, K, E, S, tile, tiles, stream);
    } else {
      err = launch_group<T, 16>(cg, design, nlp, pg, nc, K, E, S, tile, tiles, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = C * E;
  const int threads = 128;
  flw_merge_kernel<T><<<static_cast<unsigned int>((rows + threads - 1) / threads), threads, 0, stream>>>(
      part, lse1, lse2, rows, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gw_flw_f32(const float* coefs, const float* design, const float* nlp, float* part, float* lse1, float* lse2,
               long long C, long long K, long long E, long long S, long long tile, void* stream) {
  return launch<float>(coefs, design, nlp, part, lse1, lse2, C, K, E, S, tile, stream);
}

int gw_flw_f64(const double* coefs, const double* design, const double* nlp, double* part, double* lse1,
               double* lse2, long long C, long long K, long long E, long long S, long long tile, void* stream) {
  return launch<double>(coefs, design, nlp, part, lse1, lse2, C, K, E, S, tile, stream);
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
