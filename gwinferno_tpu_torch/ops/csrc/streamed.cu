// K2: the streamed whole-chain likelihood of the bench model, forward and
// backward, for C chains at once.
//
// Replaces the four Pallas TPU kernels of gwinferno_tpu/ops/streamed.py:
// fwd_kernel / fwd_kernel_c (forward, one chain / all chains) and
// bwd_kernel / bwd_kernel_c (backward).  Here C = 1 is one case of the
// chain-batched kernels.  The TPU kernels run any traced log-weight chain
// and differentiate it with jax.vjp inside the kernel; CUDA has no in-kernel
// autodiff, so this file holds the bench chain (bench.py::streamed_logw) and
// its derivative written out by hand:
//
//   lw = log p(q | beta, mmin/m1)                      powerlaw in q
//      + logaddexp(c_pl + alpha log m1,                powerlaw in m1
//                  c_peak - t^2/2), t = (m1-mu)/sig    Gaussian peak
//      + sum_i (A_i log a_i + B_i log(1-a_i) + N_i)    beta spin magnitudes
//      + sum_i logaddexp(c_iso_i, c_ali_i - t_i^2/2)   tilt mixtures
//      + [z <= zmax] (log dVc/dz + (lamb-1) log(1+z) - z_lognorm), else the
//        dtype's most negative finite value
//      - log prior,
//   out of any support, NaN or +inf -> -inf.
//
// Every term that depends on the hyperparameters alone (erf, lgamma, the m1
// powerlaw norm, log lambda, ...) is computed by the caller as a per-chain
// parameter vector P (layout kP* below); the kernels evaluate the per-sample
// part, where only exp, log, log1p and expm1 run, and the backward returns
// sum_s w_s d lw_s / d P_j, with w_s = g1 e^(lw-l1) + 2 g2 e^(2 lw - l2), for
// autograd to carry on to the hyperparameters.  The one per-sample
// nonlinearity in a hyperparameter is the q powerlaw's norm on [mmin/m1, 1]:
//   norm = log|1+beta| - max(0, b) - log(-expm1(-d)),
//   b = (1+beta) log(mmin/m1), d = max(|b|, eps)   (beta != -1)
//   norm = -log max(|log(mmin/m1)|, eps)             (beta == -1).
//
// Data: the caller passes the bank as kNCol columns (kNCol, rows, S) of
// data-only terms computed once (log m1, log q, ...) and an int flags array
// (rows, S) of support bits.
//
// Design.  A block owns one (row, tile) of the bank: it stages the tile's
// columns in shared memory once, then sweeps the C chains over it, so each
// bank element is read from device memory once for all chains (the property
// fwd_kernel_c was built for).  Per (chain, row, tile) the forward writes an
// online (max m, s1 = sum e^(lw-m), s2 = sum e^(2(lw-m))) and the backward
// kPStride partial sums; a second small kernel merges them, in a fixed
// order, into (C, rows) lse pairs or (C, kPStride) gradients.  No float
// atomics: a seed reproduces a run bit for bit.  The tile is chosen by the
// caller so that short banks still give enough blocks for the 132 SMs.
//
// Bound: at C = 16 the work per bank element is ~10 transcendental calls
// per chain forward and ~14 backward against 13 column reads, so the
// kernels are bound by operations (the special-function units), not by
// device memory.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing, returns a cudaError_t code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// data columns (must match gwinferno_tpu_torch/ops/streamed.py)
enum Col {
  kM1, kLogM1, kLogQ, kLogLow, kLogA1, kLog1mA1, kLogA2, kLog1mA2, kCt1m1, kCt2m1, kLog1pZ, kLogDvdz, kLogPrior,
  kNCol
};
// support bits of the flags array
constexpr int kFM1 = 1, kFQ = 2, kFA1 = 4, kFA2 = 8, kFCt1 = 16, kFCt2 = 32, kFZOk = 64, kFValid = 128;
constexpr int kSupport = kFM1 | kFQ | kFA1 | kFA2 | kFCt1 | kFCt2 | kFValid;
// per-chain parameters
enum Par {
  kPBeta, kPAp1, kPLogAbsAp1, kPIsM1, kPAlpha, kPCPl, kPMu, kPInvSig, kPCPeak,
  kPA1, kPB1, kPN1, kPA2, kPB2, kPN2,
  kPIso1, kPAli1, kPInvSt1, kPIso2, kPAli2, kPInvSt2, kPLamb1, kPZl,
  kNP
};
constexpr int kPStride = 24;
static_assert(kNP <= kPStride, "parameter stride");

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }
__device__ __forceinline__ float gw_log1p(float v) { return log1pf(v); }
__device__ __forceinline__ double gw_log1p(double v) { return log1p(v); }
__device__ __forceinline__ float gw_expm1(float v) { return expm1f(v); }
__device__ __forceinline__ double gw_expm1(double v) { return expm1(v); }

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  __device__ static constexpr float eps() { return 1.1920928955078125e-07f; }
  __device__ static constexpr float lowest() { return -3.4028234663852886e+38f; }
};
template <>
struct Lim<double> {
  __device__ static constexpr double eps() { return 2.220446049250313e-16; }
  __device__ static constexpr double lowest() { return -1.7976931348623157e+308; }
};

// What the backward needs of one sample's evaluation, besides lw.
template <typename T>
struct Aux {
  T r1, r2, r3, r4, r5, r6;  // mixture responsibilities of the three logaddexps
  T t, t1, t2;               // standardised m1 - mu, ct1 - 1, ct2 - 1
  T dls;                     // d log_span / d (1+beta) of the q norm
};

// logaddexp(a, b) and the responsibilities e^(a-r), e^(b-r); -inf when both are
template <typename T>
__device__ __forceinline__ T logaddexp_r(T a, T b, T& ra, T& rb) {
  const T m = a > b ? a : b;
  if (m == -INFINITY) {
    ra = T(0);
    rb = T(0);
    return -INFINITY;
  }
  const T r = m + gw_log1p(gw_exp(-fabs(a - b)));
  ra = gw_exp(a - r);
  rb = gw_exp(b - r);
  return r;
}

// One sample's log-weight; -inf out of support or where the sum is NaN / +inf.
template <typename T>
__device__ __forceinline__ T eval_logw(const T (&x)[kNCol], int f, const T (&p)[kPStride], Aux<T>& ax) {
  if ((f & kSupport) != kSupport) return -INFINITY;
  const T eps = Lim<T>::eps();
  const T llow = x[kLogLow];
  T norm_q;
  if (p[kPIsM1] != T(0)) {
    norm_q = -gw_log(fmax(fabs(T(0) - llow), eps));
    ax.dls = T(0);
  } else {
    const T b = p[kPAp1] * llow;
    const T d = fmax(fabs(b), eps);
    const T em = -gw_expm1(-d);
    norm_q = p[kPLogAbsAp1] - ((b > T(0) ? b : T(0)) + gw_log(em));
    ax.dls = (b > T(0) ? llow : T(0)) + (fabs(b) >= eps ? (b > T(0) ? llow : -llow) * gw_exp(-d) / em : T(0));
  }
  const T log_p_q = p[kPBeta] * x[kLogQ] + norm_q;

  ax.t = (x[kM1] - p[kPMu]) * p[kPInvSig];
  const T log_p_m1 =
      logaddexp_r(p[kPCPl] + p[kPAlpha] * x[kLogM1], p[kPCPeak] - T(0.5) * ax.t * ax.t, ax.r1, ax.r2);

  const T mag = (p[kPA1] * x[kLogA1] + p[kPB1] * x[kLog1mA1] + p[kPN1]) +
                (p[kPA2] * x[kLogA2] + p[kPB2] * x[kLog1mA2] + p[kPN2]);

  ax.t1 = x[kCt1m1] * p[kPInvSt1];
  ax.t2 = x[kCt2m1] * p[kPInvSt2];
  const T tilt = logaddexp_r(p[kPIso1], p[kPAli1] - T(0.5) * ax.t1 * ax.t1, ax.r3, ax.r4) +
                 logaddexp_r(p[kPIso2], p[kPAli2] - T(0.5) * ax.t2 * ax.t2, ax.r5, ax.r6);

  const T zterm = (f & kFZOk) ? (x[kLogDvdz] + p[kPLamb1] * x[kLog1pZ]) - p[kPZl] : Lim<T>::lowest();
  const T lw = ((((log_p_q + log_p_m1) + mag) + tilt) + zterm) - x[kLogPrior];
  return (lw > -INFINITY && lw < INFINITY) ? lw : T(-INFINITY);
}

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
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Stage the (row, tile) block of the columns and flags in shared memory;
// samples past the row's end get flags 0 (out of support).
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ cols, const int* __restrict__ flags, T* sc, int* sf,
                                           int rows, long long S, int row, long long j0, int tile) {
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const long long j = j0 + i;
    const bool in = j < S;
#pragma unroll
    for (int k = 0; k < kNCol; ++k) sc[k * tile + i] = in ? cols[(static_cast<long long>(k) * rows + row) * S + j] : T(0);
    sf[i] = in ? flags[static_cast<long long>(row) * S + j] : 0;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void load_sample(const T* sc, int tile, int i, T (&x)[kNCol]) {
#pragma unroll
  for (int k = 0; k < kNCol; ++k) x[k] = sc[k * tile + i];
}

template <typename T>
__device__ __forceinline__ void load_params(const T* __restrict__ P, int c, T (&p)[kPStride]) {
#pragma unroll
  for (int j = 0; j < kPStride; ++j) p[j] = P[c * kPStride + j];
}

// grid (n_tiles, rows); part[((c * rows + row) * n_tiles + tile) * 3 + {m, s1, s2}]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k2_fwd_kernel(const T* __restrict__ cols, const int* __restrict__ flags, const T* __restrict__ P,
                  T* __restrict__ part, int C, int rows, long long S, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);
  int* sf = reinterpret_cast<int*>(sc + kNCol * tile);
  __shared__ T sm[kWarps], ss1[kWarps], ss2[kWarps];

  const int row = blockIdx.y, t = blockIdx.x, n_tiles = gridDim.x;
  stage_tile(cols, flags, sc, sf, rows, S, row, static_cast<long long>(t) * tile, tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int c = 0; c < C; ++c) {
    T p[kPStride];
    load_params(P, c, p);
    State<T> st{-INFINITY, T(0), T(0)};
    for (int i = threadIdx.x; i < tile; i += kThreads) {
      T x[kNCol];
      load_sample(sc, tile, i, x);
      Aux<T> ax;
      const T v = eval_logw(x, sf[i], p, ax);
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
        T* o = part + ((static_cast<long long>(c) * rows + row) * n_tiles + t) * 3;
        o[0] = st.m;
        o[1] = st.s1;
        o[2] = st.s2;
      }
    }
    __syncthreads();
  }
}

// one thread per (chain, row): merge the row's tiles in order
template <typename T>
__global__ void k2_fwd_merge(const T* __restrict__ part, T* __restrict__ lse1, T* __restrict__ lse2, int n_out,
                             int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  State<T> st{-INFINITY, T(0), T(0)};
  for (int t = 0; t < n_tiles; ++t) {
    const T* q = part + (static_cast<long long>(idx) * n_tiles + t) * 3;
    st = merge(st, State<T>{q[0], q[1], q[2]});
  }
  // empty row: m = -inf and s = 0, so both outputs are -inf
  lse1[idx] = st.m + gw_log(st.s1);
  lse2[idx] = T(2) * st.m + gw_log(st.s2);
}

// grid (n_tiles, rows); part[((c * rows + row) * n_tiles + tile) * kPStride + j]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k2_bwd_kernel(const T* __restrict__ cols, const int* __restrict__ flags, const T* __restrict__ P,
                  const T* __restrict__ g1, const T* __restrict__ g2, const T* __restrict__ l1,
                  const T* __restrict__ l2, T* __restrict__ part, int C, int rows, long long S, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw);
  int* sf = reinterpret_cast<int*>(sc + kNCol * tile);
  __shared__ T red[kWarps * kPStride];

  const int row = blockIdx.y, t = blockIdx.x, n_tiles = gridDim.x;
  stage_tile(cols, flags, sc, sf, rows, S, row, static_cast<long long>(t) * tile, tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int c = 0; c < C; ++c) {
    T p[kPStride];
    load_params(P, c, p);
    const long long cr = static_cast<long long>(c) * rows + row;
    const T G1 = g1[cr], G2 = g2[cr], L1 = l1[cr], L2 = l2[cr];
    const bool is_m1 = p[kPIsM1] != T(0);
    T acc[kPStride];
#pragma unroll
    for (int j = 0; j < kPStride; ++j) acc[j] = T(0);

    for (int i = threadIdx.x; i < tile; i += kThreads) {
      T x[kNCol];
      load_sample(sc, tile, i, x);
      const int f = sf[i];
      Aux<T> ax;
      const T lw = eval_logw(x, f, p, ax);
      if (lw == -INFINITY) continue;  // masked or out of support: weight exactly 0
      // d lse1 / d lw = e^(lw - l1); d lse2 / d lw = 2 e^(2 lw - l2)
      T w = T(0);
      if (G1 != T(0)) w += gw_exp(lw - L1) * G1;
      if (G2 != T(0)) w += gw_exp(T(2) * lw - L2) * (T(2) * G2);
      acc[kPBeta] += w * x[kLogQ];
      if (!is_m1) {
        acc[kPLogAbsAp1] += w;
        acc[kPAp1] -= w * ax.dls;
      }
      acc[kPAlpha] += w * ax.r1 * x[kLogM1];
      acc[kPCPl] += w * ax.r1;
      acc[kPMu] += w * ax.r2 * ax.t * p[kPInvSig];
      acc[kPInvSig] -= w * ax.r2 * ax.t * (x[kM1] - p[kPMu]);
      acc[kPCPeak] += w * ax.r2;
      acc[kPA1] += w * x[kLogA1];
      acc[kPB1] += w * x[kLog1mA1];
      acc[kPN1] += w;
      acc[kPA2] += w * x[kLogA2];
      acc[kPB2] += w * x[kLog1mA2];
      acc[kPN2] += w;
      acc[kPIso1] += w * ax.r3;
      acc[kPAli1] += w * ax.r4;
      acc[kPInvSt1] -= w * ax.r4 * ax.t1 * x[kCt1m1];
      acc[kPIso2] += w * ax.r5;
      acc[kPAli2] += w * ax.r6;
      acc[kPInvSt2] -= w * ax.r6 * ax.t2 * x[kCt2m1];
      if (f & kFZOk) {
        acc[kPLamb1] += w * x[kLog1pZ];
        acc[kPZl] -= w;
      }
    }
#pragma unroll
    for (int j = 0; j < kPStride; ++j) {
      const T v = warp_sum(acc[j]);
      if (lane == 0) red[warp * kPStride + j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kPStride) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kPStride + threadIdx.x];
      part[(cr * n_tiles + t) * kPStride + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// one warp per (chain, parameter): sum the (row, tile) partials in a fixed order
template <typename T>
__global__ void k2_bwd_merge(const T* __restrict__ part, T* __restrict__ dP, int n_parts) {
  const int c = blockIdx.x / kPStride, j = blockIdx.x % kPStride;
  const T* q = part + static_cast<long long>(c) * n_parts * kPStride + j;
  T s = T(0);
  for (int k = threadIdx.x; k < n_parts; k += 32) s += q[static_cast<long long>(k) * kPStride];
  s = warp_sum(s);
  if (threadIdx.x == 0) dP[static_cast<long long>(c) * kPStride + j] = s;
}

template <typename T>
size_t smem_bytes(int tile) {
  return static_cast<size_t>(tile) * (kNCol * sizeof(T) + sizeof(int));
}

inline bool bad_shape(int C, int rows, long long S, int tile) {
  return C <= 0 || rows <= 0 || rows > 65535 || S <= 0 || tile < kThreads || tile % kThreads != 0 || tile > 4096 ||
         (S + tile - 1) / tile > 2147483647LL;
}

template <typename T>
int fwd_launch(const T* cols, const int* flags, const T* P, T* part, T* lse1, T* lse2, int C, int rows, long long S,
               int tile, void* stream) {
  if (bad_shape(C, rows, S, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((S + tile - 1) / tile);
  const size_t smem = smem_bytes<T>(tile);
  cudaError_t e = cudaFuncSetAttribute(k2_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  k2_fwd_kernel<T><<<dim3(n_tiles, rows), kThreads, smem, st>>>(cols, flags, P, part, C, rows, S, tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = C * rows;
  k2_fwd_merge<T><<<(n_out + 127) / 128, 128, 0, st>>>(part, lse1, lse2, n_out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_launch(const T* cols, const int* flags, const T* P, const T* g1, const T* g2, const T* l1, const T* l2,
               T* part, T* dP, int C, int rows, long long S, int tile, void* stream) {
  if (bad_shape(C, rows, S, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((S + tile - 1) / tile);
  const size_t smem = smem_bytes<T>(tile);
  cudaError_t e = cudaFuncSetAttribute(k2_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  k2_bwd_kernel<T><<<dim3(n_tiles, rows), kThreads, smem, st>>>(cols, flags, P, g1, g2, l1, l2, part, C, rows, S,
                                                                tile);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k2_bwd_merge<T><<<C * kPStride, 32, 0, st>>>(part, dP, rows * n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gw_k2_fwd_f32(const float* cols, const int* flags, const float* P, float* part, float* lse1, float* lse2, int C,
                  int rows, long long S, int tile, void* stream) {
  return fwd_launch<float>(cols, flags, P, part, lse1, lse2, C, rows, S, tile, stream);
}

int gw_k2_fwd_f64(const double* cols, const int* flags, const double* P, double* part, double* lse1, double* lse2,
                  int C, int rows, long long S, int tile, void* stream) {
  return fwd_launch<double>(cols, flags, P, part, lse1, lse2, C, rows, S, tile, stream);
}

int gw_k2_bwd_f32(const float* cols, const int* flags, const float* P, const float* g1, const float* g2,
                  const float* l1, const float* l2, float* part, float* dP, int C, int rows, long long S, int tile,
                  void* stream) {
  return bwd_launch<float>(cols, flags, P, g1, g2, l1, l2, part, dP, C, rows, S, tile, stream);
}

int gw_k2_bwd_f64(const double* cols, const int* flags, const double* P, const double* g1, const double* g2,
                  const double* l1, const double* l2, double* part, double* dP, int C, int rows, long long S,
                  int tile, void* stream) {
  return bwd_launch<double>(cols, flags, P, g1, g2, l1, l2, part, dP, C, rows, S, tile, stream);
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
