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
// Bound: at C = 16 the work per bank element is ~9 special-function results
// and ~60 other operations per chain forward (~17 and ~140 backward) against
// 13 column reads, so both kernels are bound by operations, not by device
// memory.  The design therefore spends no instruction twice:
//
// Forward (k2_fwd_kernel).  A block owns one (row, tile) of the bank and a
// group of at most NC chains (a template parameter: 1, or 4 with the chains
// past the group masked; 4 timed fastest on an H100, PERF.md); the chains sit
// INSIDE the sample loop.  Each thread reads a sample's columns and flags
// once from device memory (coalesced: neighbouring threads on neighbouring
// samples) into registers, evaluates it for every chain of the group, with
// the chains' parameters read from shared memory (broadcast 16-byte loads,
// one chain at a time so that they do not all occupy registers), and keeps
// the group's online (m, s1 = sum e^(lw-m), s2 = sum e^(2(lw-m))) states in
// registers.  Further chain groups are further blocks (the grid's z axis).
// The forward evaluates only lw, none of the backward's terms.  At the end of
// the tile one reduction serves all chains: a recursive-halving warp exchange
// (each round a lane keeps half of its chains and takes its partner's copy of
// that half, so 4 chains cost 6 merges a lane, not 20), then one
// __syncthreads and a merge across the block's warps in warp order.
//
// Backward (k2_bwd_kernel).  24 accumulators per chain do not fit in
// registers for 16 chains at once, so a block stages its (row, tile) in
// shared memory once (the only __syncthreads), and each WARP owns one chain
// over a slice of the tile, lanes over samples: no block barrier per chain.
// The warp's lanes stage that chain's parameters and cotangents in the
// warp's own slot of shared memory (a __syncwarp, not a block barrier), so
// the shared memory does not grow with C; each lane loads its value of the
// warp's next chain while the current one runs, so no chain waits on device
// memory.  Each (chain, slice) ends in one warp-level reduction
// of its 24 sums, again by recursive halving (27 shuffles instead of 120),
// and writes its partials.  With fewer chains than warps, the tile is split
// into slices so that every warp works.
//
// The caller chooses the geometry (tile, chains a block, slices) from
// the card's SM count and the kernels' occupancy
// (gwinferno_tpu_torch/ops/streamed.py::k2_geometry).  Partials are merged by
// a second small kernel in a fixed order; no float atomics, so a seed
// reproduces a run bit for bit.
//
// Float32 uses the special-function unit (__expf, __logf, __fdividef) in the
// per-sample chain and the in-block merges, and the q norm's log(-expm1(-d))
// as a short series for small d (log_span); float64 keeps libm.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing, returns a cudaError_t code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChains = 4;  // chains a forward block carries
constexpr size_t kDefaultSmem = 48 * 1024;
// resident blocks per SM the float32 kernels are compiled for (at most
// 65536 / (256 n) registers a thread); float64 asks for 1
template <typename T>
__host__ __device__ constexpr int fwd_min_blocks() {
  return sizeof(T) == 8 ? 1 : 4;
}
template <typename T>
__host__ __device__ constexpr int bwd_min_blocks() {
  return sizeof(T) == 8 ? 1 : 3;
}

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
// a backward warp's slot: its chain's parameters, then g1, g2, l1, l2 of
// its (chain, row)
constexpr int kSG1 = kPStride, kSG2 = kPStride + 1, kSL1 = kPStride + 2, kSL2 = kPStride + 3, kSlot = 32;

// libm: the merge kernels' final logs and the float64 chain
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }
// the hot loops: the special-function unit in float32, libm in float64
__device__ __forceinline__ float hot_exp(float v) { return __expf(v); }
__device__ __forceinline__ double hot_exp(double v) { return exp(v); }
__device__ __forceinline__ float hot_log(float v) { return __logf(v); }
__device__ __forceinline__ double hot_log(double v) { return log(v); }
// log(1 + e), 0 <= e <= 1 (the argument of log lies in [1, 2])
__device__ __forceinline__ float hot_log1p(float e) { return __logf(1.0f + e); }
__device__ __forceinline__ double hot_log1p(double e) { return log1p(e); }
__device__ __forceinline__ float hot_div(float a, float b) { return __fdividef(a, b); }
__device__ __forceinline__ double hot_div(double a, double b) { return a / b; }

// log(1 - e^-d) for d >= eps and, with kAux, em = 1 - e^-d and ed = e^-d.
// float32: below d = 0.5, log d plus the series of log((1 - e^-d) / d) =
// -d/2 + d^2/24 - d^4/2880 (the next term, d^6/181440, is under 1e-7), so
// the small d keeps its relative accuracy without expm1; above, 1 - e^-d >=
// 0.39 straight from __expf.  float64: libm's expm1.
template <bool kAux>
__device__ __forceinline__ float log_span(float d, float& em, float& ed) {
  const bool small = d < 0.5f;
  const float t = __expf(-d);
  const float series = d * (-0.5f + d * (1.0f / 24.0f - d * d * (1.0f / 2880.0f)));
  const float lg = __logf(small ? d : 1.0f - t) + (small ? series : 0.0f);
  if constexpr (kAux) {
    em = small ? __expf(lg) : 1.0f - t;
    ed = t;
  }
  return lg;
}
template <bool kAux>
__device__ __forceinline__ double log_span(double d, double& em, double& ed) {
  em = -expm1(-d);
  ed = 1.0 - em;
  return log(em);
}

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

// logaddexp(a, b) and, with kAux, the responsibilities e^(a-r), e^(b-r).
// With e = e^-|a-b|: r = max + log1p(e), and the responsibilities are
// 1 / (1 + e) (the larger term) and e / (1 + e).  When both terms are -inf
// the result is NaN, not -inf: either way the sample's lw is not finite, so
// it counts as -inf and weighs 0 (eval_logw), and nothing else reads r.
template <typename T, bool kAux>
__device__ __forceinline__ T logaddexp_r(T a, T b, T& ra, T& rb) {
  const T m = a > b ? a : b;
  const T e = hot_exp(-fabs(a - b));
  if constexpr (kAux) {
    const T big = hot_div(T(1), T(1) + e);
    ra = a >= b ? big : e * big;
    rb = a >= b ? e * big : big;
  }
  return m + hot_log1p(e);
}

// One sample's log-weight; -inf out of support or where the sum is NaN / +inf.
// With kAux (the backward) it also fills ax; without, it computes nothing else.
template <typename T, bool kAux>
__device__ __forceinline__ T eval_logw(const T (&x)[kNCol], int f, const T (&p)[kPStride], Aux<T>& ax) {
  if ((f & kSupport) != kSupport) return -INFINITY;
  const T eps = Lim<T>::eps();
  const T llow = x[kLogLow];
  T norm_q;
  if (p[kPIsM1] != T(0)) {
    norm_q = -hot_log(fmax(fabs(T(0) - llow), eps));
    if constexpr (kAux) ax.dls = T(0);
  } else {
    const T b = p[kPAp1] * llow;
    const T d = fmax(fabs(b), eps);
    T em, ed;
    norm_q = p[kPLogAbsAp1] - ((b > T(0) ? b : T(0)) + log_span<kAux>(d, em, ed));
    if constexpr (kAux) {
      ax.dls = (b > T(0) ? llow : T(0)) + (fabs(b) >= eps ? hot_div((b > T(0) ? llow : -llow) * ed, em) : T(0));
    }
  }
  const T log_p_q = p[kPBeta] * x[kLogQ] + norm_q;

  const T t = (x[kM1] - p[kPMu]) * p[kPInvSig];
  const T log_p_m1 = logaddexp_r<T, kAux>(p[kPCPl] + p[kPAlpha] * x[kLogM1], p[kPCPeak] - T(0.5) * t * t, ax.r1, ax.r2);

  const T mag = (p[kPA1] * x[kLogA1] + p[kPB1] * x[kLog1mA1] + p[kPN1]) +
                (p[kPA2] * x[kLogA2] + p[kPB2] * x[kLog1mA2] + p[kPN2]);

  const T t1 = x[kCt1m1] * p[kPInvSt1];
  const T t2 = x[kCt2m1] * p[kPInvSt2];
  const T tilt = logaddexp_r<T, kAux>(p[kPIso1], p[kPAli1] - T(0.5) * t1 * t1, ax.r3, ax.r4) +
                 logaddexp_r<T, kAux>(p[kPIso2], p[kPAli2] - T(0.5) * t2 * t2, ax.r5, ax.r6);
  if constexpr (kAux) {
    ax.t = t;
    ax.t1 = t1;
    ax.t2 = t2;
  }

  const T zterm = (f & kFZOk) ? (x[kLogDvdz] + p[kPLamb1] * x[kLog1pZ]) - p[kPZl] : Lim<T>::lowest();
  const T lw = ((((log_p_q + log_p_m1) + mag) + tilt) + zterm) - x[kLogPrior];
  return fabs(lw) < T(INFINITY) ? lw : T(-INFINITY);  // NaN and +-inf -> -inf
}

template <typename T>
struct State {
  T m, s1, s2;
};

template <typename T>
__device__ __forceinline__ State<T> merge(State<T> a, State<T> b) {
  const T m = a.m > b.m ? a.m : b.m;
  if (m == -INFINITY) return a;  // both empty
  const T ea = hot_exp(a.m - m);  // 0 when a is empty
  const T eb = hot_exp(b.m - m);
  return {m, a.s1 * ea + b.s1 * eb, a.s2 * ea * ea + b.s2 * eb * eb};
}

// add v to the online state, without branches: e = e^-|v-m| rescales the
// state when v is the new maximum (e = 0 while the state is empty), else
// weighs v
template <typename T>
__device__ __forceinline__ void push(State<T>& st, T v) {
  if (v == -INFINITY) return;
  const bool up = v > st.m;
  const T e = hot_exp(-fabs(v - st.m));
  st.s1 = up ? st.s1 * e + T(1) : st.s1 + e;
  st.s2 = up ? st.s2 * (e * e) + T(1) : st.s2 + e * e;
  st.m = up ? v : st.m;
}

// ---- warp reduction by recursive halving, for sums and for lse states

template <typename T>
__device__ __forceinline__ T shfl_x(T v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
template <typename T>
__device__ __forceinline__ State<T> shfl_x(State<T> v, int off) {
  return {shfl_x(v.m, off), shfl_x(v.s1, off), shfl_x(v.s2, off)};
}
__device__ __forceinline__ float combine(float a, float b) { return a + b; }
__device__ __forceinline__ double combine(double a, double b) { return a + b; }
template <typename T>
__device__ __forceinline__ State<T> combine(State<T> a, State<T> b) {
  return merge(a, b);
}

// Rounds that halve the values a lane holds (while their count is even),
// then plain butterflies on what is left.
__host__ __device__ constexpr int halvings(int n, int off) { return (off > 0 && n > 1 && n % 2 == 0) ? 1 + halvings(n / 2, off / 2) : 0; }
// after the reduction a lane holds kept(N) totals, of values base .. base + kept(N) - 1
__host__ __device__ constexpr int kept(int n) { return n >> halvings(n, 16); }
// lanes that differ only in these bits hold the same totals; the lane with them 0 writes
__host__ __device__ constexpr int dup_mask(int n) { return (32 >> halvings(n, 16)) - 1; }

// Reduce v[0 .. N) over the warp's 32 lanes: each round at offset OFF, a lane
// keeps one half of its values (the upper half if its bit OFF is set) and
// adds its partner's copy of that half.  On return v[0 .. kept(N)) are the
// warp's totals of values base ..; the order of the additions is fixed.
template <int OFF, int N, typename V, int M>
__device__ __forceinline__ void warp_halve(V (&v)[M], int lane, int& base) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1 && N % 2 == 0) {
      constexpr int H = N / 2;
      const bool hi = (lane & OFF) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const V keep = hi ? v[H + k] : v[k];
        const V send = hi ? v[k] : v[H + k];
        v[k] = combine(keep, shfl_x(send, OFF));
      }
      if (hi) base += H;
      warp_halve<OFF / 2, H>(v, lane, base);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = combine(v[k], shfl_x(v[k], OFF));
      warp_halve<OFF / 2, N>(v, lane, base);
    }
  }
}

// ---- loads

__device__ __forceinline__ void unpack(float4 w, float* d) {
  d[0] = w.x;
  d[1] = w.y;
  d[2] = w.z;
  d[3] = w.w;
}
__device__ __forceinline__ void unpack(double2 w, double* d) {
  d[0] = w.x;
  d[1] = w.y;
}
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// one chain's parameters from shared memory, 16 bytes a load (a broadcast)
template <typename T>
__device__ __forceinline__ void load_params_shared(const T* sp, T (&p)[kPStride]) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  const V* v = reinterpret_cast<const V*>(sp);
#pragma unroll
  for (int i = 0; i < kPStride / kPer; ++i) unpack(v[i], p + i * kPer);
}

// ---- forward

// grid (n_tiles, rows, chain groups); block z carries chains
// c0 = z * group .. c0 + nc - 1, nc <= group <= NC;
// part[((c * rows + row) * n_tiles + tile) * 3 + {m, s1, s2}]
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<T>())
    k2_fwd_kernel(const T* __restrict__ cols, const int* __restrict__ flags, const T* __restrict__ P,
                  T* __restrict__ part, int C, int group, int rows, long long S, int tile) {
  __shared__ __align__(16) T sp[NC * kPStride];
  __shared__ T rm[kWarps][NC], rs1[kWarps][NC], rs2[kWarps][NC];

  const int row = blockIdx.y, t = blockIdx.x, n_tiles = gridDim.x;
  const int c0 = blockIdx.z * group;
  const int nc = C - c0 < group ? C - c0 : group;
  P += static_cast<long long>(c0) * kPStride;
  part += static_cast<long long>(c0) * rows * n_tiles * 3;
  for (int i = threadIdx.x; i < NC * kPStride; i += kThreads) sp[i] = i < nc * kPStride ? P[i] : T(0);
  __syncthreads();

  State<T> st[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) st[c] = {-INFINITY, T(0), T(0)};

  const long long cstride = static_cast<long long>(rows) * S;
  const T* colr = cols + static_cast<long long>(row) * S;
  const int* flr = flags + static_cast<long long>(row) * S;
  const long long j0 = static_cast<long long>(t) * tile;
  const long long j1 = j0 + tile < S ? j0 + tile : S;
  for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int f = flr[j];
    if ((f & kSupport) != kSupport) continue;  // -inf for every chain
    T x[kNCol];
#pragma unroll
    for (int k = 0; k < kNCol; ++k) x[k] = colr[k * cstride + j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        // one chain at a time: keeps the compiler from hoisting every
        // chain's parameters into registers at once
        asm volatile("" ::: "memory");
        T p[kPStride];
        load_params_shared(sp + c * kPStride, p);
        Aux<T> ax;  // not filled: the forward evaluates lw alone
        push(st[c], eval_logw<T, false>(x, f, p, ax));
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  warp_halve<16, NC>(st, lane, base);
  constexpr int kDup = dup_mask(NC);
  if ((lane & kDup) == 0) {
    rm[warp][base] = st[0].m;
    rs1[warp][base] = st[0].s1;
    rs2[warp][base] = st[0].s2;
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    const int c = threadIdx.x;
    State<T> acc{rm[0][c], rs1[0][c], rs2[0][c]};
    for (int w = 1; w < kWarps; ++w) acc = merge(acc, State<T>{rm[w][c], rs1[w][c], rs2[w][c]});
    T* o = part + ((static_cast<long long>(c) * rows + row) * n_tiles + t) * 3;
    o[0] = acc.m;
    o[1] = acc.s1;
    o[2] = acc.s2;
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

// ---- backward

// Stage the (row, tile) block of the columns and flags in shared memory,
// sample-major (sample i's columns at sc[i * kNCol ..]: constant offsets for
// the readers, and a stride of 13 words that no two lanes of a warp share a
// bank on in float32); samples past the row's end get flags 0 (out of
// support).
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ cols, const int* __restrict__ flags, T* sc, int* sf,
                                           int rows, long long S, int row, long long j0, int tile) {
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const long long j = j0 + i;
    const bool in = j < S;
#pragma unroll
    for (int k = 0; k < kNCol; ++k) sc[i * kNCol + k] = in ? cols[(static_cast<long long>(k) * rows + row) * S + j] : T(0);
    sf[i] = in ? flags[static_cast<long long>(row) * S + j] : 0;
  }
  __syncthreads();
}

// add one live sample's w * d lw / d P to acc[0 .. kPStride); W2 = 2 G2 e^(2 L1 - L2)
template <typename T>
__device__ __forceinline__ void accumulate(const T (&x)[kNCol], int f, const T (&p)[kPStride], T G1, T W2, T L1,
                                           T* acc) {
  Aux<T> ax;
  const T lw = eval_logw<T, true>(x, f, p, ax);
  if (lw == -INFINITY) return;  // masked or out of support: weight exactly 0
  // d lse1 / d lw = e^(lw - l1); d lse2 / d lw = 2 e^(2 lw - l2) = 2 e^(2 l1 - l2) (e^(lw - l1))^2
  const T e1 = hot_exp(lw - L1);
  const T w = (G1 != T(0) ? G1 * e1 : T(0)) + (W2 != T(0) ? W2 * (e1 * e1) : T(0));
  acc[kPBeta] += w * x[kLogQ];
  if (p[kPIsM1] == T(0)) {
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

// lane's value of chain c's slot: a parameter (lanes < kPStride), g1, g2,
// l1 or l2 of (c, row), or nothing
template <typename T>
__device__ __forceinline__ T slot_value(const T* P, const T* g1, const T* g2, const T* l1, const T* l2, int c,
                                        int rows, int row, int lane) {
  const long long cr = static_cast<long long>(c) * rows + row;
  const T* src = lane < kPStride ? P + static_cast<long long>(c) * kPStride + lane
                 : lane == kSG1  ? g1 + cr
                 : lane == kSG2  ? g2 + cr
                 : lane == kSL1  ? l1 + cr
                                 : l2 + cr;
  return lane <= kSL2 ? *src : T(0);
}

// grid (n_tiles, rows); a warp owns one chain over one of the tile's slices.
// Shared memory: each warp's slot (kWarps, kSlot), then the tile.
// part[(((c * rows + row) * n_tiles + tile) * slices + slice) * kPStride + j]
template <typename T>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<T>())
    k2_bwd_kernel(const T* __restrict__ cols, const int* __restrict__ flags, const T* __restrict__ P,
                  const T* __restrict__ g1, const T* __restrict__ g2, const T* __restrict__ l1,
                  const T* __restrict__ l2, T* __restrict__ part, int C, int rows, long long S, int tile, int slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = reinterpret_cast<T*>(smem_raw) + kWarps * kSlot;
  int* sf = reinterpret_cast<int*>(sc + kNCol * tile);

  const int row = blockIdx.y, t = blockIdx.x, n_tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* sp = reinterpret_cast<T*>(smem_raw) + warp * kSlot;
  const int n_items = C * slices;
  const int span = tile / slices;
  // the warp's first chain loads while the block stages its tile
  T next = warp < n_items ? slot_value(P, g1, g2, l1, l2, warp / slices, rows, row, lane) : T(0);
  stage_tile(cols, flags, sc, sf, rows, S, row, static_cast<long long>(t) * tile, tile);

  for (int item = warp; item < n_items; item += kWarps) {
    const int c = item / slices, sl = item - c * slices;
    const long long cr = static_cast<long long>(c) * rows + row;
    __syncwarp();  // the lanes are done with the previous chain's slot
    sp[lane] = next;
    __syncwarp();
    if (item + kWarps < n_items) next = slot_value(P, g1, g2, l1, l2, (item + kWarps) / slices, rows, row, lane);
    const T G1 = sp[kSG1], L1 = sp[kSL1], G2 = sp[kSG2];
    // a zero cotangent contributes nothing, whatever its lse
    const T W2 = G2 != T(0) ? T(2) * G2 * exp(T(2) * L1 - sp[kSL2]) : T(0);
    T acc[kPStride];
#pragma unroll
    for (int j = 0; j < kPStride; ++j) acc[j] = T(0);

    for (int i = sl * span + lane; i < (sl + 1) * span; i += 32) {
      const int f = sf[i];
      if ((f & kSupport) != kSupport) continue;
      T x[kNCol];
#pragma unroll
      for (int k = 0; k < kNCol; ++k) x[k] = sc[i * kNCol + k];
      // the parameters from shared memory on every sample (broadcast loads),
      // not held in 24 registers across the loop
      asm volatile("" ::: "memory");
      T p[kPStride];
      load_params_shared(sp, p);
      accumulate(x, f, p, G1, W2, L1, acc);
    }

    int base = 0;
    warp_halve<16, kPStride>(acc, lane, base);
    constexpr int kKept = kept(kPStride), kDup = dup_mask(kPStride);
    if ((lane & kDup) == 0) {
#pragma unroll
      for (int k = 0; k < kKept; ++k) part[((cr * n_tiles + t) * slices + sl) * kPStride + base + k] = acc[k];
    }
  }
}

// one warp per (chain, parameter): sum the (row, tile, slice) partials in a fixed order
template <typename T>
__global__ void k2_bwd_merge(const T* __restrict__ part, T* __restrict__ dP, int n_parts) {
  const int c = blockIdx.x / kPStride, j = blockIdx.x % kPStride;
  const T* q = part + static_cast<long long>(c) * n_parts * kPStride + j;
  T s = T(0);
  for (int k = threadIdx.x; k < n_parts; k += 32) s += q[static_cast<long long>(k) * kPStride];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) dP[static_cast<long long>(c) * kPStride + j] = s;
}

// ---- host side

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

template <typename T>
size_t bwd_smem_bytes(int tile) {
  return static_cast<size_t>(kWarps) * kSlot * sizeof(T) + static_cast<size_t>(tile) * (kNCol * sizeof(T) + sizeof(int));
}

// the forward instantiation for a group of nc chains
template <typename T>
const void* fwd_fn(int nc) {
  return nc <= 1 ? reinterpret_cast<const void*>(k2_fwd_kernel<T, 1>)
                 : reinterpret_cast<const void*>(k2_fwd_kernel<T, kMaxChains>);
}

inline bool bad_bank(int C, int rows, long long S, int tile) {
  return C <= 0 || rows <= 0 || rows > 65535 || S <= 0 || tile <= 0 || (S + tile - 1) / tile > 2147483647LL;
}

template <typename T>
int fwd_launch(const T* cols, const int* flags, const T* P, T* part, T* lse1, T* lse2, int C, int rows, long long S,
               int tile, int group, void* stream) {
  if (bad_bank(C, rows, S, tile) || tile % kThreads != 0 || group < 1 || group > kMaxChains)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((S + tile - 1) / tile);
  const long long chain_blocks = (C + group - 1) / group;
  if (chain_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, rows, static_cast<unsigned>(chain_blocks));
  if (group == 1) {
    k2_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(cols, flags, P, part, C, group, rows, S, tile);
  } else {
    k2_fwd_kernel<T, kMaxChains><<<grid, kThreads, 0, st>>>(cols, flags, P, part, C, group, rows, S, tile);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = C * rows;
  k2_fwd_merge<T><<<(n_out + 127) / 128, 128, 0, st>>>(part, lse1, lse2, n_out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_launch(const T* cols, const int* flags, const T* P, const T* g1, const T* g2, const T* l1, const T* l2,
               T* part, T* dP, int C, int rows, long long S, int tile, int slices, void* stream) {
  if (bad_bank(C, rows, S, tile) || slices < 1 || slices > kWarps || tile % (32 * slices) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((S + tile - 1) / tile);
  const size_t smem = bwd_smem_bytes<T>(tile);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(k2_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_tiles, rows);
  k2_bwd_kernel<T><<<grid, kThreads, smem, st>>>(cols, flags, P, g1, g2, l1, l2, part, C, rows, S, tile, slices);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k2_bwd_merge<T><<<C * kPStride, 32, 0, st>>>(part, dP, rows * n_tiles * slices);
  return static_cast<int>(cudaGetLastError());
}

// registers and local bytes a thread, and resident blocks per SM at this
// dynamic shared memory, of the backward or of the forward for a group of
// nc chains
template <typename T>
int kernel_info(int backward, int nc, long long smem_bytes, int* out) {
  const void* fn = backward ? reinterpret_cast<const void*>(k2_bwd_kernel<T>) : fwd_fn<T>(nc);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, kThreads, smem));
}

}  // namespace

extern "C" {

int gw_k2_fwd_f32(const float* cols, const int* flags, const float* P, float* part, float* lse1, float* lse2, int C,
                  int rows, long long S, int tile, int group, void* stream) {
  return fwd_launch<float>(cols, flags, P, part, lse1, lse2, C, rows, S, tile, group, stream);
}

int gw_k2_fwd_f64(const double* cols, const int* flags, const double* P, double* part, double* lse1, double* lse2,
                  int C, int rows, long long S, int tile, int group, void* stream) {
  return fwd_launch<double>(cols, flags, P, part, lse1, lse2, C, rows, S, tile, group, stream);
}

int gw_k2_bwd_f32(const float* cols, const int* flags, const float* P, const float* g1, const float* g2,
                  const float* l1, const float* l2, float* part, float* dP, int C, int rows, long long S, int tile,
                  int slices, void* stream) {
  return bwd_launch<float>(cols, flags, P, g1, g2, l1, l2, part, dP, C, rows, S, tile, slices, stream);
}

int gw_k2_bwd_f64(const double* cols, const int* flags, const double* P, const double* g1, const double* g2,
                  const double* l1, const double* l2, double* part, double* dP, int C, int rows, long long S,
                  int tile, int slices, void* stream) {
  return bwd_launch<double>(cols, flags, P, g1, g2, l1, l2, part, dP, C, rows, S, tile, slices, stream);
}

// out[0] registers a thread, out[1] local (spill) bytes a thread, out[2]
// resident blocks per SM at smem bytes of dynamic shared memory; backward
// 0 / 1, nc the forward's chains a block (1 .. 4; the backward ignores it)
int gw_k2_kernel_info(int f64, int backward, int nc, long long smem, int* out) {
  return f64 ? kernel_info<double>(backward, nc, smem, out) : kernel_info<float>(backward, nc, smem, out);
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
