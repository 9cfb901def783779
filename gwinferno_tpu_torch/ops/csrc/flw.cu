// K3: the fused B-spline log-weight product and double logsumexp.
//
// Replaces gwinferno_tpu/ops/fused.py::_fused_kernel (the Pallas TPU kernel
// driven by _flw_core).  For chains c, design rows k and the flattened bank
// n = e * S + s of E events with S samples each it computes
//   logw[c, n] = sum_k coefs[c, k] * design[k, n] + nlp[n]
// and, for every (chain, event), the raw pair
//   lse1[c, e] = logsumexp_s logw[c, e*S + s],  lse2[c, e] = logsumexp_s 2 logw,
// without writing logw to device memory.  A sample whose nlp is -inf (a
// sample mask) weighs exactly 0; a tile, an event or padding with no live
// sample stays empty and gives -inf, never NaN (the Pallas kernel gives NaN
// there).  The design matrix may have a row stride ld >= E * S (a padded
// view); the columns past E * S are never read.
//
// Bound: bytes.  The kernel reads the design matrix once (K values a
// sample) and does 2 C K operations a sample: at C = 8 in float32 that is 4
// operations per byte read, under the card's ~20 float32 operations per
// byte of memory rate.  Design, for that floor:
// - Many bytes in flight.  A lane owns a run of 16 bytes of adjacent
//   samples (4 in float32, 2 in float64) and streams each design row's run
//   into its own slots of a ring in shared memory with 16-byte cp.async
//   copies, kRing rows ahead of the row it multiplies, so a block keeps
//   kRing * 4 KB in flight without spending registers on it (with 4 rows
//   in flight the PE bank ran ~15% slower; PERF.md).  The
//   chains' dot products for the run stay in registers, the coefficients in
//   shared memory.  Runs that straddle the tile's edge, and every run when
//   ld is not a multiple of the vector (rows not all 16-byte aligned), read
//   their samples singly.  The loads do not wait for nlp: a masked sample
//   is read and weighs 0.
// - Rows split over warps.  A block of 256 threads is ksplit slices of
//   256 / ksplit lanes; each slice takes its share of the K rows for the
//   same samples, and the slices' partial sums meet in shared memory (summed
//   in slice order).  A bank too short to fill the card with whole rows
//   (the injections, one row of samples) runs one block per SM with its
//   rows split 4 ways: an SM streams more rows at once, and a second block
//   on an SM would share its memory pipe rather than add to it.
// - Block-wise rescale.  Each (chain, run) updates the online state (max m,
//   s1 = sum e^(x-m), s2 = sum e^(2(x-m))) once: the run's max, one rescale.
// - Geometry from the card (ops/fused.py::flw_geometry): tile, ksplit and
//   grid from the SM count and this kernel's occupancy.
// - One launch a bank.  Each block merges its threads' states per chain
//   (warp shuffle, then across warps in a fixed order); when an event has
//   several tiles, it writes its partials, and an integer ticket per event
//   tells the block that finishes last, which merges the event's partials
//   in a fixed order and resets the ticket to 0.  No float atomics: the
//   result does not depend on the order in which blocks run.  Chains beyond
//   16 run in further launches, 16 at a time.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing (the caller passes the partials buffer
// and a zeroed ticket per event, which the kernel leaves zeroed), returns
// the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChains = 16;
constexpr int kRing = 16;  // design rows a thread has in flight (cp.async ring slots)
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }
__device__ __forceinline__ float gw_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double gw_fma(double a, double b, double c) { return fma(a, b, c); }

// values of T in 16 bytes
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void load16_shared(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16_shared(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct State {
  T m, s1, s2;
};

template <typename T>
__device__ __forceinline__ State<T> empty_state() {
  return {-INFINITY, T(0), T(0)};
}

template <typename T>
__device__ __forceinline__ State<T> merge(State<T> a, State<T> b) {
  const T m = a.m > b.m ? a.m : b.m;
  if (m == -INFINITY) return a;  // both empty
  const T ea = gw_exp(a.m - m);  // 0 when a is empty
  const T eb = gw_exp(b.m - m);
  return {m, a.s1 * ea + b.s1 * eb, a.s2 * ea * ea + b.s2 * eb * eb};
}

// Add the log-weights v[0..V) (-inf weighs 0) to st: one max, one rescale.
template <typename T, int V>
__device__ __forceinline__ void push_run(State<T>& st, const T* v) {
  T mx = v[0];
#pragma unroll
  for (int i = 1; i < V; ++i) mx = v[i] > mx ? v[i] : mx;
  if (mx == -INFINITY) return;
  const T m = st.m > mx ? st.m : mx;
  const T r = gw_exp(st.m - m);  // 0 while the state is empty
  T s1 = st.s1 * r, s2 = st.s2 * r * r;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const T e = gw_exp(v[i] - m);
    s1 += e;
    s2 += e * e;
  }
  st = {m, s1, s2};
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

template <typename T, int NC, int V>
__device__ __forceinline__ void fma_row(T (&acc)[NC][V], const T* __restrict__ ck, const T* d) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const T w = ck[c];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[c][i] = gw_fma(w, d[i], acc[c][i]);
  }
}

template <typename T>
__host__ __device__ __forceinline__ size_t coef_bytes(int K, int nc_pad) {
  return (static_cast<size_t>(K) * nc_pad * sizeof(T) + 15) & ~static_cast<size_t>(15);
}

// the slices' partial sums when the rows are split: (ksplit, NC, lanes * V)
__host__ __device__ __forceinline__ size_t split_bytes(int nc_pad, int ksplit) {
  return ksplit > 1 ? static_cast<size_t>(nc_pad) * kThreads * 16 : 0;
}

// One block: event e = blockIdx.x / tiles, samples [t * tile, min(S, (t+1) * tile)).
// coefs: (nc, K) of this chain group; part: (nc, E, tiles, 3) of this group;
// lse1, lse2: (nc, E) of this group.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC > 8 ? 1 : 2)
    flw_kernel(const T* __restrict__ coefs, const T* __restrict__ design, long long ld, const T* __restrict__ nlp,
               T* __restrict__ part, T* __restrict__ lse1, T* __restrict__ lse2, unsigned int* __restrict__ tickets,
               int nc, int K, long long E, long long S, long long tile, int tiles, int ksplit) {
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);                            // (K, NC): row k's coefficients side by side
  T* red = reinterpret_cast<T*>(smem_raw + coef_bytes<T>(K, NC));    // (ksplit, NC, lanes * V)
  // this thread's ring slots: kRing of 16 bytes, kThreads * 16 bytes apart
  T* ring = reinterpret_cast<T*>(smem_raw + coef_bytes<T>(K, NC) + split_bytes(NC, ksplit)) + threadIdx.x * V;
  __shared__ T red_m[kWarps][NC], red_s1[kWarps][NC], red_s2[kWarps][NC];
  __shared__ unsigned int last_block;

  const long long e = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - e * tiles);
  const int lanes = kThreads / ksplit;
  const int slice = threadIdx.x / lanes;
  const int lane = threadIdx.x - slice * lanes;
  const int k0 = slice * K / ksplit, k1 = (slice + 1) * K / ksplit;

#pragma unroll 4
  for (int i = threadIdx.x; i < K * NC; i += kThreads) {
    const int k = i / NC;
    const int c = i - k * NC;
    cs[i] = c < nc ? coefs[static_cast<long long>(c) * K + k] : T(0);
  }
  __syncthreads();

  // the tile's columns [n0, n1), in runs of V on the grid of columns whose
  // address in design row 0 is 16-byte aligned
  const long long s_end = (t + 1) * tile < S ? (t + 1) * tile : S;
  const long long n0 = e * S + t * tile, n1 = e * S + s_end;
  const long long a = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(design) & 15)) & 15) / sizeof(T);
  const long long qa = n0 - (((n0 - a) % V) + V) % V;
  const long long nq = (n1 - qa + V - 1) / V;
  const bool rows_aligned = ld % V == 0;

  State<T> st[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) st[c] = empty_state<T>();

  for (long long qb = 0; qb < nq; qb += lanes) {  // the same trip count in every thread of the block
    const long long col = qa + (qb + lane) * V;
    T lp[V];
    bool in[V];
    bool full = true, any = false;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      in[i] = qb + lane < nq && col + i >= n0 && col + i < n1;
      full = full && in[i];
      any = any || in[i];
      lp[i] = in[i] ? __ldg(nlp + col + i) : T(-INFINITY);
    }
    T acc[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[c][i] = T(0);
    const T* p = design + k0 * ld + col;
    const int nk = k1 - k0;
    if (full && rows_aligned) {
      // row u waits in slot u % kRing; rows u + 1 .. u + kRing - 1 are in flight
#pragma unroll
      for (int u = 0; u < kRing - 1; ++u) {
        if (u < nk) cp_async16(ring + u * kThreads * V, p + u * ld);
        cp_async_commit();
      }
      for (int u = 0; u < nk; ++u) {
        cp_async_wait<kRing - 2>();
        T d[V];
        load16_shared(ring + (u % kRing) * kThreads * V, d);
        // refill the slot that row u - 1 left (read in the previous round)
        const int next = u + kRing - 1;
        if (next < nk) cp_async16(ring + (next % kRing) * kThreads * V, p + next * ld);
        cp_async_commit();
        fma_row<T, NC, V>(acc, cs + (k0 + u) * NC, d);
      }
    } else if (any) {
      for (int u = 0; u < nk; ++u, p += ld) {
        T d[V];
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = in[i] ? __ldcs(p + i) : T(0);
        fma_row<T, NC, V>(acc, cs + (k0 + u) * NC, d);
      }
    }
    bool live = false;
#pragma unroll
    for (int i = 0; i < V; ++i) live = live || lp[i] != T(-INFINITY);
    if (ksplit > 1) {
      // the slices' partial sums of this lane's run, summed in slice order
      // by the slice that owns each chain (chain c: slice c % ksplit)
      const int stride = lanes * V;
      T* mine = red + static_cast<size_t>(slice) * NC * stride + lane * V;
#pragma unroll
      for (int c = 0; c < NC; ++c) store16(mine + c * stride, acc[c]);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c % ksplit != slice || !live) continue;
        const T* src = red + static_cast<size_t>(c) * stride + lane * V;
        load16_shared(src, acc[c]);
        for (int u = 1; u < ksplit; ++u) {
          T v[V];
          load16_shared(src + static_cast<size_t>(u) * NC * stride, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[c][i] += v[i];
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= nc || c % ksplit != slice) continue;
        T v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = lp[i] == T(-INFINITY) ? T(-INFINITY) : acc[c][i] + lp[i];
        push_run<T, V>(st[c], v);
      }
    }
  }

  const int wlane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const State<T> w = warp_merge(st[c]);
    if (wlane == 0) {
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
    if (tiles == 1) {
      // an empty (chain, event): m = -inf and s = 0, so both outputs are -inf
      lse1[c * E + e] = acc.m + gw_log(acc.s1);
      lse2[c * E + e] = T(2) * acc.m + gw_log(acc.s2);
    } else {
      T* out = part + ((c * E + e) * tiles + t) * 3;
      out[0] = acc.m;
      out[1] = acc.s1;
      out[2] = acc.s2;
      __threadfence();
    }
  }
  if (tiles == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(tickets + e, 1u) == static_cast<unsigned int>(tiles - 1);
  __syncthreads();
  if (!last_block) return;
  // the last block of the event: each warp merges a chain's partials in a
  // fixed order (each lane a strided run of tiles, then a shuffle tree)
  __threadfence();
  for (int c = warp; c < nc; c += kWarps) {
    const T* pc = part + (c * E + e) * tiles * 3;
    State<T> acc = empty_state<T>();
#pragma unroll 4
    for (int u = wlane; u < tiles; u += 32)
      acc = merge(acc, State<T>{__ldcg(pc + 3 * u), __ldcg(pc + 3 * u + 1), __ldcg(pc + 3 * u + 2)});
    acc = warp_merge(acc);
    if (wlane == 0) {
      lse1[c * E + e] = acc.m + gw_log(acc.s1);
      lse2[c * E + e] = T(2) * acc.m + gw_log(acc.s2);
    }
  }
  if (threadIdx.x == 0) tickets[e] = 0u;
}

template <typename T, int NC>
size_t smem_bytes(int K, int ksplit) {
  return coef_bytes<T>(K, NC) + split_bytes(NC, ksplit) + static_cast<size_t>(kRing) * kThreads * 16;
}

// Let the (T, NC) kernel take as much dynamic shared memory as a block may
// have beside its static shared memory, on the current device (once per
// device).
template <typename T, int NC>
cudaError_t allow_max_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, flw_kernel<T, NC>);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flw_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem - a.sharedSizeBytes));
  if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  return e;
}

template <typename T, int NC>
cudaError_t launch_group(const T* coefs, const T* design, long long ld, const T* nlp, T* part, T* lse1, T* lse2,
                         unsigned int* tickets, int nc, int K, long long E, long long S, long long tile, int tiles,
                         int ksplit, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, NC>(K, ksplit);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T, NC>();
  if (err != cudaSuccess) return err;
  flw_kernel<T, NC><<<static_cast<unsigned int>(E * tiles), kThreads, smem, stream>>>(
      coefs, design, ld, nlp, part, lse1, lse2, tickets, nc, K, E, S, tile, tiles, ksplit);
  return cudaGetLastError();
}

// the instantiation a chain group of nc chains runs in
int group_width(long long nc) { return nc <= 1 ? 1 : (nc <= 8 ? 8 : kMaxChains); }

template <typename T>
int launch(const T* coefs, const T* design, long long ld, const T* nlp, T* part, T* lse1, T* lse2,
           unsigned int* tickets, long long C, long long K, long long E, long long S, long long tile, int ksplit,
           void* stream_ptr) {
  if (C <= 0 || E <= 0) return 0;
  if (K <= 0 || S <= 0 || tile <= 0 || ld < E * S || K > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (ksplit != 1 && ksplit != 2 && ksplit != 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (S + tile - 1) / tile;
  if (E * tiles > 2147483647LL || C * E > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (tiles > 1 && (part == nullptr || tickets == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (long long c0 = 0; c0 < C; c0 += kMaxChains) {
    const int nc = static_cast<int>(C - c0 < kMaxChains ? C - c0 : kMaxChains);
    const T* cg = coefs + c0 * K;
    T* pg = part == nullptr ? nullptr : part + c0 * E * tiles * 3;
    T* l1 = lse1 + c0 * E;
    T* l2 = lse2 + c0 * E;
    const int k = static_cast<int>(K), nt = static_cast<int>(tiles);
    cudaError_t err;
    switch (group_width(nc)) {
      case 1:
        err = launch_group<T, 1>(cg, design, ld, nlp, pg, l1, l2, tickets, nc, k, E, S, tile, nt, ksplit, stream);
        break;
      case 8:
        err = launch_group<T, 8>(cg, design, ld, nlp, pg, l1, l2, tickets, nc, k, E, S, tile, nt, ksplit, stream);
        break;
      default:
        err = launch_group<T, 16>(cg, design, ld, nlp, pg, l1, l2, tickets, nc, k, E, S, tile, nt, ksplit, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T, int NC>
int kernel_info_of(long long dynamic_smem, int* out) {
  const void* fn = reinterpret_cast<const void*>(flw_kernel<T, NC>);
  const size_t smem = static_cast<size_t>(dynamic_smem);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_max_smem<T, NC>();
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, kThreads, smem));
}

template <typename T>
int kernel_info(int width, long long dynamic_smem, int* out) {
  if (width == 1) return kernel_info_of<T, 1>(dynamic_smem, out);
  if (width == 8) return kernel_info_of<T, 8>(dynamic_smem, out);
  return kernel_info_of<T, kMaxChains>(dynamic_smem, out);
}

}  // namespace

extern "C" {

int gw_flw_f32(const float* coefs, const float* design, long long ld, const float* nlp, float* part, float* lse1,
               float* lse2, unsigned int* tickets, long long C, long long K, long long E, long long S, long long tile,
               int ksplit, void* stream) {
  return launch<float>(coefs, design, ld, nlp, part, lse1, lse2, tickets, C, K, E, S, tile, ksplit, stream);
}

int gw_flw_f64(const double* coefs, const double* design, long long ld, const double* nlp, double* part,
               double* lse1, double* lse2, unsigned int* tickets, long long C, long long K, long long E, long long S,
               long long tile, int ksplit, void* stream) {
  return launch<double>(coefs, design, ld, nlp, part, lse1, lse2, tickets, C, K, E, S, tile, ksplit, stream);
}

// registers and spill bytes a thread, and resident blocks per SM at smem
// bytes of dynamic shared memory, of the float32 (f64 = 0) or float64
// kernel for a chain group of the given width (1, 8 or 16)
int gw_flw_kernel_info(int f64, int width, long long smem, int* out) {
  return f64 ? kernel_info<double>(width, smem, out) : kernel_info<float>(width, smem, out);
}

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
