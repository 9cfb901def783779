// K1: the paired importance-weight reduction of the hierarchical likelihood.
//
// Replaces gwinferno_tpu/ops/fused.py::_dlse_kernel (the Pallas TPU kernel
// launched by _dlse_pallas_2d).  For every row of a contiguous (rows, n)
// array it writes (logsumexp(x), logsumexp(2x)) in ONE pass over the row,
// with online states (max m, s1 = sum e^(x-m), s2 = sum e^(2(x-m))) merged as
//   m  = max(ma, mb)
//   s1 = s1a e^(ma-m)  + s1b e^(mb-m)
//   s2 = s2a e^2(ma-m) + s2b e^2(mb-m).
// -inf entries contribute nothing, and a row that is all -inf (a masked
// event) or empty gives -inf in both outputs, never NaN.
//
// Bound: bytes.  The kernel reads each input once and does ~10 operations
// per element, far below the card's arithmetic rate, so its floor is the row
// bank over the memory rate.  Design, for that floor:
// - Split rows.  Each row is cut into tiles of 16-byte vectors and each
//   block takes one (row, tile), so a few long rows (the (C, N_found)
//   injection call) spread over the whole card, and many short ones fill
//   whole waves (the caller's geometry, ops/fused.py::dlse_geometry).
// - Wide loads, one rescale.  A thread loads kVecs 16-byte vectors of its
//   tile at once (several loads in flight per thread), takes their max and
//   rescales its state once per round, as the Pallas kernel does per block;
//   no branch per element.  A row whose start is not 16-byte aligned (rows
//   of an odd length alternate) reads its few head and tail elements singly
//   in the row's first tile.
// - Merge in the last block.  Each block merges its threads' states (warp
//   shuffle, then across warps in a fixed order) and, when a row has several
//   tiles, writes its partial; an integer ticket per row tells the block
//   that finishes last, which merges the row's partials in a fixed order
//   (each lane a strided run of tiles, then a shuffle tree) and resets the
//   ticket to 0.  No float atomics: a seed reproduces the result bit for
//   bit, whatever order the blocks run in.
//
// Plain C interface, loaded with ctypes: launches on the given stream, does
// not synchronise, allocates nothing (the caller passes the partials and a
// zeroed ticket per row, which the kernel leaves zeroed), returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;  // 16-byte vectors a thread loads per round

__device__ __forceinline__ float gw_exp(float v) { return expf(v); }
__device__ __forceinline__ double gw_exp(double v) { return exp(v); }
__device__ __forceinline__ float gw_log(float v) { return logf(v); }
__device__ __forceinline__ double gw_log(double v) { return log(v); }

// values of T in 16 bytes
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
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

// Add the values v[0..N) (-inf weighs 0) to st: one max, one rescale.
template <typename T, int N>
__device__ __forceinline__ void push_block(State<T>& st, const T* v) {
  T mx = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = v[i] > mx ? v[i] : mx;
  if (mx == -INFINITY) return;
  const T m = st.m > mx ? st.m : mx;
  const T r = gw_exp(st.m - m);  // 0 while the state is empty
  T s1 = st.s1 * r, s2 = st.s2 * r * r;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T e = gw_exp(v[i] - m);  // 0 for a -inf entry
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

template <typename T>
__device__ __forceinline__ void write_lse(const State<T>& st, T* lse1, T* lse2) {
  // an empty row: m = -inf and s = 0, so both outputs are -inf
  *lse1 = st.m + gw_log(st.s1);
  *lse2 = T(2) * st.m + gw_log(st.s2);
}

// One block: row blockIdx.x / tiles, the tile's vectors [t * tile_vecs,
// (t + 1) * tile_vecs) of the row's 16-byte-aligned body.
template <typename T>
__global__ void __launch_bounds__(kThreads) dlse_kernel(const T* __restrict__ x, T* __restrict__ lse1,
                                                        T* __restrict__ lse2, T* __restrict__ part,
                                                        unsigned int* __restrict__ tickets, long long n, int tiles,
                                                        long long tile_vecs) {
  constexpr int V = Vec16<T>::n;
  const long long row = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - row * tiles);
  const T* xr = x + row * n;
  // the row's elements before its first 16-byte boundary, its aligned body
  // of nv vectors, then fewer than V tail elements
  long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T);
  head = head < n ? head : n;
  const long long nv = (n - head) / V;
  const T* body = xr + head;

  State<T> st = empty_state<T>();
  const long long v0 = t * tile_vecs;
  const long long v1 = v0 + tile_vecs < nv ? v0 + tile_vecs : nv;
  for (long long base = v0; base < v1; base += kThreads * kVecs) {
    T v[kVecs * V];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const long long j = base + i * kThreads + threadIdx.x;
      if (j < v1) {
        load16(body + j * V, v + i * V);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) v[i * V + u] = -INFINITY;
      }
    }
    push_block<T, kVecs * V>(st, v);
  }
  if (t == 0) {  // the head and tail elements, one a thread
    const long long tail0 = head + nv * V;
    const long long j = threadIdx.x < head ? threadIdx.x : tail0 + (threadIdx.x - head);
    if (threadIdx.x < head || (j >= tail0 && j < n)) {
      const T v = xr[j];
      push_block<T, 1>(st, &v);
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
  if (warp != 0) return;
  st = lane < kWarps ? State<T>{sm[lane], ss1[lane], ss2[lane]} : empty_state<T>();
  st = warp_merge(st);
  if (tiles == 1) {
    if (lane == 0) write_lse(st, lse1 + row, lse2 + row);
    return;
  }
  T* pr = part + row * tiles * 3;
  unsigned int last = 0;
  if (lane == 0) {
    pr[3 * t] = st.m;
    pr[3 * t + 1] = st.s1;
    pr[3 * t + 2] = st.s2;
    __threadfence();
    last = atomicAdd(tickets + row, 1u) == static_cast<unsigned int>(tiles - 1);
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  // the last block of the row: its partials in a fixed order
  __threadfence();
  State<T> acc = empty_state<T>();
  for (int u = lane; u < tiles; u += 32)
    acc = merge(acc, State<T>{__ldcg(pr + 3 * u), __ldcg(pr + 3 * u + 1), __ldcg(pr + 3 * u + 2)});
  acc = warp_merge(acc);
  if (lane == 0) {
    write_lse(acc, lse1 + row, lse2 + row);
    tickets[row] = 0u;
  }
}

template <typename T>
int launch(const T* x, T* lse1, T* lse2, T* part, unsigned int* tickets, long long rows, long long n,
           long long tile, void* stream) {
  constexpr int V = Vec16<T>::n;
  if (rows <= 0) return 0;
  if (n < 0 || tile <= 0 || tile % (V * kThreads) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n > tile ? (n + tile - 1) / tile : 1;
  if (tiles > 1 && (part == nullptr || tickets == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dlse_kernel<T><<<static_cast<unsigned int>(rows * tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lse1, lse2, part, tickets, n, static_cast<int>(tiles), tile / V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int kernel_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, dlse_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, dlse_kernel<T>, kThreads, 0));
}

}  // namespace

extern "C" {

int gw_dlse_f32(const float* x, float* lse1, float* lse2, float* part, unsigned int* tickets, long long rows,
                long long n, long long tile, void* stream) {
  return launch<float>(x, lse1, lse2, part, tickets, rows, n, tile, stream);
}

int gw_dlse_f64(const double* x, double* lse1, double* lse2, double* part, unsigned int* tickets, long long rows,
                long long n, long long tile, void* stream) {
  return launch<double>(x, lse1, lse2, part, tickets, rows, n, tile, stream);
}

// registers and spill bytes a thread, and resident blocks per SM, of the
// float32 (f64 = 0) or float64 kernel on the current card
int gw_dlse_kernel_info(int f64, int* out) { return f64 ? kernel_info<double>(out) : kernel_info<float>(out); }

const char* gw_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
