// Grouped reduce by dense group id, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `hash_agg.grouped_reduce` of the JAX package
// (datafusion_tpu/exec/pallas/hash_agg.py: `_kernel`, `_build_call`, the
// pallas_call at line 95).  Computes, for g in [0, G):
//
//     out[g] = reduce(vals[r] for r in row order if live[r] and ids[r] == g)
//
// with reduce one of sum, min, max.  Rows that are dead or whose id lies
// outside [0, G) contribute nothing; an empty group keeps the identity
// (0, +inf / -inf, or the integer type's max / min).  Integer sums wrap
// as numpy's do; min and max propagate NaN as jnp.minimum / jnp.maximum
// do (CUDA's fmin / fmax drop NaN, so they are not used).
//
// What bounds it: device memory.  A call reads N * (4 + sizeof(T) + 1)
// bytes (ids, vals, live) and writes G * sizeof(T); it does one compare
// and one combine per row.  At the main path's shapes (N = 131072 rows,
// G = 8 groups, f64) that is 1.7 MB, about half a microsecond at
// 3.35 TB/s, so one call is dominated by its launch.
//
// Design.  The TPU kernel sweeps one-hot group tiles and revisits an
// output tile across a sequential grid axis; Hopper runs blocks in
// parallel and in no order, so that does not carry over.  Instead:
//
//   Pass 1, grid (row chunk, group tile).  Each of a block's 8 warps
//   scans its slice of the chunk 32 rows at a time (coalesced loads of
//   ids and live; vals only for rows that hit the tile).  The rows that
//   hit the tile are broadcast one by one, in row order, with warp
//   shuffles, and the lane that owns the group (g mod 32) folds the value
//   into the warp's partial row in shared memory.  The block then combines
//   its 8 warp partials in warp order and writes one partial per
//   (chunk, group) to a scratch buffer the caller allocates.
//   Pass 2, one warp per group.  Lane l folds chunks l, l + 32, ... in
//   order, then the warp folds the 32 lane values with a fixed shuffle
//   tree.
//
// Every combine happens in an order fixed by (N, G) alone and there are
// no atomics, so f64 results are bit-identical from run to run.  The work
// per row does not grow with G inside a tile, and the tile count
// (G / 512) bounds the re-reads of a chunk.  The kernel launches on the
// caller's stream, does not synchronize and allocates nothing.  Fusing
// all slots of a batch into one launch is left to a later change.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Lim;
template <> struct Lim<int8_t> {
  static __device__ __forceinline__ int8_t hi() { return 127; }
  static __device__ __forceinline__ int8_t lo() { return -128; }
};
template <> struct Lim<int16_t> {
  static __device__ __forceinline__ int16_t hi() { return 32767; }
  static __device__ __forceinline__ int16_t lo() { return -32768; }
};
template <> struct Lim<int32_t> {
  static __device__ __forceinline__ int32_t hi() { return 2147483647; }
  static __device__ __forceinline__ int32_t lo() { return -2147483647 - 1; }
};
template <> struct Lim<int64_t> {
  static __device__ __forceinline__ int64_t hi() { return 9223372036854775807LL; }
  static __device__ __forceinline__ int64_t lo() { return -9223372036854775807LL - 1; }
};
template <> struct Lim<float> {
  static __device__ __forceinline__ float hi() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float lo() { return __int_as_float(0xff800000); }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double hi() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double lo() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
  }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <int K, typename T>
__device__ __forceinline__ T identity() {
  if (K == kSum) return T(0);
  return K == kMin ? Lim<T>::hi() : Lim<T>::lo();
}

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  if constexpr (std::is_floating_point<T>::value) {
    return x != x;
  } else {
    return false;
  }
}

// Integer sums wrap: add in the unsigned type of the same width.
template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a + b;
  } else if constexpr (sizeof(T) == 1) {
    return static_cast<T>(static_cast<uint8_t>(static_cast<uint8_t>(a) + static_cast<uint8_t>(b)));
  } else if constexpr (sizeof(T) == 2) {
    return static_cast<T>(static_cast<uint16_t>(static_cast<uint16_t>(a) + static_cast<uint16_t>(b)));
  } else if constexpr (sizeof(T) == 4) {
    return static_cast<T>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  } else {
    return static_cast<T>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
  }
}

template <int K, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (K == kSum) {
    return add(a, b);
  } else {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if constexpr (K == kMin) {
      return b < a ? b : a;
    } else {
      return b > a ? b : a;
    }
  }
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  if constexpr (sizeof(T) < 4) {
    return static_cast<T>(__shfl_sync(kFull, static_cast<int>(v), src));
  } else {
    return __shfl_sync(kFull, v, src);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int delta) {
  if constexpr (sizeof(T) < 4) {
    return static_cast<T>(__shfl_down_sync(kFull, static_cast<int>(v), delta));
  } else {
    return __shfl_down_sync(kFull, v, delta);
  }
}

// Pass 1: one partial per (row chunk, group) into scratch[chunk][g].
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const int32_t* __restrict__ ids, const T* __restrict__ vals,
               const uint8_t* __restrict__ live, int64_t n, int32_t num_groups,
               int64_t chunk_rows, int32_t tile_g, T* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // [kWarps][tile_g]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = blockIdx.x;
  const int32_t g0 = static_cast<int32_t>(blockIdx.y) * tile_g;
  const int32_t g_end = min(num_groups, g0 + tile_g);
  const T ident = identity<K, T>();

  for (int i = threadIdx.x; i < kWarps * tile_g; i += kThreads) part[i] = ident;
  __syncthreads();

  // chunk_rows is a multiple of kThreads, so each warp's slice is a
  // whole number of 32-row steps
  const int64_t per_warp = chunk_rows / kWarps;
  const int64_t r0 = chunk * chunk_rows + warp * per_warp;
  const int64_t r1 = min64(n, r0 + per_warp);
  T* mine = part + warp * tile_g;
  for (int64_t base = r0; base < r1; base += 32) {
    const int64_t r = base + lane;
    int32_t gl = -1;
    T v = ident;
    if (r < r1 && live[r]) {
      const int32_t id = ids[r];
      if (id >= g0 && id < g_end) {
        gl = id - g0;
        v = vals[r];
      }
    }
    unsigned pending = __ballot_sync(kFull, gl >= 0);
    while (pending) {  // rows of this step in row order
      const int j = __ffs(pending) - 1;
      pending &= pending - 1;
      const int32_t gj = __shfl_sync(kFull, gl, j);
      const T vj = shfl(v, j);
      if ((gj & 31) == lane) mine[gj] = combine<K>(mine[gj], vj);
    }
  }
  __syncthreads();

  for (int gl = threadIdx.x; g0 + gl < g_end; gl += kThreads) {
    T acc = part[gl];
    for (int w = 1; w < kWarps; ++w) acc = combine<K>(acc, part[w * tile_g + gl]);
    scratch[chunk * num_groups + g0 + gl] = acc;
  }
}

// Pass 2: out[g] = fold of scratch[0..num_chunks)[g], one warp per group.
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ scratch, int32_t num_chunks,
               int32_t num_groups, T* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t g = static_cast<int32_t>(blockIdx.x) * kWarps + warp;
  if (g >= num_groups) return;  // whole warp leaves together
  T acc = identity<K, T>();
  for (int32_t c = lane; c < num_chunks; c += 32) {
    acc = combine<K>(acc, scratch[static_cast<int64_t>(c) * num_groups + g]);
  }
  for (int delta = 16; delta > 0; delta >>= 1) {
    acc = combine<K>(acc, shfl_down(acc, delta));
  }
  if (lane == 0) out[g] = acc;
}

template <int K, typename T>
void launch(const void* ids, const void* vals, const void* live, int64_t n,
            int32_t num_groups, int32_t num_chunks, int64_t chunk_rows,
            int32_t tile_g, void* scratch, void* out, cudaStream_t stream) {
  const int32_t tiles = (num_groups + tile_g - 1) / tile_g;
  const size_t smem = static_cast<size_t>(kWarps) * tile_g * sizeof(T);
  partial_kernel<K, T><<<dim3(num_chunks, tiles), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const T*>(vals),
      static_cast<const uint8_t*>(live), n, num_groups, chunk_rows, tile_g,
      static_cast<T*>(scratch));
  combine_kernel<K, T><<<(num_groups + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(scratch), num_chunks, num_groups, static_cast<T*>(out));
}

template <typename T>
int launch_kind(int kind, const void* ids, const void* vals, const void* live,
                int64_t n, int32_t num_groups, int32_t num_chunks,
                int64_t chunk_rows, int32_t tile_g, void* scratch, void* out,
                cudaStream_t stream) {
  switch (kind) {
    case kSum:
      launch<kSum, T>(ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, stream);
      return 0;
    case kMin:
      launch<kMin, T>(ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, stream);
      return 0;
    case kMax:
      launch<kMax, T>(ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, stream);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 int8, 1 int16, 2 int32, 3 int64, 4 float32, 5 float64.
// kind: 0 sum, 1 min, 2 max.  scratch holds num_chunks * num_groups
// values of the dtype; chunk_rows is a multiple of 256 and
// num_chunks * chunk_rows >= n.  Returns cudaGetLastError() after the
// launches, or -1 for a dtype or kind it does not know.
extern "C" int df_grouped_reduce(int dtype, int kind, const void* ids,
                                 const void* vals, const void* live,
                                 long long n, int num_groups, int num_chunks,
                                 long long chunk_rows, int tile_g,
                                 void* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch_kind<int8_t>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    case 1: rc = launch_kind<int16_t>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    case 2: rc = launch_kind<int32_t>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    case 3: rc = launch_kind<int64_t>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    case 4: rc = launch_kind<float>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    case 5: rc = launch_kind<double>(kind, ids, vals, live, n, num_groups, num_chunks, chunk_rows, tile_g, scratch, out, s); break;
    default: rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
