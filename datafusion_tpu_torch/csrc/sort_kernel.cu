// Stable ascending argsort of int64 keys, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `sort_kernel.argsort_i64` / `argsort_multi`
// of the JAX package (datafusion_tpu/exec/pallas/sort_kernel.py: `_cmpx`,
// `_sort_kernel`, the pallas_call at line 89).  Computes the permutation
// p (int32) such that keys[p[0]] <= keys[p[1]] <= ..., ties in row order.
// Several keys compose as `argsort_multi` composes them: sort by the last
// key, then re-sort by each earlier key gathered through the running
// permutation; each sort is stable, so it keeps the later keys' order
// among its ties.  The host wrapper (exec/cuda/sort_kernel.py) drives
// that loop.
//
// Why not the TPU design.  The TPU kernel runs a whole bitonic network on
// one run held in VMEM; 2^18 (key, index) pairs are 3 MiB, far over an
// SM's 227 KB of shared memory, and a bitonic network is not stable.  An
// LSD radix sort is stable by construction and takes any n in global
// memory, so there is no run-size window.
//
// Design.  Keys are sorted as unsigned after flipping the sign bit (so
// int64 order is unsigned order), 4 bits per pass, least significant
// digit first.  Before any pass, `andor_kernel` takes the AND and the OR
// of every key; a digit where they agree is the same in every key, so its
// pass would not move anything and the wrapper skips it (a key of small
// values runs a few passes, a constant key none).  Each pass is three
// launches:
//
//   hist_kernel     one block per 4096-row tile counts the tile's digits
//                   (warp-aggregated shared atomics) into hist[d][tile];
//   scan_kernel     one block turns hist, digit-major and tile-minor, into
//                   an exclusive prefix sum: the first output slot of each
//                   (digit, tile);
//   scatter_kernel  each thread of a tile owns 16 consecutive rows and
//                   counts their digits into its own column of a
//                   [digit][thread] table in shared memory; an exclusive
//                   scan of that table, digit-major, gives each thread the
//                   slot of its first row of each digit; the thread then
//                   writes its rows in row order.  Rows of one digit thus
//                   land in (tile, thread, row) order: stable.
//
// The keys and the permutation ping-pong between two buffer pairs that
// the wrapper allocates; `init_kernel` gathers the keys through the
// running permutation (the multi-key step) and flips the sign bit.
//
// What bounds it: device memory.  A sorted key needs at least one read of
// the key (8 bytes) and one write of the permutation (4); each pass reads
// 12 bytes per row twice and writes 12, so a key of P passes moves about
// 36 * P bytes per row.  Making the passes fewer (wider digits with a
// shared-memory local sort) is left to a later change.  The kernels
// launch on the caller's stream, do not synchronize and allocate nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 rows per tile
constexpr int kRadix = 16;                // 4-bit digits
constexpr int kScanThreads = 1024;
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ULL;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

// out[0] &= AND of every sign-flipped key, out[1] |= their OR.
__global__ void __launch_bounds__(kThreads)
andor_kernel(const int64_t* __restrict__ keys, int64_t n,
             unsigned long long* __restrict__ out) {
  unsigned long long a = ~0ULL, o = 0ULL;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long u = static_cast<unsigned long long>(keys[i]) ^ kSign;
    a &= u;
    o |= u;
  }
  for (int d = 16; d > 0; d >>= 1) {
    a &= __shfl_down_sync(kFull, a, d);
    o |= __shfl_down_sync(kFull, o, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(out, a);
    atomicOr(out + 1, o);
  }
}

// ukeys[i] = keys[perm[i]] ^ sign, idx[i] = perm[i] (perm == nullptr:
// the identity).
__global__ void __launch_bounds__(kThreads)
init_kernel(const int64_t* __restrict__ keys, const int32_t* perm, int64_t n,
            unsigned long long* __restrict__ ukeys, int32_t* idx) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int32_t src = perm != nullptr ? perm[i] : static_cast<int32_t>(i);
    ukeys[i] = static_cast<unsigned long long>(keys[src]) ^ kSign;
    idx[i] = src;
  }
}

__device__ __forceinline__ int digit_of(unsigned long long k, int shift) {
  return static_cast<int>((k >> shift) & (kRadix - 1));
}

// hist[d * num_tiles + tile] = rows of the tile whose digit is d.
__global__ void __launch_bounds__(kThreads)
hist_kernel(const unsigned long long* __restrict__ ukeys, int64_t n, int shift,
            int32_t num_tiles, int32_t* __restrict__ hist) {
  __shared__ int32_t cnt[kRadix];
  if (threadIdx.x < kRadix) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {  // whole warps iterate
    const int64_t i = base + j;
    const int d = i < n ? digit_of(ukeys[i], shift) : -1;
    const unsigned same = __match_any_sync(kFull, d);
    if (d >= 0 && lane == __ffs(same) - 1) atomicAdd(&cnt[d], __popc(same));
  }
  __syncthreads();
  if (threadIdx.x < kRadix) {
    hist[static_cast<int64_t>(threadIdx.x) * num_tiles + blockIdx.x] = cnt[threadIdx.x];
  }
}

// Exclusive prefix sum of x over the threads of a block (kThreads or
// kScanThreads wide); `sums` holds one int per warp.
template <int kBlock>
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kBlock / 32 ? sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kBlock / 32) sums[lane] = w;
  }
  __syncthreads();
  return inc - x + (warp > 0 ? sums[warp - 1] : 0);
}

// In-place exclusive prefix sum of data[0, size), one block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ data, int32_t size) {
  __shared__ int32_t sums[kScanThreads / 32];
  const int32_t per = (size + kScanThreads - 1) / kScanThreads;
  const int32_t lo = min(size, static_cast<int32_t>(threadIdx.x) * per);
  const int32_t hi = min(size, lo + per);
  int32_t s = 0;
  for (int32_t i = lo; i < hi; ++i) s += data[i];
  int32_t prefix = block_exclusive_scan<kScanThreads>(s, sums);
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t v = data[i];
    data[i] = prefix;
    prefix += v;
  }
}

// One stable scatter pass; offsets is the scanned hist.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const unsigned long long* __restrict__ keys_in,
               const int32_t* __restrict__ idx_in, int64_t n, int shift,
               int32_t num_tiles, const int32_t* __restrict__ offsets,
               unsigned long long* __restrict__ keys_out,
               int32_t* __restrict__ idx_out) {
  __shared__ int32_t cnt[kRadix * kThreads];  // [digit][thread]
  __shared__ int32_t sums[kThreads / 32];
  __shared__ int32_t start[kRadix];
  const int t = threadIdx.x;
  for (int d = 0; d < kRadix; ++d) cnt[d * kThreads + t] = 0;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + static_cast<int64_t>(t) * kItems;
  unsigned long long k[kItems];
  int32_t v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i < n) {
      k[j] = keys_in[i];
      v[j] = idx_in[i];
      cnt[digit_of(k[j], shift) * kThreads + t] += 1;  // own column only
    }
  }
  __syncthreads();

  // exclusive scan of the table read digit-major: thread t scans the 16
  // consecutive entries [16 t, 16 t + 16) (all of one digit)
  int32_t* mine = cnt + t * kItems;
  int32_t s = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) s += mine[q];
  int32_t prefix = block_exclusive_scan<kThreads>(s, sums);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int32_t c = mine[q];
    mine[q] = prefix;
    prefix += c;
  }
  __syncthreads();
  if (t < kRadix) start[t] = cnt[t * kThreads];
  __syncthreads();
  // cnt[d][t] := output slot of thread t's first row of digit d
#pragma unroll
  for (int d = 0; d < kRadix; ++d) {
    cnt[d * kThreads + t] += offsets[static_cast<int64_t>(d) * num_tiles + blockIdx.x] - start[d];
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j < n) {
      const int32_t dst = cnt[digit_of(k[j], shift) * kThreads + t]++;
      keys_out[dst] = k[j];
      idx_out[dst] = v[j];
    }
  }
}

}  // namespace

// out holds two uint64, initialised to all ones and to zero; afterwards
// out[0] is the AND and out[1] the OR of the sign-flipped keys.  Returns
// cudaGetLastError() after the launch.
extern "C" int df_radix_andor(const void* keys, long long n, void* out,
                              void* stream) {
  if (n > 0) {
    andor_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), n, static_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Stable sort of keys[perm[i]] (perm null: keys[i]): runs the passes whose
// bit is set in digit_mask (bit d: bits [4d, 4d + 4)), ping-ponging between
// (keys_a, idx_a) and (keys_b, idx_b).  The sorted permutation ends in
// idx_a when the number of passes run is even, else in idx_b.  keys_* hold
// n uint64, idx_* n int32, hist 16 * ceil(n / 4096) int32; perm may alias
// idx_a or idx_b.  n < 2^31.  Returns cudaGetLastError() after the
// launches.
extern "C" int df_radix_sort_key(const void* keys, const void* perm, long long n,
                                 int digit_mask, void* keys_a, void* idx_a,
                                 void* keys_b, void* idx_b, void* hist,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  init_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(perm), n,
      static_cast<unsigned long long*>(keys_a), static_cast<int32_t*>(idx_a));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int32_t num_tiles = static_cast<int32_t>((n + kTile - 1) / kTile);
  unsigned long long* kin = static_cast<unsigned long long*>(keys_a);
  unsigned long long* kout = static_cast<unsigned long long*>(keys_b);
  int32_t* iin = static_cast<int32_t*>(idx_a);
  int32_t* iout = static_cast<int32_t*>(idx_b);
  int32_t* h = static_cast<int32_t*>(hist);
  for (int d = 0; d < 64 / 4; ++d) {
    if (!((digit_mask >> d) & 1)) continue;
    const int shift = 4 * d;
    hist_kernel<<<num_tiles, kThreads, 0, s>>>(kin, n, shift, num_tiles, h);
    scan_kernel<<<1, kScanThreads, 0, s>>>(h, kRadix * num_tiles);
    scatter_kernel<<<num_tiles, kThreads, 0, s>>>(kin, iin, n, shift, num_tiles, h,
                                                  kout, iout);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    unsigned long long* kt = kin;
    kin = kout;
    kout = kt;
    int32_t* it = iin;
    iin = iout;
    iout = it;
  }
  return 0;
}
