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
// Design: an 8-bit least-significant-digit radix sort after the onesweep
// scheme (Adinets and Merrill, "Onesweep: A Faster Least Significant
// Digit Radix Sort for GPUs", 2022).  Keys are sorted as unsigned after
// flipping the sign bit (so int64 order is unsigned order).
//
//   hist_kernel  one launch per call reads every key once and counts all
//                8 digits of every key (256 buckets each) with shared-
//                memory atomics per block, added to global memory once
//                per block.  Lanes that hit one bucket serialize, but
//                aggregating them first with a __match_any_sync per digit
//                was tried and cost more.  A histogram does not depend on
//                row order, so every pass's digit counts come from this
//                one read.  The wrapper copies each digit's largest count
//                to the host and skips each digit whose one bucket holds
//                all n rows.
//   pass_kernel  one launch per pass.  A block takes a tile of kTile rows
//                by an atomic ticket (so it only ever waits on tiles whose
//                blocks already run), ranks its rows by digit in shared
//                memory (per warp with __match_any_sync, then the per-warp
//                counts scanned in warp order: rows of a digit keep their
//                (warp, item, lane) = row order), publishes its per-digit
//                counts into a status array, gets its global offsets by
//                decoupled look-back over the tiles before it, stages keys
//                and indices in digit order in shared memory and writes
//                each digit's run out contiguously.
//
// The first pass of a key reads keys[perm[i]] ^ sign itself (the
// multi-key gather); the last pass of a key writes only the permutation,
// since the next key gathers its own keys.  A status word is 64 bits, a
// 2-bit flag (aggregate or inclusive prefix) over a 62-bit count, stored
// and loaded whole, so n up to 2^31 - 1 fits and no read is torn.
//
// What bounds it: device memory.  A sorted key needs at least one read of
// the key (8 bytes) and one write of the permutation (4).  The histogram
// reads 8 bytes a row per key, and a pass reads and writes 12 bytes a row
// (4 when it writes only the permutation, plus the key gather on a key's
// first pass).  The kernels launch on the caller's stream, do not
// synchronize and allocate nothing; the entry points zero the histogram,
// the status array and the ticket with memsets on that stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;                 // rows per thread in a pass
constexpr int kWarpRows = 32 * kItems;     // 480
constexpr int kTile = kThreads * kItems;   // 3840 rows per tile
constexpr int kRadix = 256;                // 8-bit digits
constexpr int kDigits = 8;                 // digits of a 64-bit key
constexpr int kHistItems = 16;             // rows per thread per histogram block
constexpr int kHistMaxBlocks = 132 * 4;
constexpr int kMaxKeysPerLaunch = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ULL;
constexpr unsigned long long kFlagAggregate = 1ULL << 62;
constexpr unsigned long long kFlagInclusive = 2ULL << 62;
constexpr unsigned long long kValueMask = kFlagAggregate - 1;
// dynamic shared memory of a pass: staged keys, staged indices and the
// per-warp digit counts
constexpr int kPassSmem = kTile * (8 + 4) + kWarps * kRadix * 4;  // 54,272 B

static_assert(kThreads == kRadix, "one thread per digit in the pass's scans");

struct KeyPtrs {
  const int64_t* p[kMaxKeysPerLaunch];
};

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// hist[key][b][d] += rows whose sign-flipped key has byte b equal to d;
// blockIdx.y picks the key.
__global__ void __launch_bounds__(kThreads)
hist_kernel(KeyPtrs keys, int64_t n, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kDigits * kRadix];
  for (int e = threadIdx.x; e < kDigits * kRadix; e += kThreads) h[e] = 0;
  __syncthreads();
  const int64_t* k = keys.p[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long u = static_cast<unsigned long long>(k[i]) ^ kSign;
#pragma unroll
    for (int b = 0; b < kDigits; ++b) {
      atomicAdd(&h[b * kRadix + static_cast<int>((u >> (8 * b)) & 0xFF)], 1);
    }
  }
  __syncthreads();
  int32_t* out = hist + static_cast<int64_t>(blockIdx.y) * kDigits * kRadix;
  for (int e = threadIdx.x; e < kDigits * kRadix; e += kThreads) {
    if (h[e] != 0) atomicAdd(out + e, h[e]);
  }
}

// Exclusive prefix sum of x over the kThreads threads of a block; `sums`
// holds one int per warp and is not reused by another call before a
// __syncthreads.
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
    int32_t w = lane < kWarps ? sums[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) sums[lane] = w;
  }
  __syncthreads();
  return inc - x + (warp > 0 ? sums[warp - 1] : 0);
}

// One stable pass over the digit at `shift`.  First pass of a key:
// raw_keys is the key (rows gathered through idx_in, or the identity when
// idx_in is null) and keys_in is unused; later passes read keys_in and
// idx_in.  keys_out null: write only the permutation.  digit_hist holds
// the 256 counts of this digit over all n rows; status holds
// ceil(n / kTile) * 256 zeroed words and ticket one zeroed word.
__global__ void __launch_bounds__(kThreads)
pass_kernel(const int64_t* __restrict__ raw_keys,
            const unsigned long long* __restrict__ keys_in,
            const int32_t* __restrict__ idx_in, int64_t n, int shift,
            const int32_t* __restrict__ digit_hist,
            unsigned long long* __restrict__ status,
            unsigned int* __restrict__ ticket,
            unsigned long long* __restrict__ keys_out,
            int32_t* __restrict__ idx_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_keys + kTile);
  int32_t* s_warp = s_idx + kTile;  // [warp][digit] counts, then offsets
  __shared__ long long s_fix[kRadix];  // global slot of staged row p: s_fix[d] + p
  __shared__ int32_t s_start[kRadix];  // first staged slot of each digit
  __shared__ int32_t s_sums_a[kWarps];
  __shared__ int32_t s_sums_b[kWarps];
  __shared__ unsigned int s_tile;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(ticket, 1u);
  for (int e = t; e < kWarps * kRadix; e += kThreads) s_warp[e] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile + warp * kWarpRows;

  // load: warp-contiguous rows, item j of lane l is row base + 32 j + l
  unsigned long long key[kItems];
  int32_t idx[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + 32 * j + lane;
    key[j] = 0;
    idx[j] = 0;
    if (i < n) {
      if (raw_keys != nullptr) {
        const int32_t src = idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
        idx[j] = src;
        key[j] = static_cast<unsigned long long>(raw_keys[src]) ^ kSign;
      } else {
        key[j] = keys_in[i];
        idx[j] = idx_in[i];
      }
    }
  }

  // rank within the warp: rows of one digit in (item, lane) order
  const unsigned lower = (1u << lane) - 1u;
  int32_t* wc = s_warp + warp * kRadix;
  int32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = base + 32 * j + lane < n;
    const int d = valid ? static_cast<int>((key[j] >> shift) & 0xFF) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const int32_t before = valid ? wc[d] : 0;
    __syncwarp();
    if (valid && (peers & lower) == 0) wc[d] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lower);
  }
  __syncthreads();

  // thread t owns digit t: per-warp counts to offsets in warp order
  const int dg = t;
  int32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = s_warp[w * kRadix + dg];
    s_warp[w * kRadix + dg] = count;
    count += c;
  }
  // publish this tile's count, then look back for the tiles before it
  unsigned long long* mine = status + tile * kRadix + dg;
  long long prefix = 0;
  if (tile == 0) {
    store_relaxed(mine, kFlagInclusive | static_cast<unsigned long long>(count));
  } else {
    store_relaxed(mine, kFlagAggregate | static_cast<unsigned long long>(count));
    int64_t p = tile - 1;
    while (true) {
      const unsigned long long w = load_relaxed(status + p * kRadix + dg);
      if (w == 0) continue;  // tile p has not published yet; it runs
      prefix += static_cast<long long>(w & kValueMask);
      if (w & kFlagInclusive) break;
      --p;
    }
    store_relaxed(mine, kFlagInclusive | static_cast<unsigned long long>(prefix + count));
  }
  const int32_t global_start = block_exclusive_scan(digit_hist[dg], s_sums_a);
  const int32_t start = block_exclusive_scan(count, s_sums_b);
  s_start[dg] = start;
  s_fix[dg] = static_cast<long long>(global_start) + prefix - start;
  __syncthreads();

  // stage in digit order
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + 32 * j + lane < n) {
      const int d = static_cast<int>((key[j] >> shift) & 0xFF);
      const int32_t slot = s_start[d] + wc[d] + rank[j];
      s_keys[slot] = key[j];
      s_idx[slot] = idx[j];
    }
  }
  __syncthreads();

  // write each digit's run contiguously
  const int64_t left = n - tile * kTile;
  const int tile_rows = left < kTile ? static_cast<int>(left) : kTile;
  for (int p = t; p < tile_rows; p += kThreads) {
    const unsigned long long k = s_keys[p];
    const long long g = s_fix[static_cast<int>((k >> shift) & 0xFF)] + p;
    if (keys_out != nullptr) keys_out[g] = k;
    idx_out[g] = s_idx[p];
  }
}

}  // namespace

// hist holds nkeys * 8 * 256 int32; the call zeroes it and counts every
// digit of every key into it (hist[key][b][d]).  keys is a host array of
// nkeys device pointers, each to n int64.  Returns the first CUDA error of
// the memset and the launches, or 0.
extern "C" int df_radix_histograms(const void* const* keys, int nkeys, long long n,
                                   void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* h = static_cast<int32_t*>(hist);
  cudaError_t rc = cudaMemsetAsync(
      h, 0, static_cast<size_t>(nkeys) * kDigits * kRadix * sizeof(int32_t), s);
  if (rc != cudaSuccess || n <= 0) return static_cast<int>(rc);
  long long blocks = (n + kThreads * kHistItems - 1) / (kThreads * kHistItems);
  if (blocks > kHistMaxBlocks) blocks = kHistMaxBlocks;
  for (int first = 0; first < nkeys; first += kMaxKeysPerLaunch) {
    const int count = nkeys - first < kMaxKeysPerLaunch ? nkeys - first : kMaxKeysPerLaunch;
    KeyPtrs ptrs = {};
    for (int i = 0; i < count; ++i) ptrs.p[i] = static_cast<const int64_t*>(keys[first + i]);
    hist_kernel<<<dim3(static_cast<unsigned>(blocks), count), kThreads, 0, s>>>(
        ptrs, n, h + static_cast<int64_t>(first) * kDigits * kRadix);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// Stable sort of keys[perm[i]] (perm null: keys[i]): runs the passes whose
// bit is set in digit_mask (bit b: bits [8b, 8b + 8)), the first gathering
// through perm, the last writing only the permutation.  hist holds this
// key's 8 * 256 digit counts (from df_radix_histograms).  keys_a and
// keys_b hold n uint64, idx_a and idx_b n int32; perm may alias idx_a or
// idx_b (the first pass then writes the other).  status holds
// ceil(n / 3840) * 256 + 1 uint64 (the look-back words, then the ticket),
// zeroed here before each pass.  *result_in_b is set to 1 when the
// sorted permutation ends in idx_b, 0 when in idx_a.  0 < n < 2^31 and
// digit_mask != 0.  Returns the first CUDA error, or 0.
extern "C" int df_radix_sort_key(const void* keys, const void* perm, long long n,
                                 int digit_mask, const void* hist, void* keys_a,
                                 void* keys_b, void* idx_a, void* idx_b,
                                 void* status, int* result_in_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // above 48 KB of dynamic shared memory a kernel must opt in, per device
  cudaError_t rc = cudaFuncSetAttribute(
      pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPassSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* st = static_cast<unsigned long long*>(status);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(st + tiles * kRadix);
  const size_t status_bytes = static_cast<size_t>(tiles * kRadix + 1) * sizeof(unsigned long long);
  unsigned long long* ka = static_cast<unsigned long long*>(keys_a);
  unsigned long long* kb = static_cast<unsigned long long*>(keys_b);
  int32_t* ia = static_cast<int32_t*>(idx_a);
  int32_t* ib = static_cast<int32_t*>(idx_b);
  const int32_t* iin = static_cast<const int32_t*>(perm);
  const unsigned long long* kin = nullptr;
  unsigned long long* kout = ka;
  int32_t* iout = iin == ia ? ib : ia;
  int left = __builtin_popcount(static_cast<unsigned>(digit_mask) & 0xFFu);
  bool first = true;
  for (int b = 0; b < kDigits; ++b) {
    if (!((digit_mask >> b) & 1)) continue;
    --left;
    rc = cudaMemsetAsync(st, 0, status_bytes, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pass_kernel<<<static_cast<unsigned>(tiles), kThreads, kPassSmem, s>>>(
        first ? static_cast<const int64_t*>(keys) : nullptr, kin, iin, n, 8 * b,
        static_cast<const int32_t*>(hist) + b * kRadix, st, ticket,
        left > 0 ? kout : nullptr, iout);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    first = false;
    iin = iout;
    kin = kout;
    iout = iin == ia ? ib : ia;
    kout = kin == ka ? kb : ka;
  }
  *result_in_b = iin == ib ? 1 : 0;
  return 0;
}
