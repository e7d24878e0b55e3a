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
// and one combine per row.  At N = 524288 rows, G = 4096 groups, f64 that
// is 6.8 MB, 2 us at 3.35 TB/s.
//
// Design.  The TPU kernel sweeps one-hot group tiles and revisits an
// output tile across a sequential grid axis; Hopper runs blocks in
// parallel and in no order, so that does not carry over.  Instead one
// cooperative launch of two phases, one block of 8 warps per SM:
//
//   Partials.  Block b owns a contiguous chunk of rows, one slice per
//   owning warp.  Each owning warp keeps its own partial of the group
//   tile in shared memory, up to the 227 KB opt-in, so every G up to
//   8192 at 8-byte types is one tile and every row is read once.  A warp
//   loads kItems 32-row steps (ids, live and vals) before it folds any,
//   so that many loads are in flight per thread.  Dead and out-of-tile
//   rows take the group -1 and are skipped.
//   - A small G (32 * G values per warp fit for all 8 warps): every lane
//     keeps its own partial and folds its rows into it in step order, so
//     no lane waits on another.
//   - Otherwise a step whose lanes hit distinct groups (found through a
//     tag byte per group) commits every lane at once; a step with a
//     shared group groups its lanes with __match_any_sync, reduces each
//     peer set in a balanced tree over its members' ranks in lane order,
//     and commits one value per set.
//   The block combines its partials in a fixed order (lanes in a shuffle
//   tree after warps in warp order, or warps in warp order) and writes
//   one partial per (block, group) after `out` in the caller's buffer.
//   A G beyond one tile loops over tiles, reading the rows once per tile.
//   Fold, after a grid barrier.  Each group gets fold_lanes threads (a
//   power of two up to 32): thread s folds chunks s, s + fold_lanes, ...
//   in chunk order (neighbouring threads read neighbouring groups), then
//   a fixed shuffle tree folds the fold_lanes values.
//
// One launch with a grid barrier took no longer on the H100 than the
// same two phases as two ordinary launches, on the device or per call,
// at every shape measured (PERF.md).
//
// The query axis: one launch serves Q queries that share the rows' ids,
// each with its own live mask and either shared or its own values (a
// solo call is Q = 1).  Bound: the ids once, the values once when shared
// (else each query's), each query's live mask, and Q * G outputs; at
// Q = 8, G = 8, N = 6,029,312 shared f64 values that is 120.6 MB.
// Every query keeps the geometry of its solo launch (blocks, chunk_rows,
// warps and their row slices, the route, the fold), and the queries run
// in query tiles: as many as keep their partials side by side in a
// block's shared memory at that geometry (hash_agg.query_tiles; one
// query's lane partials at G = 8 f64 are 16 KB, so 14 fit).  A tile is
// one sweep of the rows inside the one launch: a warp loads a batch's
// ids, and shared values, once, then folds it into each query of the
// tile with that query's live bytes (and its own values), so the ids
// and shared values are read once per tile, ceil(Q / tile) times a
// call, and each live mask once.  A mask loads as four words a lane
// (load_live), so the masks of 8 queries are in flight together, and
// the lane partials of those 8 fold step by step together, their
// shared-memory read-add-write chains overlapping.  Q = 8 at G = 8 is
// one sweep; a G whose partials fill shared memory alone (G >= 64 f64
// with lane partials, G = 4096 f64 with tags) is a tile of one, a sweep
// per query.  Each query's rows reach its partials in the order of its
// solo launch, one grid barrier follows the last tile, and the fold
// runs once per query, so each query's result is bit-identical to its
// own solo call.
//
// Every float combine happens in an order fixed by the launch geometry
// (hash_agg.geometry: N, G, the type's size and the card's SM count and
// shared memory) and the data, and there are no float atomics, so f64
// results are bit-identical from run to run.  The kernel launches on the
// caller's stream, does not synchronize and allocates nothing.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kItems = 16;  // 32-row steps a warp loads before it folds any
constexpr int kQueryBlock = 8;  // live masks (shared values) a warp loads and folds at once
constexpr int kUnroll = 16;  // scratch loads in flight per fold thread
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

// With DF_AGG_PHASE_CLOCKS (a measurement build, never the port's), the
// first thread of each block records the global timer (ns) as it enters
// the partials (0), has cleared them (1), has folded its rows (2) and
// combined them (3) in the last query tile and group tile, starts the
// fold (4: past the grid barrier) and has folded its groups (5).
constexpr int kClockBlocks = 1024;
#ifdef DF_AGG_PHASE_CLOCKS
__device__ long long g_phase_clocks[kClockBlocks][6];
#endif

__device__ __forceinline__ void phase_clock(int phase) {
#ifdef DF_AGG_PHASE_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phase_clocks[blockIdx.x][phase] = t;
  }
#endif
}

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

// a is the earlier value in the combine order, b the later one.
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

// Shuffles have no 8- or 16-bit form: widen to int.
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  if constexpr (sizeof(T) < 4) {
    return static_cast<T>(__shfl_sync(kFull, static_cast<int>(v), src));
  } else {
    return __shfl_sync(kFull, v, src);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int delta, int width) {
  if constexpr (sizeof(T) < 4) {
    return static_cast<T>(__shfl_down_sync(kFull, static_cast<int>(v), delta, width));
  } else {
    return __shfl_down_sync(kFull, v, delta, width);
  }
}

// The partials are written and read in one launch: read them at L2
// (ld.global.cg), never through a line another SM's write left stale.
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  T v;
  if constexpr (sizeof(T) == 8) {
    const long long b = __ldcg(reinterpret_cast<const long long*>(p));
    memcpy(&v, &b, 8);
  } else if constexpr (sizeof(T) == 4) {
    const int b = __ldcg(reinterpret_cast<const int*>(p));
    memcpy(&v, &b, 4);
  } else if constexpr (sizeof(T) == 2) {
    const short b = __ldcg(reinterpret_cast<const short*>(p));
    memcpy(&v, &b, 2);
  } else {
    const signed char b = __ldcg(reinterpret_cast<const signed char*>(p));
    memcpy(&v, &b, 1);
  }
  return v;
}

// Values of kItems 32-row steps from row `base` (item j of lane l is
// row base + 32 j + l; ident past r1).  Values are read for every row in
// range, so no load waits on liveness.
template <typename T>
__device__ __forceinline__ void load_vals(const T* __restrict__ vals, int64_t base, int64_t r1,
                                          int lane, T ident, T (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + 32 * j + lane;
    v[j] = r < r1 ? vals[r] : ident;
  }
}

// The ids of the same rows, -1 past r1: read once for every query of a
// query tile.  in_tile turns them into groups of the tile once every
// load of the batch is in flight.
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ ids, int64_t base,
                                         int64_t r1, int lane, int32_t (&rel)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + 32 * j + lane;
    rel[j] = r < r1 ? ids[r] : -1;
  }
}

// rel[j] = the row's group in the tile [g0, g0 + tg), or -1.
__device__ __forceinline__ void in_tile(int32_t g0, int32_t tg, int32_t (&rel)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    rel[j] = rel[j] >= g0 && rel[j] - g0 < tg ? rel[j] - g0 : -1;
  }
}

// One query's live bytes of the same kItems steps, 16 bytes a lane in
// four words: word k of lane l holds rows base + 128 k + 4 l .. + 3, so
// the byte of row base + 32 j + l is byte l & 3 of word j >> 2 of lane
// 8 (j & 3) + (l >> 2) (live_bit).  Four coalesced loads and four
// registers a query instead of kItems of each, so a query block's masks
// are all in flight at once.  The words may hold rows past the warp's
// r1 (other warps' rows, which no fold takes: their rel is -1), so a
// warp's last, partial batch loads whole words too; only bytes past the
// mask's n read as 0.  A mask that is not 4-byte aligned (N not a
// multiple of 4), or the batch that reaches n, is read byte by byte,
// every byte load issued before any is used.
__device__ __forceinline__ void load_live(const uint8_t* __restrict__ live, int64_t base,
                                          int64_t n, int lane, uint32_t (&w)[4]) {
  if ((reinterpret_cast<uintptr_t>(live) & 3) == 0 && base + 32 * kItems <= n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = *reinterpret_cast<const uint32_t*>(live + base + 128 * k + 4 * lane);
    }
    return;
  }
  uint32_t bytes[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t r = base + 128 * k + 4 * lane + b;
      bytes[k][b] = r < n ? live[r] : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = bytes[k][0] | bytes[k][1] << 8 | bytes[k][2] << 16 | bytes[k][3] << 24;
  }
}

// The live masks of queries 0..count-1 (query k's mask at live + k * n)
// into w[k]; w[k] = 0 for the rest of the block.
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ live, int64_t n,
                                           int count, int64_t base, int lane,
                                           uint32_t (&w)[kQueryBlock][4]) {
#pragma unroll
  for (int k = 0; k < kQueryBlock; ++k) {
    if (k < count) {
      load_live(live + k * n, base, n, lane, w[k]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[k][u] = 0;
    }
  }
}

// Whether item j of this lane is live, from its query's load_live words.
// Every lane of the warp must call it (a shuffle).
__device__ __forceinline__ bool live_bit(const uint32_t (&w)[4], int j, int lane) {
  const uint32_t word = __shfl_sync(kFull, w[j >> 2], 8 * (j & 3) + (lane >> 2));
  return (word >> (8 * (lane & 3))) & 0xffu;
}

// One step with a group that several lanes hit: the lanes with equal
// gid form a peer set (-1 joins none); each set is reduced in a balanced
// tree over its members' ranks (rank k = members in lower lanes): at
// level d the member of rank k, k a multiple of 2d, takes the member of
// rank k + d, which is the next member above it whose rank is a multiple
// of d.  The set's rank-0 lane commits the result.  The order depends on
// lane positions alone.
template <int K, typename T>
__device__ __forceinline__ void fold_peers(int32_t gid, T v, int lane, T* mine) {
  const unsigned peers = __match_any_sync(kFull, gid);
  const int k = __popc(peers & ((1u << lane) - 1u));
  const int c = __popc(peers);
  const bool real = gid >= 0;
  const unsigned higher = ~((2u << lane) - 1u);  // lanes above this one
  for (int d = 1; __any_sync(kFull, real && c > d); d <<= 1) {
    const unsigned above = __ballot_sync(kFull, (k & (d - 1)) == 0) & peers & higher;
    const T other = shfl(v, above ? __ffs(static_cast<int>(above)) - 1 : lane);
    if ((k & (2 * d - 1)) == 0 && above) v = combine<K>(v, other);
  }
  if (real && k == 0) mine[gid] = combine<K>(mine[gid], v);
}

// Folds the first `steps` steps of a batch into the warp's partial
// `mine`, step after step.  A step whose lanes hit distinct groups, the
// common case at a large G, commits every lane at once; whether one does
// is found through `tags` (one byte per group of the tile): each lane
// writes its lane number at its group, and a lane that reads back
// another's shares its group.  Only such a step pays for fold_peers.
// The result is the same either way: a peer set of one is its value.
template <int K, typename T>
__device__ __forceinline__ void fold_batch(const int32_t (&gid)[kItems], const T (&v)[kItems],
                                           int steps, int lane, T* mine,
                                           volatile uint8_t* tags) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < steps) {
      const bool real = gid[j] >= 0;
      if (real) tags[gid[j]] = static_cast<uint8_t>(lane);
      __syncwarp();
      const bool shared = real && tags[gid[j]] != lane;
      __syncwarp();
      if (__any_sync(kFull, shared)) {
        fold_peers<K>(gid[j], v[j], lane, mine);
      } else if (real) {
        mine[gid[j]] = combine<K>(mine[gid[j]], v[j]);
      }
    }
  }
}

// At a small G every lane keeps its own partial, mine[g * 32 + lane], and
// folds its rows into it in step order: no lane waits on another.
template <int K, typename T>
__device__ __forceinline__ void fold_batch_lanes(const int32_t (&gid)[kItems],
                                                 const T (&v)[kItems], int steps,
                                                 int lane, T* mine) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < steps && gid[j] >= 0) {
      T* slot = mine + gid[j] * 32 + lane;
      *slot = combine<K>(*slot, v[j]);
    }
  }
}

// p[0..count) = x, in 16-byte stores (p is 16-byte aligned).
template <typename T>
__device__ __forceinline__ void fill(T* p, int count, T x) {
  constexpr int kPer = 16 / sizeof(T);
  T pattern[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) pattern[u] = x;
  uint4 word;
  memcpy(&word, pattern, 16);
  uint4* q = reinterpret_cast<uint4*>(p);
  const int whole = count / kPer;
  for (int i = threadIdx.x; i < whole; i += blockDim.x) q[i] = word;
  for (int i = whole * kPer + threadIdx.x; i < count; i += blockDim.x) p[i] = x;
}

// Folds one query's batch into its partial `mine`: a row counts where
// it lies in the tile (rel) and the query's live bit (from `w`, its
// load_live words) is set.
template <int K, typename T>
__device__ __forceinline__ void fold_query(const int32_t (&rel)[kItems], const T (&v)[kItems],
                                           const uint32_t (&w)[4], int steps, int lane,
                                           bool lane_parts, T* mine, volatile uint8_t* tags) {
  int32_t gid[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) gid[j] = live_bit(w, j, lane) ? rel[j] : -1;
  if (lane_parts) {
    fold_batch_lanes<K>(gid, v, steps, lane, mine);
  } else {
    fold_batch<K>(gid, v, steps, lane, mine, tags);
  }
}

// Folds one batch of shared values into the lane partials of a block's
// queries (query m's at mine + m * per_query, its mask in w[m]; a query
// past the block's count has words 0 and folds nothing), step after
// step.  A step reads every query's slot before it writes any: the
// queries' partials are disjoint, so their read-add-write chains
// overlap, while each slot still takes its rows in step order.
template <int K, typename T>
__device__ __forceinline__ void fold_block_lanes(const int32_t (&rel)[kItems],
                                                 const T (&v)[kItems],
                                                 const uint32_t (&w)[kQueryBlock][4],
                                                 int steps, int lane, T* mine,
                                                 int per_query) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < steps) {
      T* slot = mine + max(rel[j], 0) * 32 + lane;
      bool hit[kQueryBlock];
      T cur[kQueryBlock];
#pragma unroll
      for (int m = 0; m < kQueryBlock; ++m) {
        hit[m] = live_bit(w[m], j, lane) && rel[j] >= 0;
        if (hit[m]) cur[m] = slot[m * per_query];
      }
#pragma unroll
      for (int m = 0; m < kQueryBlock; ++m) {
        if (hit[m]) slot[m * per_query] = combine<K>(cur[m], v[j]);
      }
    }
  }
}

// Block b's partial of every group, for each query of a query tile of
// `queries` queries, into query q's scratch[q * slice + b * G + g].
// Warps 0..warps-1 own a partial and a slice of the block's rows; every
// warp of the block clears the partials and combines them.  A query's
// partials take per_query = warps * per_owner values: with lane_parts
// each owning warp holds tile_g * 32 values (a partial per lane, lane
// fastest), otherwise tile_g values; the tile's queries lie side by side,
// then the warps' tile_g tag bytes, which the queries use in turn.  A
// warp loads a batch's ids (and shared values) once and folds the batch
// into each query of the tile.  With shared values the live masks of a
// block of kQueryBlock queries load at once, and lane partials fold the
// block's queries step by step together; with values per query the next
// query's values and mask load while one folds.  Each query's rows reach
// its partials in the order of its solo launch.
template <int K, typename T>
__device__ __forceinline__ void partials(const int32_t* __restrict__ ids,
                                         const T* __restrict__ vals, int64_t vals_stride,
                                         const uint8_t* __restrict__ live, int64_t n,
                                         int32_t queries, int32_t num_groups, int32_t tile_g,
                                         int32_t warps, bool lane_parts, int64_t chunk_rows,
                                         T* scratch, int64_t slice, T* part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = blockIdx.x;
  phase_clock(0);
  // chunk_rows is a multiple of warps * 32: whole 32-row steps per warp
  const int64_t per_warp = chunk_rows / warps;
  const int64_t r0 = chunk * chunk_rows + warp * per_warp;
  const int64_t r1 = warp < warps ? min64(n, r0 + per_warp) : r0;
  const T ident = identity<K, T>();
  const int per_owner = lane_parts ? tile_g * 32 : tile_g;
  const int per_query = warps * per_owner;
  T* mine = part + warp * per_owner;
  volatile uint8_t* tags =
      reinterpret_cast<uint8_t*>(part + queries * per_query) + warp * tile_g;

  const bool shared = vals_stride == 0;
  const int first = shared ? min(kQueryBlock, queries) : 1;

  for (int32_t g0 = 0; g0 < num_groups; g0 += tile_g) {
    const int32_t tg = min(tile_g, num_groups - g0);
    int32_t rel[kItems];
    T v[kItems];
    uint32_t w[kQueryBlock][4];
    // A batch's loads (ids, the first query's values or the shared ones,
    // the first block's masks) are all issued before any is used; the
    // first batch's are in flight while the partials are cleared.
    load_ids(ids, r0, r1, lane, rel);
    load_vals(vals, r0, r1, lane, ident, v);
    load_block(live, n, first, r0, lane, w);
    fill(part, queries * per_query, ident);
    __syncthreads();
    phase_clock(1);
    for (int64_t base = r0; base < r1; base += 32 * kItems) {
      if (base != r0) {
        load_ids(ids, base, r1, lane, rel);
        load_vals(vals, base, r1, lane, ident, v);
        load_block(live, n, first, base, lane, w);
      }
      in_tile(g0, tg, rel);
      const int steps = static_cast<int>(min64(kItems, (r1 - base + 31) / 32));
      // Shared values: blocks of kQueryBlock queries, the next block's
      // masks loading after one folds.  Values per query: one block of
      // every query, the next query's values and mask loading while one
      // folds.
      for (int32_t q0 = 0;;) {
        const int count = shared ? min(kQueryBlock, queries - q0) : queries;
        if (shared && lane_parts && count > 1) {
          fold_block_lanes<K>(rel, v, w, steps, lane, mine + q0 * per_query, per_query);
        } else {
          // one query at a time, w[0]: the words move down one query each
          // time, so no register array is indexed at run time
#pragma unroll 1
          for (int k = 0; k < count; ++k) {
            T next_v[kItems];
            const bool more = !shared && k + 1 < count;
            if (more) {
              load_vals(vals + (k + 1) * vals_stride, base, r1, lane, ident, next_v);
              load_live(live + (k + 1) * n, base, n, lane, w[1]);
            }
            fold_query<K>(rel, v, w[0], steps, lane, lane_parts, mine + (q0 + k) * per_query,
                          tags);
            if (more) {
#pragma unroll
              for (int j = 0; j < kItems; ++j) v[j] = next_v[j];
            }
#pragma unroll
            for (int t = 0; t + 1 < kQueryBlock; ++t) {
#pragma unroll
              for (int u = 0; u < 4; ++u) w[t][u] = w[t + 1][u];
            }
          }
        }
        q0 += count;
        if (q0 >= queries) break;
        load_block(live + q0 * n, n, min(kQueryBlock, queries - q0), base, lane, w);
      }
    }
    __syncthreads();
    phase_clock(2);
    for (int32_t q = 0; q < queries; ++q) {
      const T* qpart = part + q * per_query;
      T* qscratch = scratch + q * slice + chunk * num_groups + g0;
      if (lane_parts) {
        // warp by group: each lane folds its partials in warp order, then a
        // fixed shuffle tree folds the lanes
        for (int32_t gl = warp; gl < tg; gl += blockDim.x >> 5) {
          T acc = qpart[gl * 32 + lane];
          for (int w = 1; w < warps; ++w) acc = combine<K>(acc, qpart[w * per_owner + gl * 32 + lane]);
          for (int delta = 16; delta > 0; delta >>= 1) acc = combine<K>(acc, shfl_down(acc, delta, 32));
          if (lane == 0) qscratch[gl] = acc;
        }
      } else {
        // four groups per round, so their combine chains overlap
        for (int32_t gl0 = threadIdx.x; gl0 < tg; gl0 += 4 * blockDim.x) {
          T acc[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int32_t gl = gl0 + u * blockDim.x;
            acc[u] = gl < tg ? qpart[gl] : ident;
          }
          for (int w = 1; w < warps; ++w) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int32_t gl = gl0 + u * blockDim.x;
              if (gl < tg) acc[u] = combine<K>(acc[u], qpart[w * tile_g + gl]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int32_t gl = gl0 + u * blockDim.x;
            if (gl < tg) qscratch[gl] = acc[u];
          }
        }
      }
    }
    __syncthreads();
    phase_clock(3);
  }
}

// out[g] = fold of scratch[0..chunks)[g] in chunk order, fold_lanes
// threads per group (consecutive lanes of one warp).
template <int K, typename T>
__device__ __forceinline__ void fold(const T* scratch, int32_t chunks,
                                     int32_t num_groups, int fold_lanes, T* out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t segments = static_cast<int64_t>(gridDim.x) * blockDim.x / fold_lanes;
  const int s = threadIdx.x & (fold_lanes - 1);
  // every thread runs the same number of rounds, so the shuffles see
  // whole warps
  for (int64_t g = t / fold_lanes; g - t / fold_lanes < num_groups; g += segments) {
    T acc = identity<K, T>();
    if (g < num_groups) {
      const T* col = scratch + g;
      int32_t c = s;
      for (; c + (kUnroll - 1) * fold_lanes < chunks; c += kUnroll * fold_lanes) {
        T x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = load_cg(col + static_cast<int64_t>(c + u * fold_lanes) * num_groups);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = combine<K>(acc, x[u]);
      }
      for (; c < chunks; c += fold_lanes) {
        acc = combine<K>(acc, load_cg(col + static_cast<int64_t>(c) * num_groups));
      }
    }
    for (int delta = fold_lanes >> 1; delta > 0; delta >>= 1) {
      acc = combine<K>(acc, shfl_down(acc, delta, fold_lanes));
    }
    if (s == 0 && g < num_groups) out[g] = acc;
  }
}

// Query q reads vals + q * vals_stride (a stride of 0 shares one value
// column) and live + q * n, and writes its result to out[q * G ..] and
// its partials to the scratch after the Q results.  The queries run in
// passes of query_tile (the last pass takes the rest), each one sweep
// of the rows.  The launch must be cooperative (every block resident)
// for the grid barrier.
template <int K, typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
reduce_kernel(const int32_t* __restrict__ ids, const T* __restrict__ vals,
              int64_t vals_stride, const uint8_t* __restrict__ live, int64_t n,
              int32_t queries, int32_t query_tile, int32_t num_groups, int32_t tile_g,
              int32_t warps, int32_t lane_parts, int64_t chunk_rows, int32_t fold_lanes,
              T* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t slice = static_cast<int64_t>(gridDim.x) * num_groups;
  T* scratch = out + static_cast<int64_t>(queries) * num_groups;
  for (int32_t q0 = 0; q0 < queries; q0 += query_tile) {
    partials<K, T>(ids, vals + q0 * vals_stride, vals_stride, live + q0 * n, n,
                   min(query_tile, queries - q0), num_groups, tile_g, warps, lane_parts != 0,
                   chunk_rows, scratch + q0 * slice, slice, reinterpret_cast<T*>(smem_raw));
  }
  cg::this_grid().sync();
  phase_clock(4);
  for (int32_t q = 0; q < queries; ++q) {
    fold<K, T>(scratch + q * slice, gridDim.x, num_groups, fold_lanes,
               out + static_cast<int64_t>(q) * num_groups);
  }
  phase_clock(5);
}

// Lets `kernel` take all the opt-in shared memory its static shared
// memory leaves.
cudaError_t allow_all_smem(const void* kernel) {
  int dev = 0;
  int bytes = 0;
  cudaFuncAttributes attrs;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attrs, kernel);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes - static_cast<int>(attrs.sharedSizeBytes));
  }
  return rc;
}

// *most = the largest static shared memory of the type's kernels.
template <typename T>
cudaError_t most_static_smem(size_t* most) {
  const void* kernels[] = {reinterpret_cast<const void*>(&reduce_kernel<kSum, T>),
                           reinterpret_cast<const void*>(&reduce_kernel<kMin, T>),
                           reinterpret_cast<const void*>(&reduce_kernel<kMax, T>)};
  for (const void* kernel : kernels) {
    cudaFuncAttributes attrs;
    const cudaError_t rc = cudaFuncGetAttributes(&attrs, kernel);
    if (rc != cudaSuccess) return rc;
    if (attrs.sharedSizeBytes > *most) *most = attrs.sharedSizeBytes;
  }
  return cudaSuccess;
}

template <int K, typename T>
int launch(const void* ids, const void* vals, long long vals_stride, const void* live,
           long long n, int queries, int query_tile, int num_groups, int tile_g, int warps,
           int lane_parts, int blocks, long long chunk_rows, int fold_lanes, void* out,
           cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // instantiation, to the device's limit
  static const cudaError_t opted =
      allow_all_smem(reinterpret_cast<const void*>(&reduce_kernel<K, T>));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int32_t* ids_p = static_cast<const int32_t*>(ids);
  const T* vals_p = static_cast<const T*>(vals);
  int64_t stride = vals_stride;
  const uint8_t* live_p = static_cast<const uint8_t*>(live);
  int64_t n64 = n;
  int32_t qs = queries;
  int32_t qtile = query_tile;
  int32_t groups = num_groups;
  int32_t tile = tile_g;
  int32_t owners = warps;
  int32_t by_lane = lane_parts;
  int64_t rows = chunk_rows;
  int32_t lanes = fold_lanes;
  T* out_p = static_cast<T*>(out);
  // a query tile's partials side by side, then (without lane_parts) one
  // tag byte per group and owning warp
  const size_t per_query = static_cast<size_t>(warps) * tile_g *
                           (lane_parts ? 32 * sizeof(T) : sizeof(T));
  const size_t smem = query_tile * per_query +
                      (lane_parts ? 0 : static_cast<size_t>(warps) * tile_g);
  void* args[] = {&ids_p, &vals_p, &stride, &live_p, &n64, &qs, &qtile, &groups, &tile,
                  &owners, &by_lane, &rows, &lanes, &out_p};
  // fails (and is reported) if the grid is not resident all at once
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&reduce_kernel<K, T>), dim3(blocks),
      dim3(kMaxThreads), args, smem, stream));
}

template <typename T>
int launch_kind(int kind, const void* ids, const void* vals, long long vals_stride,
                const void* live, long long n, int queries, int query_tile, int num_groups,
                int tile_g, int warps, int lane_parts, int blocks, long long chunk_rows,
                int fold_lanes, void* out, cudaStream_t stream) {
  switch (kind) {
    case kSum:
      return launch<kSum, T>(ids, vals, vals_stride, live, n, queries, query_tile, num_groups,
                             tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out,
                             stream);
    case kMin:
      return launch<kMin, T>(ids, vals, vals_stride, live, n, queries, query_tile, num_groups,
                             tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out,
                             stream);
    case kMax:
      return launch<kMax, T>(ids, vals, vals_stride, live, n, queries, query_tile, num_groups,
                             tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out,
                             stream);
    default:
      return -1;
  }
}

}  // namespace

#ifdef DF_AGG_PHASE_CLOCKS
// Copies the phase clocks of blocks [0, blocks) of the last launch to
// host memory: blocks * 6 values.  Returns the CUDA error, or 0.
extern "C" int df_grouped_reduce_phase_clocks(long long* out, int blocks) {
  const size_t rows = static_cast<size_t>(blocks < kClockBlocks ? blocks : kClockBlocks);
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_clocks, rows * 6 * sizeof(long long)));
}
#endif

// The current device's SM count and the dynamic shared memory per block
// that every kernel is granted (the opt-in limit less the largest static
// shared memory of any instantiation), for the launch geometry.  Returns
// the first CUDA error, or 0.
extern "C" int df_grouped_reduce_limits(int* sms, int* smem) {
  int dev = 0;
  int optin = 0;
  size_t most = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc == cudaSuccess) rc = most_static_smem<int8_t>(&most);
  if (rc == cudaSuccess) rc = most_static_smem<int16_t>(&most);
  if (rc == cudaSuccess) rc = most_static_smem<int32_t>(&most);
  if (rc == cudaSuccess) rc = most_static_smem<int64_t>(&most);
  if (rc == cudaSuccess) rc = most_static_smem<float>(&most);
  if (rc == cudaSuccess) rc = most_static_smem<double>(&most);
  *smem = optin - static_cast<int>(most);
  return static_cast<int>(rc);
}

// dtype: 0 int8, 1 int16, 2 int32, 3 int64, 4 float32, 5 float64.
// kind: 0 sum, 1 min, 2 max.  Q = `queries` reductions over one set of
// ids.  vals holds one column (vals_stride 0) or Q columns of n values
// (vals_stride n); live holds Q masks of n bytes.  The geometry (tile_g,
// warps, lane_parts, blocks, chunk_rows, fold_lanes) is
// hash_agg.geometry's for (n, num_groups): warps <= 8 of a block's 8 own
// a partial that fits the shared memory df_grouped_reduce_limits reports
// (tile_g * 32 values with lane_parts, else tile_g values and tile_g
// bytes), chunk_rows is a multiple of warps * 32, blocks * chunk_rows >=
// n, and fold_lanes is a power of two <= 32.  query_tile (>= 1) is
// hash_agg.query_tiles': that many queries' partials (warps * tile_g *
// 32 values each with lane_parts, else warps * tile_g values, plus the
// tags once) fit that shared memory.  out holds
// Q * (1 + blocks) * num_groups values of the dtype: the Q results, then
// the partials.  One cooperative launch.  Returns the launch's CUDA
// error (a grid that cannot be resident at once is one), or -1 for a
// dtype or kind it does not know.
extern "C" int df_grouped_reduce(int dtype, int kind, const void* ids, const void* vals,
                                 long long vals_stride, const void* live, long long n,
                                 int queries, int query_tile, int num_groups, int tile_g,
                                 int warps, int lane_parts, int blocks, long long chunk_rows,
                                 int fold_lanes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_kind<int8_t>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    case 1: return launch_kind<int16_t>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    case 2: return launch_kind<int32_t>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    case 3: return launch_kind<int64_t>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    case 4: return launch_kind<float>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    case 5: return launch_kind<double>(kind, ids, vals, vals_stride, live, n, queries, query_tile, num_groups, tile_g, warps, lane_parts, blocks, chunk_rows, fold_lanes, out, s);
    default: return -1;
  }
}
