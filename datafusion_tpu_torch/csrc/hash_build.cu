// Direct-address join build (dense int keys), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `hash_build.build_slot_table` of the JAX
// package (datafusion_tpu/exec/pallas/hash_build.py: `_kernel`,
// `_build_call`, the pallas_call at line 70).  For s in [0, S):
//
//     row[s]   = max(r : live[r] and pos[r] == s), or -1 if there is none
//     count[s] = |{r : live[r] and pos[r] == s}|
//
// A build key k occupies slot k - kmin, so `row` says which build row
// holds each key (the probe gathers payload from it) and `count` whether
// the key is unique.  Rows that are dead, or whose pos lies outside
// [0, S), touch nothing: the caller computes pos for dead rows too
// (NULL keys, padding), so the bounds check is the kernel's own.
//
// What bounds it: device memory.  A call reads N * (4 + 1) bytes (pos,
// live) and writes S * 8 (row, count); it does two int32 atomics per
// live row.  At the main path's shapes (the customer build of TPC-H Q5 at
// SF-1: N = S = 150,000) that is 1.95 MB, about 0.6 us at 3.35 TB/s, so
// a call is dominated by its launch.
//
// Design.  The TPU kernel sweeps one-hot slot tiles across a sequential
// grid because XLA lowers a scatter serially there.  Hopper has native
// int32 atomics in device memory, and int32 max and add commute, so one
// thread per row does atomicMax(row[pos], r) and atomicAdd(count[pos], 1):
// the result is exact and the same from run to run whatever order the
// atomics land in.  The loop is grid-strided so any N fits one launch.
// The wrapper allocates and initialises row (-1) and count (0); the
// kernel launches on the caller's stream, does not synchronize and
// allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

__global__ void __launch_bounds__(kThreads)
build_kernel(const int32_t* __restrict__ pos, const uint8_t* __restrict__ live,
             int64_t n, int32_t num_slots, int32_t* __restrict__ row,
             int32_t* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    if (!live[r]) continue;
    const int32_t p = pos[r];
    if (p < 0 || p >= num_slots) continue;
    atomicMax(row + p, static_cast<int32_t>(r));
    atomicAdd(count + p, 1);
  }
}

}  // namespace

// row and count hold num_slots int32 each, initialised to -1 and 0;
// n < 2^31 (row indices are int32).  Returns cudaGetLastError() after
// the launch.
extern "C" int df_build_slot_table(const void* pos, const void* live,
                                   long long n, int num_slots, void* row,
                                   void* count, void* stream) {
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    build_kernel<<<static_cast<int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(live),
        n, num_slots, static_cast<int32_t*>(row), static_cast<int32_t*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}
