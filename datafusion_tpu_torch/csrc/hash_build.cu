// Direct-address join build (dense int keys), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `hash_build.build_slot_table` of the JAX
// package (datafusion_tpu/exec/pallas/hash_build.py: `_kernel`,
// `_build_call`, the pallas_call at line 70).  For s in [0, S):
//
//     row[s]   = max(r : live[r] and pos[r] == s), or -1 if there is none
//     count[s] = |{r : live[r] and pos[r] == s}|
//     dup      = 1 if some count[s] > 1, else 0
//
// A build key k occupies slot k - kmin, so `row` says which build row
// holds each key (the probe gathers payload from it) and `dup` whether
// the keys are unique, which decides whether the direct-address probe
// is legal at all.  Rows that are dead, or whose pos lies outside
// [0, S), touch nothing: the caller computes pos for dead rows too
// (NULL keys, padding), so the bounds check is the kernel's own.
//
// What bounds it: device memory.  A call reads N * (4 + 1) bytes (pos,
// live) and writes S * 8 + 4 (row, count, dup); it does two int32
// atomics per live row.  At the main path's largest shape (the orders
// build of TPC-H Q5 and Q12 at SF-1: N = S = 1,500,000) that is 19.5 MB,
// about 6 us at 3.35 TB/s; at the customer build (N = S = 150,000) a
// call is dominated by its launch and the host's dispatch.
//
// Design.  The TPU kernel sweeps one-hot slot tiles across a sequential
// grid because XLA lowers a scatter serially there.  Hopper has native
// int32 atomics in device memory, and int32 max and add commute, so one
// thread per row does atomicMax(row[pos], r) and atomicAdd(count[pos], 1):
// the result is exact and the same from run to run whatever order the
// atomics land in.  The thread whose atomicAdd returns an old count of
// 1 or more has found a second row of its slot and stores 1 into `dup`,
// so the caller learns uniqueness from one 4-byte copy instead of a host
// sort of the keys.  The loop is grid-strided so any N fits one launch.
// The entry point initialises the outputs itself with two memsets (row
// bytes 0xFF make every int32 -1; count and dup 0) on the caller's
// stream, so one host call does the whole build; it does not
// synchronize and allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

__global__ void __launch_bounds__(kThreads)
build_kernel(const int32_t* __restrict__ pos, const uint8_t* __restrict__ live,
             int64_t n, int32_t num_slots, int32_t* __restrict__ row,
             int32_t* __restrict__ count, int32_t* __restrict__ dup) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    if (!live[r]) continue;
    const int32_t p = pos[r];
    if (p < 0 || p >= num_slots) continue;
    atomicMax(row + p, static_cast<int32_t>(r));
    if (atomicAdd(count + p, 1) >= 1) *dup = 1;
  }
}

}  // namespace

// row holds num_slots int32; count holds num_slots + 1, the last being
// the dup flag; the call initialises both.  n < 2^31 (row indices are
// int32).  Returns the first CUDA error of the memsets and the launch,
// or 0.
extern "C" int df_build_slot_table(const void* pos, const void* live,
                                   long long n, int num_slots, void* row,
                                   void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t slot_bytes = static_cast<size_t>(num_slots) * sizeof(int32_t);
  cudaError_t rc = cudaMemsetAsync(row, 0xFF, slot_bytes, s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(count, 0, slot_bytes + sizeof(int32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    int32_t* cnt = static_cast<int32_t*>(count);
    build_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(live),
        n, num_slots, static_cast<int32_t*>(row), cnt, cnt + num_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
