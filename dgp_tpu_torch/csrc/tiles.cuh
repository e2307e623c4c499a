// Launch helpers shared by the port's CUDA sources: the padded M of the
// conditional kernels' plans, the shared-memory opt-in and the size of a
// persistent grid (the blocks the card holds at once).

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90

template <int V>
using Int = std::integral_constant<int, V>;

inline int padded_m(int M) { return M <= 64 ? 64 : 128; }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

template <typename K>
cudaError_t allow_shared_memory(K kern, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Opts the kernel into the most shared memory a block may take, once per
// device (the attribute holds for every later launch there): each caller
// keeps one `done` per kernel.
template <typename K>
cudaError_t allow_shared_memory_once(K kern, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = allow_shared_memory(kern, MAX_SMEM);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Blocks of `kern` (THREADS threads and `bytes` of shared memory a block)
// the card holds at once: a persistent grid; 0 on a CUDA error. It opts the
// kernel into the most shared memory a block may take, never less: a launch
// that set the attribute once must not find it lowered by this query.
template <int THREADS, typename K>
int resident_count(K kern, size_t bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  if (allow_shared_memory(kern, MAX_SMEM) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, bytes) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// resident_count, capped at the number of tiles of n points (TILE a tile).
template <int THREADS, int TILE, typename K>
int resident_blocks(K kern, size_t bytes, long long n) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long resident = resident_count<THREADS>(kern, bytes);
  return static_cast<int>(tiles < resident ? tiles : resident);
}

}  // namespace
