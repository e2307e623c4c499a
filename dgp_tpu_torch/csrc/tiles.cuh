// Tile building blocks shared by the port's CUDA sources: a block of 256
// threads owns a tile of TN = 64 points; M x M operands are staged k-major in
// shared memory, zero-padded to MP = 64 or 128, and each thread keeps an
// RM x 4 register tile (RM = MP / 16) of a product. Plain IEEE fp32 FMA.
// Every sum runs in a fixed order, with no atomics.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int TN = 64;          // points per block
constexpr int NT = 256;         // threads per block: 16 row groups x 16 column groups
constexpr int NWARP = NT / 32;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90
constexpr int TS = TN + 4;      // row stride of the backward kernels' tiles: 8 threads
                                // reading float4 from 8 consecutive rows then hit
                                // 32 distinct banks

template <int V>
using Int = std::integral_constant<int, V>;

inline int padded_m(int M) { return M <= 64 ? 64 : 128; }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// G is k-major [M][M] (G[k * M + i]); W becomes [MP][MP], zero-padded.
template <int MP>
__device__ __forceinline__ void stage(float* W, const float* __restrict__ G,
                                      int M, int tid) {
  if (M == MP) {
    const float4* g4 = reinterpret_cast<const float4*>(G);
    float4* w4 = reinterpret_cast<float4*>(W);
#pragma unroll 4
    for (int e = tid; e < MP * MP / 4; e += NT) w4[e] = __ldg(g4 + e);
  } else {
    for (int e = tid; e < MP * MP; e += NT) {
      const int k = e / MP, i = e % MP;
      W[e] = (k < M && i < M) ? __ldg(G + k * M + i) : 0.0f;
    }
  }
}

// T[m][j] (row stride S) = A[m][p0 + j] for m < M and j < nt, else 0: the
// tile of points p0 .. p0 + TN of an [M][n] operand, zero-padded to MP rows.
template <int MP, int S>
__device__ __forceinline__ void load_tile(float* T, const float* __restrict__ A,
                                          long long n, long long p0, int nt, int M,
                                          int tid) {
  for (int e = tid; e < MP * TN; e += NT) {
    const int m = e / TN, j = e % TN;
    T[m * S + j] = (m < M && j < nt) ? __ldg(A + m * n + p0 + j) : 0.0f;
  }
}

// acc[r][c] = sum_k W[k][ty*RM + r] * T[k][tx*4 + c]; T has row stride TS_
template <int RM, int TS_ = TN>
__device__ __forceinline__ void tile_product(const float* W, const float* T,
                                             int ty, int tx, float (&acc)[RM][4]) {
  constexpr int MP = 16 * RM;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < MP; ++k) {
    float a[RM];
#pragma unroll
    for (int q = 0; q < RM / 4; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(W + k * MP + ty * RM + 4 * q);
      a[4 * q + 0] = w.x;
      a[4 * q + 1] = w.y;
      a[4 * q + 2] = w.z;
      a[4 * q + 3] = w.w;
    }
    const float4 t = *reinterpret_cast<const float4*>(T + k * TS_ + tx * 4);
    const float b[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_k W[ty*RM + r][k] * T[k][tx*4 + c]: the staged operand
// read along its rows, i.e. the product with its transpose. T has stride TS.
template <int RM>
__device__ __forceinline__ void tile_product_t(const float* W, const float* T,
                                               int ty, int tx, float (&acc)[RM][4]) {
  constexpr int MP = 16 * RM;
#pragma unroll 2
  for (int k = 0; k < MP; k += 4) {
    float t[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 t4 = *reinterpret_cast<const float4*>(T + (k + q) * TS + tx * 4);
      t[q][0] = t4.x;
      t[q][1] = t4.y;
      t[q][2] = t4.z;
      t[q][3] = t4.w;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(W + (ty * RM + r) * MP + k);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(w[q], t[q][c], acc[r][c]);
    }
  }
}

// slab[i][k] (+)= sum_j P[i][j] * Q[k][j] over the tile's TN points, for
// i, k < M. The thread owns rows ty*RM + r and columns c*16 + tx in every
// tile, so the read-modify-write of the slab races with nobody.
template <int RM>
__device__ __forceinline__ void outer_accumulate(float* slab, const float* P,
                                                 const float* Q, int M, int ty,
                                                 int tx, bool first) {
  float acc[RM][RM];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RM; ++c) acc[r][c] = 0.0f;
#pragma unroll 1
  for (int j = 0; j < TN; j += 4) {
    float4 p[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      p[r] = *reinterpret_cast<const float4*>(P + (ty * RM + r) * TS + j);
#pragma unroll
    for (int c = 0; c < RM; ++c) {
      const float4 q = *reinterpret_cast<const float4*>(Q + (c * 16 + tx) * TS + j);
#pragma unroll
      for (int r = 0; r < RM; ++r)
        acc[r][c] = fmaf(p[r].w, q.w, fmaf(p[r].z, q.z, fmaf(p[r].y, q.y,
                         fmaf(p[r].x, q.x, acc[r][c]))));
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty * RM + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < RM; ++c) {
      const int col = c * 16 + tx;
      if (col >= M) continue;
      float* g = slab + row * M + col;
      *g = first ? acc[r][c] : *g + acc[r][c];
    }
  }
}

// Per-warp partial column sums of acc^2 into red[warp][TN]. Lanes 0-15 and
// 16-31 of a warp hold the same columns (row groups 2w and 2w+1).
template <int RM>
__device__ __forceinline__ void colsumsq_partials(const float (&acc)[RM][4],
                                                  float* red, int tid) {
  const int tx = tid & 15, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < RM; ++r) s = fmaf(acc[r][c], acc[r][c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 16) red[warp * TN + tx * 4 + c] = s;
  }
}

__device__ __forceinline__ float colsum(const float* red, int j) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += red[w * TN + j];
  return s;
}

// out[e] = sum over the blocks' slabs, in block order
__global__ void reduce_slabs(const float* __restrict__ scratch, float* __restrict__ out,
                             int blocks, long long len) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += scratch[b * len + e];
  out[e] = s;
}

inline cudaError_t launch_reduce_slabs(const float* scratch, float* out, int blocks,
                                       long long len, cudaStream_t stream) {
  reduce_slabs<<<static_cast<unsigned>((len + 255) / 256), 256, 0, stream>>>(
      scratch, out, blocks, len);
  return cudaGetLastError();
}

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
template <int THREADS = NT, int TILE = TN, typename K>
int resident_blocks(K kern, size_t bytes, long long n) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long resident = resident_count<THREADS>(kern, bytes);
  return static_cast<int>(tiles < resident ? tiles : resident);
}

}  // namespace
