// Batched Cholesky factor, and the factor with its inverse, of a stack of
// symmetric positive-definite matrices, for Hopper (sm_90a).
//
// Replaces the TPU kernels benchmarks/chol_probe.py:_chol_kernel (#7,
// L = chol(A)) and _chol_inv_kernel (#8, L and W = L^{-1} in one sweep). On
// the port's paths A is the jittered Kuu stack of a DGP's layers ([G, M, M],
// G = layers of one (M, white) group, M <= 128) and an exact GP's Gram
// matrix (G = 1, M = the padded archive).
//
// What bounds it: M^3 / 3 FLOP for L (and as much again for W) against
// 4 M^2 bytes in and 4 M^2 (8 M^2) out per matrix: at M = 128 about 0.7
// (1.4) MFLOP and 64 KB in, a bound well under a microsecond on the whole
// card. But the work is a chain of M dependent steps, and a stack holds one
// or two matrices: neither the FLOP nor the bytes decide the time, the
// latency of the chain does. What the design does about it: one block per
// matrix, the whole matrix in shared memory, each step a barrier and a
// rank-1 update done by all 512 threads; nothing touches device memory
// between the load and the store, and nothing is sent back to the host.
//
//   step j:  d = sqrt(A[j][j]);  L[i][j] = A[i][j] / d  (i > j),  L[j][j] = d
//            (with W)  W[j][c] = B[j][c] / d             (c <= j)
//            A[i][k] -= L[i][j] L[k][j]                   (j < k <= i)
//            (with W)  B[i][c] -= L[i][j] W[j][c]          (i > j, c <= j)
//
// B starts as the identity, so W's rows come out of the same sweep as L's
// columns (the probe's fused factorize-and-invert, here in its right-looking
// form: row j of W is final once column j of L is). Only the lower triangle
// of A is read. Plain IEEE fp32: sqrtf, division and FMA, so the TPU
// probe's bf16 MXU passes have no counterpart. A pivot that is not > 0 (or
// NaN) makes that matrix's L NaN on and below the diagonal and its W all
// NaN, as jnp.linalg.cholesky and a triangular solve give them; no error
// flag, no host read. Two runs on the same input give the same bits.
//
// Shared memory: A [M][M], column j of L, row j of W, and (with W) B [M][M]:
// 66,560 B at M = 128 for #7, 132,096 B for #8. The gates below take any M
// whose plan fits the 227 KB a block may opt into (M <= 240 for #7, M <= 169
// for #8).

#include "tiles.cuh"

namespace {

constexpr int CT = 512;       // threads per block
constexpr int CX = 32;        // columns per row pass: one warp walks one row
constexpr int CY = CT / CX;   // rows per pass

inline long long chol_smem_bytes(int M, bool inverse) {
  const long long MM = static_cast<long long>(M) * M;
  return static_cast<long long>(sizeof(float)) * ((inverse ? 2 : 1) * MM + 2LL * M);
}

inline bool chol_fits(int M, bool inverse) {
  return M >= 1 && chol_smem_bytes(M, inverse) <= MAX_SMEM;
}

template <bool INV>
__global__ void __launch_bounds__(CT, 1)
cholesky_kernel(const float* __restrict__ A, float* __restrict__ L,
                float* __restrict__ W, int M) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);  // [M][M]: A, then L column by column
  float* col = a + M * M;                      // column j of L
  float* wrow = col + M;                       // row j of W
  float* b = wrow + M;                         // [M][M]: I, then W row by row

  const int tid = threadIdx.x, tx = tid % CX, ty = tid / CX;
  const long long off = static_cast<long long>(blockIdx.x) * M * M;
  for (int e = tid; e < M * M; e += CT) {
    a[e] = __ldg(A + off + e);
    if (INV) b[e] = (e / M == e % M) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // every thread reads the same pivots, so every thread reaches the same ok
  bool ok = true;
  for (int j = 0; j < M; ++j) {
    const float pivot = a[j * M + j];
    ok = ok && pivot > 0.0f;  // false for NaN too
    const float d = sqrtf(pivot);
    for (int i = j + tid; i < M; i += CT) col[i] = i == j ? d : a[i * M + j] / d;
    if (INV)
      for (int c = tid; c <= j; c += CT) wrow[c] = b[j * M + c] / d;
    __syncthreads();  // column j of L and row j of W are known

    // A's column j and B's row j become L's and W's; the trailing update
    // writes only columns k > j of A and rows i > j of B
    for (int i = j + tid; i < M; i += CT) a[i * M + j] = col[i];
    if (INV)
      for (int c = tid; c <= j; c += CT) b[j * M + c] = wrow[c];
    for (int i = j + 1 + ty; i < M; i += CY) {
      const float li = col[i];
      float* ai = a + i * M;
      for (int k = j + 1 + tx; k <= i; k += CX) ai[k] = fmaf(-li, col[k], ai[k]);
      if (INV) {
        float* bi = b + i * M;
        for (int c = tx; c <= j; c += CX) bi[c] = fmaf(-li, wrow[c], bi[c]);
      }
    }
    __syncthreads();  // the trailing block is up to date
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int e = tid; e < M * M; e += CT) {
    const bool lower = e % M <= e / M;
    L[off + e] = !lower ? 0.0f : (ok ? a[e] : nan);
    if (INV) W[off + e] = !ok ? nan : (lower ? b[e] : 0.0f);
  }
}

template <bool INV>
cudaError_t launch(const float* A, float* L, float* W, int G, int M,
                   cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(chol_smem_bytes(M, INV));
  auto kern = cholesky_kernel<INV>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(G), CT, bytes, stream>>>(A, L, W, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the plan covers M x M matrices (inverse = 1: with W), else 0: the
// wrapper's dispatch gate. dgp_cholesky returns cudaErrorInvalidValue where
// this is 0.
int dgp_cholesky_supported(int M, int inverse) { return chol_fits(M, inverse != 0) ? 1 : 0; }

// Launches one block per matrix on `stream`. A [G][M][M] (lower triangle
// read); L [G][M][M] lower-triangular with zeros above the diagonal; W
// [G][M][M] = L^{-1}, or null for the factor alone (#7). All float32,
// contiguous, on one device. Returns cudaGetLastError().
int dgp_cholesky(const float* A, float* L, float* W, int G, int M, void* stream) {
  const bool inverse = W != nullptr;
  if (G < 1 || !chol_fits(M, inverse)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(inverse ? launch<true>(A, L, W, G, M, s)
                                  : launch<false>(A, L, W, G, M, s));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
