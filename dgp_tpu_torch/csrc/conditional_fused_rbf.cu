// Fused whitened stationary-SVGP conditional, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgp_tpu/ops/conditional_fused_rbf.py:_fwd_kernel.
// For every point x (a row of Xs = X / lengthscales) and inducing input z
// (a row of Zs = Z / lengthscales):
//
//   sq    = max((||x||^2 - 2 z.x) + ||z||^2, 0)
//   kuf   = k(sq)                 RBF (0), Matern-3/2 (1) or Matern-5/2 (2)
//   a     = Pinv @ kuf            mean = a^T q_mu      t1 = ||a||^2
//   b_d   = Sq[d] @ a             t2_d = ||b_d||^2
//   var_d = max((v - t1) + t2_d, 0)                    (stationary: Kff == v)
//
// What bounds it: this kernel does 2*M*(Din + M + D*M + D) FLOP per point
// (full squares) against about 4*(Din + 2*D) bytes, so at every shape the
// model serves it is bound by fp32 arithmetic, not by memory. On the
// whitened path Pinv = Lu^{-1} is lower- and Sq upper-triangular, so the
// function needs only M*(M+1) FLOP per point for each of the 1 + D M x M
// products: about half of what the full squares spend. The arithmetic is plain IEEE fp32 FMA (no
// TF32): ||a||^2 cancels against v, and TF32's 1e-3 error in a would swamp
// the variance. What the design does about that bound: it spends no bytes
// of device memory on intermediates, so the FLOP are the only cost that
// grows with n.
//   * One block of 256 threads owns a tile of TN = 64 points.
//   * The M x M operand of the current product (Pinv, then Sq[0..D-1]) is
//     staged in shared memory one at a time, k-major (the wrapper passes
//     Pinv^T and Sq^T), so the copy is a straight, coalesced one.
//   * The kuf tile is built in shared memory and, once the product a is in
//     registers, overwritten in place by a. Neither kuf, a nor b reaches
//     device memory.
//   * Each thread keeps an RM x 4 register tile of the product
//     (RM = MP / 16); t1 and t2 are reduced per point from those registers
//     (a warp shuffle, then a fixed-order sum over the 8 warps: deterministic).
//   * M is padded with zeros to MP = 64 or 128 in shared memory; the ragged
//     last tile of points is masked here (rows past n read as 0 and are
//     never written).
//   * At M = 128, Din = D = 8 a block holds 113,664 bytes of shared memory,
//     so two blocks share an SM and one stages its next panel while the
//     other computes.
// Later work for speed: skipping the zero halves of the triangular Pinv and
// Sq, wgmma/TMA, 3xTF32 for the cancellation-free b product.

#include <cuda_runtime.h>

namespace {

constexpr int TN = 64;          // points per block
constexpr int NT = 256;         // threads per block: 16 row groups x 16 column groups
constexpr int NWARP = NT / 32;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90

struct Layout {
  int t, u, t1, om, ov, qm, total;  // offsets in floats; total floats
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout layout(int MP, int M, int Din, int D) {
  Layout L;
  L.t = MP * MP;                                  // W: the staged operand [MP][MP]
  L.u = L.t + MP * TN;                            // T: kuf, then a [MP][TN]
  int phase1 = MP * Din + Din * TN + TN + MP;     // zs, xs^T, ||x||^2, ||z||^2
  int reduce = NWARP * TN;                        // per-warp column partials
  L.t1 = L.u + round4(phase1 > reduce ? phase1 : reduce);
  L.om = L.t1 + TN;
  L.ov = L.om + round4(TN * D);
  L.qm = L.ov + round4(TN * D);
  L.total = L.qm + round4(M * D);
  return L;
}

inline int padded_m(int M) { return M <= 64 ? 64 : 128; }

// Shared memory one block needs, in bytes.
inline long long smem_bytes(int M, int Din, int D) {
  return static_cast<long long>(sizeof(float)) * layout(padded_m(M), M, Din, D).total;
}

inline bool fits(int M, int Din, int D) {
  return M >= 1 && M <= 128 && Din >= 1 && D >= 1 && smem_bytes(M, Din, D) <= MAX_SMEM;
}

template <int KIND>
__device__ __forceinline__ float kuf_of(float v, float sq) {
  if (KIND == 0) return v * expf(-0.5f * sq);
  const float r = sqrtf(sq);
  if (KIND == 1) {
    const float a = 1.7320508075688772f;  // sqrt(3)
    return v * (1.0f + a * r) * expf(-a * r);
  }
  const float a = 2.2360679774997896f;    // sqrt(5)
  return v * (1.0f + a * r + (5.0f / 3.0f) * sq) * expf(-a * r);
}

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

// acc[r][c] = sum_k W[k][ty*RM + r] * T[k][tx*4 + c]
template <int RM>
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
    const float4 t = *reinterpret_cast<const float4*>(T + k * TN + tx * 4);
    const float b[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
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

template <int KIND, int RM>
__global__ void __launch_bounds__(NT, 2)
fused_fwd(const float* __restrict__ pinvT, const float* __restrict__ xs,
          const float* __restrict__ zs, const float* __restrict__ vptr,
          const float* __restrict__ qmu, const float* __restrict__ sqT,
          float* __restrict__ mean, float* __restrict__ var,
          long long n, int M, int Din, int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(MP, M, Din, D);
  float* W = smem;
  float* T = smem + L.t;
  float* zsS = smem + L.u;          // phase 1 only
  float* xsS = zsS + MP * Din;      //   [Din][TN]
  float* xx = xsS + Din * TN;
  float* zz = xx + TN;
  float* red = smem + L.u;          // after phase 1
  float* t1s = smem + L.t1;
  float* outm = smem + L.om;        // [TN][D]
  float* outv = smem + L.ov;        // [TN][D]
  float* qm = smem + L.qm;          // [M][D]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long p0 = static_cast<long long>(blockIdx.x) * TN;
  const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);
  const float v = __ldg(vptr);

  // phase 0: stage q_mu, Zs, this tile's points and Pinv^T
  for (int e = tid; e < M * D; e += NT) qm[e] = __ldg(qmu + e);
  for (int e = tid; e < MP * Din; e += NT) zsS[e] = e < M * Din ? __ldg(zs + e) : 0.0f;
  for (int e = tid; e < TN * Din; e += NT) {
    const int j = e / Din, c = e % Din;
    xsS[c * TN + j] = j < nt ? __ldg(xs + (p0 + j) * Din + c) : 0.0f;
  }
  stage<MP>(W, pinvT, M, tid);
  __syncthreads();
  if (tid < TN) {
    float s = 0.0f;
    for (int c = 0; c < Din; ++c) s = fmaf(xsS[c * TN + tid], xsS[c * TN + tid], s);
    xx[tid] = s;
  } else if (tid < TN + MP) {
    const int m = tid - TN;
    float s = 0.0f;
    for (int c = 0; c < Din; ++c) s = fmaf(zsS[m * Din + c], zsS[m * Din + c], s);
    zz[m] = s;
  }
  __syncthreads();

  // phase 1: the kuf tile [MP][TN]; padded rows are 0
  for (int e = tid; e < MP * TN; e += NT) {
    const int m = e / TN, j = e % TN;
    float k = 0.0f;
    if (m < M) {
      float cross = 0.0f;
      for (int c = 0; c < Din; ++c) cross = fmaf(zsS[m * Din + c], xsS[c * TN + j], cross);
      k = kuf_of<KIND>(v, fmaxf((xx[j] - 2.0f * cross) + zz[m], 0.0f));
    }
    T[e] = k;
  }
  __syncthreads();

  // phase 2: a = Pinv @ kuf into registers, then over kuf in place; t1, mean
  float acc[RM][4];
  tile_product<RM>(W, T, ty, tx, acc);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RM; ++r)
    *reinterpret_cast<float4*>(T + (ty * RM + r) * TN + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  colsumsq_partials<RM>(acc, red, tid);
  __syncthreads();
  if (tid < TN) t1s[tid] = colsum(red, tid);
  for (int o = tid; o < TN * D; o += NT) {
    const int d = o / TN, j = o % TN;
    float s = 0.0f;
    for (int m = 0; m < M; ++m) s = fmaf(T[m * TN + j], qm[m * D + d], s);
    outm[j * D + d] = s;
  }

  // phase 3: b_d = Sq[d] @ a, reduced to t2_d without leaving registers
  for (int d = 0; d < D; ++d) {
    __syncthreads();
    stage<MP>(W, sqT + static_cast<long long>(d) * M * M, M, tid);
    __syncthreads();
    tile_product<RM>(W, T, ty, tx, acc);
    colsumsq_partials<RM>(acc, red, tid);
    __syncthreads();
    if (tid < TN) outv[tid * D + d] = fmaxf((v - t1s[tid]) + colsum(red, tid), 0.0f);
  }
  __syncthreads();

  // outputs are [n][D] row-major: this tile is one contiguous run
  const long long base = p0 * D;
  for (int e = tid; e < nt * D; e += NT) {
    mean[base + e] = outm[e];
    var[base + e] = outv[e];
  }
}

template <int KIND, int RM>
cudaError_t launch(const float* pinvT, const float* xs, const float* zs,
                   const float* v, const float* qmu, const float* sqT,
                   float* mean, float* var, long long n, int M, int Din, int D,
                   cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(smem_bytes(M, Din, D));
  auto kern = fused_fwd<KIND, RM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + TN - 1) / TN);
  kern<<<grid, NT, bytes, stream>>>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on `stream`. pinvT = Pinv^T [M][M], xs [n][Din],
// zs [M][Din], v [1], qmu [M][D], sqT[d] = Sq[d]^T [D][M][M]; mean and var
// [n][D]. All float32, contiguous, on one device. Returns cudaGetLastError().
int dgp_fused_rbf_fwd(int kind, const float* pinvT, const float* xs,
                      const float* zs, const float* v, const float* qmu,
                      const float* sqT, float* mean, float* var, long long n,
                      int M, int Din, int D, void* stream) {
  if (kind < 0 || kind > 2 || n < 1 || !fits(M, Din, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const bool small = padded_m(M) == 64;
  switch (kind) {
    case 0:
      err = small ? launch<0, 4>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s)
                  : launch<0, 8>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s);
      break;
    case 1:
      err = small ? launch<1, 4>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s)
                  : launch<1, 8>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s);
      break;
    default:
      err = small ? launch<2, 4>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s)
                  : launch<2, 8>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s);
      break;
  }
  return static_cast<int>(err);
}

// 1 if the shared-memory plan covers (M, Din, D), else 0: the wrapper's
// dispatch gate. The forward returns cudaErrorInvalidValue where it is 0.
int dgp_fused_rbf_supported(int M, int Din, int D) { return fits(M, Din, D) ? 1 : 0; }

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
