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
// to five matrices: neither the FLOP nor the bytes decide the time, the
// latency of the chain does.
//
// What the design does about the latency: one block per matrix, the whole
// matrix (and B, which becomes W) in shared memory from the load to the
// store, nothing sent back to the host, and a blocked right-looking sweep
// over panels of NB = 16 columns (k0 .. s = k0 + nb):
//
//   (a) one warp factors the nb x nb diagonal block in registers, lane i
//       holding row i: the only serial chain left, M warp-level steps in
//       all (a column sweep with two block barriers per column took M
//       block-level ones);
//   (b) the panel below, L21 = A21 L11^{-T}, by forward substitution, one
//       thread per row; with W, W's panel rows = L11^{-1} B likewise, one
//       thread per column c < s;
//   (c) the trailing update A22 -= L21 L21^T on the lower triangle (and,
//       with W, B's rows below -= L21 W_panel), each warp a 16 x 32 tile,
//       each thread 4 x 4 elements read once, given nb FMAs in registers
//       and written back once. Warp 0 first brings the next diagonal block
//       up to date and factors it, step (a) of the next panel, while the
//       other warps update the rest.
//
// Two barriers a panel, 16 at M = 128 (17 with W) where the column sweep
// took 256; for M <= NB the factor is step (a) alone, in a block of one
// warp, and no block barrier runs between the load and the store. Every
// loop of the chain is rolled (the registers rotate, so the body stays
// small): the chain runs once per matrix, and unrolled straight-line code
// came cold from L2 and cost more than the arithmetic.
//
//   column j:  y = 1 / sqrt(A[j][j]);  L[j][j] = sqrt(A[j][j])
//              L[i][j] = A[i][j] y                          (i > j)
//              (with W)  W[j][c] = B[j][c] y                 (c <= j)
//              A[i][k] -= L[i][j] L[k][j]                   (j < k <= i)
//              (with W)  B[i][c] -= L[i][j] W[j][c]          (i > j, c <= j)
//
// In the blocked plan a column is scaled by the reciprocal of its pivot's
// square root, as LAPACK's potf2 scales by 1 / L[j][j]: y is rsqrtf and one
// Newton step, within about an ulp: IEEE sqrtf and division on the chain
// made each column several times slower. The one-warp plan (M <= NB), whose
// time is the host's, divides by the IEEE sqrtf of the pivot instead, as a
// column sweep does, and is the more accurate on the small, ill-conditioned
// Grams it takes. Every element takes these operations in the same order
// whatever the panel width (its rank-1 terms by ascending j, each an fmaf,
// then the scaling), so the width does not change the bits; the
// substitution scales as the factor does, and takes no product with an
// explicit L11^{-1}, so L keeps the rounding of a column sweep. B starts as
// the identity, so W's rows come out of the same sweep as L's columns. Only
// the lower triangle of A is used. Plain fp32 FMA. A pivot that is not > 0
// (or NaN) clears a flag in shared memory that every thread reads after
// the last barrier, so that matrix's L is NaN on and below the diagonal
// and its W all NaN, as jnp.linalg.cholesky and a triangular solve give
// them; no early return (a barrier in a diverged branch would hang), no
// error flag, no host read. Two runs on the same input give the same bits.
//
// Not used, and why: tensor cores (wgmma, mma.sync), since the factor must
// stay fp32 (TF32 breaks the port) and a rank-NB update of at most a
// 112 x 112 triangle is too small for 3xTF32 to pay; thread-block clusters,
// since a stack holds one to five matrices and what limits the kernel is
// the chain's latency, not one SM's throughput.
//
// Shared memory: the current panel's columns below the diagonal, col
// [NB][NB] (its never-written last row holds the flag and the slot masked
// lanes store to) and its NB reciprocals y (diagonal entries d in the
// one-warp plan); then A [M][LD] and (with W) B [M][LD], LD = M | 1 (odd,
// so the 32 rows a warp reads down one column sit in 32 distinct banks):
// 67,136 B at M = 128 for #7, 133,184 B for #8. The gates below take any M
// whose plan fits the 227 KB a block may opt into (M <= 240 for #7,
// M <= 169 for #8).

#include "tiles.cuh"

#include <atomic>
#include <cstdint>

namespace {

constexpr int CT = 512;           // threads per block of the blocked plan
constexpr int NB = 16;            // panel width
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int chol_ld(int M) { return M | 1; }

// col [NB][NB] and rdiag [NB] of the current panel, then A and B
inline long long chol_smem_bytes(int M, bool inverse) {
  const long long floats = NB * (NB + 1LL) + (inverse ? 2LL : 1LL) * M * chol_ld(M);
  return static_cast<long long>(sizeof(float)) * floats;
}

inline bool chol_fits(int M, bool inverse) {
  return M >= 1 && chol_smem_bytes(M, inverse) <= MAX_SMEM;
}

template <int NT>
__device__ __forceinline__ void block_sync() {
  if (NT == 32)
    __syncwarp();
  else
    __syncthreads();
}

// 1 / sqrt(p): the approximate reciprocal square root and one Newton step,
// within about an ulp; NaN for p < 0 or NaN, inf for p = 0. Every lane that
// calls it on the same p gets the same bits.
__device__ __forceinline__ float rsqrt_refined(float p) {
  const float y = rsqrtf(p);
  return fmaf(0.5f * y, fmaf(-p * y, y, 1.0f), y);
}

// (a) One warp factors the nb x nb diagonal block at (k0, k0) in place,
// lane i holding row i in registers. The loop over columns is rolled and
// the row rotates through the registers (r[0] is always column k), so the
// body stays small: the chain runs once per matrix, and straight-line code
// would come cold from L2. Column k is scaled by y = 1 / sqrt(pivot) (as
// LAPACK's potf2 scales by 1 / L[k][k]), which every lane forms itself; so
// does the next pivot, from lane k + 1's two entries shuffled off the
// chain. A step's chain is then rsqrt, three FMA and one multiply (IEEE
// sqrt and division, tried first, were several times slower). EXACT (the
// one-warp plan) divides by d = sqrtf(pivot) instead, and rdiag holds d
// where it would hold y. Column k
// below the diagonal goes to col[k][j] = L[k0 + k + j][k0 + k], where the
// lanes read it back as NB / 4 float4 (one value per shuffle was the
// dearer way), and y (or d) to rdiag[k], both for the substitutions too; each
// lane's diagonal L[i][i] = sqrtf(pivot) is written after the loop, off
// the chain. Entries above a lane's diagonal take updates too (no select);
// they are never read. Clears *flag if a pivot is not > 0.
template <bool EXACT>
__device__ __forceinline__ void factor_diagonal(float* a, float* col, float* rdiag,
                                                float* sink, int LD, int k0, int nb,
                                                int lane, int* flag) {
  const bool live = lane < nb;
  float* row = a + (k0 + (live ? lane : 0)) * LD + k0;
  float r[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) r[j] = live && j <= lane ? row[j] : 0.0f;

  bool ok = true;  // the same on every lane
  float p = __shfl_sync(FULL, r[0], 0), pivot = 0.0f;
  for (int k = 0; k < nb; ++k) {
    const float a1 = __shfl_sync(FULL, r[0], (k + 1) & 31);  // lane k + 1's
    const float b1 = __shfl_sync(FULL, r[1], (k + 1) & 31);  // columns k, k + 1
    ok = ok && p > 0.0f;  // false for NaN too
    if (lane == k) pivot = p;
    const float y = EXACT ? sqrtf(p) : rsqrt_refined(p);
    const float l = EXACT ? r[0] / y : r[0] * y;
    const float l1 = EXACT ? a1 / y : a1 * y;
    const bool below = live && lane > k;
    *(below ? row + k : sink) = l;
    *(below ? col + k * NB + lane - k : sink) = l;
    rdiag[k] = y;
    p = fmaf(-l1, l1, b1);  // lane k + 1's next r[0], bit for bit
    r[0] = fmaf(-l, __shfl_sync(FULL, l, (k + 1) & 31), r[1]);  // feeds the next a1
    __syncwarp();
    const float4* c4 = reinterpret_cast<const float4*>(col + k * NB);
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 v = c4[q];
      const float lv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e >= 2) r[4 * q + e - 1] = fmaf(-l, lv[e], r[4 * q + e]);
    }
    r[NB - 1] = 0.0f;
  }
  if (live) row[lane] = sqrtf(pivot);
  if (lane == 0 && !ok) *flag = 0;
}

// (b) x = L11^{-1} v by forward substitution for the nb entries v[j *
// stride], j < nb: a row of A21 (stride 1; then x is a row of L21, since
// L21 = A21 L11^{-T}) or a column of B's panel rows (stride LD; then x is a
// column of W's). x rotates through registers as r does in (a): x[0] is
// entry k, scaled by rdiag[k]; each later entry takes the term of k, read
// from col[k] as float4, the next step's row and scale loaded one step
// ahead (EXACT: divided by rdiag[k]). Every entry takes the same operations
// in the same order as the
// rows of the diagonal block in (a), so a row of L is the same bits
// whichever phase and panel width computes it. Entries of col past the
// block are never stored.
template <bool EXACT>
__device__ __forceinline__ void substitute(float* v, int stride, const float* col,
                                           const float* rdiag, int nb) {
  float x[NB], c[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    x[j] = j < nb ? v[j * stride] : 0.0f;
    c[j] = col[j];
  }
  float yk = rdiag[0];
#pragma unroll 2
  for (int k = 0; k < nb; ++k) {
    const int kn = min(k + 1, NB - 1);
    const float yn = rdiag[kn];
    const float4* c4 = reinterpret_cast<const float4*>(col + kn * NB);
    float cn[NB];
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 w = c4[q];
      cn[4 * q] = w.x;
      cn[4 * q + 1] = w.y;
      cn[4 * q + 2] = w.z;
      cn[4 * q + 3] = w.w;
    }
    const float xk = EXACT ? x[0] / yk : x[0] * yk;
    v[k * stride] = xk;
#pragma unroll
    for (int j = 1; j < NB; ++j) x[j - 1] = fmaf(-xk, c[j], x[j]);
    x[NB - 1] = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) c[j] = cn[j];
    yk = yn;
  }
}

// (c) Warp tile t of the trailing update after the panel k0 .. s: 16 rows
// by 32 columns, lane l owning rows 4 (l / 8) + r and columns l % 8 + 8 q
// (r, q < 4), so that the rows read down one column by a warp sit in
// distinct banks. The tiles of A22's lower triangle come first, then (with
// W) those of B's rows below s and columns left of s. Each element takes
// the panel's terms by ascending k.
template <bool INV>
__device__ __forceinline__ void update_tile(float* a, float* b, int LD, int M, int k0,
                                            int s, int nL, int t, int lane) {
  const bool onB = INV && t >= nL;
  int i0, j0;
  if (!onB) {  // row strip rs holds the column strips cs <= rs / 2
    int rs = 0;
    while (t >= rs / 2 + 1) t -= rs++ / 2 + 1;
    i0 = s + 16 * rs;
    j0 = s + 32 * t;
  } else {
    const int C = (s + 31) / 32;
    i0 = s + 16 * ((t - nL) / C);
    j0 = 32 * ((t - nL) % C);
  }
  i0 += 4 * (lane / 8);
  j0 += lane % 8;
  const int jmax = onB ? s : M;
  float* out = onB ? b : a;
  int ri[4], cj[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ri[q] = min(i0 + q, M - 1);  // past the edge: read clamped, never stored
    cj[q] = min(j0 + 8 * q, jmax - 1);
  }
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = out[ri[r] * LD + cj[c]];
#pragma unroll 2
  for (int k = k0; k < s; ++k) {
    float li[4], lj[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      li[q] = a[ri[q] * LD + k];
      lj[q] = onB ? b[k * LD + cj[q]] : a[cj[q] * LD + k];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(-li[r], lj[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + r, j = j0 + 8 * c;
      if (i < M && j < jmax && (onB || j <= i)) out[i * LD + j] = acc[r][c];
    }
}

template <bool INV, int NT>
__global__ void __launch_bounds__(NT, 1)
cholesky_kernel(const float* __restrict__ A, float* __restrict__ L,
                float* __restrict__ W, int M, bool vec) {
  extern __shared__ float4 smem4[];
  const int LD = chol_ld(M);
  // col[k][j] = L[k0 + k + j][k0 + k]; its last row is never written by
  // (a) (no lane lies below column nb - 1), so it holds the flag and the
  // slot that masked lanes store to, whose values (a) and (b) read only
  // past the block
  float* col = reinterpret_cast<float*>(smem4);  // [NB][NB], rows 16-byte aligned
  float* rdiag = col + NB * NB;                  // [NB]: 1 / L[k0 + k][k0 + k] (EXACT: L)
  float* a = rdiag + NB;                         // [M][LD]: A, then L panel by panel
  float* b = a + M * LD;                         // [M][LD]: I, then W (with W)
  float* sink = col + NB * NB - 2;
  int* flag = reinterpret_cast<int*>(col + NB * NB - 1);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int NW = NT / 32;
  constexpr bool EXACT = NT == 32;  // the one-warp plan: IEEE sqrt and division
  const long long off = static_cast<long long>(blockIdx.x) * M * M;
  if (vec) {  // M % 4 == 0 and 16-byte aligned: float4 loads, several in flight
    const int M4 = M / 4;
#pragma unroll 4
    for (int e = tid; e < M * M4; e += NT) {
      const int i = e / M4, j = 4 * (e % M4);
      const float4 v = j <= i ? __ldg(reinterpret_cast<const float4*>(A + off + i * M + j))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float* out = a + i * LD + j;
      out[0] = v.x;
      out[1] = j + 1 <= i ? v.y : 0.0f;
      out[2] = j + 2 <= i ? v.z : 0.0f;
      out[3] = j + 3 <= i ? v.w : 0.0f;
    }
  } else {
    for (int i = warp; i < M; i += NW)
      for (int j = lane; j < M; j += 32) a[i * LD + j] = j <= i ? __ldg(A + off + i * M + j) : 0.0f;
  }
  if (INV)
    for (int i = warp; i < M; i += NW)
      for (int j = lane; j < M; j += 32) b[i * LD + j] = i == j ? 1.0f : 0.0f;
  if (tid == 0) *flag = 1;
  block_sync<NT>();

  if (warp == 0) factor_diagonal<EXACT>(a, col, rdiag, sink, LD, 0, min(NB, M), lane, flag);
  block_sync<NT>();  // the first L11 is known

  for (int k0 = 0; k0 < M; k0 += NB) {
    const int nb = min(NB, M - k0), s = k0 + nb;
    const int below = M - s, tasks = below + (INV ? s : 0);
    for (int t = tid; t < tasks; t += NT) {
      if (t < below)
        substitute<EXACT>(a + (s + t) * LD + k0, 1, col, rdiag, nb);
      else
        substitute<EXACT>(b + k0 * LD + t - below, LD, col, rdiag, nb);
    }
    if (below == 0) break;
    block_sync<NT>();  // L21 and W's panel rows are known

    // Look-ahead: warp 0 brings the next diagonal block up to date (the
    // first nd tiles) and factors it while the other warps update the rest;
    // the warps that share warp 0's scheduler (warp % 4 == 0) stay idle, so
    // that the chain gets its issue slots
    const int RS = (below + 15) / 16;
    const int nL = (RS / 2 + 1) * (RS / 2) + (RS % 2) * (RS / 2 + 1);
    const int tiles = nL + (INV ? RS * ((s + 31) / 32) : 0), nd = min(NB / 16, RS);
    if (warp == 0) {
      for (int t = 0; t < nd; ++t) update_tile<INV>(a, b, LD, M, k0, s, nL, t, lane);
      __syncwarp();
      factor_diagonal<EXACT>(a, col, rdiag, sink, LD, s, min(NB, below), lane, flag);
    } else if (warp % 4 != 0) {
      for (int t = nd + warp - 1 - warp / 4; t < tiles; t += NW - NW / 4)
        update_tile<INV>(a, b, LD, M, k0, s, nL, t, lane);
    }
    block_sync<NT>();  // the trailing block and the next L11 are up to date
  }
  if (INV) block_sync<NT>();  // W's last panel rows are known

  const bool ok = *flag != 0;
  const float nan = __int_as_float(0x7fc00000);
  auto l_at = [&](int i, int j) { return j > i ? 0.0f : (ok ? a[i * LD + j] : nan); };
  auto w_at = [&](int i, int j) { return !ok ? nan : (j <= i ? b[i * LD + j] : 0.0f); };
  if (vec) {
    const int M4 = M / 4;
    for (int e = tid; e < M * M4; e += NT) {
      const int i = e / M4, j = 4 * (e % M4);
      const long long o = off + static_cast<long long>(i) * M + j;
      *reinterpret_cast<float4*>(L + o) =
          make_float4(l_at(i, j), l_at(i, j + 1), l_at(i, j + 2), l_at(i, j + 3));
      if (INV)
        *reinterpret_cast<float4*>(W + o) =
            make_float4(w_at(i, j), w_at(i, j + 1), w_at(i, j + 2), w_at(i, j + 3));
    }
  } else {
    for (int i = warp; i < M; i += NW)
      for (int j = lane; j < M; j += 32) {
        const long long o = off + static_cast<long long>(i) * M + j;
        L[o] = l_at(i, j);
        if (INV) W[o] = w_at(i, j);
      }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool INV, int NT>
cudaError_t launch(const float* A, float* L, float* W, int G, int M,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  auto kern = cholesky_kernel<INV, NT>;
  const cudaError_t err = allow_shared_memory_once(kern, allowed);
  if (err != cudaSuccess) return err;
  const size_t bytes = static_cast<size_t>(chol_smem_bytes(M, INV));
  const bool vec = M % 4 == 0 && aligned16(A) && aligned16(L) && (W == nullptr || aligned16(W));
  kern<<<static_cast<unsigned>(G), NT, bytes, stream>>>(A, L, W, M, vec);
  return cudaGetLastError();
}

// M <= NB: the diagonal block is the whole matrix, one warp does it all
template <bool INV>
cudaError_t launch_plan(const float* A, float* L, float* W, int G, int M,
                        cudaStream_t stream) {
  return M <= NB ? launch<INV, 32>(A, L, W, G, M, stream)
                 : launch<INV, CT>(A, L, W, G, M, stream);
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
  return static_cast<int>(inverse ? launch_plan<true>(A, L, W, G, M, s)
                                  : launch_plan<false>(A, L, W, G, M, s));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
