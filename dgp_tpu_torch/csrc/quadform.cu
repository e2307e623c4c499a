// Variational quadform of the SVGP conditional variance, forward and
// backward, for Hopper (sm_90a).
//
// FORWARD. Replaces the TPU kernel dgp_tpu/ops/quadform_pallas.py:_fwd_kernel,
// with and without its t1 output. For every column a = A[:, j] of A [M][n]:
//
//   b_d   = Sq[d] @ a          t2_d = ||b_d||^2          (with t1) t1 = ||a||^2
//
// What bounds it: 2 M^2 FLOP per point and output on the full square against
// 4 (M + D) bytes per point (A read once, t2 written once): at every shape
// the model runs, fp32 arithmetic, not memory. On the conditional's path
// Sq = tril(q_sqrt)^T is upper-triangular, so the function needs only
// M (M + 1) FLOP per point and output; this kernel takes any Sq and spends
// the full square. Plain IEEE fp32 FMA, no TF32: t2 is a cancellation-free
// sum of squares, but it meets t1 in the variance, which does cancel. What
// the design does about the bound: B never reaches device memory, so the
// FLOP are the only cost that grows with n beyond reading A.
//   * One block of 256 threads owns a tile of TN = 64 points. Its A tile
//     [MP][TN] is read from device memory once, into shared memory; M is
//     padded with zero rows to MP = 64 or 128, and the columns of the ragged
//     last tile past n read as 0 and are never written.
//   * Sq[d] is staged k-major one d at a time (the wrapper passes
//     Sq^T = tril(q_sqrt)), and each thread keeps an RM x 4 register tile of
//     b_d, reduced to t2_d per point by a warp shuffle and a fixed-order sum
//     over the 8 warps (deterministic). t1 is a fixed-order sum per column.
//   * 100,352 bytes of shared memory at M = 128, whatever D is, so two
//     blocks share an SM and one stages its next Sq[d] while the other
//     computes.
// This is the second half of the fused conditional's forward
// (conditional_fused_rbf.cu) without its Kuf and A stages; the building
// blocks are shared through tiles.cuh.
//
// BACKWARD. Replaces dgp_tpu/ops/quadform_pallas.py:_bwd_kernel. Given the
// cotangents g2 [D][n] of t2 (and g1 [n] of t1) it recomputes b_d per tile:
//
//   gb_d   = 2 b_d g2_d
//   dA     = sum_d Sq[d]^T gb_d  (+ 2 a g1)          written per tile
//   dSq[d] = sum over all points of gb_d a^T         a cross-tile sum
//
// What bounds it: three M x M products per output and tile (b_d, Sq[d]^T gb_d
// and gb_d a^T), 6 D M^2 FLOP per point on full squares against 4 (2 M + D)
// bytes: fp32 arithmetic. The TPU kernel zeroed dSq on grid step 0 and added
// into it on a grid that runs in order; here blocks run concurrently, so the
// cross-tile sum takes the fused backward's scheme:
//   * A persistent grid: as many blocks as the card holds at once (one per SM
//     at M = 128), block b taking tiles b, b + grid, ...: a static assignment,
//     so every sum has one fixed order.
//   * Each block owns a slab of D M^2 floats in the wrapper's scratch (512 KB
//     at D = 8, M = 128; about 69 MB for 132 blocks, whatever n is). The
//     thread that owns an element of gb_d a^T adds each tile's contribution
//     into the slab: a read-modify-write nobody else touches, 2 D M^2 * 4
//     bytes per tile (1.6 GB per call at D = 8, M = 128, n = 100,000,
//     mostly from L2). Keeping one d's dSq[d] in registers across a block's
//     tiles would avoid it (later work).
//   * A second kernel, reduce_slabs, adds the slabs in block order. No float
//     atomics: two runs on the same inputs give the same bits.
//   * Shared memory: Sq[d] staged once per d (64 KB) and read both ways
//     (down its columns for b_d, along its rows for Sq[d]^T gb_d), the A tile
//     and the gb_d tile (later dA) at row stride TS; 135,680 bytes at M = 128:
//     one block of 8 warps per SM.
//   * Rows of M past M and points past n hold a = 0 and g = 0, so all their
//     contributions are 0; their dA entries are never written.

#include "tiles.cuh"

namespace {

// Shared memory, in floats: the staged Sq[d], the A tile and the column
// partials of t2.
inline long long fwd_smem_bytes(int M) {
  const int MP = padded_m(M);
  return static_cast<long long>(sizeof(float)) * (MP * MP + MP * TN + NWARP * TN);
}

// The staged Sq[d], the A tile, the gb_d / dA tile, g2_d and g1.
inline long long bwd_smem_bytes(int M) {
  const int MP = padded_m(M);
  return static_cast<long long>(sizeof(float)) * (MP * MP + 2 * MP * TS + 2 * TN);
}

inline bool fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && fwd_smem_bytes(M) <= MAX_SMEM;
}

inline bool bwd_fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && bwd_smem_bytes(M) <= MAX_SMEM;
}

// t1 is null for the variant without it (a branch outside the products: one
// instantiation serves both variants and halves the build)
template <int RM>
__global__ void __launch_bounds__(NT, 2)
quadform_fwd(const float* __restrict__ sqT, const float* __restrict__ A,
             float* __restrict__ t2, float* __restrict__ t1, long long n, int M,
             int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // [MP][MP]
  float* T = W + MP * MP;                      // the A tile [MP][TN]
  float* red = T + MP * TN;                    // per-warp column partials

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long p0 = static_cast<long long>(blockIdx.x) * TN;
  const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);
  const long long MM = static_cast<long long>(M) * M;

  load_tile<MP, TN>(T, A, n, p0, nt, M, tid);
  __syncthreads();
  if (t1 != nullptr && tid < nt) {
    float s = 0.0f;
    for (int m = 0; m < M; ++m) s = fmaf(T[m * TN + tid], T[m * TN + tid], s);
    t1[p0 + tid] = s;
  }
  float acc[RM][4];
  for (int d = 0; d < D; ++d) {
    __syncthreads();  // W and red are free again
    stage<MP>(W, sqT + d * MM, M, tid);
    __syncthreads();
    tile_product<RM>(W, T, ty, tx, acc);  // b_d = Sq[d] @ a, in registers
    colsumsq_partials<RM>(acc, red, tid);
    __syncthreads();
    if (tid < nt) t2[d * n + p0 + tid] = colsum(red, tid);
  }
}

// g1 is null for the variant without t1
template <int RM>
__global__ void __launch_bounds__(NT, 1)
quadform_bwd(const float* __restrict__ sqT, const float* __restrict__ A,
             const float* __restrict__ g2, const float* __restrict__ g1,
             float* __restrict__ dA, float* scratch, long long n, int M, int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // [MP][MP]
  float* AT = W + MP * MP;                     // the A tile [MP][TS]
  float* GB = AT + MP * TS;                    // gb_d, then dA [MP][TS]
  float* gS = GB + MP * TS;                    // g2_d of the current d [TN]
  float* g1S = gS + TN;                        // g1 [TN]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long MM = static_cast<long long>(M) * M;
  float* slab = scratch + blockIdx.x * (D * MM);
  const bool with_t1 = g1 != nullptr;

  const long long ntiles = (n + TN - 1) / TN;
  bool first = true;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first = false) {
    const long long p0 = tile * TN;
    const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);
    __syncthreads();  // the previous tile is done with AT, GB and g1S
    load_tile<MP, TS>(AT, A, n, p0, nt, M, tid);
    if (with_t1 && tid < TN) g1S[tid] = tid < nt ? __ldg(g1 + p0 + tid) : 0.0f;

    float da[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) da[r][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      __syncthreads();  // W, gS and GB are free again
      stage<MP>(W, sqT + d * MM, M, tid);
      if (tid < TN) gS[tid] = tid < nt ? __ldg(g2 + d * n + p0 + tid) : 0.0f;
      __syncthreads();
      float acc[RM][4];
      tile_product<RM, TS>(W, AT, ty, tx, acc);  // b_d = Sq[d] @ a
#pragma unroll
      for (int r = 0; r < RM; ++r)
        *reinterpret_cast<float4*>(GB + (ty * RM + r) * TS + tx * 4) = make_float4(
            2.0f * acc[r][0] * gS[tx * 4 + 0], 2.0f * acc[r][1] * gS[tx * 4 + 1],
            2.0f * acc[r][2] * gS[tx * 4 + 2], 2.0f * acc[r][3] * gS[tx * 4 + 3]);
      __syncthreads();
      tile_product_t<RM>(W, GB, ty, tx, da);                             // += Sq[d]^T gb_d
      outer_accumulate<RM>(slab + d * MM, GB, AT, M, ty, tx, first);    // dSq[d] += gb_d a^T
    }
    __syncthreads();  // every read of GB is done

    // dA = da (+ 2 a g1) into GB, then out one contiguous run per row
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty * RM + r;
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c;
        out[c] = with_t1 ? fmaf(2.0f * AT[row * TS + col], g1S[col], da[r][c]) : da[r][c];
      }
      *reinterpret_cast<float4*>(GB + row * TS + tx * 4) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();
    for (int e = tid; e < MP * TN; e += NT) {
      const int m = e / TN, j = e % TN;
      if (m < M && j < nt) dA[m * n + p0 + j] = GB[m * TS + j];
    }
  }
}

// f(Int<RM>) for the padded M
template <typename F>
auto dispatch(int M, F f) {
  return padded_m(M) == 64 ? f(Int<4>{}) : f(Int<8>{});
}

template <int RM>
cudaError_t launch_fwd(const float* sqT, const float* A, float* t2, float* t1,
                       long long n, int M, int D, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(fwd_smem_bytes(M));
  auto kern = quadform_fwd<RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + TN - 1) / TN);
  kern<<<grid, NT, bytes, stream>>>(sqT, A, t2, t1, n, M, D);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_bwd(const float* sqT, const float* A, const float* g2,
                       const float* g1, float* dA, float* scratch, long long n, int M,
                       int D, int blocks, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M));
  auto kern = quadform_bwd<RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NT, bytes, stream>>>(sqT, A, g2, g1, dA, scratch, n, M, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the forward's shared-memory plan covers (M, D), else 0: the wrapper's
// dispatch gate. The plan takes M <= 128 (padded to 64 or 128) and any D;
// M = 256 would need Sq[d] staged in panels (256 KB does not fit). The
// forward returns cudaErrorInvalidValue where this is 0.
int dgp_quadform_supported(int M, int D) { return fits(M, D) ? 1 : 0; }

// The same for the backward's plan.
int dgp_quadform_bwd_supported(int M, int D) { return bwd_fits(M, D) ? 1 : 0; }

// Launches the forward on `stream`. sqT[d] = Sq[d]^T [D][M][M], A [M][n];
// t2 [D][n], and t1 [n] or null (then t1 is not computed). All float32,
// contiguous, on one device. Returns cudaGetLastError().
int dgp_quadform_fwd(const float* sqT, const float* A, float* t2, float* t1,
                     long long n, int M, int D, void* stream) {
  if (n < 1 || !fits(M, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(M, [&](auto R) {
    return launch_fwd<decltype(R)::value>(sqT, A, t2, t1, n, M, D, s);
  }));
}

// How many slabs of D M^2 floats the backward needs as scratch for n points
// (its persistent grid). 0 if the sizes are outside the plan or CUDA
// reports an error.
int dgp_quadform_bwd_blocks(long long n, int M, int D) {
  if (n < 1 || !bwd_fits(M, D)) return 0;
  return dispatch(M, [&](auto R) {
    return resident_blocks(quadform_bwd<decltype(R)::value>,
                           static_cast<size_t>(bwd_smem_bytes(M)), n);
  });
}

// Launches the backward and then the slab reduction on `stream`. sqT and A
// as the forward's; g2 [D][n], and g1 [n] or null for the variant without t1.
// Outputs: dA [M][n], dSq [D][M][M] (in Sq's own layout). scratch holds
// `blocks` slabs, blocks = dgp_quadform_bwd_blocks(...). Returns
// cudaGetLastError().
int dgp_quadform_bwd(const float* sqT, const float* A, const float* g2,
                     const float* g1, float* dA, float* scratch, float* dSq,
                     long long n, int M, int D, int blocks, void* stream) {
  if (n < 1 || !bwd_fits(M, D) || blocks < 1 || blocks > (n + TN - 1) / TN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(M, [&](auto R) {
    return launch_bwd<decltype(R)::value>(sqT, A, g2, g1, dA, scratch, n, M, D, blocks, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_reduce_slabs(scratch, dSq, blocks, static_cast<long long>(D) * M * M, s));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
