// Variational quadform of the SVGP conditional variance, forward and
// backward, for Hopper (sm_90a).
//
// FORWARD (#5). Replaces the TPU kernel dgp_tpu/ops/quadform_pallas.py:
// _fwd_kernel, with and without its t1 output. For every column a = A[:, j]
// of A [M][n]:
//
//   b_d = Sq[d] a        t2_d = ||b_d||^2        (with t1) t1 = ||a||^2
//
// Sq = tril(q_sqrt)^T is upper-triangular on the conditional's path, and
// both directions read only its upper triangle: the wrapper passes
// sqT[d] = Sq[d]^T, whose lower triangle the ring stages packed, so garbage
// below Sq's diagonal never reaches a result. What bounds it: D M (M + 1)
// FLOP per point in the products b_d against 4 (M + D) bytes per point (A
// read once, t2 written once). At M = 128, D = 8 that is arithmetic, even
// with b_d in 3xTF32 at the tensor cores' TF32 rate (0.83 ms at n = 1e6
// against 0.16 ms of bytes); at D = 1 it is A's bytes (0.15 ms). What the
// design does (conditional.cuh's forward steps without the a product):
//   * A persistent grid of one 256-thread block per SM (two at M <= 64)
//     walks tiles of 128 points. A's tiles arrive by cp.async in two
//     buffers, zero past M and past n: the next tile's copies are issued
//     as this tile's first product starts. The ring's next barrier waits
//     for every copy in flight, so they must land within that first
//     product (output d = 0), not across all D of them.
//   * The ring hands out Sq[0..D-1]^T as packed lower triangles, the next
//     while the current is used. Each b_d runs on the tensor cores in
//     3xTF32 (colsumsq_tc), its sums of squares reduced from the
//     accumulators: b never leaves registers, and each output costs one
//     barrier. t2 only adds to the variance. t1, which cancels against Kff
//     on the whitened fallback, is IEEE fp32 FMA, a fixed-order sum per
//     point over the A tile.
//   * 209,920 bytes of shared memory at M = 128, whatever D is: the plan
//     takes every D.
//
// BACKWARD (#6). Replaces dgp_tpu/ops/quadform_pallas.py:_bwd_kernel. Given
// the cotangents g2 [D][n] of t2 (and g1 [n] of t1):
//
//   gb_d   = 2 b_d g2_d
//   dA     = sum_d Sq[d]^T gb_d  (+ 2 a g1)                  per point (phase A)
//   dSq[d] = triu(sum_n gb_d a^T) = triu(2 Sq[d] C_d),
//   C_d    = A diag(g2_d) A^T                                a sum over points (phase B)
//
// dSq comes out on Sq's pattern, exact zeros below the diagonal
// (tril(q_sqrt) cuts the rest on the path). What bounds it: with the
// triangles' zero halves skipped, 2 D M (M + 1) FLOP per point in phase A's
// products and D M (M + 1) in the Grams, against 4 (2 M + D) bytes per
// point: fp32 arithmetic. The sum over points takes the whitened
// backwards' two-phase scheme, whose device code is in conditional.cuh:
//   * Phase A (quadform_bwd_a): the forward's grid and tiles; per tile A
//     by cp.async, then per output chain_output (b_d by tri_cols, gb_d,
//     da += Sq[d]^T gb_d by tri_rows; IEEE fp32 FMA, two barriers), and dA
//     written straight from registers. A and g2 are in device memory
//     already, so phase A writes no scratch. 202,752 bytes of shared
//     memory at M = 128, whatever D is.
//   * Phase B: gram_bwd's split-K Grams over (A, g2), read in place at row
//     stride n, the D Grams alone; their slices summed in order
//     (reduce_parts, not launched where one slice covers the pass); then
//     gram_finish. The wrapper runs it in passes of 2^17 points, which
//     bound the slices' partial sums (67 MB at M = 128, D = 8).
//   * No float atomics: two runs on the same inputs give the same bits.

#include "conditional.cuh"

namespace {

// Shared memory: the ring's two packed triangles, then for the forward two
// A tiles [MP][FTS], the outputs' partials (two slots of [2][BTN]) and
// t1's ([2][BTN]); for phase A the A tile and the gb_d tile, [MP][BTS]
// each.
inline long long fwd_smem_bytes(int M) {
  const int MP = padded_m(M);
  return static_cast<long long>(sizeof(float)) * (2 * tri_off(MP) + 2 * MP * FTS + 6 * BTN);
}

inline long long bwd_smem_bytes(int M) {
  const int MP = padded_m(M);
  return static_cast<long long>(sizeof(float)) * (2 * tri_off(MP) + 2 * MP * BTS);
}

inline bool fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && fwd_smem_bytes(M) <= MAX_SMEM;
}

inline bool bwd_fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && bwd_smem_bytes(M) <= MAX_SMEM;
}

// Points of tile `tile` of n
__device__ __forceinline__ int tile_points(long long tile, long long n) {
  const long long left = n - tile * BTN;
  return static_cast<int>(left < BTN ? left : BTN);
}

// The forward over n points: a persistent grid, each block walking tiles of
// BTN points. t1 is null for the variant without it (a branch outside the
// products: one instantiation serves both).
template <int MP>
__global__ void __launch_bounds__(BNT, MP <= 64 ? 2 : 1)
quadform_fwd(const float* __restrict__ sqT, const float* __restrict__ A,
             float* __restrict__ t2, float* __restrict__ t1, long long n, int M, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tiles = smem + 2 * tri_off(MP);  // two A tiles [MP][FTS]
  float* red = tiles + 2 * MP * FTS;      // per output slot (d mod 2): [2 halves][BTN]
  float* t1red = red + 4 * BTN;           // [2 halves][BTN]
  Ring ring{{smem, smem + tri_off(MP)}, nullptr, sqT, static_cast<long long>(M) * M, M, D, D,
            0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool aligned = n % 4 == 0 && (reinterpret_cast<unsigned long long>(A) & 15) == 0;
  const long long ntiles = (n + BTN - 1) / BTN;

  // once per block: the ring's first operand and the first A tile
  ring.start<MP>(tid);
  load_tile_async<MP, FTS>(tiles, A, n, blockIdx.x * static_cast<long long>(BTN),
                           tile_points(blockIdx.x, n), M, aligned, tid);
  cp_async_commit();

  int b = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, b ^= 1) {
    const long long p0 = tile * BTN;
    const int nt = tile_points(tile, n);
    const float* T = tiles + b * MP * FTS;
    // t2_d of the tile's points: the two halves' partials of output d
    auto finish = [&](int d) {
      const float* part = red + (d & 1) * 2 * BTN;
      if (tid < nt) t2[d * n + p0 + tid] = part[tid] + part[BTN + tid];
    };
    for (int d = 0; d < D; ++d) {
      // Sq[d]^T; at d = 0 this tile's A too, and every read of the other
      // A buffer and of red's slot d mod 2 is done
      const float* L = ring.next<MP>(tid);
      if (d == 0) {
        const long long next = tile + gridDim.x;
        if (next < ntiles) {
          load_tile_async<MP, FTS>(tiles + (b ^ 1) * MP * FTS, A, n, next * BTN,
                                   tile_points(next, n), M, aligned, tid);
          cp_async_commit();
        }
        if (t1 != nullptr) {  // half h of the rows of point j
          const int h = tid / BTN, j = tid % BTN, m1 = min(M, (h + 1) * (MP / 2));
          float s = 0.0f;
          for (int m = h * (MP / 2); m < m1; ++m) s = fmaf(T[m * FTS + j], T[m * FTS + j], s);
          t1red[h * BTN + j] = s;
        }
      } else {
        finish(d - 1);
      }
      float* part = red + (d & 1) * 2 * BTN;
      if (warp < 4)
        colsumsq_tc<MP, 0>(L, T, warp, lane, part);
      else
        colsumsq_tc<MP, 1>(L, T, warp, lane, part);
    }
    __syncthreads();
    finish(D - 1);
    if (t1 != nullptr && tid < nt) t1[p0 + tid] = t1red[tid] + t1red[BTN + tid];
  }
  cp_async_wait_all();
}

// Phase A of the backward over n points: per tile of BTN points the A
// tile, then per output d chain_output with g2_d as the weight, then
// dA = da (+ 2 a g1) straight from registers. g1 is null for the variant
// without t1.
template <int MP>
__global__ void __launch_bounds__(BNT, MP <= 64 ? 2 : 1)
quadform_bwd_a(const float* __restrict__ sqT, const float* __restrict__ A,
               const float* __restrict__ g2, const float* __restrict__ g1,
               float* __restrict__ dA, long long n, int M, int D) {
  constexpr int G = MP / 32, R = 2 * G;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* T = smem + 2 * tri_off(MP);  // the A tile [MP][BTS]
  float* GB = T + MP * BTS;           // gb_d [MP][BTS]
  Ring ring{{smem, smem + tri_off(MP)}, nullptr, sqT, static_cast<long long>(M) * M, M, D, D,
            0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  const bool aligned = n % 4 == 0 && (reinterpret_cast<unsigned long long>(A) & 15) == 0;
  const long long ntiles = (n + BTN - 1) / BTN;

  ring.start<MP>(tid);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BTN;
    const int nt = tile_points(tile, n);
    // this tile's A, zero past M and past n; the ring's next wait covers it
    load_tile_async<MP, BTS>(T, A, n, p0, nt, M, aligned, tid);
    cp_async_commit();

    float acc[R][8], da[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) da[r][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float w[8];  // g2_d of this thread's points, loaded before the product
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = col_of(tx, c);
        w[c] = col < nt ? __ldg(g2 + d * n + p0 + col) : 0.0f;
      }
      chain_output<MP, G>(ring, T, GB, tid, [&](float (&out)[8]) {
#pragma unroll
        for (int c = 0; c < 8; ++c) out[c] = w[c];
      }, acc, da);
    }

    // dA = da (+ 2 a g1), straight from registers
    float g[8] = {};
    if (g1 != nullptr) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = col_of(tx, c);
        g[c] = col < nt ? __ldg(g1 + p0 + col) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row_of<MP, G>(ty, r);
      if (row >= M) continue;
      float a[8];
      lds8(T + row * BTS, tx, a);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = col_of(tx, c);
        if (col < nt)
          dA[row * n + p0 + col] = g1 != nullptr ? fmaf(2.0f * a[c], g[c], da[r][c]) : da[r][c];
      }
    }
    __syncthreads();  // the next tile overwrites T
  }
  cp_async_wait_all();
}

// -- host side ------------------------------------------------------------------

// f(Int<MP>) for the padded M
template <typename F>
auto dispatch(int M, F f) {
  return padded_m(M) == 64 ? f(Int<64>{}) : f(Int<128>{});
}

}  // namespace

extern "C" {

// 1 if the forward's shared-memory plan covers (M, D), else 0: the wrapper's
// dispatch gate. The plan takes M <= 128 (padded to 64 or 128) and every D;
// M = 256 would need Sq[d] staged in panels. The forward returns
// cudaErrorInvalidValue where this is 0.
int dgp_quadform_supported(int M, int D) { return fits(M, D) ? 1 : 0; }

// The same for the backward's plan (phase A's; phase B takes every M <= 128
// and D).
int dgp_quadform_bwd_supported(int M, int D) { return bwd_fits(M, D) ? 1 : 0; }

// The forward's persistent grid: the blocks of its plan for (M, D) that the
// card holds at once (the wrapper asks once per device and sizes). 0 if the
// sizes are outside the plan or CUDA reports an error.
int dgp_quadform_fwd_blocks(int M, int D) {
  if (!fits(M, D)) return 0;
  return dispatch(M, [&](auto P) {
    return resident_count<BNT>(quadform_fwd<decltype(P)::value>,
                               static_cast<size_t>(fwd_smem_bytes(M)));
  });
}

// Launches the forward on `stream` as min(blocks, tiles of n) blocks, blocks
// from dgp_quadform_fwd_blocks. sqT[d] = Sq[d]^T [D][M][M] (only its lower
// triangle is read), A [M][n]; t2 [D][n], and t1 [n] or null (then t1 is
// not computed). All float32, contiguous, on one device. Returns
// cudaGetLastError().
int dgp_quadform_fwd(const float* sqT, const float* A, float* t2, float* t1, long long n,
                     int M, int D, int blocks, void* stream) {
  if (n < 1 || !fits(M, D) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (n + BTN - 1) / BTN;
  const int grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(fwd_smem_bytes(M));
  return static_cast<int>(dispatch(M, [&](auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = quadform_fwd<decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<grid, BNT, bytes, s>>>(sqT, A, t2, t1, n, M, D);
    return cudaGetLastError();
  }));
}

// Phase A's persistent grid, as dgp_quadform_fwd_blocks.
int dgp_quadform_bwd_a_blocks(int M, int D) {
  if (!bwd_fits(M, D)) return 0;
  return dispatch(M, [&](auto P) {
    return resident_count<BNT>(quadform_bwd_a<decltype(P)::value>,
                               static_cast<size_t>(bwd_smem_bytes(M)));
  });
}

// Points per phase-B slice: the wrapper sizes phase B's partial sums with
// it.
int dgp_quadform_bwd_slice() { return GKB; }

// Phase A of the backward on `stream` as min(blocks, tiles of n) blocks,
// blocks from dgp_quadform_bwd_a_blocks: dA [M][n] = sum_d Sq[d]^T gb_d
// (+ 2 A g1). sqT and A as the forward's; g2 [D][n], and g1 [n] or null for
// the variant without t1. Returns cudaGetLastError().
int dgp_quadform_bwd_a(const float* sqT, const float* A, const float* g2, const float* g1,
                       float* dA, long long n, int M, int D, int blocks, void* stream) {
  if (n < 1 || !bwd_fits(M, D) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (n + BTN - 1) / BTN;
  const int grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M));
  return static_cast<int>(dispatch(M, [&](auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = quadform_bwd_a<decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<grid, BNT, bytes, s>>>(sqT, A, g2, g1, dA, n, M, D);
    return cudaGetLastError();
  }));
}

// Phase B on the n points of one pass: gram [D][M][M] (+)= the lower
// triangles of C_d = A diag(g2_d) A^T over those points (a and g2 at row
// stride ld), summed slice by slice in order; parts holds
// ceil(n / slice) D M^2 floats.
int dgp_quadform_bwd_gram(const float* a, long long ld, const float* g2, float* parts,
                          float* gram, long long n, int M, int D, int accumulate, void* stream) {
  if (n < 1 || M < 1 || M > 128 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gram(a, nullptr, ld, nullptr, 0, g2, parts, gram, n, M, D,
                                      accumulate != 0, static_cast<cudaStream_t>(stream)));
}

// dSq [D][M][M] (in Sq's own layout) = triu(2 Sq[d] C_d), with
// Sq[d] = sqT[d]^T (only sqT's lower triangle is read); exact zeros below
// the diagonal.
int dgp_quadform_bwd_finish(const float* gram, const float* sqT, float* dsq, int M, int D,
                            void* stream) {
  if (M < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_gram_finish(gram, sqT, nullptr, dsq, M, D, static_cast<cudaStream_t>(stream)));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
