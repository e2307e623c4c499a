// Fused whitened SVGP conditional from a materialized Kuf and Kff, forward
// and backward, for Hopper (sm_90a).
//
// FORWARD. Replaces the TPU kernel dgp_tpu/ops/conditional_fused.py:_fwd_kernel.
// For every point (a column kuf of Kuf [M][n], with its prior variance kff):
//
//   a     = Pinv @ kuf            mean = a^T q_mu      t1 = ||a||^2
//   b_d   = Sq[d] @ a             t2_d = ||b_d||^2
//   var_d = max((kff - t1) + t2_d, 0)
//
// This is the whitened conditional of any kernel that the stationary kernel
// (conditional_fused_rbf.cu) does not take: Sum, Product, Linear, or
// active_dims. Kuf and Kff are built outside (PyTorch) and read here once.
// What bounds it: (1 + D) M (M + 1) + 4 M D FLOP per point (Pinv and Sq
// are triangular on the whitened path) against 4 (M + 1 + 2 D) bytes per
// point (Kuf and Kff read, mean and var written): arithmetic at every
// shape the model runs (reading Kuf at M = 128 is 0.15 ms per 1e6 points).
// a and t1 stay IEEE fp32 FMA: ||a||^2 cancels against kff (up to ~9 for
// an RBF + Linear kernel on [0, 1]^8), and TF32's 1e-3 error in a would
// swamp the variance; the D products b_d = Sq[d] a only add, and run on the
// tensor cores in 3xTF32. What the design does: it is the stationary
// kernel's forward (conditional.cuh's tile_forward, see
// conditional_fused_rbf.cu) with the kuf tile read from Kuf instead of
// built from the points: a persistent grid of one 256-thread block per SM
// over tiles of 128 points, each tile's Kuf copied by cp.async with every
// copy in flight at once (zero past M and past n), Pinv and tril(q_sqrt)
// staged as packed triangles through the cp.async ring. 147 KB of shared
// memory at M = 128, D = 8 (D up to 88, wider than the backward's plan).
//
// BACKWARD. Replaces dgp_tpu/ops/conditional_fused.py:_bwd_kernel. Given the
// cotangents g_mean, g_var [n][D] it recomputes a and b_d per tile in IEEE
// fp32 and chains them to every input:
//
//   gv_d  = g_var_d where (kff - t1) + t2_d > 0, else 0        (the clamp mask)
//   s     = sum_d gv_d                  dKff = s                written per tile
//   da    = sum_d Sq[d]^T (2 b_d gv_d) - 2 a s + q_mu g_mean^T
//   dKuf  = Pinv^T da                                           written per tile
//   dq_mu = a g_mean                                            per-tile slots
//   dPinv = tril(da kuf^T)   dSq[d] = triu(2 Sq[d] a diag(gv_d) a^T)  sums over n
//
// It assumes Pinv lower- and Sq upper-triangular, as on the whitened path,
// and returns dPinv and dSq on those patterns (only they reach a
// parameter). What bounds it: with the triangles' zero halves skipped,
// (2 + 2 D) M (M + 1) FLOP per point in the tile products and
// (1 + D) M (M + 1) in the sums over points, against 4 (2 M + 2 + 2 D)
// bytes per point: fp32 arithmetic. The sums over points take the two-phase
// scheme of the stationary kernel's backward (conditional_fused_rbf.cu and
// conditional.cuh):
//   * Phase A (conditional_fused_bwd_a): a persistent grid of one 256-thread
//     block per SM walks tiles of 128 points, reads each kuf tile from Kuf,
//     runs tile_backward and writes dKuf straight from registers and dKff;
//     a, da and gv go to scratch, dq_mu's share of the tile to its slot.
//   * Phase B (gram_bwd, reduce_parts, gram_finish) reads Kuf itself beside
//     the scratch: split-K Grams, summed slice by slice in order.
//   * No float atomics: two runs on the same inputs give the same bits.
//     Passes of 2^17 points bound the scratch (A, dA [M][pass], gv [D][pass]
//     and phase B's slots: 167 MB at M = 128, D = 8, n = 100,000).
//   * Shared memory at M = 128, D = 8: the ring of packed operands
//     (2 x 33 KB), the kuf / gb / da and a tiles ([128][132] each), q_mu and
//     g_mean: 216,576 bytes, one block per SM (D up to 23 at M = 128).
//   * Rows of M past M and points past n hold kuf = 0, kff = 0 and
//     g_mean = g_var = 0, so lin = 0 masks them and all their contributions
//     are 0; their dKuf and dKff entries are never written.
// The clamp mask is recomputed from (kff - t1) + t2_d, as on the TPU.

#include "conditional.cuh"

namespace {

struct FwdLayout {  // offsets in floats; total floats
  int ring1, t, red, t1s, kff, out, qm, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int MP, int M, int D) {
  FwdLayout L;
  int o = tri_off(MP);                    // ring buffer 0: a packed triangle
  L.ring1 = o; o += tri_off(MP);          // ring buffer 1
  L.t = o;    o += MP * FTS;              // kuf, then a
  L.red = o;  o += BRED * BTN;            // per-point column partials
  L.t1s = o;  o += BTN;
  L.kff = o;  o += BTN;
  L.out = o;  o += round4(BTN * D);       // the tile's var, then mean [BTN][D]
  L.qm = o;   o += round4(M * D);
  L.total = o;
  return L;
}

inline long long fwd_smem_bytes(int M, int D) {
  return static_cast<long long>(sizeof(float)) * fwd_layout(padded_m(M), M, D).total;
}

inline bool fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && fwd_smem_bytes(M, D) <= MAX_SMEM;
}

// The forward over n points: a persistent grid, each block walking tiles of
// BTN points; per tile the kuf tile and kff read from Kuf [M][n] and Kff,
// then tile_forward, then the tile's outputs.
template <int MP>
__global__ void __launch_bounds__(BNT, 1)
conditional_fused_fwd(const float* __restrict__ pinv, const float* __restrict__ kuf,
                      const float* __restrict__ qmu, const float* __restrict__ sqT,
                      const float* __restrict__ kff, float* __restrict__ mean,
                      float* __restrict__ var, long long n, int M, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(MP, M, D);
  const ForwardTiles t{smem + L.t, smem + L.red, smem + L.t1s, smem + L.out, smem + L.qm};
  float* kffS = smem + L.kff;
  Ring ring{{smem, smem + L.ring1}, pinv, sqT, static_cast<long long>(M) * M, M, D, D + 1,
            0};

  const int tid = threadIdx.x;

  // once per block: q_mu and the ring's first operand
  ring.start<MP>(tid);
  for (int e = tid; e < M * D; e += BNT) t.qm[e] = __ldg(qmu + e);
  const bool aligned = n % 4 == 0 && (reinterpret_cast<unsigned long long>(kuf) & 15) == 0;

  const long long ntiles = (n + BTN - 1) / BTN;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BTN;
    const int nt = static_cast<int>(n - p0 < BTN ? n - p0 : BTN);

    // this tile's kuf, zero past M and past n, by cp.async: every copy is in
    // flight at once, and the ring's next wait covers it; and kff
    load_tile_async<MP, FTS>(t.T, kuf, n, p0, nt, M, aligned, tid);
    cp_async_commit();
    if (tid < BTN) kffS[tid] = tid < nt ? __ldg(kff + p0 + tid) : 0.0f;

    tile_forward<MP>(t, ring, M, D, tid, [kffS](int j) { return kffS[j]; },
                     mean + p0 * D, var + p0 * D, nt);
  }
  cp_async_wait_all();
}

// -- backward -------------------------------------------------------------------

struct BwdLayout {  // offsets in floats; total floats
  int ring1, t1, t2, red, t1s, kff, ss, gm, qm, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int MP, int M, int D) {
  BwdLayout L;
  int o = tri_off(MP);                    // ring buffer 0: a packed triangle
  L.ring1 = o; o += tri_off(MP);          // ring buffer 1
  L.t1 = o;   o += MP * BTS;              // kuf, then gb_d, then da
  L.t2 = o;   o += MP * BTS;              // a
  L.red = o;  o += BRED * BTN;            // per-point column partials
  L.t1s = o;  o += BTN;
  L.kff = o;  o += BTN;
  L.ss = o;   o += BTN;                   // s = sum_d gv_d
  L.gm = o;   o += round4(BTN * D);       // g_mean tile, transposed [D][BTN]
  L.qm = o;   o += round4(M * D);
  L.total = o;
  return L;
}

inline long long bwd_smem_bytes(int M, int D) {
  return static_cast<long long>(sizeof(float)) * bwd_layout(padded_m(M), M, D).total;
}

inline bool bwd_fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && bwd_smem_bytes(M, D) <= MAX_SMEM;
}

// Phase A of the backward over n points (one chunk): per tile of BTN points
// the kuf tile read from Kuf (row stride ldk), tile_backward, then dKuf
// (same stride) and dKff.
template <int MP>
__global__ void __launch_bounds__(BNT, 1)
conditional_fused_bwd_a(const float* __restrict__ pinv, const float* __restrict__ kuf,
                        long long ldk, const float* __restrict__ qmu,
                        const float* __restrict__ sqT, const float* __restrict__ kff,
                        const float* __restrict__ gmean, const float* __restrict__ gvar,
                        float* __restrict__ dkuf, float* __restrict__ dkff,
                        float* __restrict__ a_s, float* __restrict__ da_s,
                        float* __restrict__ gv_s, long long ld, float* __restrict__ parts,
                        long long n, int M, int D) {
  constexpr int G = MP / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(MP, M, D);
  const BackwardTiles t{smem + L.t1, smem + L.t2, smem + L.red, smem + L.t1s,
                        smem + L.ss, smem + L.gm, smem + L.qm};
  float* kffS = smem + L.kff;
  Ring ring{{smem, smem + L.ring1}, pinv, sqT, static_cast<long long>(M) * M, M, D, D + 2,
            0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;

  // once per block: q_mu and the ring's first operand
  ring.start<MP>(tid);
  for (int e = tid; e < M * D; e += BNT) t.qm[e] = __ldg(qmu + e);
  const bool aligned = n % 4 == 0 && (reinterpret_cast<unsigned long long>(kuf) & 15) == 0;

  const long long ntiles = (n + BTN - 1) / BTN;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BTN;
    const int nt = static_cast<int>(n - p0 < BTN ? n - p0 : BTN);

    // this tile's kuf, kff and g_mean; zero past M and past n
    for (int e = tid; e < MP * BTN; e += BNT) {
      const int m = e / BTN, j = e % BTN;
      t.T1[m * BTS + j] = (m < M && j < nt) ? __ldg(kuf + m * ldk + p0 + j) : 0.0f;
    }
    for (int e = tid; e < BTN * D; e += BNT)
      t.gmS[(e % D) * BTN + e / D] = e < nt * D ? __ldg(gmean + p0 * D + e) : 0.0f;
    if (tid < BTN) kffS[tid] = tid < nt ? __ldg(kff + p0 + tid) : 0.0f;

    float acc[2 * G][8];  // dKuf = Pinv^T da
    tile_backward<MP, G>(t, ring, gvar + p0 * D, nt, a_s + p0, da_s + p0, gv_s + p0, ld,
                         parts + tile * M * D, M, D, tid,
                         [kffS](int j) { return kffS[j]; }, acc);

    // dKuf straight from registers; dKff = s
#pragma unroll
    for (int r = 0; r < 2 * G; ++r) {
      const int row = row_of<MP, G>(ty, r);
      if (row >= M) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (col_of(tx, c) < nt) dkuf[row * ldk + p0 + col_of(tx, c)] = acc[r][c];
    }
    if (tid < nt) dkff[p0 + tid] = t.sS[tid];
    __syncthreads();  // the next tile overwrites T1, kffS and gmS
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
// dispatch gate. The plan takes M <= 128 (padded to 64 or 128) and, at
// M = 128, D up to 88. The forward returns cudaErrorInvalidValue where this
// is 0.
int dgp_conditional_fused_supported(int M, int D) { return fits(M, D) ? 1 : 0; }

// The same for the backward's plan, which is larger (D up to 23 at M = 128).
int dgp_conditional_fused_bwd_supported(int M, int D) { return bwd_fits(M, D) ? 1 : 0; }

// The forward's persistent grid: the blocks of its plan for (M, D) that the
// card holds at once (the wrapper asks once per device and sizes). 0 if the
// sizes are outside the plan or CUDA reports an error.
int dgp_conditional_fused_fwd_blocks(int M, int D) {
  if (!fits(M, D)) return 0;
  return dispatch(M, [&](auto P) {
    return resident_count<BNT>(conditional_fused_fwd<decltype(P)::value>,
                               static_cast<size_t>(fwd_smem_bytes(M, D)));
  });
}

// Launches the forward on `stream` as min(blocks, tiles of n) blocks, blocks
// from dgp_conditional_fused_fwd_blocks. pinv = Pinv [M][M] (lower-triangular:
// only its lower triangle is read), kuf [M][n], qmu [M][D], sqT[d] =
// tril(q_sqrt[d]) = Sq[d]^T [D][M][M] (only its lower triangle is read),
// kff [n]; mean and var [n][D]. All float32, contiguous, on one device.
// Returns cudaGetLastError().
int dgp_conditional_fused_fwd(const float* pinv, const float* kuf, const float* qmu,
                              const float* sqT, const float* kff, float* mean,
                              float* var, long long n, int M, int D, int blocks,
                              void* stream) {
  if (n < 1 || !fits(M, D) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (n + BTN - 1) / BTN;
  const int grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(fwd_smem_bytes(M, D));
  return static_cast<int>(dispatch(M, [&](auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = conditional_fused_fwd<decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<grid, BNT, bytes, s>>>(pinv, kuf, qmu, sqT, kff, mean, var, n, M, D);
    return cudaGetLastError();
  }));
}

// Phase A's persistent grid for n points (one chunk): the blocks the card
// holds at once, capped at the number of tiles. 0 if the sizes are outside
// the plan or CUDA reports an error.
int dgp_conditional_fused_bwd_blocks(long long n, int M, int D) {
  if (n < 1 || !bwd_fits(M, D)) return 0;
  return dispatch(M, [&](auto P) {
    return resident_blocks<BNT, BTN>(conditional_fused_bwd_a<decltype(P)::value>,
                                     static_cast<size_t>(bwd_smem_bytes(M, D)), n);
  });
}

// Points per phase-A tile and per phase-B slice: the wrapper sizes its
// scratch with them.
int dgp_conditional_fused_bwd_tile() { return BTN; }
int dgp_conditional_fused_bwd_slice() { return GKB; }

// Phase A of the backward on the n points of one chunk, then the tiles'
// dq_mu shares added in tile order into dqmu [M][D] (added to what it holds
// if accumulate). pinv = Pinv [M][M] (lower-triangular), sqT[d] =
// tril(q_sqrt[d]) [D][M][M], qmu [M][D]; kuf and dkuf [M][.] at row stride
// ldk, and kff, gmean, gvar, dkff, all starting at the chunk. Writes a_s,
// da_s [M][ld] and gv_s [D][ld] (ld a multiple of the tile, at least the
// chunk's tiles) for phase B; parts holds ceil(n / tile) [M][D] slots.
// Returns cudaGetLastError().
int dgp_conditional_fused_bwd_a(const float* pinv, const float* kuf, long long ldk,
                                const float* qmu, const float* sqT, const float* kff,
                                const float* gmean, const float* gvar, float* dkuf,
                                float* dkff, float* a_s, float* da_s, float* gv_s,
                                long long ld, float* parts, float* dqmu, long long n, int M,
                                int D, int blocks, int accumulate, void* stream) {
  const long long ntiles = (n + BTN - 1) / BTN;
  if (n < 1 || !bwd_fits(M, D) || blocks < 1 || blocks > ntiles || ld < ntiles * BTN ||
      ld % BTN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M, D));
  const cudaError_t err = dispatch(M, [&](auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = conditional_fused_bwd_a<decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<blocks, BNT, bytes, s>>>(pinv, kuf, ldk, qmu, sqT, kff, gmean, gvar, dkuf, dkff,
                                    a_s, da_s, gv_s, ld, parts, n, M, D);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_parts(parts, dqmu, static_cast<int>(ntiles),
                                              static_cast<long long>(M) * D, 0,
                                              accumulate != 0, s));
}

// Phase B on the n points of one chunk: gram [(D + 1)][M][M] (+)= the lower
// triangles of C_d = A diag(gv_d) A^T and of dA Kuf^T over those points
// (phase A's a_s, da_s, gv_s at row stride ld, Kuf at ldk), summed slice by
// slice in order; parts holds ceil(n / slice) (D + 1) M^2 floats.
int dgp_conditional_fused_bwd_gram(const float* a_s, const float* da_s, long long ld,
                                   const float* kuf, long long ldk, const float* gv_s,
                                   float* parts, float* gram, long long n, int M, int D,
                                   int accumulate, void* stream) {
  if (n < 1 || M < 1 || M > 128 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gram(a_s, da_s, ld, kuf, ldk, gv_s, parts, gram, n, M, D,
                                      accumulate != 0, static_cast<cudaStream_t>(stream)));
}

// dPinv [M][M] = tril of gram's last matrix; dSq [D][M][M] (in Sq's own
// layout) = triu(2 Sq[d] C_d), with Sq[d] = sqT[d]^T. Exact zeros elsewhere.
int dgp_conditional_fused_bwd_finish(const float* gram, const float* sqT, float* dpinv,
                                     float* dsq, int M, int D, void* stream) {
  if (M < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_gram_finish(gram, sqT, dpinv, dsq, M, D, static_cast<cudaStream_t>(stream)));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
