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
// What bounds it: 2 M^2 (1 + D) FLOP per point on full squares against
// 4 (M + 1 + 2 D) bytes per point (Kuf and Kff read, mean and var written):
// fp32 arithmetic at every shape the model runs (reading Kuf at M = 128 is
// 0.15 ms per 1e6 points, the products about 2.2 ms at the fp32 peak). On the
// whitened path Pinv = Lu^{-1} is lower- and Sq = tril(q_sqrt)^T
// upper-triangular, so the function needs only M (M + 1) FLOP per point for
// each of the 1 + D products; this kernel spends the full squares. Plain IEEE
// fp32 FMA, no TF32: ||a||^2 cancels against kff (up to ~9 for an RBF + Linear
// kernel on [0, 1]^8), and TF32's 1e-3 error in a would swamp the variance.
// What the design does about the bound: A and B never reach device memory, so
// beyond one read of Kuf the FLOP are the only cost that grows with n.
//   * It is the stationary kernel's pipeline with the Kuf tile read from
//     device memory (load_tile) instead of built from the points (the tile
//     steps, forward and backward, are shared in conditional.cuh): one block
//     of 256 threads per tile of TN = 64 points, Pinv^T then each Sq[d]^T
//     staged k-major in shared memory, a over kuf in place, b_d in registers,
//     t1 and t2_d reduced by a warp shuffle and a fixed-order sum over the 8
//     warps (deterministic).
//   * M is padded with zero rows to MP = 64 or 128; the columns of the ragged
//     last tile past n read as 0 and are never written.
//   * 109,056 bytes of shared memory at M = 128, D = 8: two blocks share an
//     SM, and one stages its next operand while the other computes.
//
// BACKWARD. Replaces dgp_tpu/ops/conditional_fused.py:_bwd_kernel. Given the
// cotangents g_mean, g_var [n][D] it recomputes a and b_d per tile in IEEE
// fp32 and chains them to every input:
//
//   gv_d  = g_var_d where (kff - t1) + t2_d > 0, else 0        (the clamp mask)
//   s     = sum_d gv_d                  dKff = s                written per tile
//   gb_d  = 2 b_d gv_d
//   da    = sum_d Sq[d]^T gb_d - 2 a s + q_mu g_mean^T
//   dKuf  = Pinv^T da                                           written per tile
//   dPinv = da kuf^T     dq_mu = a g_mean     dSq[d] = gb_d a^T  sums over points
//
// What bounds it: six M x M products per output on full squares (a, dKuf and
// dPinv once; b_d, Sq[d]^T gb_d and dSq[d] per d), 2 M^2 (3 + 3 D) FLOP per
// point against 4 (2 M + 2 + 2 D) bytes: fp32 arithmetic again. The TPU kernel
// zeroed its sums on grid step 0 and added into them on a grid that runs in
// order; here blocks run concurrently, so the cross-tile sums take the scheme
// of the other backward kernels:
//   * A persistent grid: as many blocks as the card holds at once (one per SM
//     at M = 128), block b taking tiles b, b + grid, ...: a static assignment,
//     so every sum has one fixed order.
//   * Each block owns a slab of (1 + D) M^2 + M D floats in the wrapper's
//     scratch (about 78 MB for 132 blocks at D = 8, M = 128, whatever n is).
//     dq_mu accumulates in shared memory and is written once; each tile's
//     da kuf^T and gb_d a^T are added into the slab by the thread that owns
//     the element (a read-modify-write nobody else touches).
//   * reduce_slabs adds the slabs in block order. No float atomics: two runs
//     on the same inputs give the same bits.
//   * Shared memory: the staged operand W (64 KB at M = 128) and three
//     [MP][TN + 4] tiles: kuf (later dKuf), a, and gb_d (later da); Sq[d] is
//     staged once per tile and read both ways; Pinv^T is staged at the end of
//     a tile for dKuf and stays for the next tile's a. 185,344 bytes at
//     M = 128, D = 8: one block per SM.
//   * Rows of M past M and points past n hold kuf = 0, kff = 0 and
//     g_mean = g_var = 0, so lin = 0 masks them and all their contributions
//     are 0; their dKuf and dKff entries are never written.
// The clamp mask is recomputed from (kff - t1) + t2_d, as on the TPU.

#include "conditional.cuh"

namespace {

struct FwdLayout {  // offsets in floats; total floats
  int t, red, t1, kff, om, ov, qm, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int MP, int M, int D) {
  FwdLayout L;
  int o = MP * MP;                   // W: the staged operand [MP][MP]
  L.t = o;    o += MP * TN;          // T: kuf, then a [MP][TN]
  L.red = o;  o += NWARP * TN;       // per-warp column partials
  L.t1 = o;   o += TN;
  L.kff = o;  o += TN;
  L.om = o;   o += round4(TN * D);   // mean tile [TN][D]
  L.ov = o;   o += round4(TN * D);   // var tile [TN][D]
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

template <int RM>
__global__ void __launch_bounds__(NT, 2)
conditional_fused_fwd(const float* __restrict__ pinvT, const float* __restrict__ kuf,
                      const float* __restrict__ qmu, const float* __restrict__ sqT,
                      const float* __restrict__ kff, float* __restrict__ mean,
                      float* __restrict__ var, long long n, int M, int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(MP, M, D);
  float* W = smem;
  float* T = smem + L.t;
  float* red = smem + L.red;
  float* t1s = smem + L.t1;
  float* kffS = smem + L.kff;
  float* outm = smem + L.om;  // [TN][D]
  float* outv = smem + L.ov;  // [TN][D]
  float* qm = smem + L.qm;    // [M][D]

  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * TN;
  const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);

  // stage q_mu, this tile's kff and kuf, and Pinv^T
  for (int e = tid; e < M * D; e += NT) qm[e] = __ldg(qmu + e);
  if (tid < TN) kffS[tid] = tid < nt ? __ldg(kff + p0 + tid) : 0.0f;
  load_tile<MP, TN>(T, kuf, n, p0, nt, M, tid);
  stage<MP>(W, pinvT, M, tid);
  __syncthreads();

  conditional_tile<RM>(W, T, red, t1s, outm, outv, qm, sqT, M, D, tid,
                       [kffS](int j) { return kffS[j]; });

  // outputs are [n][D] row-major: this tile is one contiguous run
  const long long base = p0 * D;
  for (int e = tid; e < nt * D; e += NT) {
    mean[base + e] = outm[e];
    var[base + e] = outv[e];
  }
}

// -- backward -------------------------------------------------------------------

struct BwdLayout {  // offsets in floats; total floats
  int ku, at, gb, red, t1, kff, gv, ss, gm, gvar, qm, dqm, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int MP, int M, int D) {
  BwdLayout L;
  int o = MP * MP;                        // W: the staged operand [MP][MP]
  L.ku = o;   o += MP * TS;               // kuf, then dKuf
  L.at = o;   o += MP * TS;               // a
  L.gb = o;   o += MP * TS;               // gb_d, then da
  L.red = o;  o += NWARP * TN;            // per-warp column partials
  L.t1 = o;   o += TN;
  L.kff = o;  o += TN;
  L.gv = o;   o += TN;                    // gv_d of the current d
  L.ss = o;   o += TN;                    // s = sum_d gv_d
  L.gm = o;   o += round4(TN * D);        // g_mean tile [TN][D]
  L.gvar = o; o += round4(TN * D);        // g_var tile [TN][D]
  L.qm = o;   o += round4(M * D);
  L.dqm = o;  o += round4(M * D);         // dq_mu, summed over this block's tiles
  L.total = o;
  return L;
}

inline long long bwd_smem_bytes(int M, int D) {
  return static_cast<long long>(sizeof(float)) * bwd_layout(padded_m(M), M, D).total;
}

inline bool bwd_fits(int M, int D) {
  return M >= 1 && M <= 128 && D >= 1 && bwd_smem_bytes(M, D) <= MAX_SMEM;
}

// Floats of one block's slab and of the summed output:
// dPinv [M][M], dSq [D][M][M], dq_mu [M][D].
__host__ __device__ inline long long slab_floats(int M, int D) {
  return static_cast<long long>(1 + D) * M * M + static_cast<long long>(M) * D;
}

template <int RM>
__global__ void __launch_bounds__(NT, 1)
conditional_fused_bwd(const float* __restrict__ pinvT, const float* __restrict__ kuf,
                      const float* __restrict__ qmu, const float* __restrict__ sqT,
                      const float* __restrict__ kff, const float* __restrict__ gmean,
                      const float* __restrict__ gvar, float* __restrict__ dkuf,
                      float* __restrict__ dkff, float* scratch, long long n, int M,
                      int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(MP, M, D);
  const BackwardTiles tiles{smem, smem + L.ku, smem + L.at, smem + L.gb,
                            smem + L.red, smem + L.t1, smem + L.gv, smem + L.ss,
                            smem + L.gm, smem + L.gvar, smem + L.qm, smem + L.dqm};
  float* W = tiles.W;
  float* KU = tiles.KU;
  float* sS = tiles.sS;
  float* kffS = smem + L.kff;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long MM = static_cast<long long>(M) * M;
  float* slab = scratch + blockIdx.x * slab_floats(M, D);
  float* s_dpinv = slab;
  float* s_dsq = slab + MM;
  float* s_dqm = s_dsq + D * MM;

  // once per block: q_mu, Pinv^T, and the block's dq_mu accumulator
  for (int e = tid; e < M * D; e += NT) {
    tiles.qm[e] = __ldg(qmu + e);
    tiles.dqmS[e] = 0.0f;
  }
  stage<MP>(W, pinvT, M, tid);

  const long long ntiles = (n + TN - 1) / TN;
  bool first = true;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first = false) {
    const long long p0 = tile * TN;
    const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);

    // this tile's kuf, kff and cotangents; points past n read as 0
    load_tile<MP, TS>(KU, kuf, n, p0, nt, M, tid);
    for (int e = tid; e < TN * D; e += NT) {
      const bool in = e < nt * D;
      tiles.gmS[e] = in ? __ldg(gmean + p0 * D + e) : 0.0f;
      tiles.gvarS[e] = in ? __ldg(gvar + p0 * D + e) : 0.0f;
    }
    if (tid < TN) {
      kffS[tid] = tid < nt ? __ldg(kff + p0 + tid) : 0.0f;
      sS[tid] = 0.0f;
    }
    __syncthreads();

    float acc[RM][4];  // dKuf = Pinv^T da
    conditional_tile_backward<RM>(tiles, pinvT, sqT, s_dpinv, s_dsq, M, D, first, tid,
                                  [kffS](int j) { return kffS[j]; }, acc);
    __syncthreads();  // every read of the kuf tile is done

    // dKuf over kuf, then out one contiguous run per row; dKff = s
#pragma unroll
    for (int r = 0; r < RM; ++r)
      *reinterpret_cast<float4*>(KU + (ty * RM + r) * TS + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    for (int e = tid; e < MP * TN; e += NT) {
      const int m = e / TN, j = e % TN;
      if (m < M && j < nt) dkuf[m * n + p0 + j] = KU[m * TS + j];
    }
    if (tid < nt) dkff[p0 + tid] = sS[tid];
    __syncthreads();  // the next tile overwrites KU, sS, kffS and the cotangents
  }

  // the block's dq_mu, which lived on chip, into its slab
  for (int e = tid; e < M * D; e += NT) s_dqm[e] = tiles.dqmS[e];
}

// -- host side ------------------------------------------------------------------

// f(Int<RM>) for the padded M
template <typename F>
auto dispatch(int M, F f) {
  return padded_m(M) == 64 ? f(Int<4>{}) : f(Int<8>{});
}

template <int RM>
cudaError_t launch_fwd(const float* pinvT, const float* kuf, const float* qmu,
                       const float* sqT, const float* kff, float* mean, float* var,
                       long long n, int M, int D, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(fwd_smem_bytes(M, D));
  auto kern = conditional_fused_fwd<RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + TN - 1) / TN);
  kern<<<grid, NT, bytes, stream>>>(pinvT, kuf, qmu, sqT, kff, mean, var, n, M, D);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_bwd(const float* pinvT, const float* kuf, const float* qmu,
                       const float* sqT, const float* kff, const float* gmean,
                       const float* gvar, float* dkuf, float* dkff, float* scratch,
                       long long n, int M, int D, int blocks, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M, D));
  auto kern = conditional_fused_bwd<RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NT, bytes, stream>>>(pinvT, kuf, qmu, sqT, kff, gmean, gvar, dkuf,
                                      dkff, scratch, n, M, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the forward's shared-memory plan covers (M, D), else 0: the wrapper's
// dispatch gate. The plan takes M <= 128 (padded to 64 or 128) and, at
// M = 128, D up to 128. The forward returns cudaErrorInvalidValue where this
// is 0.
int dgp_conditional_fused_supported(int M, int D) { return fits(M, D) ? 1 : 0; }

// The same for the backward's plan, which is larger (D up to 38 at M = 128).
int dgp_conditional_fused_bwd_supported(int M, int D) { return bwd_fits(M, D) ? 1 : 0; }

// Launches the forward on `stream`. pinvT = Pinv^T [M][M], kuf [M][n],
// qmu [M][D], sqT[d] = Sq[d]^T [D][M][M], kff [n]; mean and var [n][D]. All
// float32, contiguous, on one device. Returns cudaGetLastError().
int dgp_conditional_fused_fwd(const float* pinvT, const float* kuf, const float* qmu,
                              const float* sqT, const float* kff, float* mean,
                              float* var, long long n, int M, int D, void* stream) {
  if (n < 1 || !fits(M, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(M, [&](auto R) {
    return launch_fwd<decltype(R)::value>(pinvT, kuf, qmu, sqT, kff, mean, var, n, M,
                                          D, s);
  }));
}

// How many slabs of slab_floats(M, D) floats the backward needs as scratch
// for n points (its persistent grid). 0 if the sizes are outside the plan or
// CUDA reports an error.
int dgp_conditional_fused_bwd_blocks(long long n, int M, int D) {
  if (n < 1 || !bwd_fits(M, D)) return 0;
  return dispatch(M, [&](auto R) {
    return resident_blocks(conditional_fused_bwd<decltype(R)::value>,
                           static_cast<size_t>(bwd_smem_bytes(M, D)), n);
  });
}

// Launches the backward and then the slab reduction on `stream`. Inputs as
// the forward's, plus gmean, gvar [n][D]. Outputs: dkuf [M][n], dkff [n],
// and out [slab_floats] = dPinv [M][M], dSq [D][M][M] (in Sq's own layout),
// dq_mu [M][D]. scratch holds `blocks` slabs, with
// blocks = dgp_conditional_fused_bwd_blocks(...). Returns cudaGetLastError().
int dgp_conditional_fused_bwd(const float* pinvT, const float* kuf, const float* qmu,
                              const float* sqT, const float* kff, const float* gmean,
                              const float* gvar, float* dkuf, float* dkff,
                              float* scratch, float* out, long long n, int M, int D,
                              int blocks, void* stream) {
  if (n < 1 || !bwd_fits(M, D) || blocks < 1 || blocks > (n + TN - 1) / TN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(M, [&](auto R) {
    return launch_bwd<decltype(R)::value>(pinvT, kuf, qmu, sqT, kff, gmean, gvar, dkuf,
                                          dkff, scratch, n, M, D, blocks, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_slabs(scratch, out, blocks, slab_floats(M, D), s));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
