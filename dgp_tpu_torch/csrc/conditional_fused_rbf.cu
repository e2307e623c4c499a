// Fused whitened stationary-SVGP conditional, forward and backward, for
// Hopper (sm_90a).
//
// FORWARD. Replaces the TPU kernel
// dgp_tpu/ops/conditional_fused_rbf.py:_fwd_kernel.
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
//
// BACKWARD. Replaces the TPU kernel
// dgp_tpu/ops/conditional_fused_rbf.py:_bwd_kernel. Given the cotangents
// g_mean, g_var [n][D] it recomputes sq, kuf, a and b_d per point tile and
// chains them to every tensor input:
//
//   gv_d  = g_var_d where (v - t1) + t2_d > 0, else 0
//   gb_d  = 2 b_d gv_d
//   da    = sum_d Sq[d]^T gb_d - 2 a sum_d gv_d + q_mu g_mean^T
//   dkuf  = Pinv^T da
//   dPinv = da kuf^T       dq_mu = a g_mean       dSq[d] = gb_d a^T
//   dv    = sum(dkuf kuf) / v + sum(gv)           (Kuf = v f(sq), Kff = v)
//   dsq   = (dk/dsq) dkuf where sq > 0, else 0    (smooth Matern forms in sq)
//   dXs   = 2 Xs sum_m dsq - 2 dsq^T Zs           dZs = 2 Zs sum_n dsq - 2 dsq Xs
//
// What bounds it: 2 M^2 (3 + 3 D) FLOP per point on full squares (six M x M
// products per output, three times the forward) against 4 (2 Din + 2 D)
// bytes per point: fp32 arithmetic again, in plain IEEE FMA like the forward.
// What is new is that every output but dXs is a sum over all points. The TPU
// kernel zeroed its accumulators on grid step 0 and added into them on a grid
// that runs in order; here blocks run concurrently. One slab of partial sums
// per point tile would need (1 + D) M^2 floats for each 64 points (0.9 GB at
// n = 100,000, M = 128, D = 8), so instead:
//   * A persistent grid: as many blocks as the card holds at once (one per
//     SM at M = 128), block b taking tiles b, b + grid, b + 2 grid, ... The
//     assignment is static, so every sum has one fixed order.
//   * Each block owns one slab [(1 + D) M^2 + M Din + M D + 1] in device
//     memory (the wrapper's scratch: about 78 MB for 132 blocks at M = 128,
//     D = 8, Din = 8, whatever n is). dZs, dq_mu and dv accumulate in shared
//     memory and registers and are written once; the M x M sums dPinv and
//     dSq[d] do not fit in registers beside the products, so each tile's
//     da kuf^T and gb_d a^T are added into the slab by the thread that owns
//     the element (a read-modify-write only that thread ever touches; about
//     128 KB of traffic per tile per square, mostly from L2).
//   * A second kernel, reduce_slabs, adds the slabs in block order into the
//     outputs. No float atomics anywhere: two runs on the same inputs give
//     the same bits.
//   * Shared memory holds the staged operand W (64 KB at M = 128) and three
//     [MP][TN + 4] tiles: kuf (later dsq), a, and gb_d (later da); the row
//     stride is padded so the a gb^T products read both tiles without bank
//     conflicts. 196,160 bytes at M = 128, Din = D = 8: one block per SM.
//     Sq[d] is staged once per tile and read in both orientations
//     (b_d = Sq[d] a down its columns, Sq[d]^T gb_d along its rows); Pinv is
//     staged at the end of a tile for dkuf and stays for the next tile's a.
//   * Rows past n read g_mean = g_var = 0, which makes every one of their
//     contributions 0; padded rows of M hold kuf = 0 and are masked in dsq.
// The clamp masks are recomputed from (v - t1) + t2 and sq, as on the TPU.
// The steps after the kuf tile, forward and backward, are shared with the
// Kuf-consuming kernels (conditional_fused.cu) through conditional.cuh.

#include "conditional.cuh"

namespace {

struct Layout {
  int t, u, t1, om, ov, qm, total;  // offsets in floats; total floats
};

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

  const int tid = threadIdx.x;
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

  // phases 2-3: a, t1, mean, b_d and var (Kff == v)
  conditional_tile<RM>(W, T, red, t1s, outm, outv, qm, sqT, M, D, tid,
                       [v](int) { return v; });

  // outputs are [n][D] row-major: this tile is one contiguous run
  const long long base = p0 * D;
  for (int e = tid; e < nt * D; e += NT) {
    mean[base + e] = outm[e];
    var[base + e] = outv[e];
  }
}

// -- backward -------------------------------------------------------------------

struct BwdLayout {  // offsets in floats; total floats
  int ku, at, gb, zs, xs, xx, zz, red, t1, gv, ss, gm, gvar, qm, dzs, dqm, wsum, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int MP, int M, int Din, int D) {
  BwdLayout L;
  int o = MP * MP;                        // W: the staged operand [MP][MP]
  L.ku = o;   o += MP * TS;               // kuf, then dsq
  L.at = o;   o += MP * TS;               // a
  L.gb = o;   o += MP * TS;               // gb_d, then da
  L.zs = o;   o += round4(MP * Din);
  L.xs = o;   o += round4(Din * TN);      // xs^T [Din][TN]
  L.xx = o;   o += TN;
  L.zz = o;   o += MP;
  L.red = o;  o += NWARP * TN;            // per-warp column partials
  L.t1 = o;   o += TN;
  L.gv = o;   o += TN;                    // gv_d of the current d
  L.ss = o;   o += TN;                    // sum_d gv_d
  L.gm = o;   o += round4(TN * D);        // g_mean tile [TN][D]
  L.gvar = o; o += round4(TN * D);        // g_var tile [TN][D]
  L.qm = o;   o += round4(M * D);
  L.dzs = o;  o += round4(MP * Din);      // dZs, summed over this block's tiles
  L.dqm = o;  o += round4(M * D);         // dq_mu, likewise
  L.wsum = o; o += 2 * NWARP;
  L.total = o;
  return L;
}

inline long long bwd_smem_bytes(int M, int Din, int D) {
  return static_cast<long long>(sizeof(float)) * bwd_layout(padded_m(M), M, Din, D).total;
}

inline bool bwd_fits(int M, int Din, int D) {
  return M >= 1 && M <= 128 && Din >= 1 && D >= 1 && bwd_smem_bytes(M, Din, D) <= MAX_SMEM;
}

// Floats of one block's slab and of the summed output:
// dPinv [M][M], dSq [D][M][M], dZs [M][Din], dq_mu [M][D], dv.
__host__ __device__ inline long long slab_floats(int M, int Din, int D) {
  return static_cast<long long>(1 + D) * M * M + M * Din + M * D + 1;
}

template <int KIND>
__device__ __forceinline__ float dkuf_dsq(float v, float sq, float kuf) {
  if (KIND == 0) return -0.5f * kuf;
  const float r = sqrtf(sq);
  if (KIND == 1) return -(1.5f * v) * expf(-1.7320508075688772f * r);
  const float a = 2.2360679774997896f;
  return -((5.0f / 6.0f) * v) * (1.0f + a * r) * expf(-a * r);
}

template <int KIND, int RM>
__global__ void __launch_bounds__(NT, 1)
fused_bwd(const float* __restrict__ pinvT, const float* __restrict__ xs,
          const float* __restrict__ zs, const float* __restrict__ vptr,
          const float* __restrict__ qmu, const float* __restrict__ sqT,
          const float* __restrict__ gmean, const float* __restrict__ gvar,
          float* __restrict__ dxs, float* scratch,
          long long n, int M, int Din, int D) {
  constexpr int MP = 16 * RM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(MP, M, Din, D);
  const BackwardTiles tiles{smem, smem + L.ku, smem + L.at, smem + L.gb,
                            smem + L.red, smem + L.t1, smem + L.gv, smem + L.ss,
                            smem + L.gm, smem + L.gvar, smem + L.qm, smem + L.dqm};
  float* W = tiles.W;
  float* KU = tiles.KU;
  float* sS = tiles.sS;
  float* zsS = smem + L.zs;
  float* xsS = smem + L.xs;
  float* xx = smem + L.xx;
  float* zz = smem + L.zz;
  float* dzsS = smem + L.dzs;
  float* wsum = smem + L.wsum;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float v = __ldg(vptr);
  const long long MM = static_cast<long long>(M) * M;
  float* slab = scratch + blockIdx.x * slab_floats(M, Din, D);
  float* s_dpinv = slab;
  float* s_dsq = slab + MM;
  float* s_dzs = s_dsq + D * MM;
  float* s_dqm = s_dzs + M * Din;
  float* s_dv = s_dqm + M * D;

  // once per block: q_mu, Zs, Pinv^T, and the block's own accumulators
  for (int e = tid; e < M * D; e += NT) {
    tiles.qm[e] = __ldg(qmu + e);
    tiles.dqmS[e] = 0.0f;
  }
  for (int e = tid; e < MP * Din; e += NT) {
    zsS[e] = e < M * Din ? __ldg(zs + e) : 0.0f;
    dzsS[e] = 0.0f;
  }
  stage<MP>(W, pinvT, M, tid);
  __syncthreads();
  if (tid < MP) {
    float s = 0.0f;
    for (int c = 0; c < Din; ++c) s = fmaf(zsS[tid * Din + c], zsS[tid * Din + c], s);
    zz[tid] = s;
  }
  float dv_kuf = 0.0f;  // this thread's share of sum(dkuf * kuf)
  float dv_gv = 0.0f;   // and of sum(gv)

  const long long ntiles = (n + TN - 1) / TN;
  bool first = true;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first = false) {
    const long long p0 = tile * TN;
    const int nt = static_cast<int>(n - p0 < TN ? n - p0 : TN);

    // phase 0: this tile's points and cotangents; rows past n read as 0
    for (int e = tid; e < TN * Din; e += NT) {
      const int j = e / Din, c = e % Din;
      xsS[c * TN + j] = j < nt ? __ldg(xs + (p0 + j) * Din + c) : 0.0f;
    }
    for (int e = tid; e < TN * D; e += NT) {
      const bool in = e < nt * D;
      tiles.gmS[e] = in ? __ldg(gmean + p0 * D + e) : 0.0f;
      tiles.gvarS[e] = in ? __ldg(gvar + p0 * D + e) : 0.0f;
    }
    __syncthreads();
    if (tid < TN) {
      float s = 0.0f;
      for (int c = 0; c < Din; ++c) s = fmaf(xsS[c * TN + tid], xsS[c * TN + tid], s);
      xx[tid] = s;
      sS[tid] = 0.0f;
    }
    __syncthreads();

    // phase 1: the kuf tile; padded rows are 0
    for (int e = tid; e < MP * TN; e += NT) {
      const int m = e / TN, j = e % TN;
      float k = 0.0f;
      if (m < M) {
        float cross = 0.0f;
        for (int c = 0; c < Din; ++c) cross = fmaf(zsS[m * Din + c], xsS[c * TN + j], cross);
        k = kuf_of<KIND>(v, fmaxf((xx[j] - 2.0f * cross) + zz[m], 0.0f));
      }
      KU[m * TS + j] = k;
    }
    __syncthreads();

    // phases 2-4: a, t1, b_d and the clamp mask per output, the slab sums
    // dSq and dPinv, dq_mu; dkuf into acc (Kff == v)
    float acc[RM][4];
    conditional_tile_backward<RM>(tiles, pinvT, sqT, s_dpinv, s_dsq, M, D, first, tid,
                                  [v](int) { return v; }, acc);
    __syncthreads();  // every read of the kuf tile is done

    // dv's kuf share, and dsq over kuf in place (own elements only)
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty * RM + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + c;
        const float k = KU[row * TS + col];
        dv_kuf = fmaf(acc[r][c], k, dv_kuf);
        float ds = 0.0f;
        if (row < M) {
          float cross = 0.0f;
          for (int q = 0; q < Din; ++q) cross = fmaf(zsS[row * Din + q], xsS[q * TN + col], cross);
          const float sq = fmaxf((xx[col] - 2.0f * cross) + zz[row], 0.0f);
          if (sq > 0.0f) ds = dkuf_dsq<KIND>(v, sq, k) * acc[r][c];
        }
        KU[row * TS + col] = ds;
      }
    }
    if (tid < TN) dv_gv += sS[tid];
    __syncthreads();

    // dXs = 2 xs sum_m dsq - 2 dsq^T zs: this tile's rows, one contiguous run
    for (int o = tid; o < nt * Din; o += NT) {
      const int j = o / Din, c = o % Din;
      float s1 = 0.0f, s2 = 0.0f;
      for (int m = 0; m < M; ++m) {
        const float ds = KU[m * TS + j];
        s1 += ds;
        s2 = fmaf(ds, zsS[m * Din + c], s2);
      }
      dxs[p0 * Din + o] = 2.0f * xsS[c * TN + j] * s1 - 2.0f * s2;
    }
    // dZs += 2 zs sum_n dsq - 2 dsq xs
    for (int e = tid; e < M * Din; e += NT) {
      const int m = e / Din, c = e % Din;
      float s1 = 0.0f, s2 = 0.0f;
      for (int j = 0; j < TN; ++j) {
        const float ds = KU[m * TS + j];
        s1 += ds;
        s2 = fmaf(ds, xsS[c * TN + j], s2);
      }
      dzsS[e] += 2.0f * zsS[e] * s1 - 2.0f * s2;
    }
    __syncthreads();  // the next tile overwrites KU, xsS, gmS
  }

  // the block's sums that lived on chip, into its slab
  for (int e = tid; e < M * Din; e += NT) s_dzs[e] = dzsS[e];
  for (int e = tid; e < M * D; e += NT) s_dqm[e] = tiles.dqmS[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dv_kuf += __shfl_down_sync(0xffffffffu, dv_kuf, off);
    dv_gv += __shfl_down_sync(0xffffffffu, dv_gv, off);
  }
  if ((tid & 31) == 0) {
    wsum[tid >> 5] = dv_kuf;
    wsum[NWARP + (tid >> 5)] = dv_gv;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < NWARP; ++w) {
      a += wsum[w];
      b += wsum[NWARP + w];
    }
    *s_dv = a / v + b;
  }
}

// -- host side ------------------------------------------------------------------

// f(Int<KIND>, Int<RM>) for the kernel kind and the padded M
template <typename F>
auto dispatch(int kind, int M, F f) {
  const bool small = padded_m(M) == 64;
  switch (kind) {
    case 0: return small ? f(Int<0>{}, Int<4>{}) : f(Int<0>{}, Int<8>{});
    case 1: return small ? f(Int<1>{}, Int<4>{}) : f(Int<1>{}, Int<8>{});
    default: return small ? f(Int<2>{}, Int<4>{}) : f(Int<2>{}, Int<8>{});
  }
}

template <int KIND, int RM>
cudaError_t launch_fwd(const float* pinvT, const float* xs, const float* zs,
                       const float* v, const float* qmu, const float* sqT,
                       float* mean, float* var, long long n, int M, int Din, int D,
                       cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(smem_bytes(M, Din, D));
  auto kern = fused_fwd<KIND, RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n + TN - 1) / TN);
  kern<<<grid, NT, bytes, stream>>>(pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D);
  return cudaGetLastError();
}

template <int KIND, int RM>
cudaError_t launch_bwd(const float* pinvT, const float* xs, const float* zs,
                       const float* v, const float* qmu, const float* sqT,
                       const float* gmean, const float* gvar, float* dxs,
                       float* scratch, long long n, int M, int Din, int D,
                       int blocks, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M, Din, D));
  auto kern = fused_bwd<KIND, RM>;
  const cudaError_t err = allow_shared_memory(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<blocks, NT, bytes, stream>>>(pinvT, xs, zs, v, qmu, sqT, gmean, gvar, dxs,
                                      scratch, n, M, Din, D);
  return cudaGetLastError();
}

// Blocks the card holds at once for this backward kernel (its persistent
// grid), capped at the number of point tiles; 0 on a CUDA error.
template <int KIND, int RM>
int bwd_resident_blocks(long long n, int M, int Din, int D) {
  return resident_blocks(fused_bwd<KIND, RM>, static_cast<size_t>(bwd_smem_bytes(M, Din, D)), n);
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
  return static_cast<int>(dispatch(kind, M, [&](auto K, auto R) {
    return launch_fwd<decltype(K)::value, decltype(R)::value>(
        pinvT, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D, s);
  }));
}

// 1 if the forward's shared-memory plan covers (M, Din, D), else 0: the
// wrapper's dispatch gate. The forward returns cudaErrorInvalidValue where
// it is 0.
int dgp_fused_rbf_supported(int M, int Din, int D) { return fits(M, Din, D) ? 1 : 0; }

// The same for the backward's plan, which is larger.
int dgp_fused_rbf_bwd_supported(int M, int Din, int D) { return bwd_fits(M, Din, D) ? 1 : 0; }

// How many slabs of slab_floats(M, Din, D) floats the backward needs as
// scratch for n points: its persistent grid. 0 if the sizes are outside the
// plan or CUDA reports an error.
int dgp_fused_rbf_bwd_blocks(int kind, long long n, int M, int Din, int D) {
  if (kind < 0 || kind > 2 || n < 1 || !bwd_fits(M, Din, D)) return 0;
  return dispatch(kind, M, [&](auto K, auto R) {
    return bwd_resident_blocks<decltype(K)::value, decltype(R)::value>(n, M, Din, D);
  });
}

// Launches the backward and then the slab reduction on `stream`. Inputs as
// the forward's, plus gmean, gvar [n][D]. Outputs: dxs [n][Din], and out
// [slab_floats] = dPinv [M][M], dSq [D][M][M] (in Sq's own layout),
// dZs [M][Din], dq_mu [M][D], dv. scratch holds `blocks` slabs, with
// blocks = dgp_fused_rbf_bwd_blocks(...). Returns cudaGetLastError().
int dgp_fused_rbf_bwd(int kind, const float* pinvT, const float* xs,
                      const float* zs, const float* v, const float* qmu,
                      const float* sqT, const float* gmean, const float* gvar,
                      float* dxs, float* scratch, float* out, long long n,
                      int M, int Din, int D, int blocks, void* stream) {
  if (kind < 0 || kind > 2 || n < 1 || !bwd_fits(M, Din, D) || blocks < 1 ||
      blocks > (n + TN - 1) / TN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(kind, M, [&](auto K, auto R) {
    return launch_bwd<decltype(K)::value, decltype(R)::value>(
        pinvT, xs, zs, v, qmu, sqT, gmean, gvar, dxs, scratch, n, M, Din, D, blocks, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_slabs(scratch, out, blocks, slab_floats(M, Din, D), s));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
