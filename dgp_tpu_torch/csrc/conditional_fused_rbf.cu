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
// What bounds it: the function needs 2 M Din + (1 + D) M (M + 1) + 4 M D
// FLOP per point (Pinv and Sq are triangular on the whitened path) against
// about 4 (Din + 2 D) bytes, so at every shape the model serves it is bound
// by arithmetic, not by memory. a and t1 stay IEEE fp32 FMA (no TF32):
// ||a||^2 cancels against v, and TF32's 1e-3 error in a would swamp the
// variance. The D products b_d = Sq[d] a only add to the variance; they are
// D/(D + 1) of the work and run on the tensor cores in 3xTF32 (each operand
// split into a TF32 hi and lo part, lo hi + hi lo + hi hi in fp32), which
// keeps about fp32's precision. What the design does (conditional.cuh's
// tile_forward, shared with conditional_fused.cu):
//   * A persistent grid of one block of 256 threads per SM walks tiles of
//     128 points; neither kuf, a nor b reaches device memory.
//   * Pinv and tril(q_sqrt[d]) = Sq[d]^T (the wrapper passes both as they
//     are) are staged as packed lower triangles through a two-buffer
//     cp.async ring, the next operand landing while the current one is
//     used; only those triangles are read.
//   * Per tile: the kuf tile (16 points by MP / 32 rows a thread), a = Pinv kuf
//     by triangular FMA products over kuf in place, t1 from registers; per
//     output d one barrier, and b_d in m16n8k8 mma.sync tiles that skip the
//     blocks above Sq's diagonal, its sums of squares reduced from the
//     accumulators; then the tile's var and mean, each as one contiguous
//     run. Every sum in a fixed order, no atomics: repeats are bit-equal.
//   * At M = 128, Din = D = 8 a block holds 158 KB of shared memory (the
//     ring 66 KB, the [128][136] tile, q_mu, Zs and the points): one block
//     per SM, D up to 80 at Din = 8, wider than the backward's plan.
// The tensor-core products use mma.sync; wgmma and TMA, the route to the
// tensor cores' full rate, are later work.
//
// BACKWARD. Replaces the TPU kernel
// dgp_tpu/ops/conditional_fused_rbf.py:_bwd_kernel. Given the cotangents
// g_mean, g_var [n][D] it recomputes sq, kuf, a and b_d per point tile and
// chains them to every tensor input:
//
//   gv_d  = g_var_d where (v - t1) + t2_d > 0, else 0
//   da    = sum_d Sq[d]^T (2 b_d gv_d) - 2 a sum_d gv_d + q_mu g_mean^T
//   dkuf  = Pinv^T da      dq_mu = a g_mean
//   dv    = sum(dkuf kuf) / v + sum(gv)           (Kuf = v f(sq), Kff = v)
//   dsq   = (dk/dsq) dkuf where sq > 0, else 0    (smooth Matern forms in sq)
//   dXs   = 2 sum_m dsq (Xs - Zs)                 dZs = 2 sum_n dsq (Zs - Xs)
//   dPinv = tril(da kuf^T)  dSq[d] = triu(2 Sq[d] a diag(gv_d) a^T)  (sums over n)
//
// It assumes Pinv lower- and Sq upper-triangular (Lu^{-1} and tril(q_sqrt)^T
// on the whitened path) and returns dPinv and dSq on those patterns: only
// they reach a parameter. What bounds it: with the triangles' zero halves
// skipped, (2 + 2 D) M (M + 1) FLOP per point in the tile products and
// (1 + D) M (M + 1) in the sums over points, against 4 (2 Din + 2 D) bytes
// per point: fp32 arithmetic, in plain IEEE FMA like the forward. The TPU
// kernel kept the M x M sums in scratch across a grid that runs in order;
// blocks here run concurrently, and a per-tile read-modify-write of such
// sums in device memory (1.8 GB per call at L1) was what held the first
// port of this kernel back. So it runs in two phases (conditional.cuh):
//   * Phase A (fused_bwd_a): a persistent grid of one 256-thread block per
//     SM walks tiles of 128 points. Per tile it builds kuf from the points
//     (and writes it to scratch for phase B), runs conditional.cuh's
//     tile_backward (a, t1, per d b_d, the mask and da, all triangular
//     products on operands staged as packed triangles through a cp.async
//     ring), then dsq over dkuf in shared memory, dXs for the tile's rows,
//     and the tile's slot of dZs, dq_mu and dv. No M x M sum is kept.
//   * Phase B (gram_bwd, reduce_parts, gram_finish): the Grams
//     a diag(gv_d) a^T and da kuf^T over all points as split-K products,
//     one slot per slice of 1,024 points added in slice order, then
//     dSq[d] = triu(2 Sq[d] C_d) and tril(dPinv).
//   * The tiles' small sums are added in tile order (reduce_parts). No float
//     atomics: two runs on the same inputs give the same bits. The wrapper
//     passes points in passes of 2^17 (ops/_launch.py), which bound the
//     scratch (A, dA, Kuf [M][pass], gv [D][pass] and phase B's slots:
//     222 MB at M = 128, D = 8, n = 100,000), and adds the passes' sums in
//     order.
//   * Shared memory at M = 128, Din = D = 8: the ring (2 x 33 KB), the kuf /
//     gb / da tile and the a tile ([128][132] each), q_mu, g_mean, Zs and
//     the points: 225,408 bytes, one block per SM (D + Din up to 22).
//   * Rows past n read g_mean = g_var = 0, which makes every one of their
//     contributions 0; padded rows of M hold kuf = 0 and are masked in dsq.
// The clamp masks are recomputed from (v - t1) + t2 and sq, as on the TPU.

#include "conditional.cuh"

namespace {

struct FwdLayout {  // offsets in floats; total floats
  int ring1, t, red, t1s, out, qm, zs, xs, zz, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int MP, int M, int Din, int D) {
  FwdLayout L;
  int o = tri_off(MP);                    // ring buffer 0: a packed triangle
  L.ring1 = o; o += tri_off(MP);          // ring buffer 1
  L.t = o;    o += MP * FTS;              // kuf, then a
  L.red = o;  o += BRED * BTN;            // per-point column partials
  L.t1s = o;  o += BTN;
  L.out = o;  o += round4(BTN * D);       // the tile's var, then mean [BTN][D]
  L.qm = o;   o += round4(M * D);
  L.zs = o;   o += round4(MP * Din);
  L.xs = o;   o += round4(Din * BTN);     // xs^T [Din][BTN]
  L.zz = o;   o += MP;
  L.total = o;
  return L;
}

// Shared memory one block of the forward needs, in bytes.
inline long long smem_bytes(int M, int Din, int D) {
  return static_cast<long long>(sizeof(float)) * fwd_layout(padded_m(M), M, Din, D).total;
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

// The forward over n points: a persistent grid, each block walking tiles of
// BTN points; per tile the kuf tile from the points, then tile_forward, then
// the tile's outputs.
template <int KIND, int MP>
__global__ void __launch_bounds__(BNT, 1)
fused_fwd(const float* __restrict__ pinv, const float* __restrict__ xs,
          const float* __restrict__ zs, const float* __restrict__ vptr,
          const float* __restrict__ qmu, const float* __restrict__ sqT,
          float* __restrict__ mean, float* __restrict__ var, long long n, int M,
          int Din, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(MP, M, Din, D);
  const ForwardTiles t{smem + L.t, smem + L.red, smem + L.t1s, smem + L.out, smem + L.qm};
  float* zsS = smem + L.zs;
  float* xsS = smem + L.xs;
  float* zz = smem + L.zz;
  Ring ring{{smem, smem + L.ring1}, pinv, sqT, static_cast<long long>(M) * M, M, D, D + 1, 0};

  const int tid = threadIdx.x;
  const float v = __ldg(vptr);

  // once per block: q_mu, Zs, ||z||^2, and the ring's first operand
  ring.start<MP>(tid);
  for (int e = tid; e < M * D; e += BNT) t.qm[e] = __ldg(qmu + e);
  for (int e = tid; e < MP * Din; e += BNT) zsS[e] = e < M * Din ? __ldg(zs + e) : 0.0f;
  __syncthreads();
  if (tid < MP) {
    float s = 0.0f;
    for (int c = 0; c < Din; ++c) s = fmaf(zsS[tid * Din + c], zsS[tid * Din + c], s);
    zz[tid] = s;
  }

  const long long ntiles = (n + BTN - 1) / BTN;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BTN;
    const int nt = static_cast<int>(n - p0 < BTN ? n - p0 : BTN);

    // this tile's points; rows past n read as 0
    for (int e = tid; e < BTN * Din; e += BNT) {
      const int j = e / Din, c = e % Din;
      xsS[c * BTN + j] = j < nt ? __ldg(xs + (p0 + j) * Din + c) : 0.0f;
    }
    __syncthreads();

    // the kuf tile, zero past M and past n: a thread owns 16 points
    // (columns 32 u + 4 q + w, u and w < 4) of MP / 32 rows (32 r + m0), so
    // each point's x is read once and feeds every row; every k(sq) is
    // computed and then selected, so the exponentials interleave
    {
      constexpr int ROWS = MP / 32;
      const int m0 = tid / (BTN / 16), q = tid % (BTN / 16);
      float cross[ROWS][16] = {}, xx[16] = {};
#pragma unroll 4
      for (int c = 0; c < Din; ++c) {
        float x[16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float x4[4];
          lds4(xsS + c * BTN + 32 * u + 4 * q, x4);
#pragma unroll
          for (int w = 0; w < 4; ++w) x[4 * u + w] = x4[w];
        }
#pragma unroll
        for (int p = 0; p < 16; ++p) xx[p] = fmaf(x[p], x[p], xx[p]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float z = zsS[(32 * r + m0) * Din + c];
#pragma unroll
          for (int p = 0; p < 16; ++p) cross[r][p] = fmaf(z, x[p], cross[r][p]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int m = 32 * r + m0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float k[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int p = 4 * u + w;
            const float kv = kuf_of<KIND>(v, fmaxf((xx[p] - 2.0f * cross[r][p]) + zz[m], 0.0f));
            k[w] = m < M && 32 * u + 4 * q + w < nt ? kv : 0.0f;
          }
          *reinterpret_cast<float4*>(t.T + m * FTS + 32 * u + 4 * q) =
              make_float4(k[0], k[1], k[2], k[3]);
        }
      }
    }

    tile_forward<MP>(t, ring, M, D, tid, [v](int) { return v; }, mean + p0 * D,
                     var + p0 * D, nt);
  }
  cp_async_wait_all();
}

// -- backward -------------------------------------------------------------------

struct BwdLayout {  // offsets in floats; total floats
  int ring1, t1, t2, red, t1s, ss, gm, qm, zs, xs, xx, zz, wsum, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int MP, int M, int Din, int D) {
  BwdLayout L;
  int o = tri_off(MP);                    // ring buffer 0: a packed triangle
  L.ring1 = o; o += tri_off(MP);          // ring buffer 1
  L.t1 = o;   o += MP * BTS;              // kuf, then gb_d, da, dsq
  L.t2 = o;   o += MP * BTS;              // a
  L.red = o;  o += BRED * BTN;            // per-point column partials
  L.t1s = o;  o += BTN;
  L.ss = o;   o += BTN;                   // sum_d gv_d
  L.gm = o;   o += round4(BTN * D);       // g_mean tile, transposed [D][BTN]
  L.qm = o;   o += round4(M * D);
  L.zs = o;   o += round4(MP * Din);
  L.xs = o;   o += round4(Din * BTN);     // xs^T [Din][BTN]
  L.xx = o;   o += BTN;
  L.zz = o;   o += MP;
  L.wsum = o; o += 2 * (BNT / 32);
  L.total = o;
  return L;
}

inline long long bwd_smem_bytes(int M, int Din, int D) {
  return static_cast<long long>(sizeof(float)) * bwd_layout(padded_m(M), M, Din, D).total;
}

inline bool bwd_fits(int M, int Din, int D) {
  return M >= 1 && M <= 128 && Din >= 1 && D >= 1 && bwd_smem_bytes(M, Din, D) <= MAX_SMEM;
}

// Floats of one tile's slot of small sums (and of their total):
// dZs [M][Din], dq_mu [M][D], dv.
__host__ __device__ inline long long small_floats(int M, int Din, int D) {
  return static_cast<long long>(M) * Din + static_cast<long long>(M) * D + 1;
}

template <int KIND>
__device__ __forceinline__ float dkuf_dsq(float v, float sq, float kuf) {
  if (KIND == 0) return -0.5f * kuf;
  const float r = sqrtf(sq);
  if (KIND == 1) return -(1.5f * v) * expf(-1.7320508075688772f * r);
  const float a = 2.2360679774997896f;
  return -((5.0f / 6.0f) * v) * (1.0f + a * r) * expf(-a * r);
}

// Phase A of the backward over n points (one chunk): per tile of BTN points
// the kuf tile, tile_backward, then dsq, dXs and the tile's slot of small
// sums. Writes kuf [M][ld] for phase B beside a, da and gv.
template <int KIND, int MP>
__global__ void __launch_bounds__(BNT, 1)
fused_bwd_a(const float* __restrict__ pinv, const float* __restrict__ xs,
            const float* __restrict__ zs, const float* __restrict__ vptr,
            const float* __restrict__ qmu, const float* __restrict__ sqT,
            const float* __restrict__ gmean, const float* __restrict__ gvar,
            float* __restrict__ dxs, float* __restrict__ a_s, float* __restrict__ da_s,
            float* __restrict__ kuf_s, float* __restrict__ gv_s, long long ld,
            float* __restrict__ parts, long long n, int M, int Din, int D) {
  constexpr int G = MP / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(MP, M, Din, D);
  const BackwardTiles t{smem + L.t1, smem + L.t2, smem + L.red, smem + L.t1s,
                        smem + L.ss, smem + L.gm, smem + L.qm};
  float* zsS = smem + L.zs;
  float* xsS = smem + L.xs;
  float* xx = smem + L.xx;
  float* zz = smem + L.zz;
  float* wsum = smem + L.wsum;
  const long long MM = static_cast<long long>(M) * M;
  Ring ring{{smem, smem + L.ring1}, pinv, sqT, MM, M, D, D + 2, 0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  const float v = __ldg(vptr);
  const long long slot = small_floats(M, Din, D);

  // once per block: q_mu, Zs, ||z||^2, and the ring's first operand
  ring.start<MP>(tid);
  for (int e = tid; e < M * D; e += BNT) t.qm[e] = __ldg(qmu + e);
  for (int e = tid; e < MP * Din; e += BNT) zsS[e] = e < M * Din ? __ldg(zs + e) : 0.0f;
  __syncthreads();
  if (tid < MP) {
    float s = 0.0f;
    for (int c = 0; c < Din; ++c) s = fmaf(zsS[tid * Din + c], zsS[tid * Din + c], s);
    zz[tid] = s;
  }

  const long long ntiles = (n + BTN - 1) / BTN;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * BTN;
    const int nt = static_cast<int>(n - p0 < BTN ? n - p0 : BTN);
    float* small = parts + tile * slot;

    // this tile's points and g_mean; rows past n read as 0
    for (int e = tid; e < BTN * Din; e += BNT) {
      const int j = e / Din, c = e % Din;
      xsS[c * BTN + j] = j < nt ? __ldg(xs + (p0 + j) * Din + c) : 0.0f;
    }
    for (int e = tid; e < BTN * D; e += BNT)
      t.gmS[(e % D) * BTN + e / D] = e < nt * D ? __ldg(gmean + p0 * D + e) : 0.0f;
    __syncthreads();
    if (tid < BTN) {
      float s = 0.0f;
      for (int c = 0; c < Din; ++c) s = fmaf(xsS[c * BTN + tid], xsS[c * BTN + tid], s);
      xx[tid] = s;
    }
    __syncthreads();

    // the kuf tile, zero past M and past n, also into kuf_s for phase B
    for (int e = tid; e < MP * BTN; e += BNT) {
      const int m = e / BTN, j = e % BTN;
      float k = 0.0f;
      if (m < M && j < nt) {
        float cross = 0.0f;
        for (int c = 0; c < Din; ++c) cross = fmaf(zsS[m * Din + c], xsS[c * BTN + j], cross);
        k = kuf_of<KIND>(v, fmaxf((xx[j] - 2.0f * cross) + zz[m], 0.0f));
      }
      t.T1[m * BTS + j] = k;
      if (m < M) kuf_s[m * ld + p0 + j] = k;
    }

    // a, t1, b_d and the clamp mask per output, da, dq_mu; dkuf into acc
    float acc[2 * G][8];
    tile_backward<MP, G>(t, ring, gvar + p0 * D, nt, a_s + p0, da_s + p0, gv_s + p0, ld,
                         small + static_cast<long long>(M) * Din, M, D, tid,
                         [v](int) { return v; }, acc);
    __syncthreads();  // every read of da in T1 is done
#pragma unroll
    for (int r = 0; r < 2 * G; ++r) sts8(t.T1 + row_of<MP, G>(ty, r) * BTS, tx, acc[r]);

    // dv's kuf share, and dsq = (dk/dsq) dkuf where sq > 0 over dkuf in T1
    // (this thread's own elements)
    float dv_kuf = 0.0f;
#pragma unroll 1
    for (int e = 0; e < 16 * G; ++e) {
      const int row = row_of<MP, G>(ty, e >> 3), col = col_of(tx, e & 7);
      float& cell = t.T1[row * BTS + col];
      float ds = 0.0f;
      if (row < M && col < nt) {
        float cross = 0.0f;
        for (int q = 0; q < Din; ++q)
          cross = fmaf(zsS[row * Din + q], xsS[q * BTN + col], cross);
        const float sq = fmaxf((xx[col] - 2.0f * cross) + zz[row], 0.0f);
        const float k = kuf_of<KIND>(v, sq);
        dv_kuf = fmaf(cell, k, dv_kuf);
        if (sq > 0.0f) ds = dkuf_dsq<KIND>(v, sq, k) * cell;
      }
      cell = ds;
    }
    float dv_gv = tid < BTN ? t.sS[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dv_kuf += __shfl_down_sync(0xffffffffu, dv_kuf, off);
      dv_gv += __shfl_down_sync(0xffffffffu, dv_gv, off);
    }
    if (lane == 0) {
      wsum[warp] = dv_kuf;
      wsum[BNT / 32 + warp] = dv_gv;
    }
    __syncthreads();

    // dXs = 2 sum_m dsq (xs - zs): this tile's rows, one contiguous run.
    // Summed over the differences, not as 2 xs sum dsq - 2 dsq^T zs: the
    // two sums are large and cancel
    for (int o = tid; o < nt * Din; o += BNT) {
      const int j = o / Din, c = o % Din;
      const float x = xsS[c * BTN + j];
      float s = 0.0f;
      for (int m = 0; m < M; ++m) s = fmaf(t.T1[m * BTS + j], x - zsS[m * Din + c], s);
      dxs[p0 * Din + o] = 2.0f * s;
    }
    // the tile's dZs = 2 sum_n dsq (zs - xs) (a lane per row m, as
    // row_dots; points past the tile's nt hold dsq = 0), and dv
    for (int item = warp, blocks = (M + 31) / 32; item < blocks * Din;
         item += BNT / 32) {
      const int m = 32 * (item % blocks) + lane, c = item / blocks;
      if (m >= M) continue;
      const float z = zsS[m * Din + c];
      float s = 0.0f;
#pragma unroll 4
      for (int j = 0; j < BTN; j += 4) {
        float ds[4], x[4];
        lds4(t.T1 + m * BTS + j, ds);
        lds4(xsS + c * BTN + j, x);
        s = fmaf(ds[3], z - x[3], fmaf(ds[2], z - x[2], fmaf(ds[1], z - x[1],
                 fmaf(ds[0], z - x[0], s))));
      }
      small[m * Din + c] = 2.0f * s;
    }
    if (tid == 0) {
      float a = 0.0f, b = 0.0f;
      for (int w = 0; w < BNT / 32; ++w) {
        a += wsum[w];
        b += wsum[BNT / 32 + w];
      }
      small[slot - 1] = a / v + b;
    }
    __syncthreads();  // the next tile overwrites T1, xsS, gmS and wsum
  }
  cp_async_wait_all();
}

// -- host side ------------------------------------------------------------------

// f(Int<KIND>, Int<MP>) for the kernel kind and the padded M
template <typename F>
auto dispatch(int kind, int M, F f) {
  const bool small = padded_m(M) == 64;
  switch (kind) {
    case 0: return small ? f(Int<0>{}, Int<64>{}) : f(Int<0>{}, Int<128>{});
    case 1: return small ? f(Int<1>{}, Int<64>{}) : f(Int<1>{}, Int<128>{});
    default: return small ? f(Int<2>{}, Int<64>{}) : f(Int<2>{}, Int<128>{});
  }
}

}  // namespace

extern "C" {

// The forward's persistent grid: the blocks of its plan for (kind, M, Din,
// D) that the card holds at once (the wrapper asks once per device and
// sizes). 0 if the sizes are outside the plan or CUDA reports an error.
int dgp_fused_rbf_fwd_blocks(int kind, int M, int Din, int D) {
  if (kind < 0 || kind > 2 || !fits(M, Din, D)) return 0;
  return dispatch(kind, M, [&](auto K, auto P) {
    return resident_count<BNT>(fused_fwd<decltype(K)::value, decltype(P)::value>,
                               static_cast<size_t>(smem_bytes(M, Din, D)));
  });
}

// Launches the forward on `stream` as min(blocks, tiles of n) blocks, blocks
// from dgp_fused_rbf_fwd_blocks. pinv = Pinv [M][M] (lower-triangular: only
// its lower triangle is read), xs [n][Din], zs [M][Din], v [1], qmu [M][D],
// sqT[d] = tril(q_sqrt[d]) = Sq[d]^T [D][M][M] (only its lower triangle is
// read); mean and var [n][D]. All float32, contiguous, on one device.
// Returns cudaGetLastError().
int dgp_fused_rbf_fwd(int kind, const float* pinv, const float* xs,
                      const float* zs, const float* v, const float* qmu,
                      const float* sqT, float* mean, float* var, long long n,
                      int M, int Din, int D, int blocks, void* stream) {
  if (kind < 0 || kind > 2 || n < 1 || !fits(M, Din, D) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (n + BTN - 1) / BTN;
  const int grid = static_cast<int>(ntiles < blocks ? ntiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem_bytes(M, Din, D));
  return static_cast<int>(dispatch(kind, M, [&](auto K, auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = fused_fwd<decltype(K)::value, decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<grid, BNT, bytes, s>>>(pinv, xs, zs, v, qmu, sqT, mean, var, n, M, Din, D);
    return cudaGetLastError();
  }));
}

// 1 if the forward's shared-memory plan covers (M, Din, D), else 0: the
// wrapper's dispatch gate. The forward returns cudaErrorInvalidValue where
// it is 0.
int dgp_fused_rbf_supported(int M, int Din, int D) { return fits(M, Din, D) ? 1 : 0; }

// The same for the backward's plan, which is larger.
int dgp_fused_rbf_bwd_supported(int M, int Din, int D) { return bwd_fits(M, Din, D) ? 1 : 0; }

// Phase A's persistent grid for n points (one chunk): the blocks the card
// holds at once, capped at the number of tiles. 0 if the sizes are outside
// the plan or CUDA reports an error.
int dgp_fused_rbf_bwd_blocks(int kind, long long n, int M, int Din, int D) {
  if (kind < 0 || kind > 2 || n < 1 || !bwd_fits(M, Din, D)) return 0;
  return dispatch(kind, M, [&](auto K, auto P) {
    return resident_blocks<BNT, BTN>(fused_bwd_a<decltype(K)::value, decltype(P)::value>,
                                     static_cast<size_t>(bwd_smem_bytes(M, Din, D)), n);
  });
}

// Points per phase-A tile and per phase-B slice: the wrapper sizes its
// scratch with them.
int dgp_fused_rbf_bwd_tile() { return BTN; }
int dgp_fused_rbf_bwd_slice() { return GKB; }

// Phase A of the backward on the n points of one chunk, then the tiles'
// small sums added in tile order into small [M Din + M D + 1] = dZs, dq_mu,
// dv (added to what small holds if accumulate). Inputs as the forward's but
// pinv = Pinv [M][M] itself (lower-triangular) and sqT[d] = tril(q_sqrt[d]),
// plus gmean, gvar [n][D]; xs, gmean, gvar and dxs [n][Din] start at the
// chunk. Writes a_s, da_s, kuf_s [M][ld] and gv_s [D][ld] (ld a multiple of
// the tile, at least the chunk's tiles) for phase B; parts holds
// ceil(n / tile) slots of small sums. Returns cudaGetLastError().
int dgp_fused_rbf_bwd_a(int kind, const float* pinv, const float* xs, const float* zs,
                        const float* v, const float* qmu, const float* sqT,
                        const float* gmean, const float* gvar, float* dxs, float* a_s,
                        float* da_s, float* kuf_s, float* gv_s, long long ld, float* parts,
                        float* small, long long n, int M, int Din, int D, int blocks,
                        int accumulate, void* stream) {
  const long long ntiles = (n + BTN - 1) / BTN;
  if (kind < 0 || kind > 2 || n < 1 || !bwd_fits(M, Din, D) || blocks < 1 ||
      blocks > ntiles || ld < ntiles * BTN || ld % BTN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(bwd_smem_bytes(M, Din, D));
  const cudaError_t err = dispatch(kind, M, [&](auto K, auto P) {
    static std::atomic<unsigned long long> allowed{0};
    auto kern = fused_bwd_a<decltype(K)::value, decltype(P)::value>;
    const cudaError_t e = allow_shared_memory_once(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<blocks, BNT, bytes, s>>>(pinv, xs, zs, v, qmu, sqT, gmean, gvar, dxs, a_s, da_s,
                                    kuf_s, gv_s, ld, parts, n, M, Din, D);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_parts(parts, small, static_cast<int>(ntiles),
                                              small_floats(M, Din, D), 0, accumulate != 0, s));
}

// Phase B on the n points of one chunk: gram [(D + 1)][M][M] (+)= the lower
// triangles of C_d = A diag(gv_d) A^T and of dA Kuf^T over those points
// (phase A's a_s, da_s, gv_s at row stride ld, Kuf at ldk), summed slice by
// slice in order; parts holds ceil(n / slice) (D + 1) M^2 floats.
int dgp_fused_rbf_bwd_gram(const float* a_s, const float* da_s, long long ld,
                           const float* kuf, long long ldk, const float* gv_s, float* parts,
                           float* gram, long long n, int M, int D, int accumulate,
                           void* stream) {
  if (n < 1 || M < 1 || M > 128 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gram(a_s, da_s, ld, kuf, ldk, gv_s, parts, gram, n, M, D,
                                      accumulate != 0, static_cast<cudaStream_t>(stream)));
}

// dPinv [M][M] = tril of gram's last matrix; dSq [D][M][M] (in Sq's own
// layout) = triu(2 Sq[d] C_d), with Sq[d] = sqT[d]^T. Exact zeros elsewhere.
int dgp_fused_rbf_bwd_finish(const float* gram, const float* sqT, float* dpinv, float* dsq,
                             int M, int D, void* stream) {
  if (M < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_gram_finish(gram, sqT, dpinv, dsq, M, D, static_cast<cudaStream_t>(stream)));
}

const char* dgp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
