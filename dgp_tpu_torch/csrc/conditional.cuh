// The whitened SVGP conditional of one point tile, forward and backward,
// shared by the stationary kernels (conditional_fused_rbf.cu), which build
// the kuf tile from the points, and the Kuf-consuming kernels
// (conditional_fused.cu), which read it from device memory. Both pass the
// prior variance of point j of the tile as kff(j): the constant v of a
// stationary kernel, or the tile's slice of Kff.

#pragma once

#include "tiles.cuh"

namespace {

// Forward, from the kuf tile T [MP][TN] with W holding Pinv^T and the block
// synchronised: a = Pinv kuf over T in place, t1 = ||a||^2 into t1s,
// mean = a^T q_mu into outm [TN][D], and per output d, b_d = Sq[d] a
// reduced to var_d = max((kff(j) - t1) + ||b_d||^2, 0) into outv [TN][D].
// red holds NWARP x TN floats. Ends with the block synchronised.
template <int RM, typename Kff>
__device__ __forceinline__ void conditional_tile(float* W, float* T, float* red,
                                                 float* t1s, float* outm, float* outv,
                                                 const float* qm,
                                                 const float* __restrict__ sqT, int M,
                                                 int D, int tid, Kff kff) {
  constexpr int MP = 16 * RM;
  const int ty = tid >> 4, tx = tid & 15;
  const long long MM = static_cast<long long>(M) * M;

  // a = Pinv @ kuf into registers, then over kuf in place; t1, mean
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

  // b_d = Sq[d] @ a, reduced to t2_d without leaving registers
  for (int d = 0; d < D; ++d) {
    __syncthreads();
    stage<MP>(W, sqT + d * MM, M, tid);
    __syncthreads();
    tile_product<RM>(W, T, ty, tx, acc);
    colsumsq_partials<RM>(acc, red, tid);
    __syncthreads();
    if (tid < TN) outv[tid * D + d] = fmaxf((kff(tid) - t1s[tid]) + colsum(red, tid), 0.0f);
  }
  __syncthreads();
}

// Shared memory of the backward's tile step, each [MP][TS] tile at row
// stride TS: KU (kuf), AT (a), GB (gb_d, then da); per point of the tile
// t1s, gvS (gv_d of the current d), sS (s = sum_d gv_d), gmS and gvarS
// (g_mean, g_var [TN][D]); qm (q_mu [M][D]) and dqmS (the block's dq_mu).
struct BackwardTiles {
  float *W, *KU, *AT, *GB, *red, *t1s, *gvS, *sS, *gmS, *gvarS, *qm, *dqmS;
};

// Backward, from the kuf tile and this tile's cotangents, with W holding
// Pinv^T, sS zeroed and the block synchronised. Recomputes a (into AT), t1
// and b_d, and chains:
//
//   gv_d  = g_var_d where (kff(j) - t1) + t2_d > 0, else 0      s = sum_d gv_d
//   gb_d  = 2 b_d gv_d        da = sum_d Sq[d]^T gb_d - 2 a s + q_mu g_mean^T
//
// adding gb_d a^T into dsq[d] and da kuf^T into dpinv (the block's slab; the
// first tile writes), a g_mean into dqmS, and leaving dkuf = Pinv^T da in
// acc, da in GB, s in sS and Pinv^T in W. KU, AT and GB are still being read
// on return: the caller synchronises before it overwrites them.
template <int RM, typename Kff>
__device__ __forceinline__ void conditional_tile_backward(
    const BackwardTiles& t, const float* __restrict__ pinvT,
    const float* __restrict__ sqT, float* dpinv, float* dsq, int M, int D, bool first,
    int tid, Kff kff, float (&acc)[RM][4]) {
  constexpr int MP = 16 * RM;
  const int ty = tid >> 4, tx = tid & 15;
  const long long MM = static_cast<long long>(M) * M;

  // a = Pinv @ kuf, t1
  tile_product<RM, TS>(t.W, t.KU, ty, tx, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r)
    *reinterpret_cast<float4*>(t.AT + (ty * RM + r) * TS + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  colsumsq_partials<RM>(acc, t.red, tid);
  __syncthreads();
  if (tid < TN) t.t1s[tid] = colsum(t.red, tid);

  // per output d: b_d, the clamp mask, gb_d, and the sums over d
  float da[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) da[r][c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    __syncthreads();  // W, red, gvS and GB are free again
    stage<MP>(t.W, sqT + d * MM, M, tid);
    __syncthreads();
    tile_product<RM, TS>(t.W, t.AT, ty, tx, acc);  // b_d = Sq[d] @ a
    colsumsq_partials<RM>(acc, t.red, tid);
    __syncthreads();
    if (tid < TN) {
      const float lin = (kff(tid) - t.t1s[tid]) + colsum(t.red, tid);
      const float g = lin > 0.0f ? t.gvarS[tid * D + d] : 0.0f;
      t.gvS[tid] = g;
      t.sS[tid] += g;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RM; ++r)
      *reinterpret_cast<float4*>(t.GB + (ty * RM + r) * TS + tx * 4) = make_float4(
          2.0f * acc[r][0] * t.gvS[tx * 4 + 0], 2.0f * acc[r][1] * t.gvS[tx * 4 + 1],
          2.0f * acc[r][2] * t.gvS[tx * 4 + 2], 2.0f * acc[r][3] * t.gvS[tx * 4 + 3]);
    __syncthreads();
    tile_product_t<RM>(t.W, t.GB, ty, tx, da);                        // += Sq[d]^T gb_d
    outer_accumulate<RM>(dsq + d * MM, t.GB, t.AT, M, ty, tx, first);  // dSq[d] += gb_d a^T
  }
  __syncthreads();

  // da complete, into GB; Pinv^T back into W
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty * RM + r;
    const float4 a4 = *reinterpret_cast<const float4*>(t.AT + row * TS + tx * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx * 4 + c;
      float qg = 0.0f;
      if (row < M)
        for (int d = 0; d < D; ++d) qg = fmaf(t.qm[row * D + d], t.gmS[col * D + d], qg);
      out[c] = (da[r][c] - 2.0f * a[c] * t.sS[col]) + qg;
    }
    *reinterpret_cast<float4*>(t.GB + row * TS + tx * 4) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
  stage<MP>(t.W, pinvT, M, tid);
  __syncthreads();

  // dq_mu += a g_mean
  for (int e = tid; e < M * D; e += NT) {
    const int m = e / D, d = e % D;
    float s = 0.0f;
    for (int j = 0; j < TN; ++j) s = fmaf(t.AT[m * TS + j], t.gmS[j * D + d], s);
    t.dqmS[e] += s;
  }
  // dkuf = Pinv^T da (into acc); dPinv += da kuf^T
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  tile_product_t<RM>(t.W, t.GB, ty, tx, acc);
  outer_accumulate<RM>(dpinv, t.GB, t.KU, M, ty, tx, first);
}

}  // namespace
