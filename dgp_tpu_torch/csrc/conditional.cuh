// The whitened SVGP conditional of one point tile, forward and backward,
// shared by the stationary kernels (conditional_fused_rbf.cu), which build
// the kuf tile from the points, and the Kuf-consuming kernels
// (conditional_fused.cu), which read it from device memory. Both pass the
// prior variance of point j of the tile as kff(j): the constant v of a
// stationary kernel, or the tile's slice of Kff.
//
// Pinv = Lu^{-1} is lower- and Sq = tril(q_sqrt)^T upper-triangular on the
// whitened path. Both directions stage Pinv and tril(q_sqrt[d]) = Sq[d]^T
// as packed lower triangles (row r padded to round4(r + 1) floats: 33 KB at
// M = 128) through a ring of two buffers filled by cp.async, so the next
// operand lands while the current one is used, and every product skips the
// zero half: only the lower triangles of Pinv and of Sq[d]^T are read, so
// garbage off those patterns never reaches a result. A persistent grid of
// one block of 256 threads per SM walks tiles of BTN = 128 points; in the
// FMA products each thread owns 2G rows (G from the top, G mirrored from
// the bottom) by 8 points, so that every triangular product gives every
// thread the same number of FMAs. Every sum runs in a fixed order with no
// atomics: two runs on the same inputs give the same bits.
//
// The forward (#1 and #3, tile_forward), per tile and with a = Pinv kuf:
//
//   mean = a^T q_mu    t1 = ||a||^2    b_d = Sq[d] a
//   var_d = max((kff - t1) + ||b_d||^2, 0)
//
// The ring hands out Pinv, Sq[0..D-1] per tile. a is IEEE fp32 FMA (t1
// cancels against kff) and overwrites the kuf tile once every thread has
// read it; t1 is reduced from the threads' registers. Each b_d runs on the
// tensor cores in 3xTF32 (colsumsq_tc), its sums of squares reduced from
// the accumulators, so b never leaves registers and each output d costs
// one barrier. The tile's var, then its mean, is staged in shared memory
// and leaves as one contiguous run of its [n][D] rows. The backward is all
// IEEE fp32 FMA.
//
// The backward of both (#2 and #4) runs in two phases, whose device code is
// here. With A = Pinv kuf per point and gv_d the clamp-masked g_var_d:
//
//   B_d = Sq[d] A      GB_d = 2 B_d diag(gv_d)
//   dA  = sum_d Sq[d]^T GB_d - 2 A diag(sum_d gv_d) + q_mu g_mean^T
//   dKuf = Pinv^T dA                                   per point (phase A)
//   dPinv = tril(dA Kuf^T)    dSq[d] = triu(2 Sq[d] C_d),
//   C_d = A diag(gv_d) A^T                             sums over points (phase B)
//
// Only tril(dPinv) and triu(dSq) reach a parameter (the Cholesky adjoint
// reads the lower triangle of dPinv, and tril(q_sqrt) cuts the rest of
// dSq), so both phases skip the zero halves and the outputs are exact zeros
// off those patterns.
//   * Phase A: the persistent grid above; the ring hands out Pinv,
//     Sq[0..D-1], Pinv again per tile. A, dA (and, where the caller builds
//     it, Kuf) and gv are written to scratch for phase B; no M x M sum is
//     kept, so nothing is read back per tile.
//   * Phase B (gram_bwd): the D weighted Grams C_d and dA Kuf^T as split-K
//     SIMT products, one block per (matrix, slice of GKB points), ten warps
//     at M = 128 each owning one 32 x 32 tile of the lower triangle; each
//     slice's sums go to their own slot, which reduce_parts adds in slice
//     order. gram_finish forms dSq[d] = triu(2 Sq[d] C_d) and tril(dPinv).
//
// The quadform's kernels (#5 and #6, quadform.cu) take the same steps
// without Pinv: the ring hands out Sq[0..D-1]^T (period D); the forward
// runs colsumsq_tc per output over an A tile read by load_tile_async;
// phase A runs chain_output per output with the cotangent g2_d as the
// weight; phase B computes the D Grams alone (no dPinv matrix).

#pragma once

#include "tiles.cuh"

namespace {

constexpr int BTN = 128;           // points per tile of the forward and of phase A
constexpr int BTS = BTN + 4;       // row stride of their tiles: 32 lanes reading
                                   // float4 from 32 rows then hit every bank once
constexpr int FTS = BTN + 8;       // row stride of the forward's tile: the tensor-core
                                   // fragments' reads of 4 rows x 8 points then hit
                                   // every bank once
constexpr int BNT = 256;           // their threads: 16 row groups x 16 column groups
constexpr int BRED = BNT / 32;     // per-point column partials, one per warp
constexpr int GK = 32;             // phase B: points per K-step
constexpr int GS = GK + 4;         // phase B: row stride of a staged panel
constexpr int GKB = 1024;          // phase B: points per split-K slice

// Packed lower triangle: row r holds columns 0..r, zero-padded to
// round4(r + 1) floats, at offset tri_off(r); tri_off(MP) floats in all.
__host__ __device__ inline int tri_off(int r) {
  const int q = r >> 2, m = r & 3;
  return 8 * q * (q + 1) + 4 * (q + 1) * m;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// P (packed, MP rows) = tril(G) for G row-major [M][M]; rows past M are
// zero. Asynchronous: the caller commits the group and waits for it. Bytes
// past the triangle are zero-filled by cp.async, never read.
template <int MP>
__device__ __forceinline__ void stage_tri(float* P, const float* __restrict__ G, int M,
                                          int tid) {
  constexpr int TPR = BNT / MP;  // threads per row
  const int r = tid / TPR, t = tid % TPR;
  float* row = P + tri_off(r);
  const int len = round4(r + 1);
  if ((M & 3) == 0 && (reinterpret_cast<unsigned long long>(G) & 15) == 0) {
    for (int c = 4 * t; c < len; c += 4 * TPR) {
      const int valid = r < M ? min(r + 1 - c, 4) : 0;
      cp_async16(row + c, valid > 0 ? G + r * M + c : G, 4 * valid);
    }
  } else {
    for (int c = t; c < len; c += TPR) {
      const bool ok = r < M && c <= r;
      cp_async4(row + c, ok ? G + r * M + c : G, ok ? 4 : 0);
    }
  }
}

// T[m][j] (row stride S) = X[m][p0 + j] for m < M and j < nt, else 0: the
// tile of BTN points from p0 of an operand X [M][ld], by cp.async with every
// copy in flight at once; 16-byte copies where X's rows are 16-byte aligned
// (``aligned``: ld % 4 == 0 and X aligned), else 4-byte ones. The caller
// commits the group and waits for it.
template <int MP, int S>
__device__ __forceinline__ void load_tile_async(float* T, const float* __restrict__ X,
                                                long long ld, long long p0, int nt, int M,
                                                bool aligned, int tid) {
  if (aligned) {
    for (int e = tid; e < MP * (BTN / 4); e += BNT) {
      const int m = e / (BTN / 4), j = 4 * (e % (BTN / 4));
      const int valid = m < M ? max(0, min(nt - j, 4)) : 0;
      cp_async16(T + m * S + j, valid > 0 ? X + m * ld + p0 + j : X, 4 * valid);
    }
  } else {
    for (int e = tid; e < MP * BTN; e += BNT) {
      const int m = e / BTN, j = e % BTN;
      const bool ok = m < M && j < nt;
      cp_async4(T + m * S + j, ok ? X + m * ld + p0 + j : X, ok ? 4 : 0);
    }
  }
}

template <int G>
__device__ __forceinline__ void lds(const float* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) { lds<4>(p, v); }

// Row r < 2G of a thread's register tile: G rows from G ty (low), then G
// rows from MP - G (ty + 1) (high, the mirror), so that the k range of a
// triangular product, long for one group where it is short for the other,
// adds up to the same MP + G for every thread.
template <int MP, int G>
__device__ __forceinline__ int row_of(int ty, int r) {
  return r < G ? G * ty + r : MP - G * (ty + 1) + (r - G);
}

// Column c < 8 of a thread's register tile: 4 tx + c, then 64 + 4 tx + c - 4,
// so that each half-warp's float4 reads of a tile row are one contiguous run.
__device__ __forceinline__ int col_of(int tx, int c) {
  return (c < 4 ? 0 : BTN / 2 - 4) + 4 * tx + c;
}

// v[0..7] = the thread's 8 columns of row p (p points at the row's start)
__device__ __forceinline__ void lds8(const float* p, int tx, float (&v)[8]) {
  float a[4], b[4];
  lds4(p + 4 * tx, a);
  lds4(p + BTN / 2 + 4 * tx, b);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = a[c];
    v[4 + c] = b[c];
  }
}

__device__ __forceinline__ void sts8(float* p, int tx, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p + 4 * tx) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + BTN / 2 + 4 * tx) = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[r][c] += sum_{k <= row} L[row][k] T[k][col]: L packed lower (rows
// past the diagonal read as the zero padding), T [MP][S]. The G rows of a
// group share one padded length (e0 low, e1 high), so row q of a group
// starts q rows of that length after its first.
template <int MP, int G, int S = BTS>
__device__ __forceinline__ void tri_rows(const float* L, const float* T, int ty, int tx,
                                         float (&acc)[2 * G][8]) {
  const int e0 = round4(G * ty + G), e1 = round4(MP - G * ty);
  const float* lo = L + tri_off(G * ty);
  const float* hi = L + tri_off(MP - G * (ty + 1));
  auto step = [&](int k, auto both) {
    float t[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) lds8(T + (k + q) * S, tx, t[q]);
#pragma unroll
    for (int r = decltype(both)::value ? 0 : G; r < 2 * G; ++r) {
      float w[4];
      lds4(r < G ? lo + r * e0 + k : hi + (r - G) * e1 + k, w);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[r][c] = fmaf(w[3], t[3][c], fmaf(w[2], t[2][c], fmaf(w[1], t[1][c],
                         fmaf(w[0], t[0][c], acc[r][c]))));
    }
  };
#pragma unroll 1
  for (int k = 0; k < e0; k += 4) step(k, std::true_type{});
#pragma unroll 1
  for (int k = e0; k < e1; k += 4) step(k, std::false_type{});
}

// acc[r][c] = sum_{k >= row} L[k][row] T[k][col]: the product with L^T, L
// packed lower, T [MP][BTS].
template <int MP, int G>
__device__ __forceinline__ void tri_cols(const float* L, const float* T, int ty, int tx,
                                         float (&acc)[2 * G][8]) {
#pragma unroll
  for (int r = 0; r < 2 * G; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  const int r0 = G * ty, r1 = MP - G * (ty + 1);
  auto step = [&](const float* row, int k, auto both) {
    float t[8], w[G];
    lds8(T + k * BTS, tx, t);
    lds<G>(row + r0, w);
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(w[q], t[c], acc[q][c]);
    if (decltype(both)::value) {
      float h[G];
      lds<G>(row + r1, h);
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[G + q][c] = fmaf(h[q], t[c], acc[G + q][c]);
    }
  };
  int off = tri_off(r0);
#pragma unroll 2
  for (int k = r0; k < r1; ++k) {  // the low rows only
    step(L + off, k, std::false_type{});
    off += round4(k + 1);
  }
#pragma unroll 2
  for (int k = r1; k < MP; ++k) {  // both groups
    step(L + off, k, std::true_type{});
    off += round4(k + 1);
  }
}

// red[warp][col] = sum over the warp's two row groups of acc[.][c]^2
template <int R>
__device__ __forceinline__ void colsumsq_tile(const float (&acc)[R][8], float* red, int tid,
                                             int tx) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) s = fmaf(acc[r][c], acc[r][c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 16) red[warp * BTN + col_of(tx, c)] = s;
  }
}

// The ring of two packed operand buffers. Stage s holds, for s mod period:
// 0 Pinv (for A), 1..D Sq[s - 1]^T, and in the backward (period D + 2)
// D + 1 Pinv (for dKuf); the forward's period is D + 1. Without Pinv (null:
// the quadform, period D) stage s holds Sq[s mod D]^T.
struct Ring {
  float* buf[2];
  const float* pinv;
  const float* sqT;
  long long MM;
  int M, D, period, s;

  __device__ const float* src(int t) const {
    const int i = t % period - (pinv != nullptr ? 1 : 0);
    return (i < 0 || i >= D) ? pinv : sqT + i * MM;
  }
  template <int MP>
  __device__ void start(int tid) {
    s = 0;
    stage_tri<MP>(buf[0], src(0), M, tid);
    cp_async_commit();
  }
  // Waits for stage s and makes it (and every shared-memory write before
  // the call) visible to the block, starts stage s + 1 into the other
  // buffer, and returns stage s's buffer.
  template <int MP>
  __device__ const float* next(int tid) {
    cp_async_wait_all();
    __syncthreads();
    stage_tri<MP>(buf[(s + 1) & 1], src(s + 1), M, tid);
    cp_async_commit();
    return buf[(s++) & 1];
  }
};

// The sum over the warps' partials (colsumsq_tile) of point j, in warp order.
__device__ __forceinline__ float colsum_tile(const float* red, int j) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < BRED; ++w) s += red[w * BTN + j];
  return s;
}

// -- forward -------------------------------------------------------------------

// x = hi + lo, the operands of a 3xTF32 product, which keeps about fp32's
// precision: hi is x rounded to TF32's 10 mantissa bits (half an ulp added,
// then the low 13 bits cleared), lo = x - hi exactly (|lo| <= 2^-11 |x|),
// and the tensor cores read lo's top 19 bits (an error below 2^-21 |x|).
// Integer and FADD work: cvt.rna.tf32 runs at a fraction of their rate.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += A B on the tensor cores: A 16 x 8 (row), B 8 x 8 (col) in TF32, c fp32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Partial sums of squares of b = L^T A [MP][BTN], with L packed lower (rows
// past M zero) and A [MP][FTS], on the tensor cores in 3xTF32 (lo hi +
// hi lo + hi hi, the small terms first, fp32 accumulators). The product
// runs transposed, b^T = A^T L, in m16n8k8 tiles: warp w owns the 32 points
// 32 (w % 4) .. (two m16 tiles, so each fragment of L feeds two products)
// and half H = w / 4 of the 8-row blocks ib of b, those with ib % 4 in
// {0, 3} or in {1, 2}: each half holds the same number of the blocks (kb,
// ib <= kb) that L's triangle leaves, so every warp does the same work.
// Unrolled whole: the accumulators stay in registers, and the products go
// out in rounds over up to four row blocks and both m tiles, so that no
// product waits on the one issued just before. part[H][j] = the sum over
// the half's rows of b[i][j]^2 (the row blocks in turn, then a butterfly
// over the group's 4 lanes).
template <int MP, int H>
__device__ __forceinline__ void colsumsq_tc(const float* L, const float* A, int warp, int lane,
                                            float* part) {
  constexpr int NB = MP / 8, NS = NB / 2;  // row blocks of b; this half's
  const int g = lane >> 2, t = lane & 3, p0 = 32 * (warp & 3);
  auto block = [](int s) { return 2 * s + ((s & 1) ^ H); };
  float c[2][NS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][s][e] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < NB; ++kb) {
    const int k0 = 8 * kb + t, k1 = k0 + 4;
    unsigned ah[2][4], al[2][4];  // A^T [16 points][8 k] of each m tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* pts = A + p0 + 16 * mt + g;
      split_tf32(pts[k0 * FTS], ah[mt][0], al[mt][0]);
      split_tf32(pts[k0 * FTS + 8], ah[mt][1], al[mt][1]);
      split_tf32(pts[k1 * FTS], ah[mt][2], al[mt][2]);
      split_tf32(pts[k1 * FTS + 8], ah[mt][3], al[mt][3]);
    }
    const float* r0 = L + tri_off(k0);
    const float* r1 = L + tri_off(k1);
#pragma unroll
    for (int s0 = 0; s0 < NS; s0 += 4) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ib = block(s0 + q), i = 8 * ib + g;
        if (ib > kb) continue;  // L[k][i] is zero for i > k
        split_tf32(ib < kb || i <= k0 ? r0[i] : 0.0f, bh[q][0], bl[q][0]);
        split_tf32(ib < kb || i <= k1 ? r1[i] : 0.0f, bh[q][1], bl[q][1]);
      }
#pragma unroll
      for (int round = 0; round < 3; ++round)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (block(s0 + q) > kb) continue;
            if (round == 0) mma_tf32(c[mt][s0 + q], al[mt], bh[q]);
            if (round == 1) mma_tf32(c[mt][s0 + q], ah[mt], bl[q]);
            if (round == 2) mma_tf32(c[mt][s0 + q], ah[mt], bh[q]);
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        sum = fmaf(c[mt][s][2 * h + 1], c[mt][s][2 * h + 1],
                   fmaf(c[mt][s][2 * h], c[mt][s][2 * h], sum));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == h) part[H * BTN + p0 + 16 * mt + g + 8 * h] = sum;
    }
}

// The forward's shared memory beside the ring: T (the kuf tile, then a,
// [MP][FTS]), red (the warps' column partials), t1s (t1 per point), out (the
// tile's var, then its mean, [BTN][D]), qm (q_mu [M][D]).
struct ForwardTiles {
  float *T, *red, *t1s, *out, *qm;
};

// One tile of the forward, with the kuf tile in t.T (zero past M) and the
// ring about to hand out Pinv: a = Pinv kuf over kuf in place, t1,
// var_d = max((kff(j) - t1) + ||Sq[d] a||^2, 0) and mean = a^T q_mu, each
// written to the tile's rows of var and mean ([n][D], from the tile's first
// point; nt points) as one contiguous run. a and t1 are IEEE fp32 FMA (t1
// cancels against kff); b_d = Sq[d] a only adds, and runs on the tensor
// cores in 3xTF32 (colsumsq_tc). The next tile may overwrite T and out on
// return.
template <int MP, typename Kff>
__device__ __forceinline__ void tile_forward(const ForwardTiles& t, Ring& ring, int M,
                                             int D, int tid, Kff kff, float* mean,
                                             float* var, int nt) {
  constexpr int G = MP / 32, R = 2 * G;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  // a = Pinv kuf and t1; a goes over kuf once every read of kuf is done
  const float* L = ring.next<MP>(tid);
  tri_rows<MP, G, FTS>(L, t.T, ty, tx, acc);
  colsumsq_tile<R>(acc, t.red, tid, tx);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) sts8(t.T + row_of<MP, G>(ty, r) * FTS, tx, acc[r]);
  if (tid < BTN) t.t1s[tid] = colsum_tile(t.red, tid);

  // per output d: b_d = Sq[d] a in registers, reduced to var_d. Each half
  // of the row blocks leaves its partial sums in red (two slots, by the
  // parity of d), added behind the next barrier.
  auto finish = [&](int d) {
    const float* part = t.red + (d & 1) * 2 * BTN;
    t.out[tid * D + d] =
        fmaxf((kff(tid) - t.t1s[tid]) + (part[tid] + part[BTN + tid]), 0.0f);
  };
  for (int d = 0; d < D; ++d) {
    L = ring.next<MP>(tid);  // Sq[d]^T; a and t1s visible, red free
    if (d > 0 && tid < BTN) finish(d - 1);
    float* part = t.red + (d & 1) * 2 * BTN;
    if (warp < 4)
      colsumsq_tc<MP, 0>(L, t.T, warp, lane, part);
    else
      colsumsq_tc<MP, 1>(L, t.T, warp, lane, part);
  }
  __syncthreads();
  if (tid < BTN) finish(D - 1);
  __syncthreads();
  for (int e = tid; e < nt * D; e += BNT) var[e] = t.out[e];
  __syncthreads();

  // mean[j][e] = sum_m a[m][j] q_mu[m][e]: a thread per 4 points and output,
  // float4 reads along a row of a
  for (int item = tid; item < (BTN / 4) * D; item += BNT) {
    const int j = 4 * (item % (BTN / 4)), e = item / (BTN / 4);
    float s[4] = {};
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      float a[4];
      lds4(t.T + m * FTS + j, a);
      const float q = t.qm[m * D + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = fmaf(a[c], q, s[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) t.out[(j + c) * D + e] = s[c];
  }
  __syncthreads();
  for (int e = tid; e < nt * D; e += BNT) mean[e] = t.out[e];
}

// -- backward ------------------------------------------------------------------

// Phase A's shared memory beside the ring, each tile [MP][BTS]: T1 (kuf,
// then gb_d, then da), T2 (a); per point of the tile t1s and sS
// (sum_d gv_d), gmS (g_mean^T [D][BTN]); qm (q_mu [M][D]).
struct BackwardTiles {
  float *T1, *T2, *red, *t1s, *sS, *gmS, *qm;
};

// f(m, c, sum_j T[m][j] X[c][j]) for m < M, c < C: T [MP][BTS], X [C][BTN].
// A lane takes a row m and walks its points four at a time, each warp one
// (32 rows, c) block: float4 reads of 32 rows at stride BTS hit every bank
// once, and X's reads are the warp's broadcast.
template <typename F>
__device__ __forceinline__ void row_dots(const float* T, const float* X, int C, int M,
                                         int tid, F f) {
  const int warp = tid >> 5, lane = tid & 31, blocks = (M + 31) / 32;
  for (int item = warp; item < blocks * C; item += BNT / 32) {
    const int m = 32 * (item % blocks) + lane, c = item / blocks;
    if (m >= M) continue;
    float s = 0.0f;
#pragma unroll 4
    for (int j = 0; j < BTN; j += 4) {
      float a[4], x[4];
      lds4(T + m * BTS + j, a);
      lds4(X + c * BTN + j, x);
      s = fmaf(a[3], x[3], fmaf(a[2], x[2], fmaf(a[1], x[1], fmaf(a[0], x[0], s))));
    }
    f(m, c, s);
  }
}

// One output d of a backward tile, with the ring about to hand out Sq[d]^T
// and a in T [MP][BTS]: b_d = Sq[d] a into acc; weight(w) then gives the
// weights w of this thread's 8 points (a weight that reads the whole tile's
// b_d synchronises the block inside); gb_d = 2 b_d w goes to GB [MP][BTS],
// and da += Sq[d]^T gb_d. Two barriers (the ring's and one before the
// second product); GB is still being read on return.
template <int MP, int G, typename Weight>
__device__ __forceinline__ void chain_output(Ring& ring, const float* T, float* GB, int tid,
                                             Weight weight, float (&acc)[2 * G][8],
                                             float (&da)[2 * G][8]) {
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  const float* L = ring.next<MP>(tid);  // also: GB is free again
  tri_cols<MP, G>(L, T, ty, tx, acc);   // b_d = Sq[d] a
  float w[8];
  weight(w);
#pragma unroll
  for (int r = 0; r < 2 * G; ++r) {
    float gb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) gb[c] = 2.0f * acc[r][c] * w[c];
    sts8(GB + row_of<MP, G>(ty, r) * BTS, tx, gb);
  }
  __syncthreads();
  tri_rows<MP, G>(L, GB, ty, tx, da);  // += Sq[d]^T gb_d
}

// One tile of phase A, with the kuf tile in T1 (zero past M and past the
// tile's nt points), its g_mean in gmS and the ring about to hand out Pinv.
// Recomputes a (into T2), t1 and b_d, and chains
//
//   gv_d = g_var_d where (kff(j) - t1) + t2_d > 0, else 0     s = sum_d gv_d
//   gb_d = 2 b_d gv_d     da = sum_d Sq[d]^T gb_d - 2 a s + q_mu g_mean^T
//
// writing a, da [M][ld] and gv [D][ld] (this tile's columns) for phase B
// and a g_mean into dqm (the tile's slot, [M][D]), and leaving
// dkuf = Pinv^T da in acc, da in T1, a in T2 and s in sS. Every thread
// reduces t2_d for its own 8 points from the per-warp partials, so each
// output d takes three barriers; the threads of row group 0 write the
// per-point results. T1 is still being read on return: the caller
// synchronises before it overwrites it.
template <int MP, int G, typename Kff>
__device__ __forceinline__ void tile_backward(const BackwardTiles& t, Ring& ring,
                                              const float* __restrict__ gvar, int nt,
                                              float* a_out, float* da_out, float* gv_out,
                                              long long ld, float* dqm, int M, int D, int tid,
                                              Kff kff, float (&acc)[2 * G][8]) {
  constexpr int R = 2 * G;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  // the column sums of this thread's 8 points, over the warps' partials
  auto colsums = [&](float (&out)[8]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = 0.0f;
#pragma unroll
    for (int g = 0; g < BRED; ++g) {
      float v[8];
      lds8(t.red + g * BTN, tx, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) out[c] += v[c];
    }
  };

  // a = Pinv kuf, t1
  const float* L = ring.next<MP>(tid);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  tri_rows<MP, G>(L, t.T1, ty, tx, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row_of<MP, G>(ty, r);
    sts8(t.T2 + row * BTS, tx, acc[r]);
    if (row < M) sts8(a_out + row * ld, tx, acc[r]);
  }
  colsumsq_tile<R>(acc, t.red, tid, tx);
  __syncthreads();
  if (ty == 0) {
    float t1[8];
    const float zero[8] = {};
    colsums(t1);
    sts8(t.t1s, tx, t1);
    sts8(t.sS, tx, zero);
  }

  // per output d: b_d, the clamp mask, gb_d, and da += Sq[d]^T gb_d
  float da[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) da[r][c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float gvar8[8];  // loaded now, used after the product
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col_of(tx, c);
      gvar8[c] = col < nt ? __ldg(gvar + col * D + d) : 0.0f;
    }
    // the ring's barrier also frees red and makes t1s and sS visible
    chain_output<MP, G>(ring, t.T2, t.T1, tid, [&](float (&gv)[8]) {
      colsumsq_tile<R>(acc, t.red, tid, tx);
      __syncthreads();
      float t2[8], t1[8];
      colsums(t2);
      lds8(t.t1s, tx, t1);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        gv[c] = (kff(col_of(tx, c)) - t1[c]) + t2[c] > 0.0f ? gvar8[c] : 0.0f;
      if (ty == 0) {
        float s[8];
        lds8(t.sS, tx, s);
#pragma unroll
        for (int c = 0; c < 8; ++c) s[c] += gv[c];
        sts8(t.sS, tx, s);
        sts8(gv_out + d * ld, tx, gv);
      }
    }, acc, da);
  }

  // da complete (in registers), then into T1 once every read of gb is done
  float s8[8];
  lds8(t.sS, tx, s8);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row_of<MP, G>(ty, r);
    float a[8], qg[8] = {};
    lds8(t.T2 + row * BTS, tx, a);
    if (row < M)
      for (int d = 0; d < D; ++d) {
        float g[8];
        lds8(t.gmS + d * BTN, tx, g);
        const float q = t.qm[row * D + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) qg[c] = fmaf(q, g[c], qg[c]);
      }
#pragma unroll
    for (int c = 0; c < 8; ++c) da[r][c] = (da[r][c] - 2.0f * a[c] * s8[c]) + qg[c];
  }
  L = ring.next<MP>(tid);  // Pinv again
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row_of<MP, G>(ty, r);
    sts8(t.T1 + row * BTS, tx, da[r]);
    if (row < M) sts8(da_out + row * ld, tx, da[r]);
  }
  // dq_mu's share of this tile: a g_mean
  row_dots(t.T2, t.gmS, D, M, tid, [&](int m, int d, float s) { dqm[m * D + d] = s; });
  __syncthreads();
  tri_cols<MP, G>(L, t.T1, ty, tx, acc);  // dkuf = Pinv^T da
}

// Phase B: parts[slice][mat] (its lower triangle, [M][M] row-major) = the
// sum over slice's points p of
//   mat < D:  gv[mat][p] A[:, p] A[:, p]^T      (C_mat)
//   mat == D: dA[:, p] Kuf[:, p]^T               (dPinv before its projection)
// with gridDim.x matrices per slice: D + 1, or D for the Grams alone (the
// quadform's backward, which has no dPinv). Block (mat, slice); warp w
// owns the w-th 32 x 32 tile of the lower triangle, each lane an 8 x 4
// register tile (rows 4 r + lane / 8, columns 8 c + lane % 8 of the tile).
// Panels of GK points arrive by cp.async in two buffers, the next while the
// current is multiplied; for a Gram only A (into Q) and gv come in, and
// P = A gv is formed in shared memory.
// Points are summed in order: deterministic.
template <int NB>
__global__ void __launch_bounds__(16 * NB * (NB + 1), 2)
gram_bwd(const float* __restrict__ A, const float* __restrict__ dA, long long lda,
         const float* __restrict__ Kuf, long long ldk, const float* __restrict__ gv,
         float* __restrict__ parts, int nc, int M, int D) {
  constexpr int MP = 32 * NB, NTH = 16 * NB * (NB + 1);
  constexpr int CH = MP * GK / 4;  // 16-byte chunks of one panel
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);  // [2][MP][GS]
  float* Qs = Ps + 2 * MP * GS;                 // [2][MP][GS]
  float* Ws = Qs + 2 * MP * GS;                 // [2][GK]
  const int mat = blockIdx.x, tid = threadIdx.x;
  const int p_begin = blockIdx.y * GKB, p_end = min(nc, p_begin + GKB);
  const bool gram = mat < D;
  const float* P = gram ? A : dA;   // unused for a Gram
  const float* Q = gram ? A : Kuf;
  const long long ldq = gram ? lda : ldk;
  const float* w = gv + (gram ? mat : 0) * lda;
  auto aligned = [](const float* p, long long ld) {
    return ld % 4 == 0 && (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  };
  const bool p16 = aligned(P, lda), q16 = aligned(Q, ldq);

  // one panel of an operand [M][ld] into X [MP][GS]; zero past M and p_end
  auto panel = [&](float* X, const float* src, long long ld, bool al, int p0) {
    for (int c = tid; c < CH; c += NTH) {
      const int row = c / (GK / 4), k = 4 * (c % (GK / 4)), p = p0 + k;
      float* dst = X + row * GS + k;
      const float* s = src + row * ld + p;
      if (al) {
        const int valid = row < M ? max(0, min(p_end - p, 4)) : 0;
        cp_async16(dst, valid > 0 ? s : src, 4 * valid);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = row < M && p + q < p_end;
          cp_async4(dst + q, ok ? s + q : src, ok ? 4 : 0);
        }
      }
    }
  };
  auto load = [&](int p0, int b) {
    panel(Qs + b * MP * GS, Q, ldq, q16, p0);
    if (gram) {
      if (tid < GK) {
        const bool ok = p0 + tid < p_end;
        cp_async4(Ws + b * GK + tid, ok ? w + p0 + tid : w, ok ? 4 : 0);
      }
    } else {
      panel(Ps + b * MP * GS, P, lda, p16, p0);
    }
    cp_async_commit();
  };

  const int warp = tid >> 5, lane = tid & 31;
  int bi = 0, bj = warp;
  while (bj > bi) {
    bj -= bi + 1;
    ++bi;
  }
  const int i0 = 32 * bi + (lane >> 3), j0 = 32 * bj + (lane & 7);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  load(p_begin, 0);
  int b = 0;
  for (int p0 = p_begin; p0 < p_end; p0 += GK, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // panel b is in; every read of panel b ^ 1 is done
    if (p0 + GK < p_end) load(p0 + GK, b ^ 1);
    float* Pb = Ps + b * MP * GS;
    const float* Qb = Qs + b * MP * GS;
    if (gram) {  // P = A gv (block-uniform branch)
      for (int e = tid; e < MP * GK; e += NTH) {
        const int row = e / GK, k = e % GK;
        Pb[row * GS + k] = Qb[row * GS + k] * Ws[b * GK + k];
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int k = 0; k < GK; k += 4) {
      float q[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) lds4(Qb + (j0 + 8 * c) * GS + k, q[c]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float p[4];
        lds4(Pb + (i0 + 4 * r) * GS + k, p);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(p[3], q[c][3], fmaf(p[2], q[c][2], fmaf(p[1], q[c][1],
                           fmaf(p[0], q[c][0], acc[r][c]))));
      }
    }
  }

  float* out = parts + (static_cast<long long>(blockIdx.y) * gridDim.x + mat) * M * M;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 4 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 8 * c;
      if (i < M && j <= i) out[i * M + j] = acc[r][c];
    }
  }
}

// out[e] = (accumulate ? out[e] : 0) + sum_b parts[b][e], in b order, 32
// parts at a time and then those sums (a rounding error that grows with
// count / 32 + 32, not with count); with tri_m > 0 the parts are stacks of
// tri_m x tri_m matrices and only their lower triangles are summed (the
// rest of out is left as it is).
__global__ void reduce_parts(const float* __restrict__ parts, float* __restrict__ out,
                             int count, long long len, int tri_m, int accumulate) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= len) return;
  if (tri_m > 0 && (e / tri_m) % tri_m < e % tri_m) return;
  float s = 0.0f;
  for (int b0 = 0; b0 < count; b0 += 32) {
    const float* p = parts + b0 * len + e;
    const int m = min(32, count - b0);
    float c = 0.0f;
#pragma unroll 8
    for (int b = 0; b < m; ++b) c += p[b * len];
    s += c;
  }
  out[e] = accumulate ? out[e] + s : s;
}

inline cudaError_t launch_reduce_parts(const float* parts, float* out, int count,
                                       long long len, int tri_m, bool accumulate,
                                       cudaStream_t stream) {
  reduce_parts<<<static_cast<unsigned>((len + 255) / 256), 256, 0, stream>>>(
      parts, out, count, len, tri_m, accumulate ? 1 : 0);
  return cudaGetLastError();
}

// From the summed lower triangles G [(D + 1)][M][M] (D without dpinv):
// dSq[d] = triu(2 Sq[d] C_d) with Sq[d] = sqT[d]^T (upper-triangular: only
// sqT's lower triangle is read) and C_d the symmetric Gram whose lower
// triangle is G[d]; dPinv = tril(G[D]) where dpinv is not null. Exact zeros
// off the patterns.
__global__ void gram_finish(const float* __restrict__ G, const float* __restrict__ sqT,
                            float* __restrict__ dpinv, float* __restrict__ dsq, int M, int D) {
  const long long MM = static_cast<long long>(M) * M;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= (D + (dpinv != nullptr ? 1 : 0)) * MM) return;
  const int mat = static_cast<int>(e / MM), i = static_cast<int>((e / M) % M),
            j = static_cast<int>(e % M);
  const float* Gm = G + mat * MM;
  if (mat == D) {
    dpinv[i * M + j] = i >= j ? Gm[i * M + j] : 0.0f;
    return;
  }
  float s = 0.0f;
  if (i <= j) {
    const float* L = sqT + mat * MM;
    for (int k = i; k < M; ++k)
      s = fmaf(L[k * M + i], k >= j ? Gm[k * M + j] : Gm[j * M + k], s);
    s *= 2.0f;
  }
  dsq[e] = s;
}

// Phase B on n points (one chunk) and its reduction: gram (+)= the slices'
// sums, D + 1 matrices, or the D Grams alone where dA is null. parts holds
// ceil(n / GKB) such stacks of M^2 floats. A, dA and gv have row stride
// lda, Kuf ldk. Where one slice covers the chunk and nothing is added to,
// the Grams go to gram directly and the reduction is not launched.
inline cudaError_t launch_gram(const float* A, const float* dA, long long lda,
                               const float* Kuf, long long ldk, const float* gv,
                               float* parts, float* gram, long long n, int M, int D,
                               bool accumulate, cudaStream_t stream) {
  const int slices = static_cast<int>((n + GKB - 1) / GKB);
  const int mats = D + (dA != nullptr ? 1 : 0);
  const bool direct = slices == 1 && !accumulate;
  if (direct) parts = gram;
  const dim3 grid(static_cast<unsigned>(mats), static_cast<unsigned>(slices));
  cudaError_t err;
  if (M <= 64) {
    constexpr int NB = 2;
    static std::atomic<unsigned long long> allowed{0};
    const size_t bytes = sizeof(float) * (4 * 32 * NB * GS + 2 * GK);
    err = allow_shared_memory_once(gram_bwd<NB>, allowed);
    if (err != cudaSuccess) return err;
    gram_bwd<NB><<<grid, 16 * NB * (NB + 1), bytes, stream>>>(A, dA, lda, Kuf, ldk, gv,
                                                              parts, static_cast<int>(n), M, D);
  } else {
    constexpr int NB = 4;
    static std::atomic<unsigned long long> allowed{0};
    const size_t bytes = sizeof(float) * (4 * 32 * NB * GS + 2 * GK);
    err = allow_shared_memory_once(gram_bwd<NB>, allowed);
    if (err != cudaSuccess) return err;
    gram_bwd<NB><<<grid, 16 * NB * (NB + 1), bytes, stream>>>(A, dA, lda, Kuf, ldk, gv,
                                                              parts, static_cast<int>(n), M, D);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  return launch_reduce_parts(parts, gram, slices, static_cast<long long>(mats) * M * M, M,
                             accumulate, stream);
}

inline cudaError_t launch_gram_finish(const float* gram, const float* sqT, float* dpinv,
                                      float* dsq, int M, int D, cudaStream_t stream) {
  const long long len = static_cast<long long>(D + (dpinv != nullptr ? 1 : 0)) * M * M;
  gram_finish<<<static_cast<unsigned>((len + 255) / 256), 256, 0, stream>>>(
      gram, sqT, dpinv, dsq, M, D);
  return cudaGetLastError();
}

}  // namespace
