"""Kernel #1: the whitened stationary conditional's forward
(``ops/conditional_fused_rbf.py``), one launch at n points.

Inputs: Pinv (lower triangle), Xs [n, Din], Zs [M, Din], the variance,
q_mu [M, D], Sq [D, M, M] (upper triangles). Outputs: mean [n, D] and
var [n, D]. Per point:

* products: the cross term z.x (2 M Din), A = Pinv kuf (2 tri(M)),
  b_d = Sq[d] A for each output (2 D tri(M)), mean = A^T q_mu (2 M D);
* other: ||x||^2 (2 Din), sq = ||x||^2 - 2 z.x + ||z||^2 (2 M),
  kuf = v exp(-sq / 2) (3 M), t1 = ||A||^2 (2 M), t2 = ||b_d||^2
  (2 M D), var = v - t1 + t2 (2 D).
"""

from __future__ import annotations

from . import F32, Work, tri


def work(n, M, Din, D):
    t = tri(M)
    products = n * (2 * M * Din + 2 * t + 2 * D * t + 2 * M * D)
    other = n * (2 * Din + 7 * M + 2 * M * D + 2 * D) + 2 * M * Din
    nbytes = F32 * (n * Din + 2 * n * D + t + M * Din + 1 + M * D + D * t)
    return Work(products, other, nbytes)
