"""Kernel #2: the backward of #1 (phases A and B,
``ops/conditional_fused_rbf.py``), one call at n points.

Inputs: #1's inputs and the cotangents g_mean, g_var [n, D]. Outputs:
dPinv (lower triangle), dXs [n, Din], dZs [M, Din], dvariance, dq_mu
[M, D], dSq (upper triangles). The backward is not given A or b_d, so
recomputing them is counted. Per point:

* products: z.x (2 M Din), A (2 tri(M)), b_d (2 D tri(M)), Sq[d]^T gb_d
  (2 D tri(M)), q_mu g_mean (2 M D), dkuf = Pinv^T dA (2 tri(M)),
  dPinv = dA kuf^T on Pinv's pattern (2 tri(M)), dSq[d] = gb_d A^T on Sq's
  pattern (2 D tri(M)), dq_mu = A g_mean (2 M D), dXs and dZs through the
  cross term (2 M Din each);
* other: ||x||^2 (2 Din), sq and kuf (5 M), t1 (2 M), t2 (2 M D), the
  variance's mask (2 D), gb_d = 2 b_d g_d (2 M D), dA -= 2 A sum(g)
  (3 M), d sq (3 M), dvariance (2 M), the diagonal terms of dXs (2 Din).
"""

from __future__ import annotations

from . import F32, Work, tri


def work(n, M, Din, D):
    t = tri(M)
    products = n * (6 * M * Din + 6 * t + 6 * D * t + 4 * M * D)
    other = n * (4 * Din + 15 * M + 4 * M * D + 2 * D)
    small = t + M * Din + 1 + M * D + D * t
    nbytes = F32 * (n * Din + 2 * n * D + small      # inputs
                    + n * Din + small)               # outputs
    return Work(products, other, nbytes)
