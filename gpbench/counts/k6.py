"""Kernel #6: the quadform's backward (phases A and B,
``ops/quadform.py``), one call at n points.

Inputs: Sq (upper triangles), A [M, n], g2 [D, n] and, with t1, g1 [n].
Outputs: dSq (upper triangles) and dA [M, n]. b_d is not given, so
recomputing it is counted. Per point:

* products: b_d = Sq[d] a (2 D tri(M)), dA = sum_d Sq[d]^T gb_d
  (2 D tri(M)), dSq[d] = gb_d a^T on Sq's pattern (2 D tri(M));
* other: gb_d = 2 b_d g2[d] (2 M D), dA += 2 a g1 (3 M, with t1).
"""

from __future__ import annotations

from . import F32, Work, tri


def work(n, M, D, with_t1=False):
    t = tri(M)
    products = n * 6 * D * t
    other = n * (2 * M * D + (3 * M if with_t1 else 0))
    nbytes = F32 * (M * n + D * n + (n if with_t1 else 0) + D * t   # inputs
                    + D * t + M * n)                                # outputs
    return Work(products, other, nbytes)
