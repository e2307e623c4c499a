"""Kernel #5: the variational quadform's forward (``ops/quadform.py``),
one launch at n points.

Inputs: Sq [D, M, M] (upper triangles) and A [M, n]. Outputs: t2 [D, n]
and, on the whitened path, t1 [n]. Per point:

* products: b_d = Sq[d] a (2 D tri(M));
* other: t2 = ||b_d||^2 (2 M D), t1 = ||a||^2 (2 M, with t1).
"""

from __future__ import annotations

from . import F32, Work, tri


def work(n, M, D, with_t1=False):
    t = tri(M)
    products = n * 2 * D * t
    other = n * (2 * M * D + (2 * M if with_t1 else 0))
    nbytes = F32 * (M * n + D * t + D * n + (n if with_t1 else 0))
    return Work(products, other, nbytes)
