"""Kernel #8: the Cholesky factor and its inverse of a [G, M, M] stack
(``ops/cholesky.py``), one launch.

Input: the stack's lower triangles. Outputs: L and W = L^{-1} (lower
triangles). Per matrix: the factorization's M^3 / 3 operations and the
triangular inverse's M^3 / 3, priced as products (both run as blocked
products at their best).
"""

from __future__ import annotations

from . import F32, Work, tri


def work(G, M):
    products = G * 2 * M ** 3 / 3
    nbytes = F32 * G * 3 * tri(M)
    return Work(products, 0.0, nbytes)
