"""Operations and bytes that a function needs, counted from its shapes:
one file per kernel of the port (``k1``, ``k2``, ``k5``, ``k6``, ``k8``)
and the model's own work (``dgp``), which ``mfu`` reads.

Counting rules, the same in every file:

* A product's operations are 2 per multiply-add, and a triangular operand
  counts only its nonzeros: M(M+1)/2 entries of an M x M triangle.
* Elementwise arithmetic counts one operation per add, multiply, exp or
  sqrt; comparisons and clamps count nothing.
* Every input byte is read once and every output byte written once; a
  triangular input or output counts its M(M+1)/2 entries.
* Only the work that the inputs need is counted: a backward that is not
  given the forward's intermediates has to recompute them, and that work is
  counted; a model's step is counted without recomputation.

:class:`Work` prices the counts at the peaks of ``peaks.py``.
"""

from __future__ import annotations

from typing import NamedTuple

from .. import peaks

F32 = 4


class Work(NamedTuple):
    """Operations and bytes of some work: ``products`` (matrix-product
    operations), ``other`` (every other operation) and ``bytes``."""

    products: float = 0.0
    other: float = 0.0
    bytes: float = 0.0

    def __add__(self, other):
        return Work(*(a + b for a, b in zip(self, other)))

    def scaled(self, k):
        return Work(*(k * a for a in self))

    def seconds(self):
        """The least time at the card's peaks: the operations' time or the
        bytes' time, whichever is larger."""
        ops = self.products / peaks.PRODUCT_FLOPS + self.other / peaks.OTHER_FLOPS
        return max(ops, self.bytes / peaks.BYTES_PER_S)


def tri(M):
    """Entries of an M x M triangle, its diagonal included."""
    return M * (M + 1) // 2
