"""Launch steps that the kernels' wrappers share: the call of a C entry
point on a tensor's card and current stream; the size of a persistent
grid; and the passes, scratch and phase B of the two-phase backwards (the
whitened conditional's, kernels #2 and #4, and the quadform's, #6)."""

from __future__ import annotations

import functools
import types

import torch

from .. import _build


def run_kernel(lib, entry, device, what, *args):
    """Call ``entry(*args, stream)`` with ``device`` current and its current
    stream; raise if the launch returned a CUDA error."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, what)


# Points per pass of the two-phase backwards: the whitened conditional's
# (#2, #4) phase A writes A, dA (and Kuf) [M, pass] and gv [D, pass] for
# phase B, so one pass bounds the scratch (about 201 MB at M = 128 with
# Kuf); phase B keeps one partial sum per slice of a pass (the quadform's,
# #6, 67 MB at M = 128, D = 8). The passes' sums are added in pass order.
BACKWARD_PASS = 1 << 17


def backward_passes(n):
    """(start, count) of each pass of a two-phase backward over n points."""
    return [(start, min(BACKWARD_PASS, n - start))
            for start in range(0, n, BACKWARD_PASS)]


@functools.lru_cache(maxsize=None)
def plan_size(lib, prefix, what):
    """Points per phase-A ``tile`` or per phase-B ``slice`` of a two-phase
    backward: a constant of its source, asked of the library once."""
    return getattr(lib, f"{prefix}_{what}")()


@functools.lru_cache(maxsize=None)
def grid_blocks(lib, prefix, device, *sizes):
    """A persistent grid's blocks on ``device`` (a forward's, or a backward's
    phase A) for the sizes that the library's ``{prefix}_blocks`` entry takes
    (0 where its plan refuses them), asked once per device and sizes."""
    with torch.cuda.device(device):
        return getattr(lib, f"{prefix}_blocks")(*sizes)


def carve(device, **sizes):
    """One float32 allocation on ``device`` cut into parts of ``sizes``
    floats, each starting on a 256-byte boundary: (the owning tensor, the
    parts' data pointers by name)."""
    rounded = {k: -(-v // 64) * 64 for k, v in sizes.items()}
    buffer = torch.empty((sum(rounded.values()),), dtype=torch.float32,
                         device=device)
    pointers, offset = {}, 0
    for name, size in rounded.items():
        pointers[name] = pointer(buffer, offset)
        offset += size
    return buffer, types.SimpleNamespace(**pointers)


def gram_sizes(lib, prefix, n, M, mats):
    """Floats of phase B's buffers over n points: ``gram_parts``, one
    [mats, M, M] slot per slice of the largest pass, and ``gram``, their
    sum (the lower triangles of C_0 .. C_{D-1}, and of dA Kuf^T where
    mats = D + 1)."""
    slices = -(-min(n, BACKWARD_PASS) // plan_size(lib, prefix, "slice"))
    return dict(gram_parts=slices * mats * M * M, gram=mats * M * M)


def backward_scratch(lib, prefix, n, M, D, small, with_kuf, device):
    """The buffers of the whitened backward over n points, sized for its
    largest pass and carved from one allocation (``buffer``): the data
    pointers ``a``, ``da`` (and ``kuf`` with ``with_kuf``) [M, ld] and
    ``gv`` [D, ld], ld the pass rounded up to whole tiles; ``tile_parts``,
    one slot of ``small`` floats per tile; phase B's ``gram_parts`` and
    ``gram`` (:func:`gram_sizes`); and the tensor ``small``, the tiles'
    slots summed."""
    tile = plan_size(lib, prefix, "tile")
    tiles = -(-min(n, BACKWARD_PASS) // tile)
    ld = tiles * tile
    buffer, sc = carve(device, a=M * ld, da=M * ld,
                       kuf=M * ld if with_kuf else 0, gv=D * ld,
                       tile_parts=tiles * small,
                       **gram_sizes(lib, prefix, n, M, D + 1))
    sc.buffer, sc.ld = buffer, ld
    sc.small = torch.empty((small,), dtype=torch.float32, device=device)
    return sc


def run_gram(lib, prefix, device, operands, parts, gram, count, M, D,
             accumulate):
    """Phase B of a two-phase backward on one pass of ``count`` points:
    ``gram`` (+)= the lower triangles of A diag(gv_d) A^T and, for the
    whitened backwards, dA Kuf^T. ``operands`` are the arguments the
    library's ``{prefix}_gram`` entry takes before ``parts``: data pointers
    and row strides, (a, da, ld, kuf, ldk, gv) for the whitened backwards
    and (a, ld, gv) for the quadform's."""
    run_kernel(lib, getattr(lib, f"{prefix}_gram"), device,
               "backward phase B launch", *operands, parts, gram, count, M, D,
               int(accumulate))


def finish_gram(lib, prefix, device, gram, sqT, M, D, with_pinv=True):
    """(dPinv, dSq) from the summed Grams (``gram``, a data pointer):
    tril(dA Kuf^T) (None without ``with_pinv``, whose ``{prefix}_finish``
    takes no dPinv), and triu(2 Sq[d] C_d) with Sq[d] = sqT[d]^T, exact
    zeros elsewhere."""
    f32 = dict(dtype=torch.float32, device=device)
    dPinv = torch.empty((M, M), **f32) if with_pinv else None
    dSq = torch.empty((D, M, M), **f32)
    outputs = (dPinv.data_ptr(), dSq.data_ptr()) if with_pinv else (dSq.data_ptr(),)
    run_kernel(lib, getattr(lib, f"{prefix}_finish"), device,
               "backward phase B finish launch", gram, sqT.data_ptr(),
               *outputs, M, D)
    return dPinv, dSq


def gram_backward(lib, prefix, counter, A, gv, sqT, dA=None, Kuf=None):
    """Phase B on float32 CUDA tensors A [M, n], gv [D, n] and
    sqT [D, M, M] (Sq[d]^T, contiguous), and dA, Kuf [M, n] or None, in
    passes of :data:`BACKWARD_PASS` points: (tril(dA Kuf^T), or None
    without dA and Kuf; triu(2 Sq[d] A diag(gv_d) A^T)). ``counter`` (the
    autograd Function) counts the passes in ``gram_launches``."""
    M, n = A.shape
    D = gv.shape[0]
    dev = A.device
    with_pinv = dA is not None
    A, gv = A.contiguous(), gv.contiguous()
    if with_pinv:
        dA, Kuf = dA.contiguous(), Kuf.contiguous()
    _buffer, sc = carve(dev, **gram_sizes(lib, prefix, n, M, D + with_pinv))
    for start, count in backward_passes(n):
        a, g = pointer(A, start), pointer(gv, start)
        operands = ((a, pointer(dA, start), n, pointer(Kuf, start), n, g)
                    if with_pinv else (a, n, g))
        run_gram(lib, prefix, dev, operands, sc.gram_parts, sc.gram, count,
                 M, D, start > 0)
        counter.gram_launches += 1
    return finish_gram(lib, prefix, dev, sc.gram, sqT, M, D, with_pinv)


def pointer(t, offset=0):
    """The data pointer of a float32 tensor ``offset`` elements in."""
    return t.data_ptr() + 4 * offset
