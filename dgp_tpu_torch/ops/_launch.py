"""Launch steps that the kernels' wrappers share: the call of a C entry
point on a tensor's card and current stream; the buffers of a backward
kernel's persistent grid (one slab of partial sums per block, added in a
fixed order by ``reduce_slabs``); and the passes, scratch and phase B of the
whitened conditional's two-phase backward (kernels #2 and #4)."""

from __future__ import annotations

import functools
import math
import types

import torch

from .. import _build


def run_kernel(lib, entry, device, what, *args):
    """Call ``entry(*args, stream)`` with ``device`` current and its current
    stream; raise if the launch returned a CUDA error."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, what)


def persistent_grid(blocks_of, device, shapes, refusal):
    """(blocks, scratch, out) of a backward kernel: ``blocks_of()`` (asked
    with ``device`` current) sizes the persistent grid, or is 0 where the
    kernel's plan refuses the sizes (then this raises ``refusal``); scratch
    holds one float32 slab of partial sums per block ([blocks, slab],
    bounded by the card's block count whatever n is) and out the summed
    slab, whose parts have ``shapes`` (see :func:`split_slab`)."""
    with torch.cuda.device(device):
        blocks = blocks_of()
    if blocks < 1:
        raise RuntimeError(refusal)
    slab = sum(math.prod(s) for s in shapes)
    f32 = dict(dtype=torch.float32, device=device)
    return blocks, torch.empty((blocks, slab), **f32), torch.empty((slab,), **f32)


def split_slab(out, shapes):
    """The parts of a summed slab, each viewed at its shape."""
    parts = torch.split(out, [math.prod(s) for s in shapes])
    return [p.view(s) for p, s in zip(parts, shapes)]


# Points per pass of the whitened conditional's two-phase backward (kernels
# #2 and #4): phase A writes A, dA (and Kuf) [M, pass] and gv [D, pass] for
# phase B, so one pass bounds the scratch (about 201 MB at M = 128 with Kuf);
# the passes' sums are added in pass order.
BACKWARD_PASS = 1 << 17


def backward_passes(n):
    """(start, count) of each pass of the whitened backward over n points."""
    return [(start, min(BACKWARD_PASS, n - start))
            for start in range(0, n, BACKWARD_PASS)]


@functools.lru_cache(maxsize=None)
def plan_sizes(lib, prefix):
    """(points per phase-A tile, points per phase-B slice) of a whitened
    backward: constants of its source, asked of the library once."""
    return getattr(lib, f"{prefix}_tile")(), getattr(lib, f"{prefix}_slice")()


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


def gram_sizes(lib, prefix, n, M, D):
    """Floats of phase B's buffers over n points: ``gram_parts``, one
    [D + 1, M, M] slot per slice of the largest pass, and ``gram``, their
    sum (the lower triangles of C_0 .. C_{D-1} and of dA Kuf^T)."""
    slices = -(-min(n, BACKWARD_PASS) // plan_sizes(lib, prefix)[1])
    return dict(gram_parts=slices * (D + 1) * M * M, gram=(D + 1) * M * M)


def backward_scratch(lib, prefix, n, M, D, small, with_kuf, device):
    """The buffers of the whitened backward over n points, sized for its
    largest pass and carved from one allocation (``buffer``): the data
    pointers ``a``, ``da`` (and ``kuf`` with ``with_kuf``) [M, ld] and
    ``gv`` [D, ld], ld the pass rounded up to whole tiles; ``tile_parts``,
    one slot of ``small`` floats per tile; phase B's ``gram_parts`` and
    ``gram`` (:func:`gram_sizes`); and the tensor ``small``, the tiles'
    slots summed."""
    tile = plan_sizes(lib, prefix)[0]
    tiles = -(-min(n, BACKWARD_PASS) // tile)
    ld = tiles * tile
    buffer, sc = carve(device, a=M * ld, da=M * ld,
                       kuf=M * ld if with_kuf else 0, gv=D * ld,
                       tile_parts=tiles * small,
                       **gram_sizes(lib, prefix, n, M, D))
    sc.buffer, sc.ld = buffer, ld
    sc.small = torch.empty((small,), dtype=torch.float32, device=device)
    return sc


def run_gram(lib, prefix, device, a, da, ld, kuf, ldk, gv, parts, gram, count,
             M, D, accumulate):
    """Phase B of the whitened backward on one pass of ``count`` points:
    ``gram`` (+)= the lower triangles of A diag(gv_d) A^T and dA Kuf^T. All
    operands are data pointers; a, da and gv have row stride ld, kuf ldk."""
    run_kernel(lib, getattr(lib, f"{prefix}_gram"), device,
               "whitened backward phase B launch", a, da, ld, kuf, ldk, gv,
               parts, gram, count, M, D, int(accumulate))


def finish_gram(lib, prefix, device, gram, sqT, M, D):
    """(dPinv, dSq) from the summed Grams (``gram``, a data pointer):
    tril(dA Kuf^T), and triu(2 Sq[d] C_d) with Sq[d] = sqT[d]^T, exact
    zeros elsewhere."""
    f32 = dict(dtype=torch.float32, device=device)
    dPinv = torch.empty((M, M), **f32)
    dSq = torch.empty((D, M, M), **f32)
    run_kernel(lib, getattr(lib, f"{prefix}_finish"), device,
               "whitened backward phase B finish launch", gram,
               sqT.data_ptr(), dPinv.data_ptr(), dSq.data_ptr(), M, D)
    return dPinv, dSq


def gram_backward(lib, prefix, counter, A, dA, Kuf, gv, Sq):
    """Phase B alone on float32 CUDA tensors A, dA, Kuf [M, n], gv [D, n] and
    Sq [D, M, M], in passes as the backward runs it: (tril(dA Kuf^T),
    triu(2 Sq[d] A diag(gv_d) A^T)). ``counter`` (the autograd Function)
    counts the launches in ``gram_launches``."""
    M, n = A.shape
    D = gv.shape[0]
    dev = A.device
    A, dA, Kuf, gv = (t.contiguous() for t in (A, dA, Kuf, gv))
    _buffer, sc = carve(dev, **gram_sizes(lib, prefix, n, M, D))
    for start, count in backward_passes(n):
        run_gram(lib, prefix, dev, pointer(A, start), pointer(dA, start), n,
                 pointer(Kuf, start), n, pointer(gv, start), sc.gram_parts,
                 sc.gram, count, M, D, start > 0)
        counter.gram_launches += 1
    return finish_gram(lib, prefix, dev, sc.gram,
                       Sq.transpose(1, 2).contiguous(), M, D)


def pointer(t, offset=0):
    """The data pointer of a float32 tensor ``offset`` elements in."""
    return t.data_ptr() + 4 * offset
