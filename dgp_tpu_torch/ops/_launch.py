"""Launch steps that the kernels' wrappers share: the call of a C entry
point on a tensor's card and current stream, and the buffers of a backward
kernel's persistent grid (one slab of partial sums per block, added in a
fixed order by ``reduce_slabs``)."""

from __future__ import annotations

import math

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
