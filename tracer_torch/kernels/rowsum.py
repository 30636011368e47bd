"""Deterministic row sums: out[r] = the sum of the cotangent rows g[k] of
every lane k whose row id idx[k] is r, the gradient of a row gather.

The replay's row gathers (`render/integrator.py::_take`, `_rows`: the
sphere, quad and material rows of each lane's hit, the mesh vertices of
its triangle, the exact atlases' texels on the plain autodiff route) sum
their lanes' cotangents onto the tables here. The JAX package takes those
rows by a one-hot product outside Pallas (`tracer/render/integrator.py:154`,
`_rows`), whose vjp onehot^T @ g sums in one fixed order. `index_add_`,
`index_select`'s own gradient and the plain version here
(`row_sum_plain`), sums with float atomics on the card, in an order that
changes from run to run; so did the general backward, and a resumed
training run drifted from the uninterrupted one. The CUDA kernels of
`csrc/row_sum.cu` sum every row in one fixed order: a stable radix sort of
the lanes by row id, then a fold of each row's run by segmented scans, one
column per grid row (B4's design, `kernels/fold.py`). Two calls on the
same inputs give the same bits, and the kernel agrees with the plain
version to f32 summation order. A CUDA tensor always takes the kernels,
for any number of rows (one radix pass up to 256 rows, one more for every
8 bits of the largest row id).

What bounds it on an H100: memory. The function reads 4 B of row id and
4·C B of cotangent a lane and writes 4·C B a row (32.6 MB for 408,000
lanes of 19 columns); the sort moves 8 B a lane a pass, and the fold reads
the sorted row ids again for each column, mostly through L2.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.kernels import common as kc

LAUNCHES = 0  # calls that launched the CUDA kernels (not the plain version)

TILE = 4096       # sort items per block (csrc/row_sum.cu)
CHUNK = 1024      # fold items per block
BINS = 256


def row_sum(idx, g, rows, kernels="auto"):
    """[rows, C] f32: row r is the sum of g[k] over the lanes k with
    idx[k] == r, and 0 where no lane has r. idx: [N] int, every id in
    [0, rows); g: [N, C] f32."""
    if kc.use_kernel(kernels, g):
        return _row_sum_cuda(idx, g, rows)
    return row_sum_plain(idx, g, rows)


def row_sum_plain(idx, g, rows):
    """The plain PyTorch version: `index_add_` onto zeros, the gradient
    `index_select` has (in lane order on the CPU; float atomics on the
    card)."""
    return g.new_zeros((rows, g.shape[1])).index_add_(
        0, idx.reshape(-1).long(), g)


class _Args(ctypes.Structure):
    """Mirror of `RowSumArgs` in csrc/row_sum.cu (same order)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "idx", "g", "out", "rec0", "rec1", "hist", "keys", "vals", "maps",
        "carry")]
        + [(name, ctypes.c_int) for name in ("n", "r", "c", "passes")])


def _row_sum_cuda(idx, g, rows):
    from tracer_torch.kernels import _build
    global LAUNCHES
    dev = g.device
    idx = idx.reshape(-1).to(torch.int32).contiguous()
    g = g.contiguous()
    N, C = idx.numel(), g.shape[1]
    if N >= 2 ** 31 - TILE or rows >= 2 ** 31 or C > 65535:
        raise ValueError(f"row_sum: {N} lanes, {rows} rows, {C} columns "
                         "exceed the kernel's int32 positions or its grid")
    out = torch.empty((rows, C), dtype=torch.float32, device=dev)
    if rows == 0 or C == 0:
        return out
    a = _Args()
    a.idx = kc.check("idx", idx, torch.int32, (N,), dev)
    a.g = kc.check("g", g, torch.float32, (N, C), dev)
    a.out = out.data_ptr()
    # one scratch buffer, freed when the call returns: the two pair
    # buffers [N, 2], the tiles' digit counts, the sorted row ids, then as
    # f32 the sorted cotangents [C, N], the chunks' maps [C, nf, 4] and
    # carries [C, nf]
    nt, nf = (N + TILE - 1) // TILE, (N + CHUNK - 1) // CHUNK
    sizes = (2 * N, 2 * N, BINS * nt, N, C * N, 4 * C * nf, C * nf)
    scratch = torch.empty((sum(sizes),), dtype=torch.int32, device=dev)
    (a.rec0, a.rec1, a.hist, a.keys, a.vals, a.maps, a.carry) = (
        t.data_ptr() for t in scratch.split(sizes))
    a.n, a.r, a.c = N, rows, C
    # the sort keys: the bits of the largest row id, at most rows - 1
    a.passes = max(1, ((max(rows - 1, 1)).bit_length() + 7) // 8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().tt_row_sum(ctypes.addressof(a), stream)
    kc.raise_on_error("row_sum", err)
    LAUNCHES += 1
    return out
