"""Texel-cotangent fold: the sum of per-update (texel id, rgb cotangent)
pairs onto a [P, 3] atlas gradient.

The record-replay backward folds the texel cotangents of every bounce but
the last onto `tex_data` and `nm_data` (~2M updates per Cornell sample),
differentiating the nearest-texel fetch of Material.cpp:82-88.

Replaces the TPU kernel `tracer/kernels/fold.py::sorted_fold` (Pallas,
`pl.pallas_call` at fold.py:148) and the `lax.sort` in front of it with the
CUDA kernels of `csrc/sorted_fold.cu`, one call: a stable compaction that
reads each bounce's record rows in place and drops the updates whose three
channels are all +-0 (at least 3/4 of a Cornell record; adding +-0 changes
no texel sum), a stable LSD radix sort of the survivors by texel id (8 bits
a pass, ceil(log2 P) bits in all), then a fold of the sorted survivors by
segmented scans: per chunk, over the chunks' carries, and again per chunk,
where the last update of each run writes its texel. No float atomics and no
search: the same record folds to the same bits on every run.
`sorted_fold_plain` is the plain PyTorch version, the flat scatter-add of
the JAX package's fallback (`fold.py:177-185`); the two agree to f32
summation order, and a NaN or +-inf cotangent reaches its texel in both. A
CUDA tensor always takes the kernels (no size cut-over).

What bounds it on an H100: memory. The function reads 16 B per update and
12 B per texel and writes 12 B per texel (~83 MB for Cornell's 2.04M
updates onto 2.1M texels); the compaction reads the stream twice, and
the sort moves 16 B per survivor a few times more, mostly through L2.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.kernels import common as kc

LAUNCHES = 0  # calls that launched the CUDA kernels (not the plain version)


MAX_SEG = 16      # segments the kernel reads in place (csrc/sorted_fold.cu)
TILE = 4096       # sort items per block
CHUNK = 1024      # fold items per block
BINS = 256


def sorted_fold(data_g, idx, gx, gy, gz, kernels="auto"):
    """data_g [P, 3] + scatter_add(idx [M], (gx, gy, gz) [M] each).
    Every id must lie in [0, P)."""
    return fold_updates(data_g, [idx], [(gx, gy, gz)], kernels=kernels)


def sorted_fold_plain(data_g, idx, gx, gy, gz):
    """The plain PyTorch version: one flat scatter-add with the three
    channels interleaved (the JAX package's fallback)."""
    idx = idx.reshape(-1).long()
    i3 = torch.cat([idx * 3, idx * 3 + 1, idx * 3 + 2])
    v3 = torch.cat([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)])
    return data_g.reshape(-1).index_add(0, i3, v3).reshape(data_g.shape)


def fold_updates(data_g, idxs, gs, kernels="auto"):
    """Fold per-bounce texel-cotangent updates onto a [P, 3] atlas grad in
    one fold. idxs: list of int index tensors; gs: matching list of planar
    (gx, gy, gz) cotangents. The kernel reads each bounce's rows where
    they lie; the plain version folds their concatenation."""
    if kc.use_kernel(kernels, data_g):
        return _sorted_fold_cuda(data_g, idxs, gs)
    idx = torch.cat([ix.reshape(-1) for ix in idxs])
    ch = [torch.cat([g[a].reshape(-1) for g in gs]) for a in range(3)]
    return sorted_fold_plain(data_g, idx, *ch)


class _Args(ctypes.Structure):
    """Mirror of `FoldArgs` in csrc/sorted_fold.cu (same order)."""
    _fields_ = ([(name, ctypes.c_void_p * MAX_SEG)
                 for name in ("ids", "gx", "gy", "gz")]
                + [("len", ctypes.c_int * MAX_SEG),
                   ("blk", ctypes.c_int * (MAX_SEG + 1)),
                   ("nseg", ctypes.c_int)]
                + [(name, ctypes.c_void_p) for name in (
                    "data", "out", "rec0", "rec1", "tcount", "hist", "count",
                    "maps", "carry")]
                + [(name, ctypes.c_int) for name in ("p", "m", "passes")])


def _sorted_fold_cuda(data_g, idxs, gs):
    from tracer_torch.kernels import _build
    global LAUNCHES
    dev = data_g.device
    f32, i32 = torch.float32, torch.int32
    segs = [(ix.reshape(-1).to(i32), *(g[c].reshape(-1) for c in range(3)))
            for ix, g in zip(idxs, gs)]
    segs = [s for s in segs if s[0].numel() > 0]
    if len(segs) > MAX_SEG:
        segs = [tuple(torch.cat([s[c] for s in segs]) for c in range(4))]
    P = data_g.shape[0]
    M = sum(s[0].numel() for s in segs)
    if P >= 2 ** 31 or M >= 2 ** 31 - TILE:
        raise ValueError("sorted_fold: too many texels or updates for "
                         "int32 positions")
    a = _Args()
    blk = 0
    for q, (ix, x, y, z) in enumerate(segs):
        n = ix.numel()
        a.ids[q] = kc.check(f"idx[{q}]", ix, i32, (n,), dev)
        a.gx[q], a.gy[q], a.gz[q] = (
            kc.check(f"g[{q}]", t, f32, (n,), dev) for t in (x, y, z))
        a.len[q], a.blk[q] = n, blk
        blk += (n + TILE - 1) // TILE
    a.blk[len(segs)] = blk
    a.nseg = len(segs)
    a.data = kc.check("data_g", data_g, f32, (P, 3), dev)
    out = torch.empty_like(data_g)
    # one scratch buffer: the two record buffers [M, 4], the stream tiles'
    # survivor counts, the digit counts, the survivor count, then the
    # chunks' maps [nf, 8] and carries [nf, 4] as f32
    nt, nf = (M + TILE - 1) // TILE, (M + CHUNK - 1) // CHUNK
    sizes = (4 * M, 4 * M, blk, BINS * nt, 1, 8 * nf, 4 * nf)
    scratch = torch.empty((sum(sizes),), dtype=i32, device=dev)
    parts = scratch.split(sizes)
    (a.rec0, a.rec1, a.tcount, a.hist, a.count, a.maps, a.carry) = (
        t.data_ptr() for t in parts)
    a.out = out.data_ptr()
    # the sort keys: the bits of the largest id, at most P - 1
    a.p, a.m = P, M
    a.passes = max(1, ((max(P - 1, 1)).bit_length() + 7) // 8)
    if P > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_sorted_fold(ctypes.addressof(a), stream)
        kc.raise_on_error("sorted_fold", err)
        LAUNCHES += 1
    return out
