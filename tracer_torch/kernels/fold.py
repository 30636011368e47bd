"""Texel-cotangent fold: the sum of per-update (texel id, rgb cotangent)
pairs onto a [P, 3] atlas gradient.

The record-replay backward folds the texel cotangents of every bounce but
the last onto `tex_data` and `nm_data` (~2M updates per Cornell sample),
differentiating the nearest-texel fetch of Material.cpp:82-88.

Replaces the TPU kernel `tracer/kernels/fold.py::sorted_fold` (Pallas,
`pl.pallas_call` at fold.py:148) with the CUDA kernel
`csrc/sorted_fold.cu`. As on the TPU, the update stream is sorted by texel
id outside the kernel (`torch.sort`, stable, then the payload gather, where
the JAX package has `lax.sort`); the kernel does the accumulation in two
passes: per chunk of 1024 sorted updates, a segmented scan gives the sum
of each run's piece in the chunk; then one thread per texel adds its run's
pieces in order. It uses no float atomics, so it is deterministic: the same
record folds to the same bits on every run. `sorted_fold_plain` is the
plain PyTorch version, the flat scatter-add of the JAX package's fallback
(`fold.py:177-185`); the two agree to f32 summation order. A CUDA tensor
always takes the kernel (no size cut-over).

What bounds it on an H100: memory. The function reads 16 B per update and
12 B per texel and writes 12 B per texel (~83 MB for Cornell's 2.04M
updates onto 2.1M texels); the piece sums add ~12 B per update of scratch
traffic, and the sort before it moves more than the kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.kernels import common as kc

LAUNCHES = 0  # launches of the CUDA kernel (not of the plain version)


def sorted_fold(data_g, idx, gx, gy, gz, kernels="auto"):
    """data_g [P, 3] + scatter_add(idx [M], (gx, gy, gz) [M] each).
    Every id must lie in [0, P)."""
    if kc.use_kernel(kernels, data_g):
        return _sorted_fold_cuda(data_g, idx, gx, gy, gz)
    return sorted_fold_plain(data_g, idx, gx, gy, gz)


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
    (gx, gy, gz) cotangents."""
    idx = torch.cat([ix.reshape(-1) for ix in idxs])
    ch = [torch.cat([g[a].reshape(-1) for g in gs]) for a in range(3)]
    return sorted_fold(data_g, idx, *ch, kernels=kernels)


class _Args(ctypes.Structure):
    """Mirror of `FoldArgs` in csrc/sorted_fold.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ids", "g", "data", "part", "out")] + [("p", ctypes.c_int),
                                               ("m", ctypes.c_int)]


def _sorted_fold_cuda(data_g, idx, gx, gy, gz):
    from tracer_torch.kernels import _build
    global LAUNCHES
    dev = data_g.device
    P, M = data_g.shape[0], idx.numel()
    if P >= 2 ** 31 or M >= 2 ** 31 - 1024:
        raise ValueError("sorted_fold: too many texels or updates for "
                         "int32 positions")
    ids, perm = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    g = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)])
    g = g[:, perm].contiguous()
    out = torch.empty_like(data_g)
    part = torch.empty((3, M), dtype=torch.float32, device=dev)
    a = _Args()
    a.ids = kc.check("ids", ids, torch.int32, (M,), dev)
    a.g = kc.check("g", g, torch.float32, (3, M), dev)
    a.data = kc.check("data_g", data_g, torch.float32, (P, 3), dev)
    a.part, a.out = part.data_ptr(), out.data_ptr()
    a.p, a.m = P, M
    if P > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_sorted_fold(ctypes.addressof(a), stream)
        kc.raise_on_error("sorted_fold", err)
        LAUNCHES += 1
    return out
