"""Planar 3-vector helpers (the port of `tracer/core/vec3p.py`): a vector
batch is a tuple (x, y, z) of [N] tensors instead of one [N, 3] tensor.

The port keeps the JAX package's planar layout at its public functions so
the parity tests compare like with like; on the card it also gives every
component its own contiguous array, which is what the kernels read.
Only what the forward slice uses is ported.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize(v, eps: float = 1e-20):
    """v * (1 / max(|v|, eps)) — the reciprocal form of vec3p.normalize."""
    inv = 1.0 / torch.clamp_min(torch.sqrt(dot(v, v)), eps)
    return inv * v[0], inv * v[1], inv * v[2]


def where(m, a, b):
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))
