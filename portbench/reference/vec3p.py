"""Frozen for the benchmark's reference from the port's `core/vec3p.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Planar 3-vector helpers (the port of `tracer/core/vec3p.py`): a vector
batch is a tuple (x, y, z) of [N] tensors instead of one [N, 3] tensor.

The port keeps the JAX package's planar layout at its public functions so
the parity tests compare like with like; on the card it also gives every
component its own contiguous array, which is what the kernels read.
Every op is differentiable (the general bounce runs under autograd).
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


def splat(a):
    """[..., 3] tensor -> (x, y, z) components."""
    return a[..., 0], a[..., 1], a[..., 2]


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def scale(s, v):
    return s * v[0], s * v[1], s * v[2]


def mul(a, b):
    """Component (Hadamard) product."""
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def axpy(s, a, b):
    """s*a + b."""
    return s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2]


def norm(v):
    return torch.sqrt(dot(v, v))


def full_like(v, val):
    return (torch.full_like(v[0], val), torch.full_like(v[1], val),
            torch.full_like(v[2], val))


def reflect(d, n):
    """Mirror reflection (reference: Functions.cpp:38-40)."""
    k = 2.0 * dot(d, n)
    return d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2]


def refract(d, n, etai_over_etat):
    """RTiOW-form refraction (reference: Functions.cpp:42-47), per-ray
    eta. The clamp keeps sqrt's derivative finite on lanes that do not
    refract (0 * inf would leak NaN through the lobe selects)."""
    cos_theta = torch.clamp_max(dot(d, n), 1.0)
    perp = scale(etai_over_etat, axpy(cos_theta, n, d))
    k = torch.abs(1.0 - dot(perp, perp))
    par = -torch.sqrt(torch.clamp_min(k, 1e-12))
    return axpy(par, n, perp)
