"""Frozen for the benchmark's reference from the port's `core/mathutils.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Shading math (the port of `tracer/core/mathutils.py`); only what the
port uses (its images take gamma in `render/film.py::to_image`)."""

from __future__ import annotations

import torch


def schlick_reflectance(cosine, ref_idx):
    """Schlick's approximation (reference: Functions.cpp:49-54), pow(m, 5)
    as explicit multiplies (the kernels' form)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = torch.clamp_min(1.0 - cosine, 0.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)
