"""Ray/primitive intersection, planar (the port of the sphere and quad
pieces of `tracer/geometry/primitives.py` that the plain first-hit pass
uses). Each function tests one primitive against a ray batch, or derives
the hit detail of per-lane primitive parameters; all arguments broadcast.
The expressions and their order are those of the TPU first-hit kernel
(`tracer/kernels/intersect.py`), so the CUDA kernel matches them bit for
bit.

Reference semantics: a sphere gives its nearer root only and requires
t >= eps; a quad is backface-culled unless its material is glass; motion
blur moves centres and quad origins by `time * motion_blur_translation`.
"""

from __future__ import annotations

import torch

INF = 3.0e38


def sphere_t(o, d, a2, time, c, r, mb, valid, eps):
    """Candidate t vs one sphere (INF-free: returns (t, ok)). o, d planar
    [N]; a2 = d.d; c, mb: 3-tuples; r, valid: scalars."""
    ocx = o[0] - (c[0] + time * mb[0])
    ocy = o[1] - (c[1] + time * mb[1])
    ocz = o[2] - (c[2] + time * mb[2])
    b = 2.0 * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    delta = b * b - 4.0 * a2 * cc
    t = (-b - torch.sqrt(torch.clamp_min(delta, 0.0))) / (2.0 * a2)
    return t, (delta >= 0.0) & (t >= eps) & (valid > 0.5)


def quad_t(o, d, time, row, eps):
    """Candidate t vs one quad given its first-hit table row (stored normal
    and precomputed dots, kernels/intersect.py::intersect_tables).
    Returns (t, ok)."""
    nsx, nsy, nsz = row[9], row[10], row[11]
    dotRN = d[0] * nsx + d[1] * nsy + d[2] * nsz
    o_n = o[0] * nsx + o[1] * nsy + o[2] * nsz
    D = row[15] + time * row[16]
    t = (D - o_n) / torch.where(dotRN == 0.0, 1e-30, dotRN)
    ex, ey, ez = row[3], row[4], row[5]
    o_er = o[0] * ex + o[1] * ey + o[2] * ez
    d_er = d[0] * ex + d[1] * ey + d[2] * ez
    s1 = o_er + t * d_er - (row[17] + time * row[18])
    ux, uy, uz = row[6], row[7], row[8]
    o_eu = o[0] * ux + o[1] * uy + o[2] * uz
    d_eu = d[0] * ux + d[1] * uy + d[2] * uz
    s2 = o_eu + t * d_eu - (row[19] + time * row[20])
    front = dotRN < 0.0
    two_sided = row[23] > 0.5
    ok = (dotRN != 0.0) & (front | two_sided) & (t >= eps)
    ok &= (s1 >= 0.0) & (s1 <= row[21]) & (s2 >= 0.0) & (s2 <= row[22])
    ok &= row[24] > 0.5
    return t, ok


def sphere_hit_detail(o, d, a2, time, c, r, mb):
    """Hit point and unit normal on the selected sphere (per-lane params).
    max(delta, 1e-12) keeps lanes that did not select this sphere finite."""
    tcx = c[0] + time * mb[0]
    tcy = c[1] + time * mb[1]
    tcz = c[2] + time * mb[2]
    ocx, ocy, ocz = o[0] - tcx, o[1] - tcy, o[2] - tcz
    b = 2.0 * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    delta = b * b - 4.0 * a2 * cc
    sq = torch.sqrt(torch.clamp_min(delta, 1e-12))
    ts = (-b - sq) / (2.0 * a2)
    p = (o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2])
    nx, ny, nz = p[0] - tcx, p[1] - tcy, p[2] - tcz
    inv = 1.0 / torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz),
                                1e-20)
    return p, (nx * inv, ny * inv, nz * inv)


def quad_hit_detail(o, d, time, v0, er, eu, mb):
    """Hit point, unit normal (recomputed as normalize(er x eu)) and (u, v)
    on the selected quad (per-lane params)."""
    ex, ey, ez = er
    ux, uy, uz = eu
    cx = ey * uz - ez * uy
    cy = ez * ux - ex * uz
    cz = ex * uy - ey * ux
    inv = 1.0 / torch.clamp_min(torch.sqrt(cx * cx + cy * cy + cz * cz),
                                1e-20)
    nx, ny, nz = cx * inv, cy * inv, cz * inv
    blx = v0[0] + time * mb[0]
    bly = v0[1] + time * mb[1]
    blz = v0[2] + time * mb[2]
    dotRN = d[0] * nx + d[1] * ny + d[2] * nz
    safe = torch.where(torch.abs(dotRN) < 1e-9,
                       torch.where(dotRN < 0, -1e-9, 1e-9), dotRN)
    t = ((blx * nx + bly * ny + blz * nz)
         - (o[0] * nx + o[1] * ny + o[2] * nz)) / safe
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    qx, qy, qz = p[0] - blx, p[1] - bly, p[2] - blz
    u = (qx * ex + qy * ey + qz * ez) / torch.clamp_min(
        ex * ex + ey * ey + ez * ez, 1e-30)
    v = (qx * ux + qy * uy + qz * uz) / torch.clamp_min(
        ux * ux + uy * uy + uz * uz, 1e-30)
    return p, (nx, ny, nz), u, v
