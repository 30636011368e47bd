"""OFF/COFF mesh loading (host-side, numpy).

Copy of `tracer/io/off.py` (the port carries its own numpy host layer so
that it never imports the JAX package). Replaces the reference's
`Mesh::loadOFF` (`src/Mesh.cpp:9-74`) with a
vectorized parser producing SoA arrays. Supports:
- `OFF`  — plain `x y z` vertices;
- `COFF` — per-vertex colors `x y z r g b a` (colors /255, Mesh.cpp:26-27);
- per-FACE colors, detected from the first triangle line having extra fields
  (Mesh.cpp:42-51), `/255`.

Returns `(verts[V,3] f32, tris[T,3] i32, vert_colors[V,3]|None,
face_colors[T,3]|None)`.
"""

from __future__ import annotations

import numpy as np

COLOR_NONE = "none"
COLOR_VERTEX = "vertex"
COLOR_FACE = "face"


def load_off(path: str):
    with open(path, "r") as f:
        text = f.read()
    lines = [ln for ln in (l.strip() for l in text.splitlines())
             if ln and not ln.startswith("#")]
    header = lines[0].split()
    magic = header[0]
    if len(header) > 1:
        counts = [int(x) for x in header[1:4]]
        body_at = 1
    else:
        counts = [int(x) for x in lines[1].split()[:3]]
        body_at = 2
    n_v, n_t = counts[0], counts[1]

    vert_lines = lines[body_at : body_at + n_v]
    tri_lines = lines[body_at + n_v : body_at + n_v + n_t]

    vdata = np.array([ln.split() for ln in vert_lines], dtype=np.float64)
    verts = vdata[:, :3].astype(np.float32)
    vert_colors = None
    if magic == "COFF" and vdata.shape[1] >= 6:
        vert_colors = (vdata[:, 3:6] / 255.0).astype(np.float32)

    first = tri_lines[0].split()
    has_face_colors = len(first) > 4  # count + 3 indices + extras
    tris = np.empty((n_t, 3), np.int32)
    face_colors = np.empty((n_t, 3), np.float32) if has_face_colors else None
    for i, ln in enumerate(tri_lines):
        parts = ln.split()
        tris[i] = [int(parts[1]), int(parts[2]), int(parts[3])]
        if has_face_colors:
            face_colors[i] = [float(parts[4]) / 255.0,
                              float(parts[5]) / 255.0,
                              float(parts[6]) / 255.0]
    return verts, tris, vert_colors, face_colors
