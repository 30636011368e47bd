"""Frozen for the benchmark's reference from the port's `accel/bvh.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Flattened SoA BVH (the port of `tracer/accel/bvh.py`, numpy only, a
copy because importing anything under `tracer` imports JAX).

An object-median BVH over per-triangle boxes (each triangle in exactly one
leaf, leaves padded to a fixed width), flattened in DFS preorder with skip
links, so traversal is a stackless walk (`i = hit ? i+1 : skip[i]`) that
needs no per-ray stack. Boxes are built over triangles scaled by
TRIANGLE_SCALING about the origin (`Mesh.h:23`, `KDTree.cpp:38-40`), so
culling is conservative with respect to the leaf test and the walk finds
the brute-force closest hit. This median-split builder is the numpy
fallback; `tracer_torch/accel/native.py` builds binned-SAH trees in C++.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRIANGLE_SCALING = 1.000001  # reference: Mesh.h:23


@dataclasses.dataclass
class FlatBVH:
    """Flattened tree. All numpy, concatenable across meshes."""
    node_lo: np.ndarray       # [B, 3] f32
    node_hi: np.ndarray       # [B, 3] f32
    node_leaf_start: np.ndarray  # [B] i32 — offset into leaf_tris; -1 inner
    node_skip: np.ndarray     # [B] i32 — next node index when missed/after leaf
    leaf_tris: np.ndarray     # [n_leaves * leaf_width] i32 global tri ids
    leaf_width: int
    n_nodes: int


def build_bvh(tri_lo: np.ndarray, tri_hi: np.ndarray, leaf_width: int = 4,
              max_depth: int = 64, sentinel: int = -1) -> FlatBVH:
    """Median-split BVH over per-triangle AABBs.

    tri_lo/tri_hi: [T, 3] bounds (callers should pass bounds of the *scaled*
    triangles). Leaves hold exactly `leaf_width` slots, padded with
    `sentinel` (a degenerate triangle index the intersector rejects).
    """
    T = tri_lo.shape[0]
    centroids = 0.5 * (tri_lo + tri_hi)

    node_lo, node_hi, node_leaf_start, node_skip = [], [], [], []
    leaf_tris: list[int] = []

    def emit(ids: np.ndarray, depth: int) -> int:
        idx = len(node_lo)
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        node_lo.append(lo)
        node_hi.append(hi)
        node_leaf_start.append(-1)
        node_skip.append(-1)

        make_leaf = len(ids) <= leaf_width or depth >= max_depth
        if not make_leaf:
            ext = hi - lo
            axis = int(np.argmax(ext))
            order = np.argsort(centroids[ids, axis], kind="stable")
            half = len(ids) // 2
            left_ids, right_ids = ids[order[:half]], ids[order[half:]]
            if len(left_ids) == 0 or len(right_ids) == 0:
                make_leaf = True
        if make_leaf:
            # Oversized degenerate leaves (depth cap) spill into chains of
            # full-width leaves sharing one bbox.
            start = len(leaf_tris)
            node_leaf_start[idx] = start
            chunk = list(ids[:leaf_width])
            leaf_tris.extend(chunk + [sentinel] * (leaf_width - len(chunk)))
            rest = ids[leaf_width:]
            node_skip[idx] = idx + 1
            last = idx
            while len(rest) > 0:
                j = len(node_lo)
                node_lo.append(lo)
                node_hi.append(hi)
                node_leaf_start.append(len(leaf_tris))
                chunk = list(rest[:leaf_width])
                leaf_tris.extend(chunk + [sentinel] * (leaf_width - len(chunk)))
                node_skip.append(j + 1)
                rest = rest[leaf_width:]
                last = j
            return last + 1
        else:
            end_left = emit(left_ids, depth + 1)
            end = emit(right_ids, depth + 1)
            node_skip[idx] = end
            return end

    if T > 0:
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * max_depth + 100))
        emit(np.arange(T), 0)
        sys.setrecursionlimit(old)

    return FlatBVH(
        node_lo=np.asarray(node_lo, np.float32).reshape(-1, 3),
        node_hi=np.asarray(node_hi, np.float32).reshape(-1, 3),
        node_leaf_start=np.asarray(node_leaf_start, np.int32).reshape(-1),
        node_skip=np.asarray(node_skip, np.int32).reshape(-1),
        leaf_tris=np.asarray(leaf_tris, np.int32).reshape(-1),
        leaf_width=leaf_width,
        n_nodes=len(node_lo),
    )


def triangle_bounds(verts: np.ndarray, tris: np.ndarray,
                    scaling: float = TRIANGLE_SCALING, margin: float = 1e-5):
    """Per-triangle AABBs of the *scaled* triangles (+margin)."""
    v = verts[tris] * scaling  # [T, 3, 3]
    return v.min(axis=1) - margin, v.max(axis=1) + margin
