"""Bytes and f32 operations of one call of each hand-written kernel, each
input byte read once and each output byte written once, whatever the
kernel reads again. Frozen from the port's `chip_smoke.py`
(`first_hits_bytes`, `shade_bytes_new`, `bwd_bytes`, the fold's bytes and
the OPS_* constants) so that the program cannot move them; the tree
kernels (B5, B6) count each node and triangle of the tree once and each
live lane's input and output, not the nodes a walk happened to visit.

The operation counts are those of the work as the port does it today: a
change of algorithm (a BVH over spheres for B6, say) can make one stale,
and repairing it is the benchmark's job. Every f32 / i32 is 4 B, a bool
1 B."""

from __future__ import annotations

import math

# f32 operations: a table candidate test (a sphere or a quad), a winner's
# detail, a BVH node visit (slab test), a triangle test, a shadow sample
# ray (jitter draw, offset, length, normalisation, origin, hashes), an
# active lane's shading and scatter, each light's term
OPS_TABLE, OPS_DETAIL, OPS_VISIT, OPS_TRI = 30, 60, 27, 45
OPS_SAMPLE, OPS_SHADE, OPS_LIGHT = 60, 150, 25

# bytes of the per-scene tables a kernel reads once a call
SPH_COLS, QUAD_COLS, MESH_PACK_COLS = 9, 47, 24     # B1's tables
MAT_COLS, LIGHT_COLS = 20, 6                        # B2's tables
NODE_BYTES, TRI_BYTES = 32, 72   # a node's lo, hi, leaf row, skip; a
                                 # triangle's 18 f32 leaf constants


def b1_first_hits(n, live, tex_out, n_meshes, S, Q, T):
    """B1 (`first_hits`, slim record): every lane's live flag and the
    integer fields a consumer indexes with (j, tid, mid, row, sub; with
    tex_out=2 also idx_t, idx_n); a live lane's o, d, time and its mesh
    hits (t, tri a mesh), and its p, n, u, v; the sphere and quad tables
    and on mesh scenes the triangle pack. Operations: a live lane tests
    every sphere and quad and derives its winner's detail."""
    n_int = 7 if tex_out == 2 else 5
    nb = (n + 4 * n * n_int + 4 * live * (7 + 2 * n_meshes + 8)
          + 4 * (S * SPH_COLS + Q * QUAD_COLS)
          + (4 * T * MESH_PACK_COLS if n_meshes else 0))
    return nb, live * ((S + Q) * OPS_TABLE + OPS_DETAIL)


def b2_shade(n, active, hits, use_pair, last, n_lights, M, uv=True):
    """B2 (`shade_scatter`, state in place): every lane's active flag; an
    active lane that hits reads its j, mid, p, n, d, throughput, acc and
    shadow factors, its u, v where a material is textured or checkered
    (`uv`), with the pair atlas row, sub and the two texel words, before
    the last bounce its key; an active lane that misses
    reads j, d, throughput and acc (the sky); every active lane writes
    acc, and before the last bounce a lane that hits its o, d and
    throughput, a lane that misses its active flag; the material and
    light tables once. Operations: an active lane's shading and scatter
    and each light's term."""
    rd_hit = 2 + (2 if uv else 0) + 3 + 3 + 3 + 3 + 3 + n_lights + (
        0 if last else 1)
    if use_pair:
        rd_hit += 4
    rd_miss = 1 + 3 + 3 + 3
    wr = 4 * 3 * active
    if not last:
        wr += 4 * 9 * hits + (active - hits)
    nb = (n + 4 * (rd_hit * hits + rd_miss * (active - hits)) + wr
          + 4 * (M * MAT_COLS + max(n_lights, 1) * LIGHT_COLS))
    return nb, active * (OPS_SHADE + n_lights * OPS_LIGHT)


def b3_bounce_bwd(n, active, last, has_pair, S, Q, M):
    """B3 (`bounce_bwd`, both kernels): an active lane reads its state
    (10 f32), j, time and the pixel cotangent (3), with the pair atlas the
    texel record (8 f32), before the last bounce its key and the next
    state's cotangents (10); a lane that is not active reads its flag and,
    before the last bounce, the cotangents it passes on; every lane writes
    its state cotangents (10 f32) and with the pair atlas its texel
    cotangents (6); the small tables (sph 8, quad 19, mat 21 columns) are
    read once and the running tables (18 M + 8 S + 19 Q + 1 entries) read
    and written once. Operations: not counted (the byte bound is the
    larger by far, PERF.md)."""
    live = 10 + 1 + 1 + 3 + (8 if has_pair else 0) + (0 if last else 11)
    dead = 1 + (0 if last else 10)
    out = 10 + (6 if has_pair else 0)
    tables = 4 * (8 * S + 19 * Q + 21 * M)
    acc = 4 * (18 * M + 8 * S + 19 * Q + 1)
    nb = (4 * (active * live + (n - active) * dead + n * out) + tables
          + 2 * acc)
    return nb, 0


def b4_fold(updates, texels):
    """B4 (`sorted_fold`): each update's texel id and 3 cotangents read
    once, the [P, 3] f32 atlas gradient read and the result written."""
    return 16 * updates + 2 * 12 * texels, 0


def _tree(n_nodes, n_tris):
    return NODE_BYTES * n_nodes + TRI_BYTES * n_tris


def tree_depth(n_tris, leaf_width):
    """The root-to-leaf depth of a balanced tree over the triangles: the
    node visits a walk needs at least."""
    return max(1, math.ceil(math.log2(max(n_tris / leaf_width, 1)))) + 1


def b5_traverse(n, live, n_nodes, n_tris, n_meshes, leaf_width):
    """B5 (`mesh_closest_hits`, both kernels): every lane's live flag, a
    live lane's o and d, every lane's (t, tri) a mesh out, and the tree's
    nodes and triangles once. Operations: a live lane walks one path from
    a root to a leaf and tests one leaf of triangles (the least a BVH walk
    does)."""
    nb = n + 4 * 6 * live + 8 * n * n_meshes + _tree(n_nodes, n_tris)
    ops = live * n_meshes * (tree_depth(n_tris, leaf_width) * OPS_VISIT
                             + leaf_width * OPS_TRI)
    return nb, ops


def b6_shadow(n, hits, n_lights, rays, table_tests, S, Q, n_nodes, n_tris,
              n_meshes, leaf_width):
    """B6 (`shadow_factors`, both kernels): every lane's flag, a lit lane's
    p, time and key, the [L, N] factors out, the light, sphere and quad
    tables and the tree once. Operations: each shadow ray (`rays`, the
    reference's count: L * K a lit lane) is drawn, makes the sphere and
    quad tests it needs before an occluder blocks it (`table_tests`, the
    reference's count), and on mesh scenes walks one root-to-leaf path and
    one leaf a mesh."""
    nb = (n + 4 * 5 * hits + 4 * n_lights * n
          + 4 * (4 * n_lights + 9 * S + 20 * Q) + _tree(n_nodes, n_tris))
    mesh = n_meshes * (tree_depth(n_tris, leaf_width) * OPS_VISIT
                       + leaf_width * OPS_TRI) if n_meshes else 0
    return nb, rays * (OPS_SAMPLE + mesh) + table_tests * OPS_TABLE
