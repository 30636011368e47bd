"""Frozen for the benchmark's reference from the port's `geometry/primitives.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Ray/primitive intersection, planar (the port of
`tracer/geometry/primitives.py`). Each function tests one primitive against
a ray batch, or derives the hit detail of per-lane primitive parameters;
all arguments broadcast. The expressions and their order are those of the
TPU kernels (`tracer/kernels/intersect.py`, `traverse.py`, `shadow.py`),
so the CUDA kernels match them bit for bit.

Reference semantics: a sphere gives its nearer root only and requires
t >= eps; a quad is backface-culled unless its material is glass; motion
blur moves centres and quad origins by `time * motion_blur_translation`;
a triangle is backface-culled and accepts t >= 0 (not eps: a mesh's
closest hit may be a t ~ 0 self-hit, which the scene then rejects
wholesale, Scene.h:224); triangles do not move.

The BVH walk (`bvh_closest_hit`) is the stackless skip-link preorder walk
of `tracer/accel`'s flattened trees, run in lockstep: every lane has its
own node index and the loop ends when every lane has reached the end of
its mesh's node range.
"""

from __future__ import annotations

import torch

INF = 3.0e38


def sphere_t(o, d, a2, time, c, r2, mb, valid, eps):
    """Candidate t vs one sphere (INF-free: returns (t, ok)). o, d planar
    [N]; a2 = d.d; c, mb: 3-tuples; r2 (the squared radius), valid:
    scalars."""
    ocx = o[0] - (c[0] + time * mb[0])
    ocy = o[1] - (c[1] + time * mb[1])
    ocz = o[2] - (c[2] + time * mb[2])
    b = 2.0 * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    delta = b * b - 4.0 * a2 * cc
    t = (-b - torch.sqrt(torch.clamp_min(delta, 0.0))) / (2.0 * a2)
    return t, (delta >= 0.0) & (t >= eps) & (valid > 0.5)


# columns of a quad row: the first-hit table's (kernels/intersect.py) and
# the shadow table's (kernels/shadow.py): n(3), er(3), eu(3), v0.n, mb.n,
# v0.er, mb.er, v0.eu, mb.eu, er.er, eu.eu, glass, valid
QUAD_COLS_INTERSECT = (9, 3, 6, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24)
QUAD_COLS_SHADOW = (0, 3, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18)


def quad_t(o, d, time, row, eps, cols=QUAD_COLS_INTERSECT):
    """Candidate t vs one quad given its table row (stored normal and
    precomputed dots) and the row's column layout. Returns (t, ok)."""
    cn, ce, cu, c_v0n, c_mbn, c_v0e, c_mbe, c_v0u, c_mbu, c_e2, c_u2, \
        c_glass, c_valid = cols
    nsx, nsy, nsz = row[cn], row[cn + 1], row[cn + 2]
    dotRN = d[0] * nsx + d[1] * nsy + d[2] * nsz
    o_n = o[0] * nsx + o[1] * nsy + o[2] * nsz
    D = row[c_v0n] + time * row[c_mbn]
    t = (D - o_n) / torch.where(dotRN == 0.0, 1e-30, dotRN)
    ex, ey, ez = row[ce], row[ce + 1], row[ce + 2]
    o_er = o[0] * ex + o[1] * ey + o[2] * ez
    d_er = d[0] * ex + d[1] * ey + d[2] * ez
    s1 = o_er + t * d_er - (row[c_v0e] + time * row[c_mbe])
    ux, uy, uz = row[cu], row[cu + 1], row[cu + 2]
    o_eu = o[0] * ux + o[1] * uy + o[2] * uz
    d_eu = d[0] * ux + d[1] * uy + d[2] * uz
    s2 = o_eu + t * d_eu - (row[c_v0u] + time * row[c_mbu])
    front = dotRN < 0.0
    two_sided = row[c_glass] > 0.5
    ok = (dotRN != 0.0) & (front | two_sided) & (t >= eps)
    ok &= (s1 >= 0.0) & (s1 <= row[c_e2]) & (s2 >= 0.0) & (s2 <= row[c_u2])
    ok &= row[c_valid] > 0.5
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


# ---------------------------------------------------------------------------
# Triangles and the BVH walk
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def triangle_consts(a, b, c):
    """Per-triangle constants of the leaf test (`triangle_test`'s and the
    TPU walk's `traverse_tables` expressions): (n, D, v0, v1, d00, d01,
    d11, denom_safe). n = cross / max(|cross|, 1e-20), the division form
    of mathutils.normalize."""
    v0, v1 = _sub(b, a), _sub(c, a)
    nn = _cross(v0, v1)
    nl = torch.clamp_min(torch.sqrt(_dot(nn, nn)), 1e-20)
    n = (nn[0] / nl, nn[1] / nl, nn[2] / nl)
    d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
    denom = d00 * d11 - d01 * d01
    return (n, _dot(a, n), v0, v1, d00, d01, d11,
            torch.where(denom == 0.0, 1e-30, denom))


def triangle_test_consts(o, d, a, n, D, v0, v1, d00, d01, d11, den):
    """Ray vs triangle from its precomputed constants: (t, ok) with
    reference semantics (backface cull, t >= 0, barycentrics in [0, 1])."""
    dotRN = _dot(d, n)
    t = (D - _dot(o, n)) / torch.where(dotRN == 0.0, 1e-30, dotRN)
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    v2 = _sub(p, a)
    d20, d21 = _dot(v2, v0), _dot(v2, v1)
    w1 = (d11 * d20 - d01 * d21) / den
    w2 = (d00 * d21 - d01 * d20) / den
    w0 = 1.0 - w1 - w2
    ok = (dotRN < 0.0) & (t >= 0.0)
    for w in (w0, w1, w2):
        ok = ok & (w >= 0.0) & (w <= 1.0)
    return t, ok


def triangle_test(o, d, a, b, c):
    """Ray vs triangles, planar and broadcasting (Triangle.h:77-126).
    Returns (t, ok)."""
    n, D, v0, v1, d00, d01, d11, den = triangle_consts(a, b, c)
    return triangle_test_consts(o, d, a, n, D, v0, v1, d00, d01, d11, den)


def slab_hit(o, inv, lo, hi, tmin, tmax):
    """AABB slab test (AABB.h:48-65) with inv = 1/d: hit iff
    min(tmax, min(tfar)) > max(tmin, max(tnear)). min and max propagate a
    NaN (0 * inf at an axis-parallel ray), as jnp.minimum / jnp.maximum
    do, and a NaN fails the test."""
    t0 = [(lo[a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(hi[a] - o[a]) * inv[a] for a in range(3)]
    tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                     torch.minimum(t0[1], t1[1])),
                       torch.minimum(t0[2], t1[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                     torch.maximum(t0[1], t1[1])),
                       torch.maximum(t0[2], t1[2]))
    return torch.minimum(tmax, tf) > torch.maximum(tmin, tn)


def skip_walk(o, d, lo, hi, leaf_start, skip, root, end, leaf_test,
              live=None, stats=None, tmax=None, lane_counts=None):
    """Closest hit of each ray over one mesh's node range [root, end) by
    the skip-link preorder walk, all lanes in lockstep.

    o, d planar [N]; lo, hi [Bn, 3] node boxes; leaf_start [Bn] (>= 0 at a
    leaf) and skip [Bn] (the next node after a miss or a leaf). A lane at
    node i tests the box against (0, its best t); a hit leaf calls
    `leaf_test(lanes, leaf_start[i])`, which returns each lane's first
    closest (t, tri) over the leaf (INF / -1 where none) and its count of
    real triangles; a strictly closer t replaces the best. Lanes with
    `live` false return (INF, -1).

    `tmax` [N] (optional): each lane's starting best t, the TPU walk's
    per-lane bound (`tracer/kernels/traverse.py:97-99`). A box entered at
    or beyond it is pruned and only hits strictly below it count, so a
    live lane returns the unbounded walk's (t, tri) where that t is below
    its bound and (tmax, -1) elsewhere.

    `stats`, a dict, gains the node visits ("visits") and real triangles
    tested ("tests") of this walk, keeps the most nodes one lane visited
    ("max_visits": the loop's length), and marks in [Bn] bool masks the
    nodes any lane read ("nodes_seen") and the leaves whose triangles any
    lane tested ("leaves_seen"). `lane_counts` ([2, N] int64, optional)
    gains each lane's node visits (row 0) and real triangles tested
    (row 1)."""
    N = o[0].shape[0]
    dev = o[0].device
    if stats is not None:
        for k in ("nodes_seen", "leaves_seen"):
            if k not in stats:
                stats[k] = torch.zeros(leaf_start.shape[0], dtype=torch.bool,
                                       device=dev)
    bt = torch.full((N,), INF, dtype=torch.float32, device=dev)
    btri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    idx = torch.arange(N, device=dev)
    if live is not None:
        idx = idx[live]
    if tmax is not None:
        bt[idx] = tmax[idx]
    if root >= end:
        idx = idx[:0]
    node = torch.full((idx.numel(),), root, dtype=torch.int64, device=dev)
    inv = tuple(1.0 / c for c in d)
    lo, hi = lo.T, hi.T
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    steps = 0
    while idx.numel():
        steps += 1
        bl = bt[idx]
        hit = slab_hit(tuple(c[idx] for c in o), tuple(c[idx] for c in inv),
                       lo[:, node], hi[:, node], zero, bl)
        ls = leaf_start[node].to(torch.int64)
        do = hit & (ls >= 0)
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + idx.numel()
            stats["nodes_seen"][node] = True
            stats["leaves_seen"][node[do]] = True
        if lane_counts is not None:
            lane_counts[0, idx] += 1
        if bool(do.any()):
            lanes = idx[do]
            t, tri, n_real = leaf_test(lanes, ls[do])
            if stats is not None:
                stats["tests"] = stats.get("tests", 0) + int(n_real.sum())
            if lane_counts is not None:
                lane_counts[1, lanes] += n_real
            better = t < bt[lanes]
            bt[lanes] = torch.where(better, t, bt[lanes])
            btri[lanes] = torch.where(better, tri, btri[lanes])
        node = torch.where(hit & (ls < 0), node + 1,
                           skip[node].to(torch.int64))
        keep = node < end
        idx, node = idx[keep], node[keep]
    if stats is not None:
        stats["max_visits"] = max(stats.get("max_visits", 0), steps)
    return bt, btri


def leaf_first_min(t, ok, tids):
    """[n, LW] slot results -> each lane's first minimum (t, tri), INF / -1
    where no slot hits (the walk's strict-< in slot order)."""
    t = torch.where(ok, t, INF)
    k = torch.argmin(t, dim=1, keepdim=True)      # first minimal slot
    tmin = torch.gather(t, 1, k)[:, 0]
    tri = torch.gather(tids, 1, k)[:, 0]
    return tmin, torch.where(tmin < INF, tri, -1)


def bvh_closest_hit(o, d, scene, root: int, end: int, leaf_width: int = 4,
                    live=None, stats=None):
    """Closest triangle hit within one mesh's node range [root, end): (t
    [N], tri [N] int32), INF / -1 on a miss. o, d planar [N]. The leaf test
    gathers the scene's triangles and runs `triangle_test` (the JAX
    package's per-ray walk, run in lockstep; KDTree.cpp:31-69)."""
    lw = leaf_width
    T = scene.tri_a.shape[0] - 1       # the sentinel row
    slots = torch.arange(lw, device=o[0].device)

    def leaf_test(lanes, ls):
        tids = scene.bvh_leaf_tris[ls[:, None] + slots[None, :]]   # [n, LW]
        tl = tids.long()
        a, b, c = (tuple(v[tl, k] for k in range(3))
                   for v in (scene.tri_a, scene.tri_b, scene.tri_c))
        t, ok = triangle_test(tuple(x[lanes][:, None] for x in o),
                              tuple(x[lanes][:, None] for x in d), a, b, c)
        return (*leaf_first_min(t, ok, tids), (tids != T).sum(1))

    return skip_walk(o, d, scene.bvh_lo, scene.bvh_hi,
                     scene.bvh_leaf_start, scene.bvh_skip, root, end,
                     leaf_test, live, stats)


def mesh_closest_hits(o, d, scene, live=None):
    """Per-mesh closest raw hits over all meshes: (t [Nm, N], tri [Nm, N]).
    The scene-level eps cut (t >= eps, Scene.h:224) is the caller's; here t
    may be below eps (see the module docstring)."""
    ts, tris = [], []
    for r, e in zip(scene.mesh_root, scene.mesh_end):
        t, tri = bvh_closest_hit(o, d, scene, r, e, scene.leaf_width, live)
        ts.append(t)
        tris.append(tri)
    if not ts:
        N, dev = o[0].shape[0], o[0].device
        return (torch.zeros((0, N), dtype=torch.float32, device=dev),
                torch.zeros((0, N), dtype=torch.int32, device=dev))
    return torch.stack(ts), torch.stack(tris)


def triangle_hit_detail(o, d, a, b, c):
    """Hit record on ONE selected triangle per lane (a, b, c planar [N]):
    (p, n, w0, w1, w2), n = normalize(cross(b - a, c - a)) in the
    reciprocal form of vec3p.normalize (`triangle_hit_detail_planar`)."""
    v0, v1 = _sub(b, a), _sub(c, a)
    nn = _cross(v0, v1)
    inv = 1.0 / torch.clamp_min(torch.sqrt(_dot(nn, nn)), 1e-20)
    n = (inv * nn[0], inv * nn[1], inv * nn[2])
    dotRN = _dot(d, n)
    t = (_dot(a, n) - _dot(o, n)) / torch.where(dotRN == 0.0, 1e-30, dotRN)
    p = (t * d[0] + o[0], t * d[1] + o[1], t * d[2] + o[2])
    v2 = _sub(p, a)
    d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
    d20, d21 = _dot(v2, v0), _dot(v2, v1)
    raw = d00 * d11 - d01 * d01
    denom = torch.clamp_min(torch.abs(raw), 1e-30)
    sign = torch.sign(raw + 1e-38)
    w1 = sign * (d11 * d20 - d01 * d21) / denom
    w2 = sign * (d00 * d21 - d01 * d20) / denom
    return p, n, 1.0 - w1 - w2, w1, w2


def sphere_angles(n):
    """(theta, phi) of a sphere's unit normal n (Sphere.h:130), the sphere's
    texture coordinates before scaling: theta = acos(clip(-n_y, -1 + 1e-7,
    1 - 1e-7)), phi = atan2(-n_z, n_x + 1e-20) + pi, in f32 constants
    (`primitives.sphere_hit_detail_planar`)."""
    from portbench.reference.shading import ACOS_HI, ACOS_LO, PI
    theta = torch.acos(torch.clamp(-n[1], ACOS_LO, ACOS_HI))
    phi = torch.atan2(-n[2], n[0] + 1e-20) + PI
    return theta, phi
