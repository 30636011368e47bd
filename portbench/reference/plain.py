"""The kernels' plain versions, frozen: the candidate tests and winner
detail of the first hit, the soft-shadow factors and the BVH walk, with
the tables they read, built from the reference's own scene
(`portbench/reference/scene.py`). Copied from the port's plain versions
(`kernels/intersect.py`, `kernels/shadow.py`, `kernels/traverse.py`)
without their CUDA dispatch, so a later change of the port cannot move
the yardstick."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import primitives as prim
from portbench.reference import rng
from portbench.reference import shading

GLASS = 1


def intersect_tables(scene):
    """Scene tables with the same columns as the TPU kernel's SMEM tables.

    sph [S, 9]:  0:3 c, 3 r, 4:7 mb, 7 valid, 8 midf
    quad [Q, 47]: 0:3 v0, 3:6 er, 6:9 eu, 9:12 n(stored), 12:15 mb,
       15 v0_n, 16 mb_n, 17 v0_er, 18 mb_er, 19 v0_eu, 20 mb_eu,
       21 er2, 22 eu2, 23 glass, 24 valid, 25 midf, 26:29 tan,
       29:32 bitan, 32 sx, 33 sy, 34 pair_wa, 35 pair_ha, 36 pair_wb,
       37 pair_hb, 38 pair_off, 39 pair_tex, 40 pair_nm, 41 tex_off,
       42 tex_w, 43 tex_h, 44 nm_off, 45 nm_w, 46 nm_h
    (The TPU kernel's docstring says [Q, 41]; its table has 47 columns.)
    """
    def f(a):
        return a.to(torch.float32)[:, None]

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]
                + a[:, 2] * b[:, 2])[:, None]

    sph = torch.cat([
        scene.sph_center, scene.sph_radius[:, None],
        scene.mat_mb[scene.sph_mat], scene.sph_valid[:, None],
        f(scene.sph_mat)], dim=1)
    n, er, eu = scene.quad_normal, scene.quad_er, scene.quad_eu
    v0 = scene.quad_v0
    qm = scene.quad_mat
    mbq = scene.mat_mb[qm]
    tex, nm = scene.mat_tex[qm], scene.mat_nm[qm]
    quad = torch.cat([
        v0, er, eu, n, mbq,
        dot(v0, n), dot(mbq, n), dot(v0, er), dot(mbq, er), dot(v0, eu),
        dot(mbq, eu), dot(er, er), dot(eu, eu),
        f(scene.mat_type[qm] == GLASS), scene.quad_valid[:, None], f(qm),
        scene.quad_tan, scene.quad_bitan, scene.mat_texscale[qm],
        f(scene.mat_pair_wa[qm]), f(scene.mat_pair_ha[qm]),
        f(scene.mat_pair_wb[qm]), f(scene.mat_pair_hb[qm]),
        f(scene.mat_pair_off[qm]),
        f(scene.mat_pair_tex[qm]), f(scene.mat_pair_nm[qm]),
        f(scene.tex_off[tex]), f(scene.tex_w[tex]), f(scene.tex_h[tex]),
        f(scene.nm_off[nm]), f(scene.nm_w[nm]), f(scene.nm_h[nm])], dim=1)
    return sph.contiguous(), quad.contiguous()


SPHERE_TEX_COLS = 15


def sphere_tex_table(scene):
    """[S, 15] f32: the texel columns of each sphere's material, in the
    order of the quad table's columns 32-46 (sx, sy, pair_wa, pair_ha,
    pair_wb, pair_hb, pair_off, pair_tex, pair_nm, tex_off, tex_w, tex_h,
    nm_off, nm_w, nm_h): what `first_hits(sphere_tex=...)` reads for a
    sphere winner."""
    def f(a):
        return a.to(torch.float32)[:, None]

    m = scene.sph_mat.long()
    tex, nm = scene.mat_tex[m].long(), scene.mat_nm[m].long()
    return torch.cat([
        scene.mat_texscale[m], f(scene.mat_pair_wa[m]),
        f(scene.mat_pair_ha[m]), f(scene.mat_pair_wb[m]),
        f(scene.mat_pair_hb[m]), f(scene.mat_pair_off[m]),
        f(scene.mat_pair_tex[m]), f(scene.mat_pair_nm[m]),
        f(scene.tex_off[tex]), f(scene.tex_w[tex]), f(scene.tex_h[tex]),
        f(scene.nm_off[nm]), f(scene.nm_w[nm]), f(scene.nm_h[nm])],
        dim=1).contiguous()


MESH_PACK_COLS = 24


def mesh_tables(scene):
    """(midf [Nm] f32, pack [T, 24] f32): the meshes' material ids and one
    row per triangle (the JAX package's `integrator._mesh_detail_p` pack):
    0:9 the three vertices from the shared `mesh_verts`, 9:18 the three
    corner colors, 18 has_col, zeros to 24. Build it once per frame."""
    v = scene.mesh_verts
    T = scene.tri_va.shape[0]
    pack = torch.cat([
        v[scene.tri_va.long()], v[scene.tri_vb.long()], v[scene.tri_vc.long()],
        scene.tri_col_a, scene.tri_col_b, scene.tri_col_c,
        scene.tri_has_col[:, None],
        torch.zeros((T, MESH_PACK_COLS - 19), dtype=torch.float32,
                    device=v.device)], dim=1)
    return scene.mesh_mat.to(torch.float32).contiguous(), pack.contiguous()


def mesh_detail(pack, o, d, tid):
    """Hit detail on the triangle `tid` [N] (clipped to the pack) of each
    lane: (p, n, color, has_col), planar; color is the corner colors
    interpolated by the barycentric weights (Scene.h:291-298)."""
    row = pack[torch.clamp(tid, 0, pack.shape[0] - 1).long()]
    a, b, c = ((row[:, k], row[:, k + 1], row[:, k + 2]) for k in (0, 3, 6))
    p, n, w0, w1, w2 = prim.triangle_hit_detail(o, d, a, b, c)
    col = tuple(w0 * row[:, 9 + i] + w1 * row[:, 12 + i]
                + w2 * row[:, 15 + i] for i in range(3))
    return p, n, col, row[:, 18]


def first_hits_plain(scene, o, d, time, live, eps, tex_out, tables,
                     t_mesh=None, tri_mesh=None, mesh=None, sphere_tex=None):
    """The plain PyTorch version of the kernel, in the TPU kernel's SIMD
    form (a Python loop over the table rows; every candidate test and both
    a sphere's and a quad's detail on every lane, selected by where). The
    kernel computes the same expressions, skipping only what changes no
    bit: rejected candidates and the details of the losers."""
    sph, quad = tables
    S, Q = sph.shape[0], quad.shape[0]
    Nm = scene.mesh_mat.shape[0]
    tm = time
    N = o[0].shape[0]
    dev = o[0].device
    a2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    best = torch.full((N,), prim.INF, dtype=torch.float32, device=dev)
    j = torch.full((N,), -1, dtype=torch.int32, device=dev)
    tid = torch.full((N,), -1, dtype=torch.int32, device=dev)

    for s in range(min(scene.n_sph_real, S)):
        r = sph[s]
        t, ok = prim.sphere_t(o, d, a2, tm, (r[0], r[1], r[2]), r[3] * r[3],
                              (r[4], r[5], r[6]), r[7], eps)
        upd = ok & (t < best)
        best = torch.where(upd, t, best)
        j = torch.where(upd, s, j)
    for q in range(min(scene.n_quad_real, Q)):
        t, ok = prim.quad_t(o, d, tm, quad[q], eps)
        upd = ok & (t < best)
        best = torch.where(upd, t, best)
        j = torch.where(upd, S + q, j)
    for m in range(Nm):  # the scene-level eps cut (Scene.h:224)
        t = torch.where(t_mesh[m] >= eps, t_mesh[m], prim.INF)
        upd = t < best
        best = torch.where(upd, t, best)
        j = torch.where(upd, S + Q + m, j)
        tid = torch.where(upd, tri_mesh[m], tid)

    # ---- the winner's row, as the TPU kernel's cache holds it ----------
    is_s = (j >= 0) & (j < S)
    is_q = (j >= S) & (j < S + Q)
    srow = sph[torch.clamp(j, 0, S - 1).long()]
    qrow = quad[torch.clamp(j - S, 0, Q - 1).long()]

    def both(sc, qc):   # slot filled by sphere AND quad winners
        return torch.where(is_q, qrow[:, qc],
                           torch.where(is_s, srow[:, sc], 0.0))

    def quad_only(qc):  # sphere winners leave the slot at zero
        return torch.where(is_q, qrow[:, qc], 0.0)

    c0, c1, c2 = both(0, 0), both(1, 1), both(2, 2)
    c3 = torch.where(is_s, srow[:, 3], 0.0)
    c4, c5, c6 = both(4, 12), both(5, 13), both(6, 14)
    ex, ey, ez = quad_only(3), quad_only(4), quad_only(5)
    ux, uy, uz = quad_only(6), quad_only(7), quad_only(8)
    midf = both(8, 25)

    v0, mb = (c0, c1, c2), (c4, c5, c6)
    ps, ns = prim.sphere_hit_detail(o, d, a2, tm, v0, c3, mb)
    pq, nq, uq, vq = prim.quad_hit_detail(o, d, tm, v0, (ex, ey, ez),
                                          (ux, uy, uz), mb)

    p = tuple(torch.where(is_q, a, b) for a, b in zip(pq, ps))
    n = tuple(torch.where(is_q, a, b) for a, b in zip(nq, ns))
    if Nm > 0:
        is_m = j >= S + Q
        midm, pack = mesh
        midf = torch.where(is_m, midm[torch.clamp(j - S - Q, 0, Nm - 1).long()],
                           midf)
        pm, nm_, _, _ = mesh_detail(pack, o, d, tid)
        p = tuple(torch.where(is_m, a, b) for a, b in zip(pm, p))
        n = tuple(torch.where(is_m, a, b) for a, b in zip(nm_, n))

    miss = best >= prim.INF * 0.5
    zi = torch.zeros_like(j)
    zf = torch.zeros_like(tm)
    out = dict(
        j=torch.where(miss, -1, j), tid=tid,
        mid=midf.to(torch.int32), row=zi, sub=zi, p=p, n=n,
        u=uq, v=vq,
        tan=(quad_only(26), quad_only(27), quad_only(28)),
        bitan=(quad_only(29), quad_only(30), quad_only(31)),
        ptex=zf, pnm=zf)
    if tex_out:
        uv = sphere_tex is not None and S > 0
        if uv:   # a sphere winner's texture coordinates (Sphere.h:130)
            theta, phi = prim.sphere_angles(ns)
            out.update(u=torch.where(is_s, phi * shading.INV_2PI, uq),
                       v=torch.where(is_s, theta * shading.INV_PI, vq))
            srt = sphere_tex[torch.clamp(j, 0, S - 1).long()]
        uu, vv = out["u"], out["v"]
        tex_lane = (is_q | is_s) if uv else is_q

        def tcol(c):   # quad column c, or its sphere-table twin
            if uv:
                return torch.where(is_q, qrow[:, c],
                                   torch.where(is_s, srt[:, c - 32], 0.0))
            return quad_only(c)

        # pair-atlas texel index: xa/ya from the primary dims, xb/yb the
        # product-region staircase; rel = (ya+yb)*wc + xa+xb
        sx, sy = tcol(32), tcol(33)
        wa, ha = tcol(34), tcol(35)
        wb, hb = tcol(36), tcol(37)
        xa, ya = shading.texel_xy(wa, ha, uu, vv, sx, sy)
        xb, yb = shading.texel_xy(wb, hb, uu, vv, sx, sy)
        wc = wa.to(torch.int32) + torch.clamp_min(wb.to(torch.int32) - 1, 0)
        rel = (ya + yb) * wc + xa + xb
        out.update(
            row=torch.where(tex_lane, tcol(38).to(torch.int32) + (rel >> 4),
                            zi),
            sub=torch.where(tex_lane, rel & 15, zi),
            ptex=tcol(39), pnm=tcol(40))
        if tex_out >= 2:
            # true atlas indices (the record's texel-cotangent fold)
            for key, c, p_atlas in (("idx_t", 41, scene.tex_data.shape[0]),
                                    ("idx_n", 44, scene.nm_data.shape[0])):
                xt, yt = shading.texel_xy(tcol(c + 1), tcol(c + 2), uu, vv,
                                          sx, sy)
                it = (tcol(c).to(torch.int32)
                      + yt * tcol(c + 1).to(torch.int32) + xt)
                out[key] = torch.where(tex_lane,
                                       torch.clamp(it, 0, p_atlas - 1), zi)

    # defaults on lanes that are not live
    def dflt(x, v):
        return torch.where(live, x, v)

    res = {}
    for k, v in out.items():
        if k in ("j", "tid"):
            res[k] = dflt(v, -1)
        elif k == "n":
            res[k] = (dflt(v[0], 0.0), dflt(v[1], 0.0), dflt(v[2], 1.0))
        elif isinstance(v, tuple):
            res[k] = tuple(dflt(c, 0.0) for c in v)
        elif v.dtype == torch.int32:
            res[k] = dflt(v, 0)
        else:
            res[k] = dflt(v, 0.0)
    return res


def shadow_tables(scene):
    """(light [L, 4], sph [S, 9], quad [Q, 20], mesh [Nm] f32), the TPU
    kernel's tables (`tracer/kernels/shadow.py::shadow_tables`) plus the
    meshes' transparency.

    light: pos(3), radius / 2; sph: c(3), r^2, mb(3), valid, transparency;
    quad: n(3), er(3), eu(3), v0.n, mb.n, v0.er, mb.er, v0.eu, mb.eu,
    er.er, eu.eu, glass, valid, transparency."""
    def f(a):
        return a.to(torch.float32)[:, None]

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]
                + a[:, 2] * b[:, 2])[:, None]

    light = torch.cat([scene.light_pos, (scene.light_radius / 2.0)[:, None]],
                      dim=1)
    sm = scene.sph_mat
    sph = torch.cat([
        scene.sph_center, (scene.sph_radius * scene.sph_radius)[:, None],
        scene.mat_mb[sm], scene.sph_valid[:, None],
        scene.mat_transparency[sm][:, None]], dim=1)
    n, er, eu, v0 = (scene.quad_normal, scene.quad_er, scene.quad_eu,
                     scene.quad_v0)
    qm = scene.quad_mat
    mbq = scene.mat_mb[qm]
    quad = torch.cat([
        n, er, eu, dot(v0, n), dot(mbq, n), dot(v0, er), dot(mbq, er),
        dot(v0, eu), dot(mbq, eu), dot(er, er), dot(eu, eu),
        f(scene.mat_type[qm] == GLASS), scene.quad_valid[:, None],
        scene.mat_transparency[qm][:, None]], dim=1)
    mesh = scene.mat_transparency[scene.mesh_mat]
    return (light.contiguous(), sph.contiguous(), quad.contiguous(),
            mesh.contiguous())


def _sample_rays(cfg, light_row, p, skeys, k: int):
    """Shadow sample k toward a light (`integrator._shadow_factor_jnp`):
    (origin, unit direction, distance to the jittered light point)."""
    ruv = (rng.cube_unit_vector_lane_p(skeys, k)
           if cfg.compat == "reference"
           else rng.sphere_unit_vector_lane_p(skeys, k))
    delta = light_row[3]
    off = tuple((delta * ruv[a] + light_row[a]) - p[a] for a in range(3))
    t_light = torch.sqrt(off[0] * off[0] + off[1] * off[1]
                         + off[2] * off[2])
    inv = 1.0 / torch.clamp_min(t_light, 1e-20)
    sd = tuple(inv * c for c in off)
    so = tuple(cfg.epsilon * sd[a] + p[a] for a in range(3))
    return so, sd, t_light


def shadow_factors_plain(scene, cfg, p, time, keys, eps, live, tables,
                         tree=None, stats=None):
    """The plain PyTorch version: per light, the K samples of every live
    lane as one megabatch, the table candidates, the meshes' closest hits
    below t_light (`traverse.mesh_walk_plain` bounded by each sample's
    t_light, for the samples whose result a walk can change, as the kernel
    does), the Bernoulli draws, and 1 - mean_k(blocked). `stats`, a dict,
    gains the shadow rays ("rays"), the sphere and quad tests a sample
    needs before it is blocked ("table_tests"), the walks' counts
    (`primitives.skip_walk`) and "lane_counts": [2, rays] int64, each
    shadow ray's node visits and real triangle tests over the meshes."""
    light, sph, quad, mesh = tables
    L, K = light.shape[0], cfg.shadow_rays
    S, Q = sph.shape[0], quad.shape[0]
    S_real, Q_real = min(scene.n_sph_real, S), min(scene.n_quad_real, Q)
    N = p[0].shape[0]
    out = torch.ones((L, N), dtype=torch.float32, device=p[0].device)
    idx = torch.nonzero(live)[:, 0]
    n = idx.numel()
    if n == 0:
        return out
    pl = tuple(c[idx] for c in p)
    tm = time[idx].repeat(K)
    kl = keys[idx]
    per_light = [torch.zeros((2, 0), dtype=torch.int64, device=p[0].device)]
    for i in range(L):
        skeys = rng.salted(kl, rng.SHADOW_LIGHT_POS, i)
        bkey = rng.salted(kl, rng.SHADOW_BERNOULLI, i)
        rays = [_sample_rays(cfg, light[i], pl, skeys, k) for k in range(K)]
        so = tuple(torch.cat([r[0][a] for r in rays]) for a in range(3))
        sd = tuple(torch.cat([r[1][a] for r in rays]) for a in range(3))
        tl = torch.cat([r[2] for r in rays])
        bk = torch.cat([rng.uniform_lane_key_p(bkey, k) for k in range(K)])

        a2 = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]
        blocked = torch.zeros_like(tl, dtype=torch.bool)

        def count_test():
            # the tests a sample needs: those up to the first that blocks
            if stats is not None:
                stats["table_tests"] = (stats.get("table_tests", 0)
                                        + int((~blocked).sum()))

        for s in range(S_real):
            r = sph[s]
            t, ok = prim.sphere_t(so, sd, a2, tm, (r[0], r[1], r[2]), r[3],
                                  (r[4], r[5], r[6]), r[7], eps)
            count_test()
            blocked |= ok & (t < tl) & (rng.lane_uniform(bk, s) > r[8])
        for q in range(Q_real):
            t, ok = prim.quad_t(so, sd, tm, quad[q], eps,
                                cols=prim.QUAD_COLS_SHADOW)
            count_test()
            blocked |= ok & (t < tl) & (rng.lane_uniform(bk, S + q)
                                        > quad[q, 19])
        counts = (torch.zeros((2, K * n), dtype=torch.int64, device=tl.device)
                  if stats is not None else None)
        for m in range(mesh.shape[0]):
            # a walk changes only samples not yet blocked whose draw
            # exceeds the mesh's transparency: the others skip it. A hit
            # at or beyond t_light never blocks, so the walk starts there
            draw = rng.lane_uniform(bk, S + Q + m) > mesh[m]
            t_raw, _ = mesh_walk_plain(scene, so, sd, m,
                                                 draw & ~blocked, tree, stats,
                                                 tmax=tl, lane_counts=counts)
            blocked |= (t_raw >= eps) & (t_raw < tl) & draw
        if stats is not None:
            stats["rays"] = stats.get("rays", 0) + K * n
            per_light.append(counts)
        # 1 - mean_k: jnp.mean compiles to the sum times f32(1/K) (XLA
        # turns a division by a constant into a reciprocal multiply)
        inv_k = float(np.float32(1.0) / np.float32(K))
        out[i, idx] = 1.0 - blocked.to(torch.float32).reshape(K, n).sum(0) \
            * inv_k
    if stats is not None:
        stats["lane_counts"] = torch.cat(per_light, dim=1)
    return out


TRI_COLS = 32     # padded per-triangle slot in a leaf row


def traverse_tables(scene):
    """(nodes_f [Bn, 8] f32, nodes_i [Bn, 2] i32, leaf [NL, LW*32] f32),
    the TPU kernel's tables (`tracer/kernels/traverse.py::traverse_tables`)
    with one spare column filled.

    nodes_f: lo(3), hi(3), the leaf's count of real (non-padding)
    triangles (0 at an inner node; a zero column in the TPU table), 0;
    nodes_i: leaf row (-1 at an inner node), skip. Leaf row slot s (cols
    s*32+c): 0:3 a, 3:6 n, 6 D, 7:10 v0, 10:13 v1, 13 d00, 14 d01, 15 d11,
    16 denom_safe, 17 tid (f32), zeros to 32; the padding slots (the
    sentinel triangle) come last."""
    LW = scene.leaf_width
    a = tuple(scene.tri_a.T)
    b = tuple(scene.tri_b.T)
    c = tuple(scene.tri_c.T)
    n, D, v0, v1, d00, d01, d11, den = prim.triangle_consts(a, b, c)
    T1 = scene.tri_a.shape[0]
    tidf = torch.arange(T1, dtype=torch.float32, device=scene.device)
    pre = torch.stack([*a, *n, D, *v0, *v1, d00, d01, d11, den, tidf], dim=1)
    pre = torch.nn.functional.pad(pre, (0, TRI_COLS - pre.shape[1]))
    leaf = pre[scene.bvh_leaf_tris.long()]
    leaf = leaf.reshape(leaf.shape[0] // LW, LW * TRI_COLS)
    Bn = scene.bvh_lo.shape[0]
    ls = scene.bvh_leaf_start
    leaf_row = torch.where(ls >= 0, torch.div(ls, LW, rounding_mode="floor"),
                           -1)
    real = (scene.bvh_leaf_tris.reshape(-1, LW) != T1 - 1).sum(1)
    count = torch.where(ls >= 0, real[leaf_row.clamp_min(0).long()], 0)
    nodes_f = torch.cat([scene.bvh_lo, scene.bvh_hi,
                         count.to(torch.float32)[:, None],
                         torch.zeros((Bn, 1), dtype=torch.float32,
                                     device=scene.device)], dim=1)
    nodes_i = torch.stack([leaf_row, scene.bvh_skip], dim=1).to(torch.int32)
    return nodes_f.contiguous(), nodes_i.contiguous(), leaf.contiguous()


def _leaf_tester(scene, tables, o, d):
    """The leaf test of the kernel for `primitives.skip_walk`: the
    triangles of the leaf rows `rows` against the rays of `lanes`, from the
    leaf table's constants (same expressions as `triangle_test`)."""
    _, _, leaf = tables
    LW = scene.leaf_width
    sentinel = scene.tri_a.shape[0] - 1

    def test(lanes, rows):
        r = leaf[rows].reshape(-1, LW, TRI_COLS)
        col = [r[:, :, k] for k in range(18)]
        oo = tuple(x[lanes][:, None] for x in o)
        dd = tuple(x[lanes][:, None] for x in d)
        t, ok = prim.triangle_test_consts(
            oo, dd, tuple(col[0:3]), tuple(col[3:6]), col[6],
            tuple(col[7:10]), tuple(col[10:13]), col[13], col[14], col[15],
            col[16])
        tids = col[17].to(torch.int32)
        return (*prim.leaf_first_min(t, ok, tids), (tids != sentinel).sum(1))

    return test


def mesh_walk_plain(scene, o, d, m, live, tables, stats=None, tmax=None,
                    lane_counts=None):
    """Mesh m's closest raw hits (t [N], tri [N] int32) by the skip-link
    walk of all lanes in lockstep (`primitives.skip_walk`) with the
    kernel's leaf test; INF / -1 where `live` is false. `stats`, `tmax`
    and `lane_counts`: as in `skip_walk`."""
    nodes_f, nodes_i, _ = tables
    return prim.skip_walk(o, d, nodes_f[:, 0:3], nodes_f[:, 3:6],
                          nodes_i[:, 0], nodes_i[:, 1], scene.mesh_root[m],
                          scene.mesh_end[m], _leaf_tester(scene, tables, o, d),
                          live, stats, tmax, lane_counts)


def mesh_closest_hits_plain(scene, o, d, live, tables, stats=None):
    """The plain PyTorch version: `mesh_walk_plain` for every mesh.
    `stats`, a dict, gains the node visits and real triangle tests, and
    "lane_counts": [2, live rays] int64, each live ray's node visits and
    real triangle tests summed over the meshes."""
    N, dev = o[0].shape[0], o[0].device
    counts = (torch.zeros((2, N), dtype=torch.int64, device=dev)
              if stats is not None else None)
    ts, tris = [], []
    for m in range(len(scene.mesh_root)):
        t, tri = mesh_walk_plain(scene, o, d, m, live, tables, stats,
                                 lane_counts=counts)
        ts.append(t)
        tris.append(tri)
    if stats is not None:
        stats["lane_counts"] = counts[:, live]
    if not ts:
        return (torch.zeros((0, N), dtype=torch.float32, device=dev),
                torch.zeros((0, N), dtype=torch.int32, device=dev))
    return torch.stack(ts), torch.stack(tris)
