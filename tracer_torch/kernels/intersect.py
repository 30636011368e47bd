"""First-hit kernel: the sphere+quad candidate pass, the merge of the
per-mesh BVH hits, the closest-hit argmin and the winner's hit detail in
one pass over the live rays.

Replaces the TPU kernel `tracer/kernels/intersect.py::first_hits` (Pallas,
`pl.pallas_call` at intersect.py:433) with the CUDA kernel
`csrc/first_hits.cu`: persistent blocks that list each tile's live lanes
in shared memory, reject candidates exactly before their divisions and
square roots, and compute only the winner's detail. Its plain PyTorch
version, `first_hits_plain`, follows the same expressions in the SIMD
form of the TPU kernel and is what the wrapper runs for CPU tensors.

What bounds it on an H100: on a dense bounce the candidate loop's issue
slots (per live lane ~90 instructions a quad, with its division; 29 B
in, 52 B out), on a sparse one the dead lanes, which cost their live flag
and integer fields only. The kernel writes a slim record
(`SLIM_FIELDS`): the tangent frame and the atlas masks are per-quad
constants, which the shade kernel and the backward read from the quad
table by j. `first_hits` gathers them
(`quad_fields`) for its full dict; the bounce loop asks for the slim one.
The tables sit in dynamic shared memory, or are read through L2 by the
kernel's second instance when they exceed a block's 227 KB
(`TABLES` says which the last launch took).

Semantics (mirrored from the TPU kernel):
- selection is strict-< in (spheres, quads, meshes) order over the REAL
  rows; a mesh's candidate is its closest raw hit from the BVH walk
  (`traverse.py`) when that is >= eps, else none: a mesh whose closest hit
  lies below eps drops out entirely (Scene.h:224);
- `tid` is the winning mesh's triangle, -1 for other winners;
- a sphere winner's quad fields read as zero, so its u = v = 0 and
  tan = bitan = 0, exactly as the TPU kernel's zeroed cache leaves them
  (the kernel writes u = v = +0; the SIMD form may give -0);
- a mesh winner's p and n are its triangle hit detail
  (`primitives.triangle_hit_detail`, the JAX package's
  `integrator._mesh_detail_p`) from the mesh pack row of `tid`: the TPU
  kernel leaves them stale and the JAX integrator replaces them, but here
  the soft-shadow kernel reads the hit point before the shade kernel runs;
  u = v = 0 and its texel fields are 0;
- `tex_out=1` adds the pair-atlas texel index (row, sub) and the
  atlas-validity masks (ptex, pnm) of quad winners;
- `tex_out=2` (the record forward of the backward) also adds the true
  atlas indices (idx_t, idx_n) of the nearest texel in `tex_data` and
  `nm_data`, clipped to the atlas, for quad winners; other lanes get 0;
- with `sphere_tex` (`sphere_tex_table`: scenes with textured spheres,
  `tex_out >= 1`) a sphere winner gets its texture coordinates u =
  phi/(2 pi), v = theta/pi (Sphere.h:130; theta = acos(clip(-n_y, -1 +
  1e-7, 1 - 1e-7)), phi = atan2(-n_z, n_x + 1e-20) + pi) and, from its
  material's row of that table, the texel fields a quad winner gets from
  its quad row. The JAX package computes these in XLA after its kernel
  (`tracer/render/integrator.py:804-850`), for want of acos and atan2 in
  Mosaic; CUDA has both;
- lanes with `live` false: j = tid = -1, mid = row = sub (= idx_t =
  idx_n) = 0, and tan = bitan = ptex = pnm = 0 in the full dict. Their
  p, n, u and v are unspecified: the kernel does not write them (no
  consumer reads them) and the plain version gives n = (0, 0, 1), the
  rest 0.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.geometry import primitives as prim
from tracer_torch.kernels import common as kc

GLASS = 1
LAUNCHES = 0  # launches of the CUDA kernel (not of the plain version)

TABLES = None  # "shared" or "global": where the last launch's tables sat

# output layout of the kernel: int32 [5, N] (tex_out=2: [7, N]) and
# float32 [8, N]
I_FIELDS = ("j", "tid", "mid", "row", "sub", "idx_t", "idx_n")
F_FIELDS = ("px", "py", "pz", "nx", "ny", "nz", "u", "v")
# the slim record's keys (with tex_out=2 also idx_t, idx_n)
SLIM_FIELDS = ("j", "tid", "mid", "row", "sub", "p", "n", "u", "v")


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


def first_hits(scene, o, d, time, live, eps=1e-5, tex_out=0,
               kernels="auto", tables=None, t_mesh=None, tri_mesh=None,
               mesh=None, slim=False, sphere_tex=None):
    """Closest hit + winner detail for planar rays.

    o, d: planar (x, y, z) of [N] f32; time [N] f32; live [N] bool.
    Mesh scenes also pass the BVH walk's closest raw hits t_mesh [Nm, N]
    f32 and tri_mesh [Nm, N] int32 (`traverse.mesh_closest_hits`) and
    `mesh`, a precomputed `mesh_tables(scene)`.
    Returns dict(j [-1 = miss], tid, mid, row, sub (int32), p, n, tan,
    bitan (planar f32), u, v, ptex, pnm (f32)), plus idx_t, idx_n (int32)
    when `tex_out=2`. With `slim` only the kernel's own record
    (`SLIM_FIELDS`, and idx_t, idx_n): tan, bitan, ptex and pnm are the
    winning quad's table columns (`quad_fields`). What a lane that is not
    live holds: see the module docstring. `tables`: a precomputed
    `intersect_tables(scene)`. `sphere_tex`: `sphere_tex_table(scene)`
    for the sphere-UV texel index (module docstring; with `tex_out >= 1`
    only)."""
    if tex_out not in (0, 1, 2):
        raise ValueError(f"first_hits: tex_out must be 0, 1 or 2, got "
                         f"{tex_out!r}")
    if tables is None:
        tables = intersect_tables(scene)
    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        if t_mesh is None or tri_mesh is None:
            raise ValueError("first_hits: a mesh scene needs t_mesh and "
                             "tri_mesh (traverse.mesh_closest_hits)")
        if mesh is None:
            mesh = mesh_tables(scene)
    if sphere_tex is not None and not tex_out:
        raise ValueError("first_hits: sphere_tex needs tex_out >= 1")
    if kc.use_kernel(kernels, o[0]):
        out = _first_hits_cuda(scene, o, d, time, live, eps, tex_out,
                               tables, t_mesh, tri_mesh, mesh, sphere_tex)
        if not slim:
            out.update(quad_fields(tables[1], tables[0].shape[0], out["j"],
                                   tex_out))
        return out
    out = first_hits_plain(scene, o, d, time, live, eps, tex_out, tables,
                           t_mesh, tri_mesh, mesh, sphere_tex)
    if slim:
        for k in ("tan", "bitan", "ptex", "pnm"):
            del out[k]
    return out


def quad_fields(quad, S, j, tex_out=1):
    """The per-quad columns of the winning quad of each lane, 0 where no
    quad wins (j = -1 on a miss or a lane that is not live): tan, bitan
    (planar; quad table columns 26:32) and, with `tex_out`, the atlas
    masks ptex, pnm (columns 39, 40), else 0."""
    Q = quad.shape[0]
    is_q = (j >= S) & (j < S + Q)
    row = (quad[torch.clamp(j - S, 0, Q - 1).long()] if Q
           else quad.new_zeros((j.shape[0], quad.shape[1])))

    def col(c):
        return torch.where(is_q, row[:, c], 0.0)

    zero = torch.zeros_like(row[:, 0])
    return dict(tan=(col(26), col(27), col(28)),
                bitan=(col(29), col(30), col(31)),
                ptex=col(39) if tex_out else zero,
                pnm=col(40) if tex_out else zero)


def _unpack(out_i, out_f):
    i = dict(zip(I_FIELDS, out_i))
    f = dict(zip(F_FIELDS, out_f))
    out = dict(j=i["j"], tid=i["tid"], mid=i["mid"], row=i["row"],
               sub=i["sub"], p=(f["px"], f["py"], f["pz"]),
               n=(f["nx"], f["ny"], f["nz"]), u=f["u"], v=f["v"])
    if "idx_t" in i:
        out.update(idx_t=i["idx_t"], idx_n=i["idx_n"])
    return out


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
        from tracer_torch.render import shading
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


class _Args(ctypes.Structure):
    """Mirror of `FirstHitsArgs` in csrc/first_hits.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ox", "oy", "oz", "dx", "dy", "dz", "tm", "live", "sph", "quad",
        "t_mesh", "tri_mesh", "mesh_mid", "pack", "sph_tex", "out_i",
        "out_f")] + [
        (name, ctypes.c_int) for name in (
            "n", "S", "S_real", "Q", "Q_real", "n_meshes", "T", "tex_out",
            "p_tex", "p_nm")] + [("eps", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "sphere_uv", "exact_atlas", "blocks", "shared_tables")]


def _first_hits_cuda(scene, o, d, time, live, eps, tex_out, tables,
                     t_mesh=None, tri_mesh=None, mesh=None, sphere_tex=None):
    from tracer_torch.kernels import _build
    global LAUNCHES, TABLES
    sph, quad = tables
    dev = o[0].device
    N = o[0].shape[0]
    S, Q = sph.shape[0], quad.shape[0]
    S_real, Q_real = min(scene.n_sph_real, S), min(scene.n_quad_real, Q)
    f32, i32 = torch.float32, torch.int32
    out_i = torch.empty((7 if tex_out == 2 else 5, N), dtype=i32,
                        device=dev)
    out_f = torch.empty((len(F_FIELDS), N), dtype=f32, device=dev)
    a = _Args()
    for name, t in zip(("ox", "oy", "oz"), o):
        setattr(a, name, kc.check(name, t, f32, (N,), dev))
    for name, t in zip(("dx", "dy", "dz"), d):
        setattr(a, name, kc.check(name, t, f32, (N,), dev))
    a.tm = kc.check("time", time, f32, (N,), dev)
    a.live = kc.check("live", live, torch.bool, (N,), dev)
    a.sph = kc.check("sph", sph, f32, (S, 9), dev)
    a.quad = kc.check("quad", quad, f32, (Q, 47), dev)
    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        midm, pack = mesh
        a.t_mesh = kc.check("t_mesh", t_mesh, f32, (Nm, N), dev)
        a.tri_mesh = kc.check("tri_mesh", tri_mesh, i32, (Nm, N), dev)
        a.mesh_mid = kc.check("mesh_mid", midm, f32, (Nm,), dev)
        a.pack = kc.check("pack", pack, f32,
                          (pack.shape[0], MESH_PACK_COLS), dev)
        a.T = pack.shape[0]
    a.n_meshes = Nm
    if sphere_tex is not None and S > 0:
        a.sph_tex = kc.check("sphere_tex", sphere_tex, f32,
                             (S, SPHERE_TEX_COLS), dev)
        a.sphere_uv = 1
    a.out_i, a.out_f = out_i.data_ptr(), out_f.data_ptr()
    a.n, a.S, a.S_real, a.Q, a.Q_real = N, S, S_real, Q, Q_real
    a.tex_out, a.eps = int(tex_out), float(eps)
    a.p_tex, a.p_nm = scene.tex_data.shape[0], scene.nm_data.shape[0]
    if N > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_first_hits(ctypes.addressof(a), stream)
        kc.raise_on_error("first_hits", err)
        LAUNCHES += 1
        TABLES = "shared" if a.shared_tables else "global"
    return _unpack(out_i, out_f)
