"""The reference path tracer: every bounce is the general bounce of the
port's plain path (`render/integrator.py::_bounce_general` as its plain
autodiff route runs it), frozen here: the candidate tests, the BVH walk
and the soft shadows by the kernels' plain versions (`plain.py`) on the
reference's own tables, the hit re-derived from the scene's tensors, the
texels read from the exact [P, 3] atlases, then lighting and the BSDF
scatter in torch ops. No kernel, no packed atlas and no graph.

Differentiable by plain autograd in the scene's tensors: the discrete
selections (winner, triangle, shadow factors) are taken without grad, the
rest is recorded, as the JAX package's and the port's plain autodiff
backward do.

`lower`, a function applied to the bounce state after each bounce and to
the radiance, stands for a lower precision (the control of
`portbench/check.py`: the state rounded to bfloat16). `counts`, a list,
receives a dict a bounce: the lanes active at its start, the lanes that
hit, and the soft-shadow pass's rays and the sphere and quad tests they
need before an occluder blocks them (the plain version's counts): what
the benchmark's roofline counts read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import plain
from portbench.reference import primitives as prim
from portbench.reference import rng
from portbench.reference import shading
from portbench.reference import vec3p as vp
from portbench.reference.config import RenderConfig
from portbench.reference.mathutils import schlick_reflectance

DIFFUSE, GLASS, MIRROR = 0, 1, 2


class Tables(NamedTuple):
    """The per-frame tables the plain versions read."""
    intersect: tuple
    mesh: Optional[tuple]
    tree: Optional[tuple]
    shadow: Optional[tuple]
    sky_wh: Optional[tuple]


@torch.no_grad()
def prepare(scene) -> Tables:
    meshes = scene.mesh_mat.shape[0] > 0
    sky = ((int(scene.sky_w), int(scene.sky_h)) if scene.has_sky_image
           else None)
    return Tables(
        plain.intersect_tables(scene),
        plain.mesh_tables(scene) if meshes else None,
        plain.traverse_tables(scene) if meshes else None,
        plain.shadow_tables(scene) if scene.light_pos.shape[0] > 0 else None,
        sky)


def _rows(table, idx):
    """Row `idx` (clipped) of a small table; zero rows for an empty one."""
    if table.shape[0] == 0:
        return table.new_zeros((idx.shape[0], table.shape[1]))
    return torch.index_select(table, 0,
                              torch.clamp(idx, 0, table.shape[0] - 1).long())


def _geo_packs(scene):
    """sph [S, 8] (c, r, mb, mid), quad [Q, 19] (v0, er, eu, mb, tan,
    bitan, mid), matf [M, 18], mati [M, 9] int: the rows a hit reads."""
    def f(a):
        return a.to(torch.float32)[:, None]

    sph = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                     scene.mat_mb[scene.sph_mat.long()], f(scene.sph_mat)],
                    dim=1)
    quad = torch.cat([scene.quad_v0, scene.quad_er, scene.quad_eu,
                      scene.mat_mb[scene.quad_mat.long()], scene.quad_tan,
                      scene.quad_bitan, f(scene.quad_mat)], dim=1)
    matf = torch.cat([
        scene.mat_texscale, scene.mat_check1, scene.mat_check2,
        scene.mat_diffuse, scene.mat_light_color,
        scene.mat_light_intensity[:, None], scene.mat_emissive[:, None],
        scene.mat_transparency[:, None], scene.mat_ior[:, None]], dim=1)
    tex, nm = scene.mat_tex.long(), scene.mat_nm.long()
    mati = torch.stack([
        scene.mat_textype, scene.tex_off[tex], scene.tex_w[tex],
        scene.tex_h[tex], scene.nm_off[nm], scene.nm_w[nm], scene.nm_h[nm],
        scene.mat_type, scene.mat_nm], dim=1).to(torch.int32)
    return sph, quad, matf, mati


def _mesh_detail(scene, o, d, tid):
    """The mesh hit's position, normal and interpolated corner colors on
    triangle `tid` (clipped), from the shared vertex table."""
    t = torch.clamp(tid, 0, scene.tri_va.shape[0] - 1).long()
    a, b, c = (vp.splat(scene.mesh_verts[v[t].long()])
               for v in (scene.tri_va, scene.tri_vb, scene.tri_vc))
    p_m, n_m, w0, w1, w2 = prim.triangle_hit_detail(o, d, a, b, c)
    ca, cb, cc = scene.tri_col_a[t], scene.tri_col_b[t], scene.tri_col_c[t]
    col_m = tuple(w0 * ca[:, i] + w1 * cb[:, i] + w2 * cc[:, i]
                  for i in range(3))
    return p_m, n_m, col_m, scene.tri_has_col[t]


def _gather_hit(scene, o, d, a2, time, j, tid, fetch_tex):
    """The selected hit's shading inputs (Scene.h:258-303): position,
    normal (normal-mapped on quads), textured diffuse, emission,
    transparency, ior and material type, planar."""
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    is_sph = j < S
    is_quad = (j >= S) & (j < S + Q)
    is_mesh = j >= S + Q
    sph_pack, quad_pack, matf, mati = _geo_packs(scene)

    srow = _rows(sph_pack, j)
    mid_s = srow[:, 7].to(torch.int32)
    p_s, n_s = prim.sphere_hit_detail(
        o, d, a2, time, (srow[:, 0], srow[:, 1], srow[:, 2]), srow[:, 3],
        (srow[:, 4], srow[:, 5], srow[:, 6]))
    theta, phi = prim.sphere_angles(n_s)
    qrow = _rows(quad_pack, j - S)
    mid_q = qrow[:, 18].to(torch.int32)
    p_q, n_q, u_q, v_q = prim.quad_hit_detail(
        o, d, time, (qrow[:, 0], qrow[:, 1], qrow[:, 2]),
        (qrow[:, 3], qrow[:, 4], qrow[:, 5]),
        (qrow[:, 6], qrow[:, 7], qrow[:, 8]),
        (qrow[:, 9], qrow[:, 10], qrow[:, 11]))
    p_sq = vp.where(is_quad, p_q, p_s)
    n_sq = vp.where(is_quad, n_q, n_s)
    mid_sq = torch.where(is_sph, mid_s, mid_q)
    tan_q = (qrow[:, 12], qrow[:, 13], qrow[:, 14])
    bitan_q = (qrow[:, 15], qrow[:, 16], qrow[:, 17])

    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        p_m, n_m, col_m, has_col = _mesh_detail(scene, o, d, tid)
        mid_m = scene.mesh_mat[torch.clamp(j - S - Q, 0, Nm - 1).long()]
    else:
        p_m = n_m = col_m = vp.full_like(o, 0.0)
        mid_m = torch.zeros_like(j)
        has_col = torch.zeros_like(o[0])

    mid = torch.where(is_mesh, mid_m.to(torch.int32), mid_sq.to(torch.int32))
    p = vp.where(is_mesh, p_m, p_sq)
    n = vp.where(is_mesh, n_m, n_sq)
    # spheres use (phi/2pi, theta/pi) (Scene.h:275-277); squares (u, v)
    u_tex = torch.where(is_sph, phi * shading.INV_2PI, u_q)
    v_tex = torch.where(is_sph, theta * shading.INV_PI, v_q)

    mrf = _rows(matf, mid)
    mri = _rows(mati, mid)
    sx, sy = mrf[:, 0], mrf[:, 1]
    textype = mri[:, 0]

    has_tex = fetch_tex and scene.tex_data.shape[0] > 1
    has_nm = fetch_tex and scene.nm_data.shape[0] > 1
    zb = torch.zeros_like(j, dtype=torch.bool)
    if has_tex:
        tex_idx, present = shading._texel_index(
            scene.tex_data.shape[0], mri[:, 1], mri[:, 2], mri[:, 3],
            u_tex, v_tex, sx, sy)
        img = vp.splat(torch.index_select(scene.tex_data, 0, tex_idx.long()))
    else:
        img, present = vp.full_like(o, 0.0), zb
    same = (shading.cpp_trunc_mod2(u_tex * sx)
            == shading.cpp_trunc_mod2(v_tex * sy))
    checker = vp.where(same, (mrf[:, 2], mrf[:, 3], mrf[:, 4]),
                       (mrf[:, 5], mrf[:, 6], mrf[:, 7]))
    img_fb = vp.where(present, img, shading._magenta_checker_p(u_tex, v_tex))

    # diffuse after texturing (Scene.h:275/283); meshes use their
    # interpolated vertex colors where they have them (Scene.h:291-298)
    base = (mrf[:, 8], mrf[:, 9], mrf[:, 10])
    textured = vp.where(textype == shading.TEX_CHECKERBOARD, checker, base)
    textured = vp.where(textype == shading.TEX_IMAGE, img_fb, textured)
    diffuse = vp.where(is_mesh, vp.where(has_col > 0.5, col_m, base),
                       textured)

    # normal mapping: squares only (Scene.h:284)
    if has_nm:
        nm_idx, npresent = shading._texel_index(
            scene.nm_data.shape[0], mri[:, 4], mri[:, 5], mri[:, 6],
            u_tex, v_tex, sx, sy)
        raw = vp.splat(torch.index_select(scene.nm_data, 0, nm_idx.long()))
        nm = tuple(2.0 * c - 1.0 for c in raw)
        n2 = vp.normalize(tuple(
            nm[0] * tan_q[a] + nm[1] * bitan_q[a] + nm[2] * n[a]
            for a in range(3)))
        use = npresent & (mri[:, 8] > 0)
        n = vp.where(is_quad, vp.where(use, n2, n), n)

    # emission: spheres and squares only (Scene.h:277,285)
    lc = (mrf[:, 11], mrf[:, 12], mrf[:, 13])
    etex = vp.where(textype == shading.TEX_CHECKERBOARD, checker, lc)
    etex = vp.where(textype == shading.TEX_IMAGE, img_fb, etex)
    ecol = vp.where(textype == shading.TEX_NONE, lc, etex)
    emis = vp.scale(mrf[:, 14] * mrf[:, 15], ecol)
    emis = vp.where(is_mesh, vp.full_like(emis, 0.0), emis)
    return dict(p=p, n=n, diffuse=diffuse, emission=emis,
                transp=mrf[:, 16], ior=mrf[:, 17], mtype=mri[:, 7])


def _direct_lighting(scene, cfg: RenderConfig, p, n, transp, diffuse,
                     shadows):
    """Per-light Lambert with the soft-shadow factors (Scene.h:305-334)."""
    ref = cfg.compat == "reference"
    color = vp.full_like(p, 0.0)
    for i in range(scene.light_pos.shape[0]):
        lpos = tuple(scene.light_pos[i, a] for a in range(3))
        ldir = vp.normalize(vp.sub(lpos, p))
        lcol = scene.light_color[0] if ref else scene.light_color[i]
        lam = torch.clamp_min(vp.dot(ldir, n), 0.0) * (1.0 - transp)
        contrib = tuple(lcol[a] * diffuse[a] * lam for a in range(3))
        sh = shadows[i]
        if ref:   # quirk: multiplies everything accumulated (Scene.h:333)
            color = vp.scale(sh, vp.add(color, contrib))
        else:
            color = vp.add(color, vp.mul(contrib, (sh,) * 3))
    return color


def _scatter(cfg: RenderConfig, d, n, p, mtype, ior, keys):
    """Material::scatter (Material.cpp:26-60), branchless, on the PCG
    streams SCATTER_GLASS and SCATTER_DIR."""
    ref = cfg.compat == "reference"
    ddn = vp.dot(d, n)
    going_out = ddn > 0.0
    ior_inv = 1.0 / torch.where(ior > 1e-12, ior, 1.0)
    if ref:   # inverted-eta quirk
        ri = torch.where(going_out, ior_inv, ior)
    else:
        ri = torch.where(going_out, ior, ior_inv)
    cos_t = torch.clamp_max(-ddn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    if ref:
        cannot = (ri * sin_t - 0.6) > 1.0           # -0.6 fudge quirk
    else:
        cannot = (ri * sin_t) > 1.0
    u_glass = rng.uniform(rng.salted(keys, rng.SCATTER_GLASS))
    use_reflect = cannot | (schlick_reflectance(cos_t, ri) > u_glass)
    refl = vp.reflect(d, n)
    d_glass = vp.where(use_reflect, refl, vp.refract(d, n, ri))
    skey = rng.salted(keys, rng.SCATTER_DIR)
    ruv = (rng.cube_unit_vector_lane_p(skey, 0) if ref
           else rng.sphere_unit_vector_lane_p(skey, 0))
    d_diff = vp.add(n, ruv)
    d_diff = vp.where(vp.norm(d_diff) <= cfg.epsilon, n, d_diff)
    d_out = vp.where(mtype == GLASS, d_glass,
                     vp.where(mtype == MIRROR, refl, d_diff))
    d_out = vp.normalize(d_out)
    return vp.axpy(cfg.epsilon, d_out, p), d_out


def _bounce(scene, cfg: RenderConfig, keys, state, b: int, last: bool,
            tables: Tables, stats=None):
    """One bounce (Scene::rayTraceRecursive body, Scene.h:258-342)."""
    eps = cfg.epsilon
    L = scene.light_pos.shape[0]
    n_rem = cfg.max_bounces - b
    o, d, time = state["o"], state["d"], state["time"]
    active, throughput, acc = (state["active"], state["throughput"],
                               state["acc"])
    bkeys = rng.salted(keys, b)
    a2 = vp.dot(d, d)
    with torch.no_grad():
        t_raw = tri_raw = None
        od = (tuple(c.detach() for c in o), tuple(c.detach() for c in d))
        if scene.mesh_mat.shape[0] > 0:
            t_raw, tri_raw = plain.mesh_closest_hits_plain(
                scene, *od, active, tables.tree)
        k1 = plain.first_hits_plain(
            scene, *od, time, active, eps, 0, tables.intersect,
            t_raw, tri_raw, tables.mesh)
    j_enc, tid = k1["j"], k1["tid"]
    miss = j_enc < 0
    j = torch.clamp_min(j_enc, 0)

    # sky on miss (Scene.h:300-303)
    sky = shading.skybox_color_p(scene, d, n_rem, cfg.compat == "reference",
                                 packed=False, sky_wh=tables.sky_wh)
    acc = tuple(acc[a] + torch.where(active & miss, throughput[a] * sky[a],
                                     0.0) for a in range(3))
    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    hit = _gather_hit(scene, o, d, a2, time, j, tid, fetch_tex)
    live = active & ~miss
    shadows = None
    if L > 0:
        with torch.no_grad():
            shadows = plain.shadow_factors_plain(
                scene, cfg, tuple(c.detach() for c in hit["p"]), time, bkeys,
                eps, live, tables.shadow, tables.tree, stats)
    direct = _direct_lighting(scene, cfg, hit["p"], hit["n"], hit["transp"],
                              hit["diffuse"], shadows)
    acc = tuple(acc[a] + torch.where(
        live, throughput[a] * (direct[a] + hit["emission"][a]), 0.0)
        for a in range(3))
    if last:
        return dict(state, acc=acc), live
    o2, d2 = _scatter(cfg, d, hit["n"], hit["p"], hit["mtype"], hit["ior"],
                      bkeys)
    return dict(
        o=vp.where(live, o2, o), d=vp.where(live, d2, d), time=time,
        throughput=vp.where(live, vp.mul(throughput, hit["diffuse"]),
                            throughput),
        active=live, acc=acc), live


def trace(scene, cfg: RenderConfig, o, d, time, keys, tables: Tables,
          lower=None, counts: Optional[list] = None):
    """Radiance [N, 3] of a ray batch (Scene::rayTrace, Scene.h:345-350):
    planar o, d of [N] f32, time [N], keys [N] (int64 holding uint32)."""
    zero = d[0] * 0.0
    state = dict(o=o, d=d, time=time,
                 throughput=(zero + 1.0, zero + 1.0, zero + 1.0),
                 active=torch.ones_like(time, dtype=torch.bool),
                 acc=(zero, zero, zero))
    B = cfg.max_bounces
    for b in range(B):
        start = state["active"]
        stats = {} if counts is not None else None
        state, live = _bounce(scene, cfg, keys, state, b, b == B - 1, tables,
                              stats)
        if counts is not None:
            counts.append(dict(active=int(start.sum()), hits=int(live.sum()),
                               rays=stats.get("rays", 0),
                               table_tests=stats.get("table_tests", 0)))
        if lower is not None:
            state = dict(state, **{k: tuple(lower(c) for c in state[k])
                                   for k in ("o", "d", "throughput", "acc")})
    out = torch.stack(state["acc"], dim=-1)
    if cfg.compat == "reference":
        # Scene.h:347-349 quirk, as the f32 reciprocal multiply
        out = out * float(np.float32(1.0) / np.float32(cfg.max_bounces))
    return out if lower is None else lower(out)
