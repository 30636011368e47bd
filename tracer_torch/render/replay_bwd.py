"""Hand-written backward of the record-replay renderer (the port of
`tracer/render/replay_bwd.py`).

The record forward (`integrator._trace_loop(with_rec=True)`) keeps each
bounce's discrete selections (winning primitive, fetched texels) and its
input state. With those fixed, a bounce is closed-form, so its
vector-Jacobian product is written out by hand: ONE reverse sweep over
bounces, each step re-deriving
the bounce's primal values from the record and chaining cotangents. There
is no replay forward and no autodiff graph.

`bounce_bwd` is the adjoint math of one bounce, planar (3-tuples of [N]
tensors), with the JAX package's expressions in the JAX package's order.
It is the body of the plain PyTorch version of the bounce-adjoint kernel
(`tracer_torch/kernels/shade_bwd.py`); `replay_backward` drives the sweep
through that kernel's wrapper, which also adds the per-lane row
cotangents onto the small running tables, and maps the tables back to
scene fields.

Scene-class gate (`hand_bwd_ok`): no meshes, no lights, no sky image, no
textured spheres, no emissive TEX_IMAGE material, and either no atlas or
a pair atlas — the Cornell class. Structural facts the derivation uses:
u/v have zero cotangents (they reach outputs only through trunc
staircases); with no lights the hit point feeds only the scatter origin;
the radiance cotangent is the same at every bounce (acc is a running sum).
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.core import rng

DIFFUSE, GLASS, MIRROR = 0, 1, 2
TEX_NONE, TEX_CHECKERBOARD, TEX_IMAGE = 0, 1, 2

# the scene fields `integrator.trace` differentiates (the JAX package's
# trainable scene fields, `tracer/train.py:50-54`, and a few more);
# `replay_backward` returns the cotangents of all but the atlases and
# `mesh_verts` (no mesh in its class)
GRAD_FIELDS = (
    "sph_center", "sph_radius", "mat_mb", "quad_v0", "quad_er", "quad_eu",
    "quad_tan", "quad_bitan", "mat_check1", "mat_check2", "mat_diffuse",
    "mat_light_color", "mat_light_intensity", "mat_emissive", "mat_ior",
    "mat_transparency", "mat_texscale", "tex_data", "nm_data", "dark_sky",
    "mesh_verts")


def hand_bwd_ok(scene, cfg) -> bool:
    """Static gate for the hand-written backward (the Cornell class)."""
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    return (scene.mesh_mat.shape[0] == 0
            and scene.light_pos.shape[0] == 0
            and not scene.has_sky_image
            and not scene.sphere_uv_needed
            and not scene.emissive_tex_image
            and (no_atlas or (scene.pair_mode
                              and scene.pair_pack.shape[0] > 1)))


# ---------------------------------------------------------------------------
# planar helpers (3-tuples of [N] tensors)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _sc(k, a):
    return (k * a[0], k * a[1], k * a[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _wh(m, a, b):
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def _mask(m, a):
    return (torch.where(m, a[0], 0.0), torch.where(m, a[1], 0.0),
            torch.where(m, a[2], 0.0))


def _norm_fwd(v, eps=1e-20):
    """vec3p.normalize forward: (unit, inv, sel); sel marks the
    differentiable branch of 1/max(|v|, eps)."""
    s = torch.sqrt(_dot(v, v))
    inv = 1.0 / torch.clamp_min(s, eps)
    return _sc(inv, v), inv, s >= eps


def _norm_bwd(unit, inv, sel, g):
    """Adjoint of u = v / max(|v|, eps): gv = inv*(g - sel*u*(u.g))."""
    k = torch.where(sel, _dot(unit, g), 0.0)
    return (inv * (g[0] - unit[0] * k), inv * (g[1] - unit[1] * k),
            inv * (g[2] - unit[2] * k))


def _trunc_mod2(x):
    """floor(x) mod 2, exact for x >= 0 (every real textured lane)."""
    t = torch.floor(x)
    return t - 2.0 * torch.floor(t * 0.5)


# ---------------------------------------------------------------------------
# one-bounce adjoint
# ---------------------------------------------------------------------------

def bounce_bwd(o, d, tp, active, tm, bk, j_enc, img, rnm, ptex, pnm,
               mrf, textype, mtype, use_nm, srow, qrow,
               go2, gd2, gtp2, gpix, *, S, Q, ref, eps, n_rem, dark,
               has_pair, last=False):
    """Adjoint of one replay bounce.

    Inputs (planar): o/d/tp/img/rnm/go2/gd2/gtp2/gpix 3-tuples of [N];
    active bool [N]; tm time [N]; bk [N] the bounce-salted keys (int64
    holding uint32); j_enc recorded winner [N] (-1 = miss); ptex/pnm
    present masks [N] f32; mrf/srow/qrow the lane's material, sphere and
    quad rows as column lists (18/8/19 of [N]); textype/mtype/use_nm [N]
    int. go2/gd2/gtp2 are the next-state cotangents (ignored when last).

    Returns (go, gd, gtp, gtm, gimg, grnm, gmrf, gsrow, gqrow, gdark) with
    the row cotangents as column lists matching the inputs."""
    zero = torch.zeros_like(tm)
    z3 = (zero, zero, zero)
    miss = j_enc < 0
    j = torch.clamp_min(j_enc, 0)
    live = active & ~miss
    is_sph = j < S
    is_quad = ~is_sph & (j < S + Q)
    if last:
        go2 = gd2 = gtp2 = z3

    # ================= primal recompute (what the adjoint needs) ========
    a2 = _dot(d, d)

    # sphere detail (primitives.sphere_hit_detail)
    center = (srow[0], srow[1], srow[2])
    radius = srow[3]
    mb_s = (srow[4], srow[5], srow[6])
    tc = _add(center, _sc(tm, mb_s))
    oc = _sub(o, tc)
    b_s = 2.0 * _dot(d, oc)
    c_s = _dot(oc, oc) - radius * radius
    delta = b_s * b_s - 4.0 * a2 * c_s
    sq = torch.sqrt(torch.clamp_min(delta, 1e-12))
    t_s = (-b_s - sq) / (2.0 * a2)
    p_s = _add(o, _sc(t_s, d))
    vns = _sub(p_s, tc)
    n_s, inv_ns, sel_ns = _norm_fwd(vns)

    # quad detail (primitives.quad_hit_detail)
    v0 = (qrow[0], qrow[1], qrow[2])
    er = (qrow[3], qrow[4], qrow[5])
    eu = (qrow[6], qrow[7], qrow[8])
    mb_q = (qrow[9], qrow[10], qrow[11])
    tan = (qrow[12], qrow[13], qrow[14])
    bitan = (qrow[15], qrow[16], qrow[17])
    cr = _cross(er, eu)
    n_q, inv_nq, sel_nq = _norm_fwd(cr)
    bl = _add(v0, _sc(tm, mb_q))
    dotRN = _dot(d, n_q)
    safe = torch.where(torch.abs(dotRN) < 1e-9,
                       torch.where(dotRN < 0, -1e-9, 1e-9), dotRN)
    num_q = _dot(bl, n_q) - _dot(o, n_q)
    t_q = num_q / safe
    p_q = _add(o, _sc(t_q, d))
    qv = _sub(p_q, bl)
    u_q = _dot(qv, er) / torch.clamp_min(_dot(er, er), 1e-30)
    v_q = _dot(qv, eu) / torch.clamp_min(_dot(eu, eu), 1e-30)

    n0 = _wh(is_quad, n_q, n_s)

    # material fields (the matf layout, kernels/shade_bwd.bwd_tables)
    sx, sy = mrf[0], mrf[1]
    c1 = (mrf[2], mrf[3], mrf[4])
    c2 = (mrf[5], mrf[6], mrf[7])
    base = (mrf[8], mrf[9], mrf[10])
    lc = (mrf[11], mrf[12], mrf[13])
    intens, emsv, ior = mrf[14], mrf[15], mrf[17]

    # texture selects: sphere lanes have no textype (the gate), so the
    # quad u/v serve the parity masks
    u_t, v_t = u_q, v_q
    same = _trunc_mod2(u_t * sx) == _trunc_mod2(v_t * sy)
    checker = _wh(same, c1, c2)
    same8 = _trunc_mod2(u_t * 8.0) == _trunc_mod2(v_t * 8.0)
    on = torch.where(same8, 0.0, 1.0)
    magenta = (on, zero, on)
    present = ptex > 0.5
    img_fb = _wh(present, img, magenta)
    is_chk = textype == TEX_CHECKERBOARD
    is_img = textype == TEX_IMAGE
    is_none = textype == TEX_NONE
    textured = _wh(is_chk, checker, base)
    diffuse = _wh(is_img, img_fb, textured)

    # normal mapping (quads only; Scene.h:284)
    if has_pair:
        nmv = (2.0 * rnm[0] - 1.0, 2.0 * rnm[1] - 1.0, 2.0 * rnm[2] - 1.0)
        v2 = tuple(nmv[0] * tan[a] + nmv[1] * bitan[a] + nmv[2] * n0[a]
                   for a in range(3))
        n2u, inv_n2, sel_n2 = _norm_fwd(v2)
        upd = is_quad & (pnm > 0.5) & (use_nm > 0)
        n = _wh(upd, n2u, n0)
    else:
        n = n0

    # emission (Material::emit)
    etex = _wh(is_chk, checker, lc)
    etex = _wh(is_img, img_fb, etex)
    ecol = _wh(is_none, lc, etex)
    kem = intens * emsv
    emis = _sc(kem, ecol)

    # procedural sky (shading.skybox_color_p, no image)
    a_sky = 0.5 * (d[1] + 1.0)
    scale = (n_rem + 1.0) if ref else 1.0
    w_sky = 1.0 - a_sky
    k_sky = 1.0 - dark
    sky = (k_sky * (w_sky + a_sky * 0.5 * scale),
           k_sky * (w_sky + a_sky * 0.7 * scale),
           k_sky * (w_sky + a_sky * 1.0 * scale))

    # ================= adjoint (reverse order) ==========================
    amiss = active & miss

    # state selects: o'=wh(live,o2,o), d'=wh(live,d2,d),
    # tp'=wh(live,tp*diffuse,tp), acc'=acc+amiss*tp*sky+live*tp*emis
    g_o2 = _mask(live, go2)
    g_o = _mask(~live, go2)
    g_d2s = _mask(live, gd2)
    g_d = _mask(~live, gd2)
    g_tp = tuple(torch.where(live, gtp2[a] * diffuse[a], gtp2[a])
                 + torch.where(amiss, gpix[a] * sky[a], 0.0)
                 + torch.where(live, gpix[a] * emis[a], 0.0)
                 for a in range(3))
    g_diffuse = list(_mask(live, tuple(gtp2[a] * tp[a] for a in range(3))))
    g_sky = _mask(amiss, tuple(gpix[a] * tp[a] for a in range(3)))
    g_emis = _mask(live, tuple(gpix[a] * tp[a] for a in range(3)))

    # sky: d/d(a) of comp c = k*(coef_c*scale - 1); d(a)/d(dy) = 0.5.
    # The scalar factor is rounded as f32 arithmetic rounds it (the JAX
    # package's scale is an f32 array, and so is the CUDA kernel's)
    coef = (0.5, 0.7, 1.0)
    dslope = [float(np.float32(np.float32(c) * np.float32(scale))
                    - np.float32(1.0)) for c in coef]
    g_a = sum(g_sky[a] * k_sky * dslope[a] for a in range(3))
    g_dy_sky = 0.5 * g_a
    g_dark = -sum(g_sky[a] * (w_sky + a_sky * coef[a] * scale)
                  for a in range(3))

    # emission: emis = kem * ecol
    g_kem = sum(g_emis[a] * ecol[a] for a in range(3))
    g_ecol = _sc(kem, g_emis)
    gm14 = g_kem * emsv
    gm15 = g_kem * intens
    m_img_e = ~is_none & is_img
    m_chk_e = ~is_none & ~is_img & is_chk
    m_lc_e = is_none | (~is_img & ~is_chk)
    g_imgfb = list(_mask(m_img_e, g_ecol))
    g_checker = list(_mask(m_chk_e, g_ecol))
    g_lc = _mask(m_lc_e, g_ecol)

    # diffuse: wh(is_img, img_fb, wh(is_chk, checker, base))
    m_chk_d = ~is_img & is_chk
    m_base = ~is_img & ~is_chk
    for a in range(3):
        g_imgfb[a] = g_imgfb[a] + torch.where(is_img, g_diffuse[a], 0.0)
        g_checker[a] = g_checker[a] + torch.where(m_chk_d, g_diffuse[a], 0.0)
    g_base = _mask(m_base, tuple(g_diffuse))

    # img_fb / checker leaves
    gimg = _mask(present, tuple(g_imgfb))
    g_c1 = _mask(same, tuple(g_checker))
    g_c2 = _mask(~same, tuple(g_checker))

    # ---------- scatter adjoint (not on the last bounce, whose scatter
    # and state outputs are dead) ----------
    g_n = list(z3)
    g_p = list(z3)
    g_ior = zero
    g_d_sc = list(z3)
    if not last:
        ddn = _dot(d, n)
        going_out = ddn > 0.0
        iw = torch.where(ior > 1e-12, ior, 1.0)
        ior_inv = 1.0 / iw
        if ref:
            ri = torch.where(going_out, ior_inv, ior)
        else:
            ri = torch.where(going_out, ior, ior_inv)
        cos_t = torch.clamp_max(-ddn, 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        if ref:
            cannot = (ri * sin_t - 0.6) > 1.0
        else:
            cannot = (ri * sin_t) > 1.0
        u_glass = rng.uniform(rng.salted(bk, rng.SCATTER_GLASS))
        r0 = (1.0 - ri) / (1.0 + ri)
        r0 = r0 * r0
        mm = torch.clamp_min(1.0 - cos_t, 0.0)
        m2 = mm * mm
        schlick = r0 + (1.0 - r0) * (m2 * m2 * mm)
        use_reflect = cannot | (schlick > u_glass)
        kr = 2.0 * ddn
        rf = tuple(d[a] - kr * n[a] for a in range(3))
        cth = torch.clamp_max(ddn, 1.0)
        pp = tuple(ri * (cth * n[a] + d[a]) for a in range(3))
        kkw = 1.0 - _dot(pp, pp)
        kk = torch.abs(kkw)
        m_r = torch.clamp_min(kk, 1e-12)
        sqm = torch.sqrt(m_r)
        par = -sqm
        rr = tuple(par * n[a] + pp[a] for a in range(3))
        skey = rng.salted(bk, rng.SCATTER_DIR)
        if ref:
            ruv = rng.cube_unit_vector_lane_p(skey, 0)
        else:
            ruv = rng.sphere_unit_vector_lane_p(skey, 0)
        ddf0 = _add(n, ruv)
        tinyn = torch.sqrt(_dot(ddf0, ddf0)) <= eps
        is_g = mtype == GLASS
        is_m = mtype == MIRROR
        d_glass = _wh(use_reflect, rf, rr)
        ddf = _wh(tinyn, n, ddf0)
        v_lobe = _wh(is_g, d_glass, _wh(is_m, rf, ddf))
        d2u, inv_d2, sel_d2 = _norm_fwd(v_lobe)

        # reverse: o2 = p + eps*d2
        g_p = list(g_o2)
        g_d2 = tuple(g_d2s[a] + eps * g_o2[a] for a in range(3))
        g_v = _norm_bwd(d2u, inv_d2, sel_d2, g_d2)
        g_dglass = _mask(is_g, g_v)
        g_rf = list(_mask(is_m & ~is_g, g_v))
        g_ddf = _mask(~is_g & ~is_m, g_v)
        # ddf = wh(tiny, n, n + ruv): both branches pass to n
        g_n = list(g_ddf)
        for a in range(3):
            g_rf[a] = g_rf[a] + torch.where(use_reflect, g_dglass[a], 0.0)
        g_rr = _mask(~use_reflect, g_dglass)
        # rr = par*n + pp
        g_par = _dot(n, g_rr)
        for a in range(3):
            g_n[a] = g_n[a] + par * g_rr[a]
        g_pp = list(g_rr)
        # par = -sqrt(max(|kkw|, 1e-12))
        g_m = -0.5 / sqm * g_par
        g_kk = torch.where(kk >= 1e-12, g_m, 0.0)
        g_kkw = torch.where(kkw > 0.0, g_kk,
                            torch.where(kkw < 0.0, -g_kk, 0.0))
        for a in range(3):
            g_pp[a] = g_pp[a] + -2.0 * pp[a] * g_kkw
        # pp = ri*(cth*n + d)
        g_ri = sum(g_pp[a] * (cth * n[a] + d[a]) for a in range(3))
        g_cth = ri * _dot(n, tuple(g_pp))
        for a in range(3):
            g_n[a] = g_n[a] + ri * cth * g_pp[a]
            g_d_sc[a] = g_d_sc[a] + ri * g_pp[a]
        g_ddn = torch.where(ddn <= 1.0, g_cth, 0.0)
        # rf = d - kr*n ; kr = 2*ddn
        g_kr = -_dot(n, tuple(g_rf))
        for a in range(3):
            g_d_sc[a] = g_d_sc[a] + g_rf[a]
            g_n[a] = g_n[a] + -kr * g_rf[a]
        g_ddn = g_ddn + 2.0 * g_kr
        # ri select (+ 1/iw)
        if ref:
            g_iorinv = torch.where(going_out, g_ri, 0.0)
            g_ior = torch.where(going_out, 0.0, g_ri)
        else:
            g_ior = torch.where(going_out, g_ri, 0.0)
            g_iorinv = torch.where(going_out, 0.0, g_ri)
        g_iw = -g_iorinv * ior_inv * ior_inv
        g_ior = g_ior + torch.where(ior > 1e-12, g_iw, 0.0)
        # ddn = d.n
        for a in range(3):
            g_d_sc[a] = g_d_sc[a] + g_ddn * n[a]
            g_n[a] = g_n[a] + g_ddn * d[a]

    # ---------- normal-map adjoint ----------
    grnm = z3
    g_tan = z3
    g_bitan = z3
    if has_pair:
        g_n2 = _mask(upd, tuple(g_n))
        g_n0 = list(_mask(~upd, tuple(g_n)))
        g_v2 = _norm_bwd(n2u, inv_n2, sel_n2, g_n2)
        g_nmx = _dot(tan, g_v2)
        g_nmy = _dot(bitan, g_v2)
        g_nmz = _dot(n0, g_v2)
        g_tan = _sc(nmv[0], g_v2)
        g_bitan = _sc(nmv[1], g_v2)
        for a in range(3):
            g_n0[a] = g_n0[a] + nmv[2] * g_v2[a]
        grnm = (2.0 * g_nmx, 2.0 * g_nmy, 2.0 * g_nmz)
    else:
        g_n0 = list(g_n)

    # ---------- p / n selects ----------
    g_pq = _mask(is_quad, tuple(g_p))
    g_ps = list(_mask(~is_quad, tuple(g_p)))
    g_nq = list(_mask(is_quad, tuple(g_n0)))
    g_ns = _mask(~is_quad, tuple(g_n0))

    # ---------- quad detail adjoint ----------
    g_o_q = list(g_pq)
    g_tq = _dot(g_pq, d)
    g_d_q = list(_sc(t_q, g_pq))
    g_num = g_tq / safe
    g_safe = -t_q * g_tq / safe
    g_dotRN = torch.where(torch.abs(dotRN) >= 1e-9, g_safe, 0.0)
    g_bl = list(_sc(g_num, n_q))
    for a in range(3):
        g_o_q[a] = g_o_q[a] + -g_num * n_q[a]
        g_nq[a] = g_nq[a] + g_num * (bl[a] - o[a])
        g_d_q[a] = g_d_q[a] + g_dotRN * n_q[a]
        g_nq[a] = g_nq[a] + g_dotRN * d[a]
    g_cr = _norm_bwd(n_q, inv_nq, sel_nq, tuple(g_nq))
    g_er = _cross(eu, g_cr)
    g_eu = _cross(g_cr, er)
    g_v0 = tuple(g_bl)
    g_tm = torch.where(is_quad, _dot(tuple(g_bl), mb_q), 0.0)
    g_mbq = _sc(tm, tuple(g_bl))

    # ---------- sphere detail adjoint ----------
    g_vns = _norm_bwd(n_s, inv_ns, sel_ns, g_ns)
    for a in range(3):
        g_ps[a] = g_ps[a] + g_vns[a]
    g_tc = list(_sc(-1.0, g_vns))
    g_o_s = list(g_ps)
    g_ts = _dot(tuple(g_ps), d)
    g_d_s = list(_sc(t_s, tuple(g_ps)))
    inv2a2 = 1.0 / (2.0 * a2)
    g_b = -g_ts * inv2a2
    g_sq = -g_ts * inv2a2
    g_a2 = -t_s * g_ts / a2
    g_delta = torch.where(delta >= 1e-12, g_sq * 0.5 / sq, 0.0)
    g_b = g_b + 2.0 * b_s * g_delta
    g_a2 = g_a2 + -4.0 * c_s * g_delta
    g_c = -4.0 * a2 * g_delta
    g_oc = list(_sc(2.0 * g_c, oc))
    g_r = -2.0 * radius * g_c
    for a in range(3):
        g_d_s[a] = g_d_s[a] + 2.0 * g_b * oc[a]
        g_oc[a] = g_oc[a] + 2.0 * g_b * d[a]
    for a in range(3):
        g_o_s[a] = g_o_s[a] + g_oc[a]
        g_tc[a] = g_tc[a] + -g_oc[a]
    g_center = tuple(g_tc)
    g_tm = g_tm + torch.where(is_sph, _dot(tuple(g_tc), mb_s), 0.0)
    g_mbs = _sc(tm, tuple(g_tc))
    for a in range(3):
        g_d_s[a] = g_d_s[a] + 2.0 * g_a2 * d[a]

    # ---------- totals ----------
    go = tuple(g_o[a] + g_o_q[a] + g_o_s[a] for a in range(3))
    gd = [g_d[a] + g_d_sc[a] + g_d_q[a] + g_d_s[a] for a in range(3)]
    gd[1] = gd[1] + g_dy_sky
    gd = tuple(gd)

    gmrf = ([zero, zero] + list(g_c1) + list(g_c2) + list(g_base)
            + list(g_lc) + [gm14, gm15, zero, g_ior])
    gsrow = list(g_center) + [g_r] + list(g_mbs) + [zero]
    gqrow = (list(g_v0) + list(g_er) + list(g_eu) + list(g_mbq)
             + list(g_tan) + list(g_bitan) + [zero])
    return (go, gd, tuple(g_tp), g_tm, gimg, grnm, gmrf, gsrow, gqrow,
            g_dark)


# ---------------------------------------------------------------------------
# the reverse sweep
# ---------------------------------------------------------------------------

def _onehot_accum(acc_t, idx, rows):
    """acc_t [C, K] += rows [C, N] @ onehot(idx) [N, K], in full f32. The
    one-hot entries are exact 0/1, so only the summation order differs
    from the JAX package's dot (Precision.HIGHEST). TF32 (three decimal
    digits) is turned off for the product and the caller's setting put
    back after it."""
    K = acc_t.shape[1]
    oh = (idx[:, None] == torch.arange(K, dtype=idx.dtype,
                                       device=idx.device)[None, :]
          ).to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return acc_t + rows @ oh
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def replay_backward(scene, cfg, time, keys, rec, states, g, dark):
    """Full hand-written backward of the replay.

    rec: per-bounce records [(reci [4, N] i32, recf [8, N] f32, ...)] from
    `integrator._trace_loop(with_rec=True)`; states: per-bounce INPUT
    states [10, N] (o(3), d(3), throughput(3), active). g: [N, 3] radiance
    cotangent.

    Returns (gscene, go [3, N], gd [3, N], gtime [N], gtex): gscene a dict
    of cotangents for `GRAD_FIELDS` (tex_data and nm_data excluded — the
    caller folds those); gtex the per-bounce texel cotangents [6, N]
    (img(3), rnm(3)) of bounces 0..B-2 (the last bounce fetches no texel
    in this class). `dark`: `scene.dark_sky` as a host float (the forward's
    `integrator.host_constants`, kept in `_TraceRecordReplay`'s ctx), so
    the sweep reads nothing from the card."""
    from tracer_torch.kernels import shade_bwd as kbwd

    B = cfg.max_bounces
    ref = cfg.compat == "reference"
    N = g.shape[0]
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    tables = kbwd.bwd_tables(scene)
    M = tables[2].shape[0]
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    has_pair = not no_atlas
    dev, f32 = g.device, torch.float32

    gp = g.t().to(f32)
    if ref:
        gp = gp / float(B)   # the _finish /B quirk
    gpix = gp.contiguous()

    # one call per bounce, B-1 down to 0: each adds its row cotangents to
    # the running tables `acc` and hands its `a` (go, gd, gtp and the
    # running gtm) to the call of the bounce before; the last bounce's
    # input state is the final recorded one
    acc = torch.zeros(kbwd.table_size(S, Q, M), dtype=f32, device=dev)
    a = None
    gtex = [None] * (B - 1)
    for b in range(B - 1, -1, -1):
        reci, recf = rec[b][:2]
        a, bb, acc = kbwd.bounce_bwd_tiles(
            states[b], reci[0], recf, tables, rng.salted(keys, b), time, a,
            gpix, acc, float(B - b), dark, S=S, Q=Q,
            ref=ref, eps=cfg.epsilon, has_pair=has_pair, last=b == B - 1,
            kernels=cfg.kernels)
        if b < B - 1:
            gtex[b] = bb
    gmatf, gsph, gquad, gdark = kbwd.table_views(acc, S, Q, M)
    zeros = dict(dtype=f32, device=dev)

    # ---- map table cotangents back to scene fields
    gmatf, gsph, gquad = gmatf.t(), gsph.t(), gquad.t()
    g_mat_mb = _onehot_accum(
        _onehot_accum(torch.zeros((3, M), **zeros), scene.sph_mat,
                      gsph[:, 4:7].t()),
        scene.quad_mat, gquad[:, 9:12].t()).t()
    gscene = dict(
        sph_center=gsph[:, 0:3], sph_radius=gsph[:, 3], mat_mb=g_mat_mb,
        quad_v0=gquad[:, 0:3], quad_er=gquad[:, 3:6],
        quad_eu=gquad[:, 6:9], quad_tan=gquad[:, 12:15],
        quad_bitan=gquad[:, 15:18],
        mat_texscale=gmatf[:, 0:2], mat_check1=gmatf[:, 2:5],
        mat_check2=gmatf[:, 5:8], mat_diffuse=gmatf[:, 8:11],
        mat_light_color=gmatf[:, 11:14],
        mat_light_intensity=gmatf[:, 14], mat_emissive=gmatf[:, 15],
        mat_transparency=gmatf[:, 16], mat_ior=gmatf[:, 17],
        dark_sky=gdark.reshape(scene.dark_sky.shape))
    return gscene, a[0:3], a[3:6], a[9], gtex
