"""Shade+scatter kernel: everything a bounce does after the first hit —
sky on miss, material and texel fetch, checker/image/emission select,
normal mapping, direct light from given shadow factors, BSDF scatter on
the PCG streams, and the wavefront state update — in one pass, in place.

Replaces the TPU kernel `tracer/kernels/shade.py::shade_scatter` (Pallas,
`pl.pallas_call` at shade.py:473) with the CUDA kernel
`csrc/shade_scatter.cu`: persistent blocks that list each tile's active
lanes in shared memory and run the chain on them only. The material row,
the winning quad's tangent frame and atlas masks (from the first-hit quad
table, by j) and the pair-atlas texel words are fetched inside the kernel
by (mid), (j) and (row, sub); the TPU path did the first and the last in
XLA (`integrator._rows` and the pair-row gather with its one-hot select)
and took the frame from its first-hit record. `shade_scatter_plain` is
the plain PyTorch version with the same expressions in the same order.

The update is in place: `state`'s o, d, throughput, acc and active
tensors are written, and nothing is allocated for them. The integrator's
`trace` owns one set of state buffers per call (`integrator._init_state`
copies the caller's rays), so a lane that is not active costs the kernel
its active flag, not a read and a write of 12 floats into a fresh output
each bounce. The record forward copies each bounce's input state before
the call. A caller that still needs the state it passes in gives a copy
(`integrator.copy_state`); the tensors must not alias one another.

What bounds it on an H100: memory traffic, about 100 B read and 48 B
written per live lane, a few dozen flops and ~10 hash rounds; on sparse
bounces the dead lanes, which cost their active flag only. The material,
light and per-quad tables sit in dynamic shared memory (or are read
through L2 beyond a block's 227 KB: `TABLES`).

Skies: on a miss the kernel takes the procedural sky or, with an image
skybox, the equirect texel of the ray's direction (`shading.
sky_texel_index`: atan2, asin, the texel index and the packed word's
decode, scaled by NRemainingBounces under compat="reference"). The JAX
package computes the image sky for every lane in XLA and hands it in
(`tracer/kernels/shade.py:91,115-116,167-177`); here only miss lanes
compute it, and no per-bounce glue runs.

Textured spheres (`mat_pair`, `mat_pair_table`): a sphere winner's
atlas masks ptex, pnm are its material's (`mat_pair_tex`,
`mat_pair_nm`), as the JAX package's sphere-UV splice gives them
(`tracer/render/integrator.py:833-834`); a quad winner's come from the
quad table by j.

An active lane adds its radiance to acc; before the last bounce a lane
that hits writes its next o, d and throughput, a lane that misses clears
its active flag; lanes that are not active are not touched. `last=True`
(the final bounce) writes only acc. `rec_out=True` (the record forward of
the backward; pair atlas only) also returns the decoded texel img(3), the
raw normal-map texel rnm(3) and the atlas masks ptex, pnm that the pass
computes anyway, as one [8, N] stack, zero on lanes that are not active:
the backward's texel record.

Mesh winners (`j >= S + Q`): p and n come from the first-hit record (it
holds their triangle hit detail); the diffuse color is the triangle's
corner colors interpolated at the hit (Scene.h:291-298) where the mesh
has colors, else the material's untextured diffuse; their emission is
zero (the reference quirk, Scene.h:277,285). The kernel reads the mesh
pack row of `tid` itself (`intersect.mesh_tables`); the plain version
takes the colors from `intersect.mesh_detail`.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.core import rng
from tracer_torch.core import vec3p as vp
from tracer_torch.kernels import common as kc
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.render import shading

DIFFUSE, GLASS, MIRROR = 0, 1, 2
MAT_COLS = 20
LAUNCHES = 0   # launches of the CUDA kernel (not of the plain version)
TABLES = None  # "shared" or "global": where the last launch's tables sat


def shade_mat_table(scene):
    """[M, 20] f32 material table: 0:3 diffuse, 3:6 check1, 6:9 check2,
    9:12 light_color, 12 k_emit (light_intensity * emissive), 13 transp,
    14 ior, 15 mtypef, 16 textypef, 17 use_nm (mat_nm > 0), 18 sx, 19 sy."""
    def f(a):
        return a.to(torch.float32)[:, None]

    return torch.cat([
        scene.mat_diffuse, scene.mat_check1, scene.mat_check2,
        scene.mat_light_color,
        (scene.mat_light_intensity * scene.mat_emissive)[:, None],
        scene.mat_transparency[:, None], scene.mat_ior[:, None],
        f(scene.mat_type), f(scene.mat_textype), f(scene.mat_nm > 0),
        scene.mat_texscale], dim=1).contiguous()


def _light_table(scene):
    """[max(L, 1), 6] f32: light position and color."""
    if scene.light_pos.shape[0] > 0:
        return torch.cat([scene.light_pos, scene.light_color],
                         dim=1).contiguous()
    return torch.zeros((1, 6), dtype=torch.float32, device=scene.device)


def mat_pair_table(scene):
    """[M, 2] f32: each material's pair-atlas masks (mat_pair_tex,
    mat_pair_nm), read for sphere winners on scenes with textured
    spheres."""
    return torch.stack([scene.mat_pair_tex, scene.mat_pair_nm],
                       dim=1).to(torch.float32).contiguous()


def shade_tables(scene, dark=None):
    """(material table, light table, dark_sky as a host float): what the
    shade pass reads besides the rays. Build it once per frame. `dark`:
    dark_sky already read to the host (`integrator.host_constants`), else
    it is read here."""
    if dark is None:
        dark = float(scene.dark_sky)
    return shade_mat_table(scene), _light_table(scene), dark


def shade_scatter(scene, cfg, state, bkeys, k1, n_rem: int, shadows=None,
                  use_pair=False, last=False, kernels="auto", tables=None,
                  rec_out=False, mesh=None, quad=None, mat_pair=None,
                  sky_wh=None, salt=None):
    """One bounce's shading and scatter over planar ray state, in place.

    state: dict(o, d, time, throughput, active, acc) — planar f32 [N] and
    `active` bool [N]; o, d, throughput, acc and active are updated in
    place (module docstring). bkeys: this bounce's keys (int64 holding
    uint32) or, with `salt` (the bounce index), the sample's keys, which
    the pass salts itself (`rng.salted(keys, salt)`). k1: the
    `first_hits` record (j, tid, mid, p, n, u, v and, with `use_pair`,
    row, sub from `tex_out >= 1`; the slim record suffices). shadows:
    [L, N] f32 soft-shadow factors, or None when the scene has no lights.
    `mesh`: a precomputed `intersect.mesh_tables(scene)` (mesh scenes);
    `quad`: the first-hit quad table
    (`intersect.intersect_tables(scene)[1]`). `mat_pair`: with `use_pair`
    on scenes with textured spheres (k1 from `first_hits(sphere_tex=
    ...)`), `mat_pair_table(scene)`. `sky_wh`: an image sky's (W, H) as
    host ints (read from the scene's tensors if not given). Returns
    `state`, or its acc when `last`; with `rec_out` (which needs
    `use_pair`), the pair (that result, rec [8, N])."""
    if rec_out and not use_pair:
        raise ValueError("shade_scatter: rec_out needs use_pair")
    if mat_pair is not None and not use_pair:
        raise ValueError("shade_scatter: mat_pair needs use_pair")
    if scene.mesh_mat.shape[0] > 0 and mesh is None:
        mesh = kintersect.mesh_tables(scene)
    if tables is None:
        tables = shade_tables(scene)
    if scene.has_sky_image and sky_wh is None:
        sky_wh = int(scene.sky_w), int(scene.sky_h)
    if quad is None:
        quad = kintersect.intersect_tables(scene)[1]
    L = scene.light_pos.shape[0]
    N = state["d"][0].shape[0]
    if L > 0:
        if isinstance(shadows, (list, tuple)):
            shadows = torch.stack(list(shadows))
        shadows = shadows.reshape(L, N).contiguous()
    if kc.use_kernel(kernels, state["d"][0]):
        return _shade_scatter_cuda(scene, cfg, state, bkeys, k1, n_rem,
                                   shadows, use_pair, last, tables, rec_out,
                                   mesh, quad, mat_pair, sky_wh, salt)
    if salt is not None:
        bkeys = rng.salted(bkeys, salt)
    return shade_scatter_plain(scene, cfg, state, bkeys, k1, n_rem,
                               shadows, use_pair, last, tables, rec_out,
                               mesh, quad, mat_pair, sky_wh)


def shade_scatter_plain(scene, cfg, state, bkeys, k1, n_rem, shadows,
                        use_pair, last, tables, rec_out=False, mesh=None,
                        quad=None, mat_pair=None, sky_wh=None):
    """The plain PyTorch version of the kernel (planar 3-tuples): the
    bounce in `torch.where` form, then its results copied into the
    state's tensors, as the kernel writes them."""
    mat_tab, light_tab, _ = tables
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    ref = cfg.compat == "reference"
    eps = cfg.epsilon
    d, th = state["d"], state["throughput"]
    active = state["active"]
    miss = k1["j"] < 0
    j = torch.clamp_min(k1["j"], 0)
    live = active & ~miss
    is_quad = (j >= S) & (j < S + Q)
    u, v = k1["u"], k1["v"]
    p, n = k1["p"], k1["n"]

    # ---- sky on miss (image: the packed twin's word) --------------------
    sky = shading.skybox_color_p(scene, d, n_rem, ref, packed=True,
                                 sky_wh=sky_wh)
    amiss = active & miss
    acc = tuple(a + torch.where(amiss, t * c, 0.0)
                for a, t, c in zip(state["acc"], th, sky))

    # ---- material row by mid --------------------------------------------
    mr = mat_tab[torch.clamp(k1["mid"], 0, mat_tab.shape[0] - 1).long()]

    def col3(c):
        return mr[:, c], mr[:, c + 1], mr[:, c + 2]

    diffuse, check1, check2, light_col = col3(0), col3(3), col3(6), col3(9)
    k_emit, transp, ior = mr[:, 12], mr[:, 13], mr[:, 14]
    mtype = mr[:, 15].to(torch.int32)
    textype = mr[:, 16].to(torch.int32)
    use_nmf, sx, sy = mr[:, 17], mr[:, 18], mr[:, 19]

    # ---- texturing ------------------------------------------------------
    same = shading.trunc_mod2(u * sx) == shading.trunc_mod2(v * sy)
    checker = vp.where(same, check1, check2)
    img = shading.magenta_checker_p(u, v)
    if use_pair:   # the winning quad's frame and atlas masks, by j
        qf = kintersect.quad_fields(quad, S, k1["j"])
        ptex, pnm = qf["ptex"], qf["pnm"]
        if mat_pair is not None:   # a sphere winner's, by its material
            is_sph = (k1["j"] >= 0) & (k1["j"] < S)
            mp = mat_pair[torch.clamp(k1["mid"], 0,
                                      mat_pair.shape[0] - 1).long()]
            ptex = torch.where(is_sph, mp[:, 0], ptex)
            pnm = torch.where(is_sph, mp[:, 1], pnm)
        prow = torch.clamp(k1["row"], 0, scene.pair_pack.shape[0] - 1).long()
        sub = k1["sub"].long()
        vt = scene.pair_pack[prow, sub]
        vn = scene.pair_pack[prow, shading.PACK_BLOCK + sub]
        img_t = shading.decode_word(vt)
        img = vp.where(ptex > 0.5, img_t, img)
    is_check = textype == shading.TEX_CHECKERBOARD
    is_img = textype == shading.TEX_IMAGE
    dcol = vp.where(is_img, img, vp.where(is_check, checker, diffuse))
    if scene.mesh_mat.shape[0] > 0:
        is_mesh = j >= S + Q
        _, _, mcol, has_col = kintersect.mesh_detail(
            mesh[1], state["o"], d, k1["tid"])
        dcol = vp.where(is_mesh, vp.where(has_col > 0.5, mcol, diffuse),
                        dcol)
        k_emit = torch.where(is_mesh, 0.0, k_emit)  # Scene.h:277,285

    # ---- normal mapping (squares only, Scene.h:284) ---------------------
    rec = None
    if use_pair:
        rnm = shading.decode_word(vn)
        if rec_out:
            rec = torch.stack([torch.where(active, c, 0.0)
                               for c in img_t + rnm + (ptex, pnm)])
        nm = tuple(2.0 * c - 1.0 for c in rnm)
        tan, bitan = qf["tan"], qf["bitan"]
        n2 = vp.normalize(tuple(nm[0] * tan[a] + nm[1] * bitan[a]
                                + nm[2] * n[a] for a in range(3)))
        n = vp.where(is_quad & (pnm > 0.5) & (use_nmf > 0.5), n2, n)
    # ---- emission (spheres and squares only) ----------------------------
    ecol = vp.where(textype == shading.TEX_NONE, light_col,
                    vp.where(is_img, img,
                             vp.where(is_check, checker, light_col)))

    # ---- direct lighting from the given shadow factors ------------------
    zero = torch.zeros_like(u)
    cl = (zero, zero, zero)
    for i in range(scene.light_pos.shape[0]):
        ldir = vp.normalize(tuple(light_tab[i, a] - p[a] for a in range(3)))
        lam = torch.clamp_min(vp.dot(ldir, n), 0.0) * (1.0 - transp)
        li = 0 if ref else i   # lights[0] color quirk (Scene.h:311)
        ci = tuple(light_tab[li, 3 + a] * dcol[a] * lam for a in range(3))
        sh = shadows[i]
        if ref:   # quirk: multiplies everything accumulated (Scene.h:333)
            cl = tuple(sh * (c + x) for c, x in zip(cl, ci))
        else:
            cl = tuple(c + x * sh for c, x in zip(cl, ci))
    acc = tuple(a + torch.where(live, t * (c + k_emit * e), 0.0)
                for a, t, c, e in zip(acc, th, cl, ecol))
    if last:
        for t, x in zip(state["acc"], acc):
            t.copy_(x)
        return (state["acc"], rec) if rec_out else state["acc"]

    # ---- BSDF scatter (Material.cpp:26-60) ------------------------------
    ddn = vp.dot(d, n)
    ior_inv = 1.0 / torch.where(ior > 1e-12, ior, 1.0)
    if ref:   # inverted-eta quirk
        ri = torch.where(ddn > 0.0, ior_inv, ior)
    else:
        ri = torch.where(ddn > 0.0, ior, ior_inv)
    cos_t = torch.clamp_max(-ddn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    if ref:
        cannot = (ri * sin_t - 0.6) > 1.0           # -0.6 fudge quirk
    else:
        cannot = (ri * sin_t) > 1.0
    u_glass = rng.uniform(rng.salted(bkeys, rng.SCATTER_GLASS))
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    mm = torch.clamp_min(1.0 - cos_t, 0.0)
    m2 = mm * mm
    use_reflect = cannot | (r0 + (1.0 - r0) * (m2 * m2 * mm) > u_glass)
    kr = 2.0 * ddn
    refl = tuple(d[a] - kr * n[a] for a in range(3))
    cth = torch.clamp_max(ddn, 1.0)
    pp = tuple(ri * (cth * n[a] + d[a]) for a in range(3))
    par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - vp.dot(pp, pp)),
                                      1e-12))
    glass = vp.where(use_reflect, refl,
                     tuple(par * n[a] + pp[a] for a in range(3)))
    skey = rng.salted(bkeys, rng.SCATTER_DIR)
    ru = (rng.cube_unit_vector_lane_p(skey, 0) if ref
          else rng.sphere_unit_vector_lane_p(skey, 0))
    diff = tuple(n[a] + ru[a] for a in range(3))
    diff = vp.where(torch.sqrt(vp.dot(diff, diff)) <= eps, n, diff)
    dout = vp.normalize(vp.where(mtype == GLASS, glass,
                                 vp.where(mtype == MIRROR, refl, diff)))
    nxt = dict(
        o=vp.where(live, tuple(eps * dout[a] + p[a] for a in range(3)),
                   state["o"]),
        d=vp.where(live, dout, d),
        throughput=vp.where(live, tuple(t * c for t, c in zip(th, dcol)),
                            th),
        acc=acc)
    for key, val in nxt.items():
        for t, x in zip(state[key], val):
            t.copy_(x)
    state["active"].copy_(live)
    return (state, rec) if rec_out else state


_IO_FIELDS = (
    "ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz",
    "ax", "ay", "az", "active", "key", "j", "px", "py", "pz",
    "nx", "ny", "nz", "u", "v", "mid", "row", "sub", "shadows", "mat",
    "light", "quad", "pair", "rec", "tid", "pack", "sky", "mat_pair",
    "tex_data", "nm_data")


class _IO(ctypes.Structure):
    """Mirror of `ShadeIO` in csrc/shade_scatter.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in _IO_FIELDS]


class _Params(ctypes.Structure):
    """Mirror of `ShadeParams` in csrc/shade_scatter.cu (same order)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "M", "Rp", "L", "S", "Q", "ref", "has_pair", "last",
        "rec_out", "n_meshes", "T", "has_sky", "exact_atlas", "sphere_uv",
        "sky_w", "sky_h", "sky_n")] + [
        (name, ctypes.c_float) for name in ("eps", "n_rem", "dark")] + [
        (name, ctypes.c_int) for name in ("salt", "blocks",
                                          "shared_tables")]


def _shade_scatter_cuda(scene, cfg, state, bkeys, k1, n_rem, shadows,
                        use_pair, last, tables, rec_out=False, mesh=None,
                        quad=None, mat_pair=None, sky_wh=None, salt=None):
    from tracer_torch.kernels import _build
    global LAUNCHES, TABLES
    mat_tab, light_tab, dark = tables
    d0 = state["d"][0]
    dev, N = d0.device, d0.shape[0]
    L = scene.light_pos.shape[0]
    f32, i32 = torch.float32, torch.int32
    io = _IO()
    planar = dict(o="o", d="d", th="throughput", a="acc")
    for pre, key in planar.items():
        for ax_, t in zip("xyz", state[key]):
            setattr(io, pre + ax_, kc.check(f"{key}.{ax_}", t, f32, (N,), dev))
    io.active = kc.check("active", state["active"], torch.bool, (N,), dev)
    io.key = kc.check("keys", bkeys, torch.int64, (N,), dev)
    for name in ("j", "mid", "row", "sub"):
        setattr(io, name, kc.check(name, k1[name], i32, (N,), dev))
    for pre, key in (("p", "p"), ("n", "n")):
        for ax_, t in zip("xyz", k1[key]):
            setattr(io, pre + ax_, kc.check(f"{key}.{ax_}", t, f32, (N,), dev))
    for name in ("u", "v"):
        setattr(io, name, kc.check(name, k1[name], f32, (N,), dev))
    if L > 0:
        io.shadows = kc.check("shadows", shadows, f32, (L, N), dev)
    M = mat_tab.shape[0]
    io.mat = kc.check("mat", mat_tab, f32, (M, MAT_COLS), dev)
    io.light = kc.check("light", light_tab, f32, (max(L, 1), 6), dev)
    Q = quad.shape[0]
    io.quad = kc.check("quad", quad, f32, (Q, 47), dev)
    Rp = scene.pair_pack.shape[0]
    io.pair = kc.check("pair_pack", scene.pair_pack, i32,
                       (Rp, 2 * shading.PACK_BLOCK), dev)
    Nm, T = scene.mesh_mat.shape[0], 0
    if Nm > 0:
        pack = mesh[1]
        T = pack.shape[0]
        io.tid = kc.check("tid", k1["tid"], i32, (N,), dev)
        io.pack = kc.check("pack", pack, f32,
                           (T, kintersect.MESH_PACK_COLS), dev)
    has_sky = int(bool(scene.has_sky_image))
    if has_sky:
        io.sky = kc.check("sky_pack", scene.sky_pack, i32,
                          (scene.sky_pack.shape[0], shading.PACK_BLOCK), dev)
    if mat_pair is not None:
        io.mat_pair = kc.check("mat_pair", mat_pair, f32, (M, 2), dev)
    rec = None
    if rec_out:
        rec = torch.empty((8, N), dtype=f32, device=dev)
        io.rec = rec.data_ptr()
    prm = _Params(n=N, M=M, Rp=Rp, L=L, S=scene.sph_center.shape[0], Q=Q,
                  ref=int(cfg.compat == "reference"),
                  has_pair=int(bool(use_pair)), last=int(bool(last)),
                  rec_out=int(bool(rec_out)), n_meshes=Nm, T=T,
                  has_sky=has_sky, sphere_uv=int(mat_pair is not None),
                  sky_w=sky_wh[0] if has_sky else 0,
                  sky_h=sky_wh[1] if has_sky else 0,
                  sky_n=scene.sky_data.shape[0],
                  eps=float(cfg.epsilon),
                  n_rem=float(n_rem), dark=dark,
                  salt=-1 if salt is None else salt)
    if N > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_shade_scatter(
            ctypes.addressof(io), ctypes.addressof(prm), stream)
        kc.raise_on_error("shade_scatter", err)
        LAUNCHES += 1
        TABLES = "shared" if prm.shared_tables else "global"
    res = state["acc"] if last else state
    return (res, rec) if rec_out else res
