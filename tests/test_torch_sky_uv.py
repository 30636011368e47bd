"""The port's image skies, sphere-UV texels and exact atlas against the JAX
package, on the CPU.

- `render/shading.py`: every function against `tracer/render/shading.py`
  on seeded inputs (eager JAX): indices and masks exactly, colours within
  2e-5 (torch's CPU sqrt is not correctly rounded), except the sky's
  texel index, whose atan2 / asin may differ by an ulp between the two
  libraries and flip a texel at its border (counted).
- The first-hit kernel's sphere-UV index (`first_hits_plain` with
  `sphere_tex`) against the JAX package's Pallas kernel in interpret mode
  followed by its XLA splice (`tracer/render/integrator.py:811-850`), on
  `testing.rt_weekend_standin` with a seeded 16x32 sky and sun texture, at
  bounces 0 and 1.
- The shade kernel's image sky (`shade_scatter_plain` with the scene's
  sky) against JAX's Pallas shade kernel fed `skybox_color_p`'s colour, as
  its integrator feeds it.
- Whole renders of `rt_weekend_standin` (the fused route: sky in B2,
  sphere UV in B1, three lights) and of the textured Cornell under
  `packed_atlas="off"` (the general route) against the JAX package's
  jitted render: sums within 2e-5 * spp, except at counted ties (XLA:CPU
  contracts multiply-adds and evaluates cos / sin / atan2 its own way,
  ROADMAP "Lit and mesh scenes carry counted ties").

Inputs are made from numpy seeds; JAX fixtures are module-scoped.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core.config import RenderConfig as JConfig
from tracer.kernels import intersect as jkint
from tracer.kernels import shade as jshade
from tracer.render import camera as jcam
from tracer.render import integrator as jintegrator
from tracer.render import renderer as jrenderer
from tracer.render import shading as jshading
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import intersect as tint
from tracer_torch.kernels import shade as tshade
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.render import shading as tshading
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures, rt_weekend_standin

ATOL = 2e-5
SMALL = dict(sky_hw=(16, 32), tex_hw=(16, 32))


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


@pytest.fixture(scope="module")
def rtw():
    js = jcompile(rt_weekend_standin(jzoo, **SMALL))
    ts = port_scene(js)
    assert (ts.has_sky_image and ts.pair_mode and ts.sphere_uv_needed
            and ts.emissive_tex_image and ts.light_pos.shape[0] == 3)
    return js, ts


@pytest.fixture(scope="module")
def cornell_tex():
    js = jcompile(fill_cornell_textures(jzoo.setup_cornell_box(32 / 18)))
    return js, port_scene(js)


def t2j(x):
    return jnp.asarray(x.numpy())


def j2n(x):
    return np.asarray(x)


def seeded(n, seed=0):
    """Seeded shading inputs: u, v (negative ones too, where C truncation
    and the floor form differ), texture scales, unit directions."""
    rs = np.random.RandomState(seed)
    u = rs.uniform(-1.5, 3.0, n).astype(np.float32)
    v = rs.uniform(-1.5, 3.0, n).astype(np.float32)
    sx = rs.choice([1.0, 3.5, 16.0], n).astype(np.float32)
    sy = rs.choice([1.0, 2.0, 100.0], n).astype(np.float32)
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return u, v, sx, sy, d


def same(a, b, what):
    """Integer and boolean outputs exactly, float ones within 2e-5 (torch's
    CPU sqrt is not correctly rounded, so a normalisation may move an
    ulp)."""
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=0, err_msg=what)
        else:
            np.testing.assert_array_equal(x, y, err_msg=what)


N_FN = 3000


@pytest.mark.parametrize("fn", [
    "texel_xy", "texel_index", "atlas_fetch_rows", "tex_image_fetch",
    "texture_color", "emission_color", "perturb_normal", "magenta_checker",
    "decoders", "skybox_image", "skybox_procedural"])
def test_shading_matches_jax(fn, rtw, cornell_tex):
    u, v, sx, sy, d = seeded(N_FN)
    tu, tv, tsx, tsy = map(torch.from_numpy, (u, v, sx, sy))
    ju, jv, jsx, jsy = map(jnp.asarray, (u, v, sx, sy))
    rs = np.random.RandomState(1)
    W = rs.choice([0, 1, 5, 16, 33], N_FN).astype(np.int32)
    H = rs.choice([0, 1, 7, 16, 20], N_FN).astype(np.int32)
    js, ts = rtw if fn not in ("perturb_normal",) else cornell_tex
    M = ts.mat_diffuse.shape[0]
    mid = rs.randint(0, M, N_FN).astype(np.int32)
    tm, jm = torch.from_numpy(mid), jnp.asarray(mid)
    if fn == "texel_xy":
        same(tshading._texel_xy(torch.from_numpy(W), torch.from_numpy(H), tu,
                                tv, tsx, tsy),
             jshading._texel_xy(jnp.asarray(W), jnp.asarray(H), ju, jv, jsx,
                                jsy), fn)
    elif fn == "texel_index":
        off = rs.randint(0, 50, N_FN).astype(np.int32)
        same(tshading._texel_index(70, torch.from_numpy(off),
                                   torch.from_numpy(W), torch.from_numpy(H),
                                   tu, tv, tsx, tsy),
             jshading._texel_index(70, jnp.asarray(off), jnp.asarray(W),
                                   jnp.asarray(H), ju, jv, jsx, jsy), fn)
    elif fn == "atlas_fetch_rows":
        P = ts.tex_data.shape[0]
        off = rs.randint(0, P, N_FN).astype(np.int32)
        args = (torch.from_numpy(off), torch.from_numpy(W),
                torch.from_numpy(H), tu, tv, tsx, tsy)
        jargs = (jnp.asarray(off), jnp.asarray(W), jnp.asarray(H), ju, jv,
                 jsx, jsy)
        for pack in (False, True):
            got = tshading.atlas_fetch_rows_p(
                ts.tex_data, *args, pack=ts.tex_pack if pack else None)
            want = jshading.atlas_fetch_rows_p(
                js.tex_data, *jargs, pack=js.tex_pack if pack else None)
            same(got[0] + (got[1],), want[0] + (want[1],), f"pack={pack}")
    elif fn in ("tex_image_fetch", "texture_color", "emission_color"):
        uu, vv = np.abs(u) * 0.7, np.abs(v) * 0.7   # texture coords >= 0
        tuu, tvv = torch.from_numpy(uu), torch.from_numpy(vv)
        juu, jvv = jnp.asarray(uu), jnp.asarray(vv)
        if fn == "tex_image_fetch":
            got = tshading.tex_image_fetch_p(ts, tm, tuu, tvv)
            want = jshading.tex_image_fetch_p(js, jm, juu, jvv)
            same(got[0] + (got[1],), want[0] + (want[1],), fn)
        elif fn == "texture_color":
            base = tuple(torch.from_numpy(x) for x in d)
            same(tshading.texture_color_p(ts, tm, tuu, tvv, base),
                 jshading.texture_color_p(js, jm, juu, jvv,
                                          tuple(jnp.asarray(x) for x in d)),
                 fn)
        else:
            same(tshading.emission_color_p(ts, tm, tuu, tvv),
                 jshading.emission_color_p(js, jm, juu, jvv), fn)
    elif fn == "perturb_normal":
        fr = [tuple(torch.from_numpy(x) for x in seeded(N_FN, s)[4])
              for s in (2, 3, 4)]
        uu, vv = np.abs(u) * 0.7, np.abs(v) * 0.7
        got = tshading.perturb_normal_p(ts, tm, torch.from_numpy(uu),
                                        torch.from_numpy(vv), *fr)
        want = jshading.perturb_normal_p(
            js, jm, jnp.asarray(uu), jnp.asarray(vv),
            *[tuple(t2j(c) for c in f) for f in fr])
        same(got, want, fn)
    elif fn == "magenta_checker":
        same(tshading._magenta_checker_p(tu, tv),
             jshading._magenta_checker_p(ju, jv), fn)
    elif fn == "decoders":
        P = ts.tex_data.shape[0]
        it = rs.randint(0, P, N_FN).astype(np.int32)
        inn = rs.randint(0, ts.nm_data.shape[0], N_FN).astype(np.int32)
        same(tshading.packed_fetch(ts.tex_pack, torch.from_numpy(it)),
             jshading._packed_decode(js.tex_pack, jnp.asarray(it)), "packed")
        tt, tn = tshading.packed_fetch2(ts.tex_pack, ts.nm_pack,
                                        torch.from_numpy(it),
                                        torch.from_numpy(inn))
        jt, jn = jshading._packed_decode2(js.tex_pack, js.nm_pack,
                                          jnp.asarray(it), jnp.asarray(inn))
        same(tt + tn, jt + jn, "packed2")
        row = rs.randint(0, ts.pair_pack.shape[0], N_FN).astype(np.int32)
        sub = rs.randint(0, 16, N_FN).astype(np.int32)
        tt, tn = tshading.paired_fetch(ts.pair_pack, torch.from_numpy(row),
                                       torch.from_numpy(sub))
        jt, jn = jshading._paired_decode(js.pair_pack, jnp.asarray(row),
                                         jnp.asarray(sub))
        same(tt + tn, jt + jn, "paired")
        # an exact gather of the [P, 3] atlas gives the same bits
        same(tshading.packed_fetch(ts.tex_pack, torch.from_numpy(it)),
             tuple(ts.tex_data[torch.from_numpy(it).long()].unbind(1)),
             "pack == data")
    elif fn == "skybox_image":
        td = tuple(torch.from_numpy(x) for x in d)
        jd = tuple(jnp.asarray(x) for x in d)
        for ref in (True, False):
            for packed in (True, False):
                got = np.stack(tshading.skybox_color_p(ts, td, 4, ref,
                                                       packed))
                want = np.stack(jshading.skybox_color_p(
                    js, jd, jnp.full((N_FN,), 4, jnp.int32), ref, packed))
                # the texel index may flip at a border (atan2/asin ulps)
                ties = int((np.abs(got - want).max(0) > 0).sum())
                assert ties <= 3, (ref, packed, ties)
        got = tshading.skybox_color_p(ts, td, 4, True, True)
        assert float(np.stack(got).max()) > 1.0   # scaled by n_rem = 4
    else:   # the procedural sky of a scene without an image
        jsc, tsc = cornell_tex
        td = tuple(torch.from_numpy(x) for x in d)
        jd = tuple(jnp.asarray(x) for x in d)
        for ref in (True, False):
            same(tshading.skybox_color_p(tsc, td, 3, ref),
                 jshading.skybox_color_p(jsc, jd,
                                         jnp.full((N_FN,), 3, jnp.int32),
                                         ref), f"ref={ref}")


def rays(ts, bounce, n=1200, seed=0, compat="reference"):
    """Camera rays of rt_weekend_standin, or the state after one bounce
    of the port's plain fused path."""
    rs = np.random.RandomState(seed)
    u = torch.from_numpy(rs.rand(n).astype(np.float32))
    v = torch.from_numpy(rs.rand(n).astype(np.float32))
    o, d = tcam.generate_rays(tcam.default_camera(16 / 9, device="cpu"),
                              u, v)
    tm = torch.from_numpy(rs.rand(n).astype(np.float32))
    state = tintegrator._init_state(o, d, tm)
    if bounce:
        keys = trng.ray_keys(seed, torch.arange(n))
        tables = tintegrator.prepare(ts)
        tintegrator._bounce_core(ts, TConfig(compat=compat), keys, state, 0,
                                 tables=tables)
    return state


def jax_splice(js, k1, with_rec):
    """The JAX package's sphere-UV splice after its first-hit kernel
    (tracer/render/integrator.py:811-850), verbatim."""
    mat_rows = jintegrator._rows(jshade.shade_mat_table(js), k1["mid"])
    n_sq = k1["n"]
    is_sph = (k1["j"] >= 0) & (jnp.maximum(k1["j"], 0)
                               < js.sph_center.shape[0])
    theta = jnp.arccos(jnp.clip(-n_sq[1], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = jnp.arctan2(-n_sq[2], n_sq[0] + 1e-20) + jnp.pi
    u_tex = jnp.where(is_sph, phi / (2.0 * jnp.pi), k1["u"])
    v_tex = jnp.where(is_sph, theta / jnp.pi, k1["v"])
    mri = jintegrator._rows_i(jintegrator._geo_packs(js)[3], k1["mid"])
    sx, sy = mat_rows[:, 18], mat_rows[:, 19]
    xa, ya = jshading._texel_xy(mri[:, 9], mri[:, 10], u_tex, v_tex, sx, sy)
    xb, yb = jshading._texel_xy(mri[:, 11], mri[:, 12], u_tex, v_tex, sx,
                                sy)
    wc = mri[:, 9] + jnp.maximum(mri[:, 11] - 1, 0)
    rel = (ya + yb) * wc + xa + xb
    out = dict(k1, u=u_tex, v=v_tex,
               row=mri[:, 13] + rel // jshading.PACK_BLOCK,
               sub=rel % jshading.PACK_BLOCK,
               ptex=jnp.where(mri[:, 14] > 0, 1.0, 0.0),
               pnm=jnp.where(mri[:, 15] > 0, 1.0, 0.0))
    if with_rec:
        xt, yt = jshading._texel_xy(mri[:, 2], mri[:, 3], u_tex, v_tex, sx,
                                    sy)
        xn, yn = jshading._texel_xy(mri[:, 5], mri[:, 6], u_tex, v_tex, sx,
                                    sy)
        out.update(
            idx_t=jnp.clip(mri[:, 1] + yt * mri[:, 2] + xt, 0,
                           js.tex_data.shape[0] - 1),
            idx_n=jnp.clip(mri[:, 4] + yn * mri[:, 5] + xn, 0,
                           js.nm_data.shape[0] - 1))
    return out


@functools.lru_cache(maxsize=None)
def _jax_first_hits():
    return jax.jit(functools.partial(jkint.first_hits, eps=1e-5, tex_out=0))


@pytest.mark.parametrize("bounce", [0, 1])
def test_first_hits_sphere_uv_matches_jax(bounce, rtw):
    js, ts = rtw
    st = rays(ts, bounce)
    o, d, tm, live = st["o"], st["d"], st["time"], st["active"]
    N0 = tm.shape[0]
    k1 = _jax_first_hits()(js, tuple(map(t2j, o)), tuple(map(t2j, d)),
                           t2j(tm), jnp.full((0, N0), 3.0e38),
                           jnp.full((0, N0), -1, jnp.int32), live=t2j(live))
    want = {k: j2n(v) if not isinstance(v, tuple) else tuple(map(j2n, v))
            for k, v in jax.jit(jax_splice, static_argnums=2)(
                js, k1, True).items()}
    got = tint.first_hits(ts, o, d, tm, live, eps=1e-5, tex_out=2,
                          sphere_tex=tint.sphere_tex_table(ts))
    lv = live.numpy()
    j = got["j"].numpy()
    np.testing.assert_array_equal(j[lv], want["j"][lv])
    is_s = lv & (j >= 0) & (j < ts.sph_center.shape[0])
    is_q = lv & (j >= ts.sph_center.shape[0])
    tex = is_s | is_q
    assert is_s.sum() > 50 and is_q.sum() > 50
    for k in ("u", "v"):   # theta, phi: one ulp of acos / atan2 apart
        np.testing.assert_allclose(got[k].numpy()[tex], want[k][tex],
                                   atol=ATOL, rtol=0, err_msg=k)
    ties = np.zeros(N0, bool)
    for k in ("row", "sub", "idx_t", "idx_n"):
        ties |= tex & (got[k].numpy() != want[k])
    # the texel index flips at a border where u, v moved by an ulp
    assert ties.sum() <= 3, np.nonzero(ties)[0]
    for k in ("ptex", "pnm"):
        np.testing.assert_array_equal(got[k].numpy()[tex], want[k][tex])
    assert (got["ptex"].numpy()[is_s] > 0.5).any()


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_shade_scatter_sky_matches_pallas(compat, rtw):
    js, ts = rtw
    ref = compat == "reference"
    cfg = TConfig(compat=compat)
    st = rays(ts, 1, compat=compat)
    keys = trng.salted(trng.ray_keys(3, torch.arange(tm_n(st))), 1)
    k1 = tint.first_hits(ts, st["o"], st["d"], st["time"], st["active"],
                         tex_out=1, sphere_tex=tint.sphere_tex_table(ts))
    L = ts.light_pos.shape[0]
    rs = np.random.RandomState(4)
    shadows = torch.from_numpy(rs.rand(L, tm_n(st)).astype(np.float32))
    n_rem = 5
    want_in = tintegrator.copy_state(st)
    got, rec = tshade.shade_scatter(
        ts, cfg, tintegrator.copy_state(st), keys, k1, n_rem,
        shadows=shadows, use_pair=True, rec_out=True,
        mat_pair=tshade.mat_pair_table(ts))

    j = t2j
    jstate = dict(o=tuple(map(j, want_in["o"])), d=tuple(map(j, want_in["d"])),
                  time=j(want_in["time"]),
                  throughput=tuple(map(j, want_in["throughput"])),
                  acc=tuple(map(j, want_in["acc"])),
                  active=j(want_in["active"]))
    full = tint.first_hits(ts, st["o"], st["d"], st["time"], st["active"],
                           tex_out=1, sphere_tex=tint.sphere_tex_table(ts))
    jk1 = dict(j=j(full["j"]), p=tuple(map(j, full["p"])),
               n=tuple(map(j, full["n"])), u=j(full["u"]), v=j(full["v"]),
               tan=tuple(map(j, full["tan"])),
               bitan=tuple(map(j, full["bitan"])))
    mid = j(full["mid"])
    mat_rows = jintegrator._rows(jshade.shade_mat_table(js), mid)
    pack = np.asarray(js.pair_pack)
    r, s = full["row"].numpy(), full["sub"].numpy()
    mri = jintegrator._rows_i(jintegrator._geo_packs(js)[3], mid)
    rows = (jnp.asarray(pack[r, s]), jnp.asarray(pack[r, 16 + s]),
            jnp.where(mri[:, 14] > 0, 1.0, 0.0),
            jnp.where(mri[:, 15] > 0, 1.0, 0.0))
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))

    @jax.jit
    def run(js, jstate, jkeys, jk1, mat_rows, rows, jsh):
        sky = jshading.skybox_color_p(
            js, jstate["d"], jnp.full(jstate["d"][0].shape, n_rem,
                                      jnp.int32), ref, packed=True)
        return jshade.shade_scatter(js, cfg_j, jstate, jkeys, jk1, mat_rows,
                                    jnp.asarray(n_rem), sky=sky, shadows=jsh,
                                    rows=rows, rec_out=True)

    cfg_j = JConfig(compat=compat)
    want, wrec = run(js, jstate, jkeys, jk1, mat_rows, rows,
                     [j(x) for x in shadows])
    act = st["active"].numpy()
    miss = act & (full["j"].numpy() < 0)
    assert miss.sum() > 50
    ties = np.zeros(act.shape, bool)
    for key in ("o", "d", "throughput", "acc"):
        for a in range(3):
            e = np.abs(got[key][a].numpy() - np.asarray(want[key][a]))
            ties |= e > ATOL
    # a sky texel one ulp of atan2 / asin across a border (counted)
    assert ties.sum() <= 3, np.nonzero(ties)[0]
    np.testing.assert_array_equal(got["active"].numpy(),
                                  np.asarray(want["active"]))
    live = act & (full["j"].numpy() >= 0)
    wrec = np.stack([np.asarray(c) for c in wrec[0] + wrec[1]])
    np.testing.assert_allclose(rec.numpy()[:6, live], wrec[:, live],
                               atol=ATOL, rtol=0)
    assert float(got["acc"][0].numpy()[miss].max()) > 0.0


def tm_n(st):
    return st["time"].shape[0]


W, H = 32, 18
# per compat mode: how many of the 1,728 1-spp sums may differ from the
# jitted JAX render by more than 2e-5 * spp: paths that split where XLA:CPU
# contracts a multiply-add or evaluates a transcendental its own way
# (measured: 30 values in 10 pixels, and 20 in 7; the port matches the
# same JAX render run op by op, jax.disable_jit, to 5e-6 everywhere); the
# means within 1e-3
TIES = {"reference": 36, "physical": 26}


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_rt_weekend_render_matches_jax(compat, rtw):
    js, ts = rtw
    pid = np.arange(W * H, dtype=np.int32)
    spp = 1
    got = trenderer.render_pixels(
        ts, tcam.default_camera(W / H, device="cpu"), TConfig(compat=compat),
        W, H, torch.from_numpy(pid), spp, 0).numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    want = np.asarray(jrenderer.render_pixels(
        js, jcam.default_camera(W / H), JConfig(compat=compat, kernels="off"),
        W, H, jnp.asarray(pid), spp, jax.random.key(0)))
    bad = np.abs(got - want) > ATOL * spp
    assert bad.sum() <= TIES[compat], bad.sum()
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=1e-3)
    assert got.max() > 0.0


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_exact_atlas_render_matches_jax(compat, cornell_tex):
    """The general route (`packed_atlas="off"`) on the textured Cornell:
    the exact [P, 3] atlas, in torch ops after B1."""
    js, ts = cornell_tex
    pid = np.arange(W * H, dtype=np.int32)
    spp = 2
    cfg = TConfig(compat=compat, packed_atlas="off")
    assert not tintegrator._fused(ts, cfg)
    got = trenderer.render_pixels(
        ts, tcam.default_camera(W / H, device="cpu"), cfg, W, H,
        torch.from_numpy(pid), spp, 0).numpy()
    want = np.asarray(jrenderer.render_pixels(
        js, jcam.default_camera(W / H),
        JConfig(compat=compat, kernels="off", packed_atlas="off"), W, H,
        jnp.asarray(pid), spp, jax.random.key(0)))
    np.testing.assert_allclose(got, want, atol=ATOL * spp, rtol=0)
    # the fused route gives the same sums on this u8 atlas
    fused = trenderer.render_pixels(
        ts, tcam.default_camera(W / H, device="cpu"), TConfig(compat=compat),
        W, H, torch.from_numpy(pid), spp, 0).numpy()
    np.testing.assert_allclose(got, fused, atol=ATOL * spp, rtol=0)
