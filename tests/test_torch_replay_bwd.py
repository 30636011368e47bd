"""The port's hand-written backward against the JAX package's, on the CPU.

- One bounce: the port's plain bounce adjoint (`kernels/shade_bwd.py`, the
  plain version of the CUDA kernel; `render/replay_bwd.py::bounce_bwd`)
  against JAX's `replay_bwd.bounce_bwd` run eagerly (no XLA fusion) and
  against its Pallas kernel `shade_bwd.bounce_bwd_tiles` in interpret mode,
  for {reference, physical} x {last, not last} x {pair atlas, no atlas}.
  The inputs are one bounce of the port's record forward on ~2K rays of the
  Cornell-like scene of tests/test_replay_bwd.py, made from a numpy seed,
  with seeded cotangents; the JAX side gets the same per-lane rows. The
  lane outputs (a, b) are held to 2e-5 * max(1, |x|) against the eager
  jnp (the same expressions in the same order; cos/sin may differ by an
  ulp) and 1e-3 * max(1, |x|) against the jitted kernel: XLA:CPU
  contracts its multiply-adds, and at an ill-conditioned refraction lane
  that moves a cotangent by 2.4e-4 of its size (measured; the eager jnp
  agrees with the port there). The running tables, from a seeded nonzero
  accumulator, are held against JAX's `_onehot_accum` of each side's row
  cotangents to 1e-5 of their largest entry (eager; f32 summation order)
  and 1e-3 of it (the jitted kernel, whose contracted lane moves a sphere
  entry by ~1.6e-4 of the largest).
- The whole VJP of `integrator.trace` through `torch.autograd` against
  `jax.vjp` of JAX's `trace`, leaf by leaf (the 20 scene fields, o, d and
  time), on that scene (64 rays, 4 bounces), with the tolerance of
  tests/test_replay_bwd.py.
- The scene-class gate agrees with JAX's on the zoo; what it rejects
  takes the general backward (`jax.vjp` leaf by leaf), and the plain
  autodiff backward (custom_vjp="off") gives the sweep's gradient.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.kernels import shade_bwd as jsb
from tracer.render import integrator as jintegrator
from tracer.render import replay_bwd as jrb
from tracer.scene.builder import Material, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import shade_bwd as tsb
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import replay_bwd as trb
from tracer_torch.scene import device as tdevice

GLASS, MIRROR = 1, 2
TEX_CHECKERBOARD, TEX_IMAGE = 1, 2
N_LANES = 2048


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def phase1_builder():
    """The scene of tests/test_replay_bwd.py: textured + normal-mapped,
    checkered and emissive quads, glass, mirror and motion-blurred
    spheres, no lights."""
    sb = SceneBuilder()
    rs = np.random.RandomState(3)
    ti = sb.add_texture((rs.rand(8, 8, 3) * 255).astype(np.uint8))
    ni = sb.add_normal_map((rs.rand(8, 8, 3) * 255).astype(np.uint8))
    m_tex = Material(diffuse=(0.9, 0.8, 0.7))
    m_tex.texture_type = TEX_IMAGE
    m_tex.texture_id = ti
    m_tex.normal_map_id = ni
    sb.add_square((-2., -1., -4.), (1., 0., 0.), (0., 1., 0.), 4., 2.,
                  m_tex)
    m_chk = Material(diffuse=(0.4, 0.5, 0.6))
    m_chk.texture_type = TEX_CHECKERBOARD
    m_chk.checkerboard_color1 = (0.9, 0.2, 0.1)
    m_chk.checkerboard_color2 = (0.1, 0.2, 0.9)
    m_chk.texture_scale_x = 3.0
    m_chk.texture_scale_y = 2.0
    sb.add_square((-2., -1.2, 0.), (1., 0., 0.), (0., 0., -1.), 4., 4.,
                  m_chk)
    m_em = Material(diffuse=(0.2, 0.2, 0.2))
    m_em.emissive = True
    m_em.light_color = (0.9, 0.7, 0.5)
    m_em.light_intensity = 2.5
    sb.add_square((-1., 1.4, -2.), (1., 0., 0.), (0., 0., 1.), 2., 2.,
                  m_em)
    sb.add_sphere((0.5, -0.2, -2.0), 0.5, Material(
        mtype=GLASS, diffuse=(0.9, 0.9, 0.9), index_medium=1.5))
    sb.add_sphere((-0.8, 0.0, -2.5), 0.45, Material(
        mtype=MIRROR, diffuse=(0.8, 0.8, 0.8)))
    m_mb = Material(diffuse=(0.6, 0.3, 0.2))
    m_mb.motion_blur_translation = (0.0, 0.3, 0.0)
    sb.add_sphere((1.2, 0.6, -3.0), 0.4, m_mb)
    return sb


@pytest.fixture(scope="module")
def phase1():
    js = jcompile(phase1_builder())
    return js, port_scene(js)


@pytest.fixture(scope="module")
def phase1_sky():
    """The same scene under the procedural sky: the sky's gradient in the
    ray direction carries cotangents to the geometry (under the black sky
    every emitter is flat and the geometry's cotangents vanish)."""
    sb = phase1_builder()
    sb.dark_sky = False
    js = jcompile(sb)
    return js, port_scene(js)


def rays(n, seed):
    """Camera rays through the middle of the frame (numpy seed), planar."""
    rs = np.random.RandomState(seed)
    u = torch.from_numpy(rs.uniform(0.2, 0.8, n).astype(np.float32))
    v = torch.from_numpy(rs.uniform(0.2, 0.8, n).astype(np.float32))
    o, d = tcam.generate_rays(tcam.default_camera(1.0, device="cpu"), u, v)
    tm = torch.from_numpy(rs.rand(n).astype(np.float32))
    return o, d, tm


def test_bwd_tables_match_jax(phase1):
    js, ts = phase1
    sph, quad, matf, mati = jintegrator._geo_packs(js)
    tsph, tquad, tmat = tsb.bwd_tables(ts)
    np.testing.assert_array_equal(tsph.numpy(), np.asarray(sph))
    np.testing.assert_array_equal(tquad.numpy(), np.asarray(quad))
    np.testing.assert_array_equal(tmat[:, :18].numpy(), np.asarray(matf))
    np.testing.assert_array_equal(tmat[:, 18:].numpy(),
                                  np.asarray(mati)[:, [0, 7, 8]])


@pytest.mark.parametrize("has_pair", [True, False])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_bounce_bwd_matches_jax(phase1, compat, last, has_pair):
    js, ts = phase1
    B = 4
    b = B - 1 if last else 1
    ref = compat == "reference"
    cfg = TConfig(compat=compat, max_bounces=B)
    o, d, tm = rays(N_LANES, seed=5)
    keys = trng.ray_keys(9, torch.arange(N_LANES))
    _, recs, states = tintegrator._trace_loop(
        ts, cfg, o, d, tm, keys, tintegrator.prepare(ts), with_rec=True)
    st10, (reci, recf, _) = states[b], recs[b]
    if not has_pair:   # what the record holds for a scene without atlas
        recf = torch.zeros_like(recf)
    rs = np.random.RandomState(7)
    gnext = torch.from_numpy(rs.normal(size=(10, N_LANES)).astype(np.float32))
    gpix = torch.from_numpy(
        (0.1 * rs.normal(size=(3, N_LANES))).astype(np.float32))
    bk = trng.salted(keys, b)
    S, Q = ts.sph_center.shape[0], ts.quad_v0.shape[0]
    tables = tsb.bwd_tables(ts)
    M = tables[2].shape[0]
    acc0 = torch.from_numpy(rs.normal(
        size=tsb.table_size(S, Q, M)).astype(np.float32))
    n_rem, dark = float(B - b), float(ts.dark_sky)
    kw = dict(S=S, Q=Q, ref=ref, eps=cfg.epsilon, has_pair=has_pair,
              last=last)
    got_a, got_b, got_acc = tsb.bounce_bwd_tiles(
        st10, reci[0], recf if has_pair else None, tables, bk, tm,
        None if last else gnext, gpix, acc0, n_rem, dark, **kw)
    assert bool((st10[9] > 0.5).any()) and bool((st10[9] < 0.5).any())

    # the JAX side: the same per-lane rows, as its sweep fetches them, and
    # the next-state cotangents and gpix stacked as its gcar
    js_, jq_, mid = tsb.row_ids(reci[0], tables[0], tables[1])
    srow = tables[0][js_].t().numpy()
    qrow = tables[1][jq_].t().numpy()
    mr21 = tables[2][mid].t().numpy()
    j = jnp.asarray
    bk32 = j(trng.as_int32_bits(bk).numpy())
    gn = np.zeros((10, N_LANES), np.float32) if last else gnext.numpy()
    gc = np.concatenate([gn[:9], gpix.numpy()])
    st, rf = st10.numpy(), recf.numpy()

    def p3(x, r):
        return tuple(j(x[r + a]) for a in range(3))

    out = jrb.bounce_bwd(
        p3(st, 0), p3(st, 3), p3(st, 6), j(st[9] > 0.5), j(tm.numpy()),
        bk32, j(reci[0].numpy()), p3(rf, 0), p3(rf, 3), j(rf[6]), j(rf[7]),
        [j(mr21[c]) for c in range(18)], j(mr21[18].astype(np.int32)),
        j(mr21[19].astype(np.int32)), j(mr21[20].astype(np.int32)),
        [j(srow[c]) for c in range(8)], [j(qrow[c]) for c in range(19)],
        p3(gc, 0), p3(gc, 3), p3(gc, 6), p3(gc, 9),
        n_rem=jnp.float32(n_rem), dark=js.dark_sky, **kw)
    go, gd, gtp, gtm, gimg, grnm, gmrf, gsr, gqr, gdark = out
    eager = [np.stack([np.asarray(x) for x in (*go, *gd, *gtp, gtm, gdark)]),
             np.stack([np.asarray(x) for x in (*gimg, *grnm)]),
             np.stack([np.asarray(x) for x in (*gmrf, *gsr, *gqr)])]
    tiles = jsb.bounce_bwd_tiles(
        j(st), j(reci[0].numpy()), j(rf), j(mr21), j(srow), j(qrow), bk32,
        j(tm.numpy()), j(gc), jnp.float32(n_rem), js.dark_sky,
        interpret=True, **kw)
    o1, o2 = 18 * M, 18 * M + 8 * S
    a0 = acc0.numpy()
    idx = [j(x.numpy().astype(np.int32)) for x in (mid, js_, jq_)]
    for name, (wa, wb, wc), tol, ttol in (
            ("eager jnp", eager, 2e-5, 1e-5),
            ("pallas interpret", tiles, 1e-3, 1e-3)):
        wa, wb, wc = np.asarray(wa), np.asarray(wb), np.asarray(wc)
        # a: go, gd, gtp, and gtm added to the running one
        want_a = wa[:10].copy()
        if not last:
            want_a[9] = gn[9] + want_a[9]
        blocks = [("a", got_a, want_a)]
        if has_pair:
            blocks.append(("b", got_b, wb))
        else:   # without the atlas the texel cotangents are all zero
            assert got_b is None and not wb.any()
        for blk, g, w in blocks:
            g = g.numpy()
            assert np.isfinite(g).all(), blk
            bad = np.abs(g - w) > tol * np.maximum(1.0, np.abs(w))
            assert not bad.any(), (
                f"{name} block {blk}: {bad.sum()} entries off, rows "
                f"{sorted(set(np.nonzero(bad)[0].tolist()))}, max "
                f"{np.abs(g - w).max():.3g}")
        # the tables: JAX's one-hot accumulation of c onto the same
        # running tables, and gdark's sum
        want_acc = np.concatenate([
            np.asarray(jrb._onehot_accum(j(a0[:o1].reshape(18, M)), idx[0],
                                         j(wc[0:18]))).reshape(-1),
            np.asarray(jrb._onehot_accum(j(a0[o1:o2].reshape(8, S)),
                                         idx[1], j(wc[18:26]))).reshape(-1),
            np.asarray(jrb._onehot_accum(j(a0[o2:-1].reshape(19, Q)),
                                         idx[2], j(wc[26:45]))).reshape(-1),
            a0[-1:] + np.asarray(jnp.sum(j(wa[10])))[None]])
        g = got_acc.numpy()
        assert np.isfinite(g).all()
        lim = ttol * np.abs(want_acc).max()
        err = np.abs(g - want_acc)
        assert err.max() <= lim, (
            f"{name} tables: max err {err.max():.3g} > {lim:.3g} at "
            f"{np.nonzero(err > lim)[0].tolist()}")
        assert not np.array_equal(g, a0)   # the bounce adds to them


@pytest.mark.parametrize("compat,sky", [("reference", False),
                                        ("physical", True)])
def test_trace_vjp_matches_jax(request, compat, sky):
    js, ts = request.getfixturevalue("phase1_sky" if sky else "phase1")
    n, B = 64, 4
    o, d, tm = rays(n, seed=0)
    rs = np.random.RandomState(5)
    g = rs.normal(size=(n, 3)).astype(np.float32)

    jcfg = JConfig(max_bounces=B, compat=compat, kernels="off")
    jkeys = jrng.ray_keys(jax.random.key(11), jnp.arange(n, dtype=jnp.int32))
    jo = jnp.asarray(np.stack([c.numpy() for c in o], -1))
    jd = jnp.asarray(np.stack([c.numpy() for c in d], -1))

    def f(scene, o_, d_, t_):
        return jintegrator.trace(scene, jcfg, o_, d_, t_, jkeys)

    jout, vjp = jax.vjp(f, js, jo, jd, jnp.asarray(tm.numpy()))
    gs_j, go_j, gd_j, gt_j = vjp(jnp.asarray(g))

    leaves = {k: getattr(ts, k).clone().requires_grad_(True)
              for k in trb.GRAD_FIELDS}
    s2 = dataclasses.replace(ts, **leaves)
    to = tuple(c.clone().requires_grad_(True) for c in o)
    td = tuple(c.clone().requires_grad_(True) for c in d)
    tt = tm.clone().requires_grad_(True)
    out = tintegrator.trace(s2, TConfig(max_bounces=B, compat=compat), to,
                            td, tt, trng.ray_keys(11, torch.arange(n)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    out.backward(torch.from_numpy(g))

    def close(name, want, got):
        want = np.asarray(want, np.float64)
        got = np.asarray(got, np.float64).reshape(want.shape)
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=f"cotangent mismatch: {name}")

    close("o", go_j, np.stack([c.grad.numpy() for c in to], -1))
    close("d", gd_j, np.stack([c.grad.numpy() for c in td], -1))
    close("time", gt_j, tt.grad.numpy())
    for name in trb.GRAD_FIELDS:
        close(name, getattr(gs_j, name), leaves[name].grad.numpy())
    # the chain reaches the materials and, under the sky, both atlases
    # and the geometry
    reached = ["mat_diffuse", "mat_light_intensity"]
    if sky:
        reached += ["tex_data", "nm_data", "sph_center", "sph_radius",
                    "quad_v0", "dark_sky"]
    for name in reached:
        assert np.abs(leaves[name].grad.numpy()).max() > 0.0, name


@pytest.mark.parametrize("name", sorted(jzoo.BY_NAME))
def test_gate_matches_jax_on_the_zoo(name):
    js = jcompile(jzoo.BY_NAME[name]())
    cfg = TConfig()
    assert trb.hand_bwd_ok(port_scene(js), cfg) == jrb.hand_bwd_ok(
        js, JConfig())


def test_outside_the_gate_raises(phase1_sky):
    """An emissive TEX_IMAGE material puts the scene outside the
    hand-written backward's class: its gradient (the general backward,
    which also folds the last bounce's texels) matches `jax.vjp` leaf by
    leaf. custom_vjp='off' (the plain autodiff backward, which raised
    before it was ported; the name is kept from then) gives the
    hand-written sweep's gradient on the phase-1 scene under the sky,
    within the tolerance this file holds that sweep to."""
    sb = phase1_builder()
    m = sb.squares[0].material
    m.emissive = True
    m.light_intensity = 1.0
    sb.dark_sky = False
    js = jcompile(sb)
    ts = port_scene(js)
    assert ts.emissive_tex_image and not trb.hand_bwd_ok(ts, TConfig())
    n, B = 32, 3
    o, d, tm = rays(n, seed=1)
    keys = trng.ray_keys(0, torch.arange(n))
    g = np.random.RandomState(2).normal(size=(n, 3)).astype(np.float32)
    fields = ("mat_diffuse", "tex_data", "nm_data", "quad_v0")
    jcfg = JConfig(max_bounces=B, kernels="off")
    jkeys = jrng.ray_keys(jax.random.key(0), jnp.arange(n, dtype=jnp.int32))
    jo = jnp.asarray(np.stack([c.numpy() for c in o], -1))
    jd = jnp.asarray(np.stack([c.numpy() for c in d], -1))

    def f(*params):
        s2 = dataclasses.replace(js, **dict(zip(fields, params)))
        return jintegrator.trace(s2, jcfg, jo, jd, jnp.asarray(tm.numpy()),
                                 jkeys)

    with jax.disable_jit():
        _, vjp = jax.vjp(f, *(getattr(js, k) for k in fields))
        want = vjp(jnp.asarray(g))
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    out = tintegrator.trace(dataclasses.replace(ts, **leaves),
                            TConfig(max_bounces=B), o, d, tm, keys)
    out.backward(torch.from_numpy(g))
    for k, w in zip(fields, want):
        w = np.asarray(w)
        got = leaves[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert np.abs(leaves["tex_data"].grad.numpy()).max() > 0.0
    _, ts1 = phase1_sky
    assert trb.hand_bwd_ok(ts1, TConfig())
    grads = []
    for cv in ("on", "off"):
        leaves = {k: getattr(ts1, k).clone().requires_grad_(True)
                  for k in fields}
        d_g = tuple(c.clone().requires_grad_(True) for c in d)
        out = tintegrator.trace(dataclasses.replace(ts1, **leaves),
                                TConfig(custom_vjp=cv), o, d_g, tm, keys)
        out.backward(torch.from_numpy(g))
        grads.append({**{k: v.grad.numpy() for k, v in leaves.items()},
                      "d": np.stack([c.grad.numpy() for c in d_g])})
    # the tolerance this file holds the hand-written sweep to
    for k, want in grads[0].items():
        assert np.abs(want).max() > 0.0, k
        np.testing.assert_allclose(
            grads[1][k], want, rtol=2e-4,
            atol=2e-4 * max(np.abs(want).max(), 1.0), err_msg=k)
