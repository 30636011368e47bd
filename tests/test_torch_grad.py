"""The port's gradient against the JAX package's, on the CPU.

- The flagship protocol loss of `bench.py` (mean radiance of a
  `render_pixels` sum over spp) at 12x8 px, 2 spp, 6 bounces, on Cornell and
  on a Cornell with seeded textures and normal maps, under both compat
  modes: the port's `loss.backward()` gradients of mat_diffuse, sph_center
  and tex_data against `jax.grad` of the same loss (JAX `kernels="off"`,
  its jnp hand-written sweep). Tolerance rtol 1e-4, atol 1e-4 * max|g|:
  the per-table and per-texel sums are taken in another order than XLA's
  dot and scatter (f32 summation order).
- The record forward (`integrator._trace_loop(with_rec=True)`) against
  JAX's `_trace_record(with_states=True)` with its Pallas kernels in
  interpret mode (the fused record the port mirrors): discrete rows equal
  on active lanes, texel rows within 2e-5, states within 2e-5 but for the
  few lanes that carry a grazing hit's difference
  (test_record_matches_jax).
- A central-difference check (`tracer_torch/diff/fd.py`) of one
  mat_diffuse row and one sph_center coordinate on the unlit phase-1 scene.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import integrator as jintegrator
from tracer.render import renderer as jrenderer
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.diff.fd import compare_ad_fd
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene import builder as tbuilder
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures

W, H, SPP = 12, 8, 2
ATOL_CARRIED = 5e-4
TRAINABLE = ("mat_diffuse", "sph_center", "tex_data")


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def scenes(textured):
    sb = jzoo.setup_cornell_box(W / H)
    if textured:
        sb = fill_cornell_textures(sb)
    js = jcompile(sb)
    return js, port_scene(js)


def jax_grads(js, compat):
    cfg = JConfig(compat=compat, kernels="off")
    pid = jnp.arange(W * H, dtype=jnp.int32)

    def loss(*params):
        # render_pixels' sum over samples, unrolled and run eagerly: the
        # jitted frame (a scan over samples around the custom VJP) takes
        # minutes to compile on the CPU
        s2 = dataclasses.replace(js, **dict(zip(TRAINABLE, params)))
        acc = sum(jrenderer._render_batch(
            s2, jcam.default_camera(W / H), cfg, W, H, pid, jnp.int32(s),
            jax.random.key(0)) for s in range(SPP))
        return jnp.mean(acc / SPP)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        *(getattr(js, k) for k in TRAINABLE))
    return [np.asarray(x) for x in g]


def port_grads(ts, compat):
    params = {k: getattr(ts, k).clone().requires_grad_(True)
              for k in TRAINABLE}
    s2 = dataclasses.replace(ts, **params)
    pid = torch.arange(W * H, dtype=torch.int32)
    loss = trenderer.render_pixels(
        s2, tcam.default_camera(W / H, device="cpu"), TConfig(compat=compat),
        W, H, pid, SPP, 0).div(SPP).mean()
    loss.backward()
    return [params[k].grad.numpy() for k in TRAINABLE]


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("textured", [False, True])
def test_protocol_gradients_match_jax(textured, compat):
    js, ts = scenes(textured)
    want = jax_grads(js, compat)
    got = port_grads(ts, compat)
    for name, w, g in zip(TRAINABLE, want, got):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    # the flat box's walls read mat_diffuse; the textured box's read the
    # atlas, whose gradient comes from the texel fold
    assert np.abs(got[2 if textured else 0]).max() > 0.0


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_record_matches_jax(compat):
    js, ts = scenes(True)
    n, B = 256, 6
    rs = np.random.RandomState(1)
    u = rs.rand(n).astype(np.float32)
    v = rs.rand(n).astype(np.float32)
    tm = rs.rand(n).astype(np.float32)
    o, d = jcam.generate_rays(jcam.default_camera(W / H), jnp.asarray(u),
                              jnp.asarray(v))
    o, d = np.asarray(o), np.asarray(d)
    jkeys = jrng.ray_keys(jax.random.key(4), jnp.arange(n, dtype=jnp.int32))
    cfg = JConfig(compat=compat, kernels="on", max_bounces=B)
    _, (rec_scan, rec_last), (st_scan, st_last) = jax.jit(
        jintegrator._trace_record, static_argnums=(1,),
        static_argnames=("with_states",))(
        js, cfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jkeys,
        with_states=True)
    tkeys = trng.ray_keys(4, torch.arange(n))
    t = torch.from_numpy
    _, recs, states = tintegrator._trace_loop(
        ts, TConfig(compat=compat, max_bounces=B),
        tuple(t(np.ascontiguousarray(o[:, a])) for a in range(3)),
        tuple(t(np.ascontiguousarray(d[:, a])) for a in range(3)), t(tm),
        tkeys, tintegrator.prepare(ts), with_rec=True)
    fetched = 0
    for b in range(B):
        if b < B - 1:
            jreci, jrecf, jst = (np.asarray(rec_scan[0][b]),
                                 np.asarray(rec_scan[1][b]),
                                 np.asarray(st_scan[b]))
        else:
            jreci, jrecf = np.asarray(rec_last[0]), np.asarray(rec_last[1])
            jst = np.stack([np.asarray(x) for x in st_last])
        reci, recf = recs[b][0].numpy(), recs[b][1].numpy()
        st = states[b].numpy()
        np.testing.assert_array_equal(st[9], jst[9], err_msg=f"active b{b}")
        act = st[9] > 0.5
        for r, name in ((0, "j"), (2, "idx_t"), (3, "idx_n")):
            np.testing.assert_array_equal(reci[r][act], jreci[r][act],
                                          err_msg=f"{name} b{b}")
        np.testing.assert_allclose(recf[:, act], jrecf[:, act], atol=2e-5,
                                   rtol=0, err_msg=f"recf b{b}")
        # states within 2e-5, except on the few lanes whose path went
        # through a grazing sphere hit: XLA:CPU contracts multiply-adds
        # (tests/test_torch_intersect.py) and the ~3e-5 it moves such a
        # hit is carried on, with one more ulp per bounce of cos/sin
        # under compat=physical
        err = np.abs(st - jst).max(axis=0)
        assert (err > 2e-5).sum() <= 0.03 * n, f"state b{b}"
        np.testing.assert_allclose(st, jst, atol=ATOL_CARRIED, rtol=0,
                                   err_msg=f"state b{b}")
        fetched += int((recf[6][act] > 0.5).sum())
    assert fetched > 0


def unlit_scene():
    """A phase-1 scene (no lights, no meshes): a diffuse sphere on a
    diffuse floor under the procedural sky."""
    sb = tbuilder.SceneBuilder()
    sb.dark_sky = False
    sb.add_sphere((0., 0., 0.), 1.0,
                  tbuilder.Material(diffuse=(0.8, 0.3, 0.2)))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      tbuilder.Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return tdevice.compile_scene(sb, device="cpu")


@pytest.mark.parametrize("field,row", [("mat_diffuse", 0),
                                       ("sph_center", 0)])
def test_gradient_matches_central_differences(field, row):
    """Rays through the sphere's interior, away from its silhouette, so
    a small probe flips no hit decision."""
    scene = unlit_scene()
    n = 6
    u = torch.linspace(0.47, 0.53, n)
    v = torch.full((n,), 0.5)
    o, d = tcam.generate_rays(tcam.default_camera(1.0, device="cpu"), u, v)
    keys = trng.ray_keys(0, torch.arange(n))
    cfg = TConfig(max_bounces=2, compat="physical")
    base = getattr(scene, field)

    def loss(p):
        val = base.clone()
        val[row] = p
        s2 = dataclasses.replace(scene, **{field: val})
        return tintegrator.trace(s2, cfg, o, d, torch.zeros(n), keys).sum()

    p0 = base[row].numpy()
    g_ad, g_fd, err, ok = compare_ad_fd(loss, p0, eps=1e-3, atol=2e-3,
                                        rtol=2e-2)
    assert ok, (g_ad, g_fd, err)
    assert np.abs(g_ad).max() > 1e-3


def test_default_device_is_the_card():
    """The entry points put scenes and cameras on the card unless the
    caller asks for the CPU (inspected, nothing is run on a card)."""
    import inspect
    for fn in (tdevice.compile_scene, tdevice.device_scene_from_numpy,
               tcam.default_camera):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
