"""The port's general backward (the vjp of the replay, outside the
hand-written class) against `jax.vjp` of the JAX package's `trace`
(custom VJP on), leaf by leaf, on the CPU.

Scenes, each at 64 camera rays and 3 bounces (one compat mode each, to
keep the JAX side's op-by-op runs short):
- a lit sphere+quad scene (two lights, a glass sphere, procedural sky),
  compat="physical";
- a 200-triangle stand-in mesh with a light, `mesh_verts` trainable
  (the vertex cotangents come from the mesh detail re-derived from the
  recorded triangle), compat="reference";
- the small `testing.rt_weekend_standin` (image sky, a TEX_IMAGE emissive
  sphere, three lights) with `tex_data` trainable: the last bounce's
  texels are folded too; compat="reference" (the sky's n_rem scale).

The JAX side runs op by op (`jax.disable_jit`): its jitted scan contracts
multiply-adds and evaluates cos / sin / atan2 its own way, which splits a
few of these paths at ties (tests/test_torch_sky_uv.py counts them on the
forward); op by op it takes the port's paths. Tolerance: rtol 1e-4 and
atol 1e-4 * max|g| per leaf (f32 summation order); every cotangent finite.
One vertex is also held against central differences (`diff/fd.py`).
Every zoo scene, with seeded skies and textures where its builder loads
them, renders and differentiates through `render_pixels` (finite
radiance and gradients).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.render import integrator as jintegrator
from tracer.scene.builder import Material, MeshObject, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.diff.fd import compare_ad_fd
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.render import replay_bwd as trb
from tracer_torch.scene import device as tdevice
from tracer_torch.scenes import zoo as tzoo
from tracer_torch.testing import fill_assets, rt_weekend_standin, standin_mesh

N, B = 64, 3


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def lit_builder():
    """Two lights, a diffuse and a glass sphere, a floor, procedural sky."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((-2., 4., 3.), radius=1.0, color=(1.0, 0.8, 0.6))
    sb.add_light((3., 2., 1.), radius=0.5, color=(0.3, 0.5, 1.0))
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    sb.add_sphere((1.5, 0.4, -1.0), 0.5,
                  Material(diffuse=(0.2, 0.2, 0.9), transparency=0.5,
                           mtype=1, index_medium=1.5))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return sb


def mesh_builder():
    """A 200-triangle seeded stand-in facing the camera, one light, a
    floor: most camera rays hit the mesh."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((1., 4., 4.), radius=1.0, color=(1.0, 1.0, 1.0))
    verts, tris, colors = standin_mesh(200, seed=2)
    m = MeshObject(verts, tris, vert_colors=colors,
                   material=Material(diffuse=(0.5, 0.5, 0.5)))
    m.scale((2.6,) * 3).rotate_y(90).translate((0., 0., 1.))
    sb.add_mesh(m)
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return sb


BUILDERS = {
    "lit": lit_builder,
    "mesh": mesh_builder,
    "rt_weekend": lambda: rt_weekend_standin(jzoo, sky_hw=(16, 32),
                                             tex_hw=(16, 32)),
}
COMPAT = {"lit": "physical", "mesh": "reference", "rt_weekend": "reference"}
# the leaves each scene must reach (nonzero cotangents)
REACHED = {
    "lit": ("sph_center", "sph_radius", "mat_diffuse", "quad_v0", "o", "d"),
    "mesh": ("mesh_verts", "mat_diffuse", "quad_v0", "d"),
    "rt_weekend": ("tex_data", "sph_center", "mat_light_intensity",
                   "mat_check1", "d"),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, build in BUILDERS.items():
        js = jcompile(build())
        ts = port_scene(js)
        assert not trb.hand_bwd_ok(ts, TConfig())
        out[name] = (js, ts)
    return out


def rays(seed=0):
    rs = np.random.RandomState(seed)
    u = torch.from_numpy(rs.uniform(0.3, 0.7, N).astype(np.float32))
    v = torch.from_numpy(rs.uniform(0.3, 0.7, N).astype(np.float32))
    o, d = tcam.generate_rays(tcam.default_camera(1.0, device="cpu"), u, v)
    tm = torch.from_numpy(rs.rand(N).astype(np.float32))
    return o, d, tm


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_general_vjp_matches_jax(name, scenes):
    js, ts = scenes[name]
    compat = COMPAT[name]
    o, d, tm = rays()
    rs = np.random.RandomState(5)
    g = rs.normal(size=(N, 3)).astype(np.float32)

    jcfg = JConfig(max_bounces=B, compat=compat, kernels="off")
    jkeys = jrng.ray_keys(jax.random.key(11), jnp.arange(N, dtype=jnp.int32))
    jo = jnp.asarray(np.stack([c.numpy() for c in o], -1))
    jd = jnp.asarray(np.stack([c.numpy() for c in d], -1))

    def f(scene, o_, d_, t_):
        return jintegrator.trace(scene, jcfg, o_, d_, t_, jkeys)

    with jax.disable_jit():
        jout, vjp = jax.vjp(f, js, jo, jd, jnp.asarray(tm.numpy()))
        gs_j, go_j, gd_j, gt_j = vjp(jnp.asarray(g))

    leaves = {k: getattr(ts, k).clone().requires_grad_(True)
              for k in trb.GRAD_FIELDS}
    s2 = dataclasses.replace(ts, **leaves)
    to = tuple(c.clone().requires_grad_(True) for c in o)
    td = tuple(c.clone().requires_grad_(True) for c in d)
    tt = tm.clone().requires_grad_(True)
    out = tintegrator.trace(s2, TConfig(max_bounces=B, compat=compat), to,
                            td, tt, trng.ray_keys(11, torch.arange(N)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    out.backward(torch.from_numpy(g))

    grads = dict(o=(go_j, np.stack([c.grad.numpy() for c in to], -1)),
                 d=(gd_j, np.stack([c.grad.numpy() for c in td], -1)),
                 time=(gt_j, tt.grad.numpy()))
    for k in trb.GRAD_FIELDS:
        grads[k] = (getattr(gs_j, k), leaves[k].grad.numpy())
    for k, (want, got) in grads.items():
        want = np.asarray(want, np.float64)
        got = np.asarray(got, np.float64).reshape(want.shape)
        assert np.isfinite(got).all(), k
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"cotangent mismatch: {k}")
    for k in REACHED[name]:
        assert np.abs(grads[k][1]).max() > 0.0, k


def test_vertex_gradient_matches_central_differences(scenes):
    """One vertex of the stand-in mesh, on rays through the middle of its
    triangles' fan around that vertex, away from silhouettes."""
    _, ts = scenes["mesh"]
    o, d, tm = rays(seed=3)
    keys = trng.ray_keys(0, torch.arange(N))
    cfg = TConfig(max_bounces=2, compat="physical")
    with torch.no_grad():
        _, recs, _ = tintegrator._trace_loop(
            ts, cfg, o, d, tm, keys, tintegrator.prepare(ts), with_rec=True)
    tid = recs[0][0][1]
    hit = tid[tid >= 0]
    assert hit.numel() > 8
    vi = int(ts.tri_va[hit[0]])                  # a vertex the rays see
    base = ts.mesh_verts

    def loss(p):
        val = base.clone()
        val[vi] = p
        s2 = dataclasses.replace(ts, mesh_verts=val)
        return tintegrator.trace(s2, cfg, o, d, tm, keys).sum()

    g_ad, g_fd, err, ok = compare_ad_fd(loss, base[vi].numpy(), eps=1e-3,
                                        atol=2e-3, rtol=2e-2)
    assert ok, (g_ad, g_fd, err)
    assert np.abs(g_ad).max() > 1e-4


# the zoo scenes whose builders load a skybox (tracer/scenes/zoo.py:62,
# 166, 196, 324, 373, 399, 432)
SKY_SCENES = {"single_sphere", "mesh", "rt_in_a_weekend", "raccoon",
              "flamingo_pond", "flamingo_lake", "backrooms_pool"}


@pytest.mark.parametrize("name", sorted(tzoo.BY_NAME))
def test_every_zoo_scene_renders_and_differentiates(name):
    """Each zoo scene, its sky and textures seeded (16x32), at 8x4 px,
    1 spp, 3 bounces: finite radiance, and finite gradients of the
    materials, the sphere centres and (where it has one) the atlas."""
    sb = fill_assets(tzoo.BY_NAME[name](), name in SKY_SCENES,
                     sky_hw=(16, 32), tex_hw=(16, 32))
    ts = tdevice.compile_scene(sb, device="cpu")
    assert ts.has_sky_image == (name in SKY_SCENES)
    fields = ["mat_diffuse", "sph_center"]
    if ts.tex_data.shape[0] > 1:
        fields.append("tex_data")
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    pid = torch.arange(32, dtype=torch.int32)
    out = trenderer.render_pixels(
        dataclasses.replace(ts, **leaves), tcam.default_camera(device="cpu"),
        TConfig(max_bounces=3), 8, 4, pid, 1, 0)
    assert out.shape == (32, 3) and bool(torch.isfinite(out).all())
    out.sum().backward()
    for k, t in leaves.items():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), k
