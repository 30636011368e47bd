"""The port's plain autodiff backward (`custom_vjp="off"`, and
`trace(with_aux=True)` under grad: `integrator._trace_scan`) against the
JAX package's `_trace_scan` on the CPU: the port of
tests/test_grad.py::test_custom_vjp_matches_autodiff.

- The lit, textured and normal-mapped Cornell box (seeded atlases,
  `testing.fill_cornell_textures`), 256 rays, 3 bounces, mat_diffuse,
  sph_center, tex_data and the ray directions: the forward with
  custom_vjp="off" equals "on" bit for bit; the "off" gradients match
  the jitted `jax.vjp` of JAX's `trace(custom_vjp="off", kernels="off")`
  at rtol 1e-4 / atol 1e-4 * max|g|; and the port's "off" and "on"
  gradients agree at rtol 2e-5 / atol 1e-7 (JAX's own test's tolerance).
  JAX runs jitted: XLA:CPU's jitted code contracts multiply-adds, so it
  may split a path at a tie (tests/test_torch_general_bwd.py runs op by
  op for that), but here the jitted gradients meet the tolerance at
  every entry and equal JAX's op-by-op ones within it; op by op they
  take ~32 s, jitted ~9 s.
- The same on a lit 200-triangle stand-in mesh (mesh_verts, mat_diffuse,
  64 rays).
- `with_aux=True` under grad: JAX's occupancy, and the "off" gradient.
- The route takes only the discrete selections from the kernels: with
  the first-hit kernel's float outputs poisoned, nothing changes.
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
from tracer.render.camera import default_camera as jcamera
from tracer.render.camera import generate_rays as jgenerate
from tracer.scene.builder import Material, MeshObject, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.render import integrator as tintegrator
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures, standin_mesh

B = 3


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def cornell():
    """tests/test_grad.py's lit Cornell box, with seeded atlases."""
    sb = fill_cornell_textures(jzoo.setup_cornell_box(1.0))
    sb.add_light((0., 0.9, 0.), radius=0.4)
    return sb


def mesh_scene():
    """A lit 200-triangle stand-in facing the camera over a floor
    (tests/test_torch_general_bwd.py's)."""
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


CASES = {
    # name: (builder, rays, fields)
    "cornell": (cornell, 256, ("mat_diffuse", "sph_center", "tex_data")),
    "mesh": (mesh_scene, 64, ("mesh_verts", "mat_diffuse")),
}


def rays(n):
    """tests/test_grad.py's rays: a camera grid, linear times, key 3."""
    u = (jnp.arange(n) % 23) / 23.0
    v = (jnp.arange(n) % 17) / 17.0
    o, d = jgenerate(jcamera(aspect=1.0), u, v)
    keys = jrng.ray_keys(jax.random.key(3), jnp.arange(n, dtype=jnp.int32))
    return o, d, jnp.linspace(0., 1., n), keys


def port_trace(ts, fields, o, d, tm, g, custom_vjp, with_aux=False):
    """(radiance, {field: grad, "d": grad}[, aux]) of the port's trace."""
    n = o.shape[0]
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    to = tuple(torch.from_numpy(np.array(o[:, a])) for a in range(3))
    td = tuple(torch.from_numpy(np.array(d[:, a])).requires_grad_(True)
               for a in range(3))
    cfg = TConfig(max_bounces=B, shadow_rays=2, custom_vjp=custom_vjp)
    out = tintegrator.trace(dataclasses.replace(ts, **leaves), cfg, to, td,
                            torch.from_numpy(np.array(tm)),
                            trng.ray_keys(3, torch.arange(n)),
                            with_aux=with_aux)
    rad, aux = out if with_aux else (out, None)
    rad.backward(torch.from_numpy(g))
    grads = {k: v.grad.numpy() for k, v in leaves.items()}
    grads["d"] = np.stack([c.grad.numpy() for c in td], -1)
    return rad.detach().numpy(), grads, aux


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The scene, rays, a seeded cotangent, JAX's vjp of its plain
    autodiff path (kernels off) and the port's "off" and "on" results."""
    build, n, fields = CASES[request.param]
    js = jcompile(build())
    ts = port_scene(js)
    o, d, tm, keys = rays(n)
    g = np.random.RandomState(0).normal(size=(n, 3)).astype(np.float32)
    jcfg = JConfig(max_bounces=B, shadow_rays=2, custom_vjp="off",
                   kernels="off")

    def f(dd, *params):
        s = dataclasses.replace(js, **dict(zip(fields, params)))
        return jintegrator.trace(s, jcfg, o, dd, tm, keys)

    def rad_vjp(*args):
        rad, vjp = jax.vjp(f, *args)
        return rad, vjp(jnp.asarray(g))

    rad, jg = jax.jit(rad_vjp)(d, *(getattr(js, k) for k in fields))
    want = dict(zip(fields, map(np.asarray, jg[1:])), d=np.asarray(jg[0]))
    return dict(js=js, ts=ts, fields=fields, rays=(o, d, tm), g=g,
                jrad=np.asarray(rad), jgrads=want,
                off=port_trace(ts, fields, o, d, tm, g, "off"),
                on=port_trace(ts, fields, o, d, tm, g, "on"))


def test_off_forward_is_on_forward(case):
    np.testing.assert_array_equal(case["off"][0], case["on"][0])
    np.testing.assert_allclose(case["off"][0], case["jrad"], atol=2e-5,
                               rtol=0)


def test_off_grads_match_jax_vjp(case):
    grads = case["off"][1]
    for k, want in case["jgrads"].items():
        got = grads[k]
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
        assert np.abs(got).max() > 0, k


def test_off_grads_match_on(case):
    off, on = case["off"][1], case["on"][1]
    for k in off:
        np.testing.assert_allclose(off[k], on[k], rtol=2e-5, atol=1e-7,
                                   err_msg=k)


def test_with_aux_under_grad(case):
    """`trace(with_aux=True)` under grad takes the plain autodiff path, as
    the JAX package's: JAX's occupancy, the "off" radiance and
    gradients."""
    o, d, tm = case["rays"]
    n = o.shape[0]

    def aux_of(s):
        return jintegrator.trace(
            s, JConfig(max_bounces=B, shadow_rays=2, kernels="off"), o, d,
            tm, jrng.ray_keys(jax.random.key(3),
                              jnp.arange(n, dtype=jnp.int32)),
            with_aux=True)[1]

    jaux = jax.jit(aux_of)(case["js"])
    rad, grads, aux = port_trace(case["ts"], case["fields"], o, d, tm,
                                 case["g"], "on", with_aux=True)
    np.testing.assert_array_equal(aux["occupancy"].numpy(),
                                  np.asarray(jaux["occupancy"]))
    off_rad, off, _ = case["off"]
    np.testing.assert_array_equal(rad, off_rad)
    for k in off:
        np.testing.assert_array_equal(grads[k], off[k], err_msg=k)


def test_only_discrete_selections_from_the_kernels(case, monkeypatch):
    """The hit is re-derived from the scene's tensors: with the first-hit
    kernel's float outputs (p, n, u, v, tan, bitan) replaced by NaN, the
    radiance and the gradients do not change (on the card those outputs
    carry no gradient, so a route that used them would lose terms)."""
    o, d, tm = case["rays"]
    want = case["off"]
    first_hits = kintersect.first_hits

    def poisoned(*a, **kw):
        k1 = dict(first_hits(*a, **kw))
        for key in ("p", "n", "tan", "bitan"):
            k1[key] = tuple(torch.full_like(c, float("nan"))
                            for c in k1[key])
        for key in ("u", "v"):
            k1[key] = torch.full_like(k1[key], float("nan"))
        return k1

    monkeypatch.setattr(kintersect, "first_hits", poisoned)
    got = port_trace(case["ts"], case["fields"], o, d, tm, case["g"], "off")
    np.testing.assert_array_equal(got[0], want[0])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
