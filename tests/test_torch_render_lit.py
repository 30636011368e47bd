"""The port's forward render of lit scenes and mesh scenes against the JAX
package's, at 32x18, 2 spp, 6 bounces: single_square (one light, two
quads), random_spheres (one light, 82 motion-blurred spheres), the
flamingo scene with a stand-in mesh of a few hundred triangles (two
lights, two spheres, one mesh) and a two-mesh lit scene. Both packages
render from the same scene tables (`device_scene_from_numpy`) and seed;
the JAX side runs with kernels="off" (its jnp path under jit) and, on the
scenes without meshes, kernels="on" (its Pallas kernels in interpret
mode): each scene under both compat modes, the JAX side's mode varied
across the cases (every JAX render is a compile of its own, ~7 s).

Sums over samples must agree within 2e-5 * spp and the gamma image within
1e-4, but for counted ties. XLA:CPU contracts a*b+c into fused
multiply-adds inside `jax.jit` and the port never does; one rounding of
difference at a silhouette, a grazing shadow ray or a mesh's self-hit
(tests/test_torch_shadow.py) sends a path elsewhere. The JAX package
disagrees with itself the same way: its jitted render differs from the
same render run op by op (`jax.disable_jit`) at 21 of random_spheres'
1,728 1-spp values, while the port equals the op-by-op render there.
Each case has its own budget of tied values, set a little above the count
measured on the CPU (TIES; 0 on single_square), and the means agree within
1e-3."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.render import camera as tcam
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import add_standin, flamingo_standin

W, H, SPP = 32, 18, 2
# the most values (of 32 * 18 * 3 = 1,728) that may differ beyond the
# tolerance, per scene and compat mode; measured: 0, 0, 26, 42, 12, 4, 0,
# and 22 for the gamma image
TIES = {("single_square", "reference"): 0, ("single_square", "physical"): 0,
        ("random_spheres", "reference"): 32,
        ("random_spheres", "physical"): 50,
        ("flamingo_standin", "reference"): 16,
        ("flamingo_standin", "physical"): 8,
        ("two_mesh", "reference"): 2}
IMAGE_TIES = 28
MEAN_RTOL = 1e-3


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def two_mesh():
    sb = jzoo.setup_single_square()
    sb.add_light((3., 6., 4.), radius=1.0)
    add_standin(sb, 300, 0, "pond_flamingo").translate((-3.5, 1.8, -4.))
    m = add_standin(sb, 200, 1, "pond_flamingo")
    m.translate((-1.5, 0.6, -1.))
    m.material.transparency = 0.5
    return sb


BUILDERS = dict(
    single_square=jzoo.setup_single_square,
    random_spheres=jzoo.setup_random_spheres,
    flamingo_standin=lambda: flamingo_standin(jzoo, 300),
    two_mesh=two_mesh)


@functools.lru_cache(maxsize=None)
def scenes(name):
    # the numpy BVH builder: test_torch_accel.py holds the native ones
    js = jcompile(BUILDERS[name](), use_native=False)
    return js, port_scene(js)


def ties(got, want, atol):
    """The number of values outside atol."""
    return int((np.abs(got - want) > atol).sum())


@pytest.mark.parametrize("name,compat,kernels", [
    ("single_square", "reference", "off"),
    ("single_square", "physical", "on"),
    ("random_spheres", "reference", "on"),
    ("random_spheres", "physical", "off"),
    ("flamingo_standin", "reference", "off"),
    ("flamingo_standin", "physical", "off"),
    ("two_mesh", "reference", "off"),
])
def test_lit_render_pixels_matches_jax(name, compat, kernels):
    js, ts = scenes(name)
    assert ts.light_pos.shape[0] > 0
    assert (ts.mesh_mat.shape[0] > 0) == (name in ("flamingo_standin",
                                                    "two_mesh"))
    pid = np.arange(W * H, dtype=np.int32)
    got = trenderer.render_pixels(
        ts, tcam.default_camera(W / H, device="cpu"), TConfig(compat=compat),
        W, H, torch.from_numpy(pid), SPP, 0).numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    want = np.asarray(jrenderer.render_pixels(
        js, jcam.default_camera(W / H),
        JConfig(compat=compat, kernels=kernels), W, H, jnp.asarray(pid), SPP,
        jax.random.key(0)))
    n = ties(got, want, 2e-5 * SPP)
    assert n <= TIES[name, compat], f"{n} of {got.size} values differ"
    assert abs(got.mean() - want.mean()) < MEAN_RTOL * want.mean()
    assert got.max() > 0.0


def test_lit_render_image_matches_jax():
    """The gamma image through `render`, against the JAX side's jnp path
    (random_spheres)."""
    js, ts = scenes("random_spheres")
    want = jrenderer.render(js, jcam.default_camera(W / H),
                            JConfig(nsamples=SPP, width=W, height=H,
                                    kernels="off"))
    got = trenderer.render(ts, tcam.default_camera(W / H, device="cpu"),
                           TConfig(nsamples=SPP, width=W, height=H))
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert ties(got, want, 1e-4) <= IMAGE_TIES
    assert abs(got.mean() - want.mean()) < MEAN_RTOL * want.mean()


def test_ray_sort_off_renders_the_same():
    """`ray_sort` is validated but has no effect in the port (rays reach
    the walk and the shadow kernels in ray order whatever it says): the
    flamingo scene renders the same either way, and a bad mode raises."""
    _, ts = scenes("flamingo_standin")
    pid = torch.arange(16 * 9, dtype=torch.int32)
    cam = tcam.default_camera(16 / 9, device="cpu")
    a = trenderer.render_pixels(ts, cam, TConfig(), 16, 9, pid, 1, 0)
    b = trenderer.render_pixels(ts, cam, TConfig(ray_sort="off"), 16, 9,
                                pid, 1, 0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="ray_sort"):
        TConfig(ray_sort="sorted")
