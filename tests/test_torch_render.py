"""The port's forward render against the JAX package's, on Cornell and on a
Cornell whose textures and normal maps are seeded arrays (the pair-atlas
branch), at 32x18, 2 spp, 6 bounces, under both compat modes. The JAX side
runs with kernels="off" (its jnp path) and "on" (its Pallas kernels in
interpret mode). Both packages render from the same scene tables
(`device_scene_from_numpy`) and the same seed, so every path and every
random draw is the same: the sums over samples must agree within
2e-5 * spp, the gamma-corrected image within 1e-4."""

import dataclasses

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
from tracer_torch.testing import fill_cornell_textures

W, H, SPP = 32, 18, 2


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


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("textured", [False, True])
def test_render_pixels_matches_jax(textured, compat):
    js, ts = scenes(textured)
    assert (ts.pair_pack.shape[0] > 1) == textured
    pid = np.arange(W * H, dtype=np.int32)
    got = trenderer.render_pixels(
        ts, tcam.default_camera(W / H, device="cpu"), TConfig(compat=compat),
        W, H,
        torch.from_numpy(pid), SPP, 0).numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    for kernels in ("off", "on"):
        cfg = JConfig(compat=compat, kernels=kernels)
        want = np.asarray(jrenderer.render_pixels(
            js, jcam.default_camera(W / H), cfg, W, H, jnp.asarray(pid), SPP,
            jax.random.key(0)))
        np.testing.assert_allclose(got, want, atol=2e-5 * SPP, rtol=0,
                                   err_msg=f"kernels={kernels}")
    assert got.max() > 0.0


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("textured", [False, True])
def test_render_image_matches_jax(textured, compat):
    """The gamma image; the JAX side's jnp path (its kernels' sums are
    covered by test_render_pixels_matches_jax)."""
    js, ts = scenes(textured)
    want = jrenderer.render(js, jcam.default_camera(W / H),
                            JConfig(nsamples=SPP, width=W, height=H,
                                    kernels="off", compat=compat))
    got = trenderer.render(ts, tcam.default_camera(W / H, device="cpu"),
                           TConfig(nsamples=SPP, width=W, height=H,
                                   compat=compat))
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_render_image_writes_ppm(tmp_path):
    _, ts = scenes(False)
    path = str(tmp_path / "rendu.ppm")
    img = trenderer.render_image(ts, tcam.default_camera(W / H, device="cpu"),
                                 TConfig(nsamples=1, width=W, height=H), path)
    from tracer_torch.io.ppm import load_ppm
    back = load_ppm(path)
    assert back.shape == (H, W, 3)
    np.testing.assert_array_equal(
        back, (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8))


@pytest.mark.parametrize("what", ["lights", "sky"])
def test_scenes_outside_the_slice_raise(what):
    """What the first slices refused now runs and matches the JAX package
    (the name is kept from then). "sky": an image skybox renders (the
    shade kernel's sky input), its sums against JAX's within 2e-5 * spp.
    "lights": the gradient of a lit scene and of a mesh scene (outside the
    hand-written backward's class, through the general backward) against
    `jax.grad` of the same render sum (8x4 px, 1 spp, 3 bounces), rtol
    1e-4, atol 1e-4 * max|g|."""
    pid = np.arange(8, dtype=np.int32)
    cam, jc = tcam.default_camera(device="cpu"), jcam.default_camera()
    if what == "sky":
        from tracer.scene.builder import SceneBuilder
        sb = SceneBuilder()
        rs = np.random.RandomState(0)
        sb.skybox = rs.randint(0, 256, (4, 8, 3)).astype(np.uint8)
        sb.add_sphere((0., 0., 0.), 1.0)
        js = jcompile(sb)
        ts = port_scene(js)
        assert ts.has_sky_image
        got = trenderer.render_pixels(ts, cam, TConfig(), 4, 2,
                                      torch.from_numpy(pid), 1, 0).numpy()
        want = np.asarray(jrenderer.render_pixels(
            js, jc, JConfig(kernels="off"), 4, 2, jnp.asarray(pid), 1,
            jax.random.key(0)))
        assert np.isfinite(got).all() and got.max() > 0.0
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        return
    from tracer_torch.testing import flamingo_standin
    lit = jcompile(jzoo.setup_single_square())
    mesh = jcompile(flamingo_standin(jzoo, 200))
    assert mesh.mesh_mat.shape[0] == 1 and lit.light_pos.shape[0] == 1
    pid = np.arange(32, dtype=np.int32)
    for js in (lit, mesh):
        ts = port_scene(js)
        diff = ts.mat_diffuse.clone().requires_grad_(True)
        out = trenderer.render_pixels(
            dataclasses.replace(ts, mat_diffuse=diff), cam,
            TConfig(max_bounces=3), 8, 4, torch.from_numpy(pid), 1, 0)
        out.sum().backward()
        got = diff.grad.numpy()

        def loss(d):
            return jnp.sum(jrenderer._render_batch(
                dataclasses.replace(js, mat_diffuse=d), jc,
                JConfig(kernels="off", max_bounces=3), 8, 4,
                jnp.asarray(pid), jnp.int32(0), jax.random.key(0)))

        want = np.asarray(jax.grad(loss)(js.mat_diffuse))
        assert np.isfinite(got).all() and np.abs(want).max() > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
