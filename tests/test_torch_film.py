"""The port's film, tiled render, look-at pose and per-bounce occupancy
against the JAX package's, on the CPU.

- `Film` and `TileManifest` (`tracer_torch/render/film.py`) give the JAX
  package's results on the same arrays, and either package reads the
  other's files (the same on-disk format).
- A tile store half written by one package's `render(ckpt_dir=...)` and
  finished by the other's assembles to the JAX package's whole image
  within 1e-4 (the image tolerance of tests/test_torch_render.py). The
  port's tiled image equals its direct render bit for bit, and a resume
  re-renders only the missing tiles (tests/test_film.py's end-to-end case).
- `look_at_quaternion` agrees with JAX's within 1e-6 for seeded poses at
  least 10 degrees from a half turn. At a half turn (target behind the
  default forward) the JAX package's trace-only `matrix_to_quat` returns
  the identity, a fault of the reference; the port's four-branch form
  looks at the target.
- `trace(with_aux=True)`: the occupancy equals JAX's, the radiance within
  2e-5 of JAX's run op by op; under grad it raises.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import film as jfilm
from tracer.render import integrator as jintegrator
from tracer.render import renderer as jrenderer
from tracer.scene.builder import Material, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.render import camera as tcam
from tracer_torch.render import film as tfilm
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene import device as tdevice

W, H = 48, 32


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def test_film_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    samples = [rs.uniform(-0.2, 2.0, (W * H, 3)).astype(np.float32)
               for _ in range(3)]
    fj, ft = jfilm.Film(W, H), tfilm.Film(W, H)
    for x in samples:
        fj.add_sample(x)
        ft.add_sample(x)
    np.testing.assert_array_equal(ft.sum, fj.sum)
    for gamma in (True, False):
        np.testing.assert_array_equal(ft.image(gamma), fj.image(gamma))
    # each package loads the other's file
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    fj.save(pj)
    ft.save(pt)
    for a, b in ((tfilm.Film.load(pj), fj), (jfilm.Film.load(pt), ft)):
        assert (a.width, a.height, a.samples_done) == (W, H, 3)
        np.testing.assert_array_equal(a.sum, b.sum)


def test_tile_manifest_matches_jax(tmp_path):
    w, h, tile = 10, 6, 4
    mj = jfilm.TileManifest(w, h, tile, str(tmp_path / "j"))
    mt = tfilm.TileManifest(w, h, tile, str(tmp_path / "t"))
    assert mt.n_tiles == mj.n_tiles == 6
    for n_hosts in (1, 2, 3, 4):
        for host in range(n_hosts):
            assert (mt.tiles_for_host(host, n_hosts)
                    == mj.tiles_for_host(host, n_hosts))
    full = np.random.RandomState(1).rand(h * w, 3).astype(np.float32)
    for t in range(mt.n_tiles):
        np.testing.assert_array_equal(mt.tile_pixels(t), mj.tile_pixels(t))
        assert not mt.done(t, 2)
        # even tiles written by the port, odd ones by JAX, into one store
        m = mt if t % 2 == 0 else jfilm.TileManifest(w, h, tile,
                                                    str(tmp_path / "t"))
        m.save_tile(t, full[mt.tile_pixels(t)] * 2, 2)
    assert sorted(os.listdir(tmp_path / "t")) == [
        f"tile_{t:05d}.npz" for t in range(6)]
    mj2 = jfilm.TileManifest(w, h, tile, str(tmp_path / "t"))
    assert all(mt.done(t, 2) and mj2.done(t, 2) for t in range(6))
    assert not mt.done(0, 3)
    for gamma in (True, False):
        np.testing.assert_array_equal(mt.assemble(2, gamma),
                                      mj2.assemble(2, gamma))
    np.testing.assert_allclose(mt.assemble(2, gamma=False).reshape(-1, 3),
                               full, atol=1e-6)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box: no lights, so the JAX package's jitted render has
    no multiply-add ties with the port (tests/test_torch_render.py)."""
    js = jcompile(jzoo.setup_cornell_box(W / H))
    return js, port_scene(js)


CFG = dict(nsamples=2, width=W, height=H, max_bounces=2, shadow_rays=2)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_tile_store_resumes_across_packages(first, cornell, tmp_path):
    """One package renders the even tiles (host 0 of 2), the other
    resumes the store: it renders only the odd tiles and assembles the
    JAX package's image."""
    js, ts = cornell
    jcfg = JConfig(kernels="off", **CFG)
    tcfg = TConfig(**CFG)
    jc, tc = jcam.default_camera(W / H), tcam.default_camera(W / H,
                                                             device="cpu")
    want = jrenderer.render(js, jc, jcfg)
    d = str(tmp_path / "tiles")
    if first == "jax":
        jrenderer.render(js, jc, jcfg, ckpt_dir=d, tile=16, host=0,
                         n_hosts=2)
    else:
        trenderer.render(ts, tc, tcfg, ckpt_dir=d, tile=16, host=0,
                         n_hosts=2)
    written = sorted(os.listdir(d))
    assert written == ["tile_00000.npz", "tile_00002.npz", "tile_00004.npz"]
    mtimes = {t: os.path.getmtime(os.path.join(d, t)) for t in written}
    if first == "jax":
        got = trenderer.render(ts, tc, tcfg, ckpt_dir=d, tile=16)
    else:
        got = jrenderer.render(js, jc, jcfg, ckpt_dir=d, tile=16)
    assert len(os.listdir(d)) == 6
    for t, mt in mtimes.items():
        assert os.path.getmtime(os.path.join(d, t)) == mt, t
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_render_ckpt_resume_end_to_end(cornell, tmp_path):
    """Mirror of tests/test_film.py::test_render_ckpt_resume_end_to_end,
    with the tiled image bit-equal to the direct one."""
    _, ts = cornell
    cam = tcam.default_camera(W / H, device="cpu")
    cfg = TConfig(**CFG)
    img_direct = trenderer.render(ts, cam, cfg)
    d = str(tmp_path / "ckpt")
    img_tiled = trenderer.render(ts, cam, cfg, ckpt_dir=d, tile=16)
    np.testing.assert_array_equal(img_tiled, img_direct)

    tiles = sorted(os.listdir(d))
    assert len(tiles) == 6
    removed = tiles[::2]
    for t in removed:
        os.remove(os.path.join(d, t))
    kept = {t: os.path.getmtime(os.path.join(d, t))
            for t in tiles if t not in removed}
    img_resumed = trenderer.render(ts, cam, cfg, ckpt_dir=d, tile=16)
    np.testing.assert_array_equal(img_resumed, img_tiled)
    for t, mt in kept.items():
        assert os.path.getmtime(os.path.join(d, t)) == mt, \
            f"tile {t} was re-rendered on resume"
    # a third call is a pure skip
    every = {t: os.path.getmtime(os.path.join(d, t)) for t in tiles}
    np.testing.assert_array_equal(
        trenderer.render(ts, cam, cfg, ckpt_dir=d, tile=16), img_tiled)
    assert every == {t: os.path.getmtime(os.path.join(d, t)) for t in tiles}


def _angle_deg(q):
    """The rotation angle of JAX's quaternion, in degrees."""
    return 2.0 * np.degrees(np.arccos(min(1.0, abs(float(q[0])))))


def test_look_at_matches_jax():
    rs = np.random.RandomState(0)
    n = 0
    while n < 200:
        pos, tgt = rs.uniform(-5, 5, 3), rs.uniform(-5, 5, 3)
        want = np.asarray(jcam.look_at_quaternion(pos, tgt))
        if _angle_deg(want) > 170.0:
            continue
        got = tcam.look_at_quaternion(pos, tgt)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        n += 1
    # the port's rays look at the target (tests/test_camera_pose.py)
    pos, tgt = (2.0, 1.0, 5.0), (-1.0, 0.5, -2.0)
    cam = dataclasses.replace(tcam.default_camera(1.0, device="cpu"),
                              position=torch.tensor(pos),
                              quaternion=tcam.look_at_quaternion(pos, tgt))
    _, d = tcam.generate_rays(cam, torch.tensor([0.5]), torch.tensor([0.5]))
    want = np.asarray(tgt, np.float32) - np.asarray(pos, np.float32)
    np.testing.assert_allclose([float(c[0]) for c in d],
                               want / np.linalg.norm(want), atol=1e-5)


def test_look_at_half_turn_fixes_the_reference():
    """Target straight behind the default forward (-z): the JAX package
    returns the identity (its camera keeps looking down -z, away from the
    target); the port's camera looks at the target."""
    pos, tgt = (0.0, 0.0, -5.0), (0.0, 0.0, 0.0)
    np.testing.assert_array_equal(
        np.asarray(jcam.look_at_quaternion(pos, tgt)), [1.0, 0.0, 0.0, 0.0])
    q = tcam.look_at_quaternion(pos, tgt)
    np.testing.assert_allclose(q.numpy(), [0.0, 0.0, 1.0, 0.0], atol=1e-7)
    cam = dataclasses.replace(tcam.default_camera(1.0, device="cpu"),
                              position=torch.tensor(pos), quaternion=q)
    _, d = tcam.generate_rays(cam, torch.tensor([0.5, 0.5]),
                              torch.tensor([0.5, 0.25]))
    np.testing.assert_allclose([float(c[0]) for c in d], [0.0, 0.0, 1.0],
                               atol=1e-7)
    assert float(d[1][1]) > float(d[1][0])    # up stays up


def _open_scene():
    """A lit sphere over a floor under the open sky: lanes leave."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((-2., 4., 3.), radius=0.5)
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    sb.add_sphere((1.2, 0.3, -1.0), 0.5,
                  Material(diffuse=(0.9, 0.9, 0.9), mtype=2))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return jcompile(sb)


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_trace_occupancy_matches_jax(compat):
    js = _open_scene()
    ts = port_scene(js)
    n, bounces = 512, 4
    rs = np.random.RandomState(2)
    u = rs.uniform(0.0, 1.0, n).astype(np.float32)
    v = rs.uniform(0.0, 1.0, n).astype(np.float32)
    o, d = tcam.generate_rays(tcam.default_camera(1.0, device="cpu"),
                              torch.from_numpy(u), torch.from_numpy(v))
    tm = rs.rand(n).astype(np.float32)
    jo = jnp.asarray(np.stack([c.numpy() for c in o], -1))
    jd = jnp.asarray(np.stack([c.numpy() for c in d], -1))
    # op by op: the jitted scan contracts multiply-adds and splits a few
    # lit paths at ties (tests/test_torch_general_bwd.py)
    with jax.disable_jit():
        jrad, jaux = jintegrator.trace(
            js, JConfig(max_bounces=bounces, compat=compat, kernels="off"),
            jo, jd, jnp.asarray(tm),
            jrng.ray_keys(jax.random.key(3), jnp.arange(n, dtype=jnp.int32)),
            with_aux=True)
    keys = trng.ray_keys(3, torch.arange(n))
    cfg = TConfig(max_bounces=bounces, compat=compat)
    rad, aux = tintegrator.trace(ts, cfg, o, d, torch.from_numpy(tm), keys,
                                 with_aux=True)
    occ = aux["occupancy"]
    assert occ.dtype == torch.float32 and occ.shape == (bounces,)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jaux["occupancy"]))
    assert occ[0] == 1.0 and occ[-1] < 1.0
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), atol=2e-5,
                               rtol=0)
    # the same radiance as without the aux output
    np.testing.assert_array_equal(
        rad.numpy(), tintegrator.trace(ts, cfg, o, d, torch.from_numpy(tm),
                                       keys).numpy())
    # under grad: the plain autodiff path (as the JAX package's), the
    # same occupancy and radiance, and the custom_vjp="off" gradient
    grads = []
    for c_vjp, aux_on in (("on", True), ("off", False)):
        d_g = tuple(c.clone().requires_grad_(True) for c in d)
        out = tintegrator.trace(ts, dataclasses.replace(cfg, custom_vjp=c_vjp),
                                o, d_g, torch.from_numpy(tm), keys,
                                with_aux=aux_on)
        if aux_on:
            out, aux_g = out
            np.testing.assert_array_equal(aux_g["occupancy"].numpy(),
                                          occ.numpy())
            np.testing.assert_array_equal(out.detach().numpy(), rad.numpy())
        out.sum().backward()
        grads.append(np.stack([c.grad.numpy() for c in d_g]))
    assert np.isfinite(grads[0]).all() and np.abs(grads[0]).max() > 0.0
    np.testing.assert_array_equal(grads[0], grads[1])
