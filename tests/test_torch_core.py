"""Parity of the port's core layer (tracer_torch.core, camera) with the JAX
package: config fields and defaults, the PCG key/uniform streams (bitwise),
the unit-vector samplers, camera rays, gamma — and the rule that the port
never imports JAX. Inputs are made from a seed with numpy."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.core.mathutils import gamma_correct as jgamma
from tracer.render import camera as jcam
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.render import camera as tcam
from tracer_torch.render.film import to_image


def _ids(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 1 << 31, size=n).astype(np.int32)


def _u32(a):
    return np.asarray(a).astype(np.int64)


def test_render_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert jf == tf
    with pytest.raises(ValueError):
        TConfig(kernels="maybe")
    with pytest.raises(ValueError):
        TConfig(max_bounces=0)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seed_word_matches_threefry_key(seed):
    want = int(jrng._seed_word(jax.random.key(seed)))
    assert trng.seed_word(seed) == want


@pytest.mark.parametrize("seed", [0, 7])
def test_keys_salts_and_uniforms_bitwise(seed):
    ids = _ids()
    jk = jrng.ray_keys(jax.random.key(seed), jnp.asarray(ids))
    tk = trng.ray_keys(seed, torch.from_numpy(ids))
    np.testing.assert_array_equal(_u32(jk), tk.numpy())
    for salts in [(3,), (0, jrng.PIXEL_JITTER), (5, 1, 2)]:
        js = jrng.salted(jk, *salts)
        ts = trng.salted(tk, *salts)
        np.testing.assert_array_equal(_u32(js), ts.numpy())
    ju = np.asarray(jrng.uniform(jk))
    tu = trng.uniform(tk).numpy()
    np.testing.assert_array_equal(ju, tu)
    ju2 = np.asarray(jrng.uniform(jk, (2,)))
    tu2 = trng.uniform(tk, (2,)).numpy()
    assert tu2.shape == (ids.shape[0], 2)
    np.testing.assert_array_equal(ju2, tu2)
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform(jk, (3,), -1.0, 1.0)),
        trng.uniform(tk, (3,), -1.0, 1.0).numpy())
    # the int32 view the CUDA kernels read has the same bit pattern
    np.testing.assert_array_equal(
        np.asarray(jk).view(np.int32), trng.as_int32_bits(tk).numpy())


@pytest.mark.parametrize("k", [0, 3])
def test_unit_vector_lanes(k):
    ids = _ids(2048, seed=1)
    jk = jrng.ray_keys(jax.random.key(7), jnp.asarray(ids))
    tk = trng.ray_keys(7, torch.from_numpy(ids))
    for jf, tf in ((jrng.cube_unit_vector_lane_p,
                    trng.cube_unit_vector_lane_p),
                   (jrng.sphere_unit_vector_lane_p,
                    trng.sphere_unit_vector_lane_p)):
        jv = jf(jk, k)
        tv = tf(tk, k)
        for a in range(3):
            np.testing.assert_allclose(np.asarray(jv[a]), tv[a].numpy(),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("pose", ["default", "rotated"])
def test_camera_rays(pose):
    rs = np.random.RandomState(2)
    u = rs.rand(3000).astype(np.float32)
    v = rs.rand(3000).astype(np.float32)
    if pose == "default":
        jc = jcam.default_camera(850 / 480)
        tc = tcam.default_camera(850 / 480, device="cpu")
    else:
        q = np.array([0.9, 0.1, -0.3, 0.2], np.float32)
        p = np.array([1.0, 2.0, 3.0], np.float32)
        jc = jcam.Camera(jnp.asarray(p), jnp.asarray(q), jnp.float32(60.0),
                         jnp.float32(1.5))
        tc = tcam.Camera(torch.from_numpy(p), torch.from_numpy(q),
                         torch.tensor(60.0), torch.tensor(1.5))
    jo, jd = jax.jit(jcam.generate_rays)(jc, jnp.asarray(u), jnp.asarray(v))
    to, td = tcam.generate_rays(tc, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(jo),
                                  np.stack([c.numpy() for c in to], -1))
    # 1-2 ulp: XLA contracts the rotation and the norm's multiply-adds
    np.testing.assert_allclose(np.asarray(jd),
                               np.stack([c.numpy() for c in td], -1),
                               atol=3e-7, rtol=0)


def test_gamma_correct():
    """The port's images take gamma 1/2.2 and the clamp in
    `render/film.py::to_image` (the direct and the tiled render both)."""
    x = np.random.RandomState(3).uniform(-0.5, 4.0,
                                         (5000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.clip(np.asarray(jgamma(jnp.asarray(x))), 0.0, 1.0),
        to_image(x, 1, 5000).reshape(5000, 3), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("nsamples", [1, 20])
def test_finish_is_the_jax_finish(nsamples):
    """The port's plain finish of a host film (`renderer.finish_frame`:
    `film.to_image` after `film / np.float32(nsamples)`), which the finish
    kernel is held to on the card, against the JAX package's (`film /
    np.float32(nsamples)`, `gamma_correct`, then `np.clip` to [0, 1]) on
    a film with zeros of both signs, negatives, values above 1,
    infinities, NaN and denormals: NaN where JAX has NaN, else within one
    ulp (zeros compared without their sign), except where the mean is a
    denormal, which XLA on the CPU flushes to zero before its power: there
    both images are below 1e-17."""
    from tracer_torch.render.renderer import finish_frame
    from tracer_torch.testing import finish_film
    s = finish_film(4096, seed=nsamples)
    mean = s / np.float32(nsamples)
    want = np.clip(np.asarray(jgamma(jnp.asarray(mean))), 0.0, 1.0)
    got = finish_frame(torch.from_numpy(s), nsamples, 64, 64)
    want, got, mean = (a.reshape(-1) for a in (want, got, mean))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    tiny = (np.abs(mean) < np.finfo(np.float32).tiny) & (mean != 0)
    assert tiny.any() and np.all(got[tiny] < 1e-17) and np.all(
        want[tiny] < 1e-17)
    keep = ~nan & ~tiny
    gap = np.abs((got[keep] + np.float32(0)).view(np.int32).astype(np.int64)
                 - (want[keep] + np.float32(0)).view(np.int32)
                 .astype(np.int64))
    assert gap.max() <= 1, gap.max()


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tracer_torch\n"
        "for m in pkgutil.walk_packages(tracer_torch.__path__, "
        "'tracer_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'tracer_torch.bench' in sys.modules\n"
        "assert 'tracer_torch.bench_multihost' in sys.modules\n"
        # the benchmarks run end to end: nothing they import late is JAX's
        "from tracer_torch import bench, bench_multihost\n"
        "from tracer_torch.dist.sharding import make_ray_mesh\n"
        "bench.main(device='cpu')\n"
        "bench_multihost.measure(make_ray_mesh(1, 1), 'x', device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tracer' or m.startswith('tracer.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, BENCH_WIDTH="8", BENCH_HEIGHT="6", BENCH_SPP="1",
               BENCH_REPS="1", BENCH_MH_WIDTH="8", BENCH_MH_HEIGHT="6",
               BENCH_MH_PIX_PER_DP="8")
    env.pop("BENCH_SCENES", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
