"""The port's first-hit pass (plain PyTorch version of the CUDA kernel)
against the JAX package's Pallas first-hit kernel, run in interpret mode on
the CPU as tests/test_kernels.py runs it. Same scene tables (carried across
with device_scene_from_numpy), same rays made from a seed with numpy.
Discrete outputs (with tex_out=2 the true atlas indices too) must be equal
on live lanes; f32 outputs within 2e-5.

One exception, measured and bounded: XLA:CPU contracts a*b+c into fused
multiply-adds inside the JAX kernel and the port does not (neither does the
CUDA kernel, built with --fmad=false). On a sphere hit near the silhouette
the discriminant b*b - 4*a*c cancels by orders of magnitude, and one
rounding of difference there moves the hit point by up to ~6e-5. Lanes
whose discriminant cancels by more than 1e3 (b*b / |delta| > 1e3) are held
to 1e-4 instead, and must be under 2% of the live lanes."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.kernels import intersect as jint
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.kernels import intersect as tint
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures

ATOL = 2e-5
ATOL_GRAZING = 1e-4


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def scene_pair(textured):
    sb = jzoo.setup_cornell_box(850 / 480)
    if textured:
        sb = fill_cornell_textures(sb)
    js = jcompile(sb)
    return js, port_scene(js)


def make_rays(ts, bounce, n=1500, seed=0):
    """Bounce-0 camera rays (seeded pixel positions, seeded live mask), or
    the bounce-1 rays the port's plain bounce scatters from them (the
    second bounce's kind: every sphere and quad is reachable)."""
    from tracer_torch.core import rng
    from tracer_torch.core.config import RenderConfig
    from tracer_torch.kernels import shade as tshade
    from tracer_torch.render import camera as tcam
    from tracer_torch.render import integrator

    rs = np.random.RandomState(seed)
    u = torch.from_numpy(rs.rand(n).astype(np.float32))
    v = torch.from_numpy(rs.rand(n).astype(np.float32))
    o, d = tcam.generate_rays(tcam.default_camera(850 / 480, device="cpu"),
                              u, v)
    tm = torch.from_numpy(rs.rand(n).astype(np.float32))
    state = integrator._init_state(o, d, tm)
    if bounce == 0:
        state["active"] = torch.from_numpy(rs.rand(n) < 0.9)
    else:
        keys = rng.salted(rng.ray_keys(seed, torch.arange(n)), 0)
        use_pair = ts.pair_pack.shape[0] > 1
        k1 = tint.first_hits(ts, o, d, tm, state["active"],
                             tex_out=int(use_pair))
        state = tshade.shade_scatter(ts, RenderConfig(), state, keys, k1, 6,
                                     use_pair=use_pair)
    return (np.stack([c.numpy() for c in state["o"]], -1),
            np.stack([c.numpy() for c in state["d"]], -1),
            state["time"].numpy(), state["active"].numpy())


def run_both(textured, tex_out, bounce=0, seed=0):
    js, ts = scene_pair(textured)
    o, d, tm, live = make_rays(ts, bounce, seed=seed)
    jo = tuple(jnp.asarray(o[:, a]) for a in range(3))
    jd = tuple(jnp.asarray(d[:, a]) for a in range(3))
    N0 = o.shape[0]
    # under jit, as the JAX integrator runs it
    fh = jax.jit(functools.partial(jint.first_hits, eps=1e-5,
                                   tex_out=tex_out))
    want = fh(js, jo, jd, jnp.asarray(tm), jnp.full((0, N0), 3.0e38),
              jnp.full((0, N0), -1, jnp.int32), live=jnp.asarray(live))
    to = tuple(torch.from_numpy(np.ascontiguousarray(o[:, a]))
               for a in range(3))
    td = tuple(torch.from_numpy(np.ascontiguousarray(d[:, a]))
               for a in range(3))
    got = tint.first_hits(ts, to, td, torch.from_numpy(tm),
                          torch.from_numpy(live), eps=1e-5, tex_out=tex_out)
    return want, got, live, (ts, o, d, tm)


def grazing_sphere_hits(rays, j):
    """Lanes whose winning sphere's discriminant cancels by more than 1e3
    (see the module docstring)."""
    ts, o, d, tm = rays
    sph = tint.intersect_tables(ts)[0].numpy()
    S = sph.shape[0]
    r = sph[np.clip(j, 0, S - 1)]
    oc = o - (r[:, 0:3] + tm[:, None] * r[:, 4:7])
    b = 2.0 * np.sum(d * oc, -1)
    delta = b * b - 4.0 * np.sum(d * d, -1) * (np.sum(oc * oc, -1)
                                               - r[:, 3] ** 2)
    is_s = (j >= 0) & (j < S)
    return is_s & (b * b > 1e3 * np.abs(delta))


def flat(rec):
    out = {}
    for k, v in rec.items():
        if isinstance(v, tuple):
            for a, t in zip("xyz", v):
                out[f"{k}.{a}"] = t
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("textured,tex_out", [(False, 0), (True, 0),
                                              (True, 1), (True, 2)])
def test_first_hits_plain_matches_pallas(textured, tex_out, bounce):
    want, got, live, rays = run_both(textured, tex_out, bounce)
    grazing = grazing_sphere_hits(rays, np.asarray(want["j"])) & live
    assert grazing.sum() < 0.02 * live.sum()
    want, got = flat(want), flat(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g[live], w[live], err_msg=k)
        else:
            ok = live & ~grazing
            np.testing.assert_allclose(g[ok], w[ok], atol=ATOL, rtol=0,
                                       err_msg=k)
            np.testing.assert_allclose(g[grazing], w[grazing],
                                       atol=ATOL_GRAZING, rtol=0, err_msg=k)
    if bounce == 1:  # scattered rays reach every real sphere and quad
        j = np.asarray(want["j"])[live]
        assert len(set(j.tolist()) - {-1}) == 2 + 11
    if tex_out:
        assert (np.asarray(want["ptex"])[live] > 0).any()
        assert np.asarray(want["sub"])[live].max() > 0
    if tex_out == 2:   # the true atlas indices reach into both atlases
        assert np.asarray(want["idx_t"])[live].max() > 0
        assert np.asarray(want["idx_n"])[live].max() > 0


def test_first_hits_dead_lane_defaults():
    """What a lane that is not live holds: the integer fields a consumer
    indexes with, and no quad columns (its p, n, u, v are unspecified:
    the CUDA kernel does not write them)."""
    _, got, live, _ = run_both(True, 2)
    dead = ~live
    assert dead.any()
    assert (got["j"].numpy()[dead] == -1).all()
    assert (got["tid"].numpy()[dead] == -1).all()
    for k in ("mid", "row", "sub", "idx_t", "idx_n"):
        assert (got[k].numpy()[dead] == 0).all(), k
    for k in ("tan", "bitan"):
        for c in got[k]:
            assert (c.numpy()[dead] == 0.0).all(), k
    for k in ("ptex", "pnm"):
        assert (got[k].numpy()[dead] == 0.0).all(), k


@pytest.mark.parametrize("name", ["cornell_box", "random_spheres"])
def test_intersect_tables_match(name):
    js = jcompile(jzoo.BY_NAME[name]())
    jsph, jquad, _ = jint.intersect_tables(js)
    tsph, tquad = tint.intersect_tables(port_scene(js))
    np.testing.assert_array_equal(np.asarray(jsph), tsph.numpy())
    np.testing.assert_array_equal(np.asarray(jquad), tquad.numpy())
    assert tquad.shape[1] == 47


def test_kernels_on_refuses_cpu_tensors():
    _, ts = scene_pair(False)
    z = torch.zeros(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tint.first_hits(ts, (z, z, z), (z, z, z + 1), z,
                        torch.ones(4, dtype=torch.bool), kernels="on")
