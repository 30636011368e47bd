"""The port's shade+scatter pass (plain PyTorch version of the CUDA kernel)
against the JAX package's Pallas shade kernel, run under jit in interpret
mode on the CPU as tests/test_kernels.py runs it. Both get the same scene
tables, the same first-hit record and the same ray state, made from a seed
with numpy. The port fetches the material row and the pair-atlas words by
index itself; the JAX kernel is fed them the way its integrator feeds them
(one-hot row fetch, pair-row gather + sub-texel select). f32 outputs must
agree within 2e-5 and the active flags exactly."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.kernels import shade as jshade
from tracer.render import integrator as jintegrator
from tracer.scene.builder import Material, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import intersect as tint
from tracer_torch.kernels import shade as tshade
from tracer_torch.render import camera as tcam
from tracer_torch.render.integrator import copy_state
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures

ATOL = 2e-5
N = 1500


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def lit_scene():
    """Two lights, a diffuse and a transparent glass sphere, a floor."""
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


SCENES = {
    "cornell": lambda: jzoo.setup_cornell_box(850 / 480),
    "cornell_textured": lambda: fill_cornell_textures(
        jzoo.setup_cornell_box(850 / 480)),
    "lit": lit_scene,
}


def inputs(js, ts, seed=0):
    """Seeded ray state and the first-hit record of its rays."""
    rs = np.random.RandomState(seed)
    u = torch.from_numpy(rs.rand(N).astype(np.float32))
    v = torch.from_numpy(rs.rand(N).astype(np.float32))
    cam = tcam.default_camera(1.0 if js.light_pos.shape[0] else 850 / 480,
                              device="cpu")
    o, d = tcam.generate_rays(cam, u, v)

    def f32(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rs.uniform(lo, hi, shape).astype(np.float32))

    state = dict(o=o, d=d, time=f32(N), throughput=tuple(f32(N)
                                                         for _ in range(3)),
                 acc=tuple(f32(N, hi=0.3) for _ in range(3)),
                 active=torch.from_numpy(rs.rand(N) < 0.85))
    keys = trng.salted(trng.ray_keys(seed, torch.arange(N)), 0)
    use_pair = ts.pair_pack.shape[0] > 1
    k1 = tint.first_hits(ts, o, d, state["time"], state["active"],
                         tex_out=int(use_pair))
    L = ts.light_pos.shape[0]
    shadows = f32(L, N) if L else None
    return state, keys, k1, use_pair, shadows


def jax_shade(js, cfg, state, keys, k1, n_rem, use_pair, shadows, last,
              rec_out=False, mesh_detail=None):
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jstate = dict(o=tuple(map(j, state["o"])), d=tuple(map(j, state["d"])),
                  time=j(state["time"]),
                  throughput=tuple(map(j, state["throughput"])),
                  acc=tuple(map(j, state["acc"])), active=j(state["active"]))
    jk1 = dict(j=j(k1["j"]), p=tuple(map(j, k1["p"])),
               n=tuple(map(j, k1["n"])), u=j(k1["u"]), v=j(k1["v"]),
               tan=tuple(map(j, k1["tan"])),
               bitan=tuple(map(j, k1["bitan"])))
    mat_rows = jintegrator._rows(jshade.shade_mat_table(js), j(k1["mid"]))
    rows = None
    if use_pair:
        pack = np.asarray(js.pair_pack)
        r, s = k1["row"].numpy(), k1["sub"].numpy()
        rows = (jnp.asarray(pack[r, s]), jnp.asarray(pack[r, 16 + s]),
                j(k1["ptex"]), j(k1["pnm"]))
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    jsh = None if shadows is None else [j(x) for x in shadows]

    @jax.jit
    def run(js, jstate, jkeys, jk1, mat_rows, rows, jsh, mesh_detail):
        return jshade.shade_scatter(js, cfg, jstate, jkeys, jk1, mat_rows,
                                    jnp.asarray(n_rem), shadows=jsh,
                                    rows=rows, last=last, rec_out=rec_out,
                                    mesh_detail=mesh_detail)

    return run(js, jstate, jkeys, jk1, mat_rows, rows, jsh, mesh_detail)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_scatter_plain_matches_pallas(name, compat, last):
    js = jcompile(SCENES[name]())
    ts = port_scene(js)
    state, keys, k1, use_pair, shadows = inputs(js, ts)
    n_rem = 4
    want = jax_shade(js, JConfig(compat=compat), state, keys, k1, n_rem,
                     use_pair, shadows, last)
    # the pass updates its state in place: hand it a copy
    got = tshade.shade_scatter(ts, TConfig(compat=compat), copy_state(state),
                               keys, k1, n_rem, shadows=shadows,
                               use_pair=use_pair, last=last)
    if last:
        want, got = dict(acc=want), dict(acc=got)
    else:
        np.testing.assert_array_equal(np.asarray(want["active"]),
                                      got["active"].numpy())
        assert got["time"] is state["time"]
    for key in ("o", "d", "throughput", "acc"):
        if key not in want:
            continue
        for a in range(3):
            np.testing.assert_allclose(
                got[key][a].numpy(), np.asarray(want[key][a]), atol=ATOL,
                rtol=0, err_msg=f"{key}[{a}]")
    # the inputs exercise misses, hits and (Cornell) the emitter
    live = (k1["j"] >= 0) & state["active"]
    assert 0 < int(live.sum()) < N


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_shade_scatter_rec_out_matches_pallas(compat, last):
    """The record variant: the same state outputs, plus the decoded texel,
    the raw normal-map texel and the atlas masks of every active lane (the
    JAX kernel also writes the texels on inactive lanes of a live tile; the
    port writes 0; the masks are the first-hit record's)."""
    js = jcompile(SCENES["cornell_textured"]())
    ts = port_scene(js)
    state, keys, k1, use_pair, shadows = inputs(js, ts)
    assert use_pair
    want, wrec = jax_shade(js, JConfig(compat=compat), state, keys, k1, 4,
                           use_pair, shadows, last, rec_out=True)
    got, rec = tshade.shade_scatter(ts, TConfig(compat=compat),
                                    copy_state(state), keys, k1, 4,
                                    use_pair=True, last=last, rec_out=True)
    plain = tshade.shade_scatter(ts, TConfig(compat=compat),
                                 copy_state(state), keys, k1, 4,
                                 use_pair=True, last=last)
    acc_got = got if last else got["acc"]
    acc_plain = plain if last else plain["acc"]
    for a in range(3):   # rec_out changes no other output
        np.testing.assert_array_equal(acc_got[a].numpy(),
                                      acc_plain[a].numpy())
    act = state["active"].numpy()
    wrec = np.stack([np.asarray(c) for c in wrec[0] + wrec[1]])
    assert rec.shape == (8, N)
    np.testing.assert_allclose(rec.numpy()[:6, act], wrec[:, act],
                               atol=ATOL, rtol=0)
    masks = torch.stack([k1["ptex"], k1["pnm"]]).numpy()
    np.testing.assert_array_equal(rec.numpy()[6:, act], masks[:, act])
    assert (rec.numpy()[:, ~act] == 0.0).all()
    assert (rec.numpy()[:, act] > 0.0).any()


def test_shade_tables_match():
    js = jcompile(SCENES["lit"]())
    ts = port_scene(js)
    mat, light, dark = tshade.shade_tables(ts)
    np.testing.assert_array_equal(np.asarray(jshade.shade_mat_table(js)),
                                  mat.numpy())
    np.testing.assert_array_equal(np.asarray(jshade._light_table(js)),
                                  light.numpy())
    assert dark == float(js.dark_sky)
    js0 = jcompile(SCENES["cornell"]())
    np.testing.assert_array_equal(
        np.asarray(jshade._light_table(js0)),
        tshade.shade_tables(port_scene(js0))[1].numpy())


def test_scatter_streams_match_jax_rng():
    """The glass-lobe uniform and the diffuse direction the shade pass
    draws are the JAX package's streams (SCATTER_GLASS, SCATTER_DIR)."""
    ids = np.arange(257, dtype=np.int32)
    jk = jrng.salted(jrng.ray_keys(jax.random.key(3), jnp.asarray(ids)), 2)
    tk = trng.salted(trng.ray_keys(3, torch.from_numpy(ids)), 2)
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform(jrng.salted(jk, jrng.SCATTER_GLASS))),
        trng.uniform(trng.salted(tk, trng.SCATTER_GLASS)).numpy())
    jv = jrng.cube_unit_vector_p(jrng.salted(jk, jrng.SCATTER_DIR))
    tv = trng.cube_unit_vector_lane_p(trng.salted(tk, trng.SCATTER_DIR), 0)
    for a in range(3):
        np.testing.assert_array_equal(np.asarray(jv[a]), tv[a].numpy())


def mesh_scene():
    """The lit scene with two meshes in view: a stand-in with vertex
    colors and an emissive one without colors (mesh emission is zero, the
    diffuse color the material's)."""
    from tracer.scene.builder import MeshObject
    from tracer_torch.testing import add_standin, standin_mesh
    sb = lit_scene()
    add_standin(sb, 400, 0, "pond_flamingo").translate((-5.2, 1.7, 1.))
    v, t, _ = standin_mesh(200, 1)
    m = MeshObject(v * 1.5 + np.float32([2.2, 0.3, 0.0]), t,
                   material=Material(diffuse=(0.9, 0.5, 0.1), emissive=True,
                                     light_intensity=5.0))
    sb.add_mesh(m)
    return sb


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_shade_scatter_meshes_matches_pallas(compat, last):
    """Mesh winners: the port reads the mesh pack by tid (corner colors,
    has_col) and zeroes their emission; the JAX kernel takes the mesh
    detail as inputs (`integrator._mesh_detail_p`)."""
    from tracer_torch.kernels import traverse as ttrav
    # the numpy BVH builder: test_torch_accel.py holds the native ones
    js = jcompile(mesh_scene(), use_native=False)
    ts = port_scene(js)
    rs = np.random.RandomState(1)
    u = torch.from_numpy(rs.uniform(0.1, 0.9, N).astype(np.float32))
    v = torch.from_numpy(rs.uniform(0.3, 0.8, N).astype(np.float32))
    o, d = tcam.generate_rays(tcam.default_camera(1.0, device="cpu"), u, v)
    f32 = lambda *sh, hi=1.0: torch.from_numpy(  # noqa: E731
        rs.uniform(0.0, hi, sh).astype(np.float32))
    state = dict(o=o, d=d, time=f32(N),
                 throughput=tuple(f32(N) for _ in range(3)),
                 acc=tuple(f32(N, hi=0.3) for _ in range(3)),
                 active=torch.from_numpy(rs.rand(N) < 0.85))
    keys = trng.salted(trng.ray_keys(1, torch.arange(N)), 0)
    t_raw, tri_raw = ttrav.mesh_closest_hits(ts, o, d, state["active"])
    k1 = tint.first_hits(ts, o, d, state["time"], state["active"],
                         t_mesh=t_raw, tri_mesh=tri_raw)
    shadows = f32(2, N)
    j = k1["j"].numpy()
    SQ = ts.sph_center.shape[0] + ts.quad_v0.shape[0]
    mesh_lanes = (j >= SQ) & state["active"].numpy()
    assert (j == SQ).sum() > 20 and (j == SQ + 1).sum() > 20
    jj = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    md = jintegrator._mesh_detail_p(
        js, tuple(map(jj, o)), tuple(map(jj, d)), jnp.maximum(jj(k1["j"]), 0),
        jj(k1["tid"]))
    want = jax_shade(js, JConfig(compat=compat), state, keys, k1, 3, False,
                     shadows, last, mesh_detail=md)
    got = tshade.shade_scatter(ts, TConfig(compat=compat), copy_state(state),
                               keys, k1, 3, shadows=shadows, last=last)
    if last:
        want, got = dict(acc=want), dict(acc=got)
    else:
        np.testing.assert_array_equal(np.asarray(want["active"]),
                                      got["active"].numpy())
    for key in ("o", "d", "throughput", "acc"):
        if key not in want:
            continue
        for a in range(3):
            np.testing.assert_allclose(
                got[key][a].numpy(), np.asarray(want[key][a]), atol=ATOL,
                rtol=0, err_msg=f"{key}[{a}]")
    if not last:   # vertex colors reach the throughput of mesh lanes
        th = got["throughput"][0].numpy() / state["throughput"][0].numpy()
        assert len(np.unique(np.round(th[mesh_lanes], 4))) > 10
