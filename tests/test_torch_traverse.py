"""The port's BVH walk (the plain PyTorch version of the CUDA kernel B5)
against the JAX package's jnp walk `tracer.geometry.primitives.
mesh_closest_hits`, and the first-hit pass with mesh candidates against
the JAX Pallas first-hit kernel in interpret mode. Same scene tables
(a two-mesh scene of stand-in meshes, carried across with
device_scene_from_numpy), same rays made from a seed with numpy.

Triangle ids must be equal. Hit distances agree to f32 rounding
(rtol 1e-5), not bit for bit: inside `jax.jit` XLA:CPU contracts a*b+c
into fused multiply-adds when it computes the triangles' normals and
plane offsets (the leaf tables of the two packages differ in the last
bit of n and D on ~10% of the triangles; tracer/kernels/traverse.py
computes them the same way), and the port never does, so that its CUDA
kernel, built with --fmad=false, can match the plain version exactly."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.geometry import primitives as jprim
from tracer.kernels import intersect as jint
from tracer.kernels import traverse as jtrav
from tracer.render import integrator as jintegrator
from tracer.scene.builder import Material as JMaterial
from tracer.scene.builder import SceneBuilder as JSceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.geometry import primitives as tprim
from tracer_torch.kernels import intersect as tint
from tracer_torch.kernels import traverse as ttrav
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import add_standin, flamingo_standin, mesh_grid

N = 257            # not a multiple of any tile (padding paths)
RTOL = 1e-5


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def two_mesh_builder():
    """Two stand-in meshes (the flamingo_pond layout's), two lights, a
    sphere in front of them and a floor."""
    sb = JSceneBuilder()
    sb.add_light((-1., 8., 2.), radius=1.5)
    sb.add_light((2., 4., -1.), radius=0.5)
    sb.add_sphere((0.6, -0.6, -2.2), 0.35, JMaterial(diffuse=(0.8, 0.3, 0.2)))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      JMaterial(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, -3.))
    add_standin(sb, 700, 0, "flamingo")
    m = add_standin(sb, 400, 1, "pond_flamingo")
    m.translate((-3., 1.2, -2.))
    return sb


@functools.lru_cache(maxsize=None)
def named_scenes(name):
    # the numpy BVH builder: test_torch_accel.py holds the native ones
    sb = (two_mesh_builder() if name == "two_mesh"
          else flamingo_standin(jzoo, 2_000))
    js = jcompile(sb, use_native=False)
    return js, port_scene(js)


def scenes():
    return named_scenes("two_mesh")


def rays(kind, seed=0):
    """'coherent': camera-like rays from the origin toward the meshes;
    'incoherent': seeded origins around the meshes, aimed at seeded points
    near them, a tenth of them with one zero component (axis-parallel: the
    slab test's 0 * inf)."""
    rs = np.random.RandomState(seed)
    if kind == "coherent":
        o = np.zeros((N, 3), np.float32)
        tgt = np.stack([rs.uniform(-2.5, 2.5, N), rs.uniform(-1.0, 2.5, N),
                        np.full(N, -5.0)], -1)
        d = tgt - o
    else:
        o = np.stack([rs.uniform(-4, 4, N), rs.uniform(-1, 4, N),
                      rs.uniform(-12, -3, N)], -1)
        tgt = np.stack([rs.uniform(-3, 1.5, N), rs.uniform(-0.5, 2.5, N),
                        rs.uniform(-8.5, -7.5, N)], -1)
        d = tgt - o
        d[: N // 10, rs.randint(0, 3)] = 0.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    live = rs.rand(N) < 0.85
    return o.astype(np.float32), d.astype(np.float32), live


def planar(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_walk_matches_jax(kind):
    js, ts = scenes()
    assert ts.mesh_mat.shape[0] == 2
    o, d, live = rays(kind)
    jt, jtri = jprim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d), js,
                                       1e-5)
    jt, jtri = np.asarray(jt).T, np.asarray(jtri).T        # [Nm, N]
    tables = ttrav.traverse_tables(ts)
    cnt = {}
    t, tri = ttrav.mesh_closest_hits_plain(
        ts, planar(o), planar(d), torch.from_numpy(live), tables, cnt)
    t, tri = t.numpy(), tri.numpy()
    assert (tri[:, ~live] == -1).all() and (t[:, ~live] == 3.0e38).all()
    np.testing.assert_array_equal(tri[:, live], jtri[:, live])
    np.testing.assert_allclose(t[:, live], jt[:, live], rtol=RTOL, atol=0)
    assert (tri[:, live] >= 0).sum() > N // 8      # the rays hit meshes
    assert cnt["visits"] > 0 and cnt["tests"] > 0
    # each live ray's counts over both meshes add up to the totals
    assert cnt["lane_counts"].shape == (2, int(live.sum()))
    assert int(cnt["lane_counts"][0].sum()) == cnt["visits"]
    assert int(cnt["lane_counts"][1].sum()) == cnt["tests"]
    assert int(cnt["lane_counts"][0].min()) >= 2    # a root box per mesh
    # the same walk on the scene's own triangles (`triangle_test`), as the
    # JAX package's per-ray walk computes it: bit for bit
    t2, tri2 = tprim.mesh_closest_hits(planar(o), planar(d), ts,
                                       torch.from_numpy(live))
    np.testing.assert_array_equal(t2.numpy(), t)
    np.testing.assert_array_equal(tri2.numpy(), tri)
    # and the wrapper takes the plain version for CPU tensors
    t3, tri3 = ttrav.mesh_closest_hits(ts, planar(o), planar(d),
                                       torch.from_numpy(live))
    np.testing.assert_array_equal(t3.numpy(), t)


def test_traverse_tables_match_jax():
    """The TPU kernel's tables, but for the spare column 6 of nodes_f, which
    the port fills with each leaf's count of real triangles
    (`test_leaf_count_column`)."""
    js, ts = scenes()
    jn_f, jn_i, jleaf = (np.asarray(x) for x in jtrav.traverse_tables(js))
    tn_f, tn_i, tleaf = (x.numpy() for x in ttrav.traverse_tables(ts))
    assert tn_f.shape == jn_f.shape
    keep = [0, 1, 2, 3, 4, 5, 7]
    np.testing.assert_array_equal(tn_f[:, keep], jn_f[:, keep])
    assert (jn_f[:, 6] == 0).all()
    np.testing.assert_array_equal(tn_i, jn_i)
    assert tleaf.shape == jleaf.shape and tleaf.dtype == jleaf.dtype
    np.testing.assert_allclose(tleaf, jleaf, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["two_mesh", "flamingo_standin"])
def test_leaf_count_column(name):
    """Column 6 of nodes_f holds a leaf's count of non-sentinel slots (0 at
    an inner node), and the real triangles come first in each leaf row, so
    a walk that stops at the count tests what one that stops at the first
    padding slot does."""
    _, ts = named_scenes(name)
    nodes_f, nodes_i, leaf = ttrav.traverse_tables(ts)
    sentinel = ts.tri_a.shape[0] - 1
    LW = ts.leaf_width
    tids = leaf.reshape(-1, LW, ttrav.TRI_COLS)[:, :, 17].to(torch.int64)
    real = tids != sentinel
    row = nodes_i[:, 0].long()
    is_leaf = row >= 0
    assert is_leaf.sum() > 4 and (~is_leaf).sum() > 4
    want = real.sum(1)[row[is_leaf]].to(torch.float32)
    np.testing.assert_array_equal(nodes_f[is_leaf, 6].numpy(), want.numpy())
    assert (nodes_f[~is_leaf, 6] == 0).all() and (nodes_f[:, 7] == 0).all()
    assert (want >= 1).all() and (want <= LW).all() and (want < LW).any()
    # padding only after the real slots
    first_pad = torch.where(real, LW, torch.arange(LW)).amin(1)
    assert (first_pad == real.sum(1)).all()


def bounds_for(t, live, seed):
    """Seeded per-lane bounds: around half of each hit's distance below
    it and half above, and a seeded distance on the misses."""
    rs = np.random.RandomState(seed)
    f = rs.uniform(0.5, 1.5, t.shape[-1]).astype(np.float32)
    miss = rs.uniform(0.5, 12.0, t.shape[-1]).astype(np.float32)
    return np.where(t < 1e38, np.minimum(t, 1e30) * f, miss).astype(np.float32)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("name", ["two_mesh", "flamingo_standin"])
def test_bounded_walk(name, kind):
    """`skip_walk` with a per-lane starting bound (the shadow walk's
    t_light): the unbounded walk's (t, tri) wherever that t is below the
    bound, (bound, -1) elsewhere, on every mesh; against the port's own
    unbounded walk bit for bit and against the JAX package's jnp walk to
    its tolerance. The bound prunes: fewer node visits."""
    js, ts = named_scenes(name)
    o, d, live = rays(kind, seed=11)
    jt, jtri = jprim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d), js,
                                       1e-5)
    jt, jtri = np.asarray(jt).T, np.asarray(jtri).T        # [Nm, N]
    tables = ttrav.traverse_tables(ts)
    lv = torch.from_numpy(live)
    n_below = n_beyond = 0      # hits below and beyond their bounds
    pruned = 0                  # node visits the bounds saved
    for m in range(ts.mesh_mat.shape[0]):
        free, cfree = {}, torch.zeros((2, N), dtype=torch.int64)
        t_u, tri_u = ttrav.mesh_walk_plain(ts, planar(o), planar(d), m, lv,
                                           tables, free, lane_counts=cfree)
        t_u, tri_u = t_u.numpy(), tri_u.numpy()
        bound = bounds_for(t_u, live, seed=12 + m)
        cnt, cb = {}, torch.zeros((2, N), dtype=torch.int64)
        t_b, tri_b = ttrav.mesh_walk_plain(
            ts, planar(o), planar(d), m, lv, tables, cnt,
            tmax=torch.from_numpy(bound), lane_counts=cb)
        t_b, tri_b = t_b.numpy(), tri_b.numpy()
        below = live & (t_u < bound)
        beyond = live & ~below
        n_below += int((below & (tri_u >= 0)).sum())
        n_beyond += int((beyond & (tri_u >= 0)).sum())
        np.testing.assert_array_equal(t_b[below], t_u[below])
        np.testing.assert_array_equal(tri_b[below], tri_u[below])
        np.testing.assert_array_equal(t_b[beyond], bound[beyond])
        assert (tri_b[beyond] == -1).all()
        assert (tri_b[~live] == -1).all() and (t_b[~live] == 3.0e38).all()
        # the JAX reference walk, below each bound
        jb = below & (jt[m] < bound)
        np.testing.assert_array_equal(tri_b[jb], jtri[m][jb])
        np.testing.assert_allclose(t_b[jb], jt[m][jb], rtol=RTOL, atol=0)
        assert (jb == below).mean() > 0.99
        # the per-lane counts add up to the walk's totals, and the bound
        # prunes
        assert int(cb[0].sum()) == cnt["visits"]
        assert int(cb[1].sum()) == cnt.get("tests", 0)
        assert int(cfree[0].sum()) == free["visits"]
        assert (cb <= cfree).all() and cnt["visits"] <= free["visits"]
        pruned += free["visits"] - cnt["visits"]
        assert (cb[:, ~live] == 0).all()
    assert n_below > 4 and n_beyond > 4 and pruned > 0


@functools.lru_cache(maxsize=None)
def grid_scenes():
    """17 small stand-in meshes on a grid (more meshes than the CUDA walk's
    first argument struct held)."""
    js = jcompile(mesh_grid(JSceneBuilder(), 17, 60), use_native=False)
    return js, port_scene(js)


@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_walk_matches_jax_at_17_meshes(kind):
    """The walk at Nm = 17 against the JAX package's jnp walk: triangle
    ids equal on live lanes, distances to f32 rounding, every mesh hit by
    some ray, and the wrapper's mesh ranges are the scene's."""
    js, ts = grid_scenes()
    assert ts.mesh_mat.shape[0] == 17
    rs = np.random.RandomState(3)
    if kind == "camera":   # from the default camera toward the grid
        o = np.tile(np.float32([0.0, 0.0, 6.1]), (N, 1))
        tgt = np.stack([rs.uniform(-4.5, 4.5, N), rs.uniform(-2.4, 2.4, N),
                        np.full(N, -1.0)], -1)
    else:                  # from seeded points among the meshes
        o = np.stack([rs.uniform(-4, 4, N), rs.uniform(-2, 2, N),
                      rs.uniform(-0.6, 0.4, N)], -1)
        tgt = np.stack([rs.uniform(-4.5, 4.5, N), rs.uniform(-2.4, 2.4, N),
                        rs.uniform(-1.5, -0.5, N)], -1)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    live = rs.rand(N) < 0.9
    jt, jtri = jprim.mesh_closest_hits(jnp.asarray(o), jnp.asarray(d), js,
                                       1e-5)
    jt, jtri = np.asarray(jt).T, np.asarray(jtri).T        # [Nm, N]
    t, tri = ttrav.mesh_closest_hits(ts, planar(o), planar(d),
                                     torch.from_numpy(live))
    t, tri = t.numpy(), tri.numpy()
    assert t.shape == (17, N)
    np.testing.assert_array_equal(tri[:, live], jtri[:, live])
    np.testing.assert_allclose(t[:, live], jt[:, live], rtol=RTOL, atol=0)
    assert (tri[:, ~live] == -1).all()
    hit_meshes = (tri[:, live] >= 0).any(axis=1)
    assert hit_meshes.sum() >= (17 if kind == "camera" else 8)
    ranges = ttrav.mesh_ranges(ts, torch.device("cpu"))
    assert ranges.dtype == torch.int32 and ranges.shape == (17, 2)
    assert ranges.tolist() == [list(x) for x in zip(ts.mesh_root,
                                                    ts.mesh_end)]


def test_cuda_needs_cuda_tensors():
    _, ts = scenes()
    o, d, live = rays("coherent")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrav.mesh_closest_hits(ts, planar(o), planar(d),
                                torch.from_numpy(live), kernels="on")


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_first_hits_with_meshes_matches_jax(kind):
    """B1 with mesh candidates (the walk's hits; some raw hits are moved
    below eps, so that their mesh drops out entirely) against the JAX
    Pallas first-hit kernel on the same inputs: j, tid and mid equal on
    live lanes; p and n within 2e-5 where a sphere or quad wins, and where
    a mesh wins against `integrator._mesh_detail_p`, the hit detail the
    JAX integrator substitutes for the kernel's."""
    js, ts = scenes()
    o, d, live = rays(kind, seed=5)
    tm = np.random.RandomState(6).rand(N).astype(np.float32)
    t_raw, tri_raw = ttrav.mesh_closest_hits(ts, planar(o), planar(d),
                                             torch.from_numpy(live))
    cut = torch.from_numpy(np.random.RandomState(7).rand(N) < 0.15)
    t_raw = torch.where(cut & (tri_raw >= 0), 5e-6, t_raw)
    jo, jd = (tuple(jnp.asarray(a[:, k]) for k in range(3)) for a in (o, d))
    want = jax.jit(functools.partial(jint.first_hits, eps=1e-5))(
        js, jo, jd, jnp.asarray(tm), jnp.asarray(t_raw.numpy()),
        jnp.asarray(tri_raw.numpy()), live=jnp.asarray(live))
    got = tint.first_hits(ts, planar(o), planar(d), torch.from_numpy(tm),
                          torch.from_numpy(live), eps=1e-5, t_mesh=t_raw,
                          tri_mesh=tri_raw)
    for k in ("j", "tid", "mid"):
        np.testing.assert_array_equal(got[k].numpy()[live],
                                      np.asarray(want[k])[live], err_msg=k)
    j = got["j"].numpy()
    SQ = ts.sph_center.shape[0] + ts.quad_v0.shape[0]
    is_m = live & (j >= SQ)
    assert is_m.sum() > N // 10 and (live & (j >= 0) & (j < SQ)).sum() > 0
    assert ((j < SQ) & live & cut.numpy() & (tri_raw.numpy()[0] >= 0)).any()
    pm, nm, _, _ = jintegrator._mesh_detail_p(
        js, jo, jd, jnp.maximum(want["j"], 0), want["tid"])
    for key, mesh_ref in (("p", pm), ("n", nm)):
        for a in range(3):
            g = got[key][a].numpy()
            w = np.asarray(want[key][a])
            other = live & ~is_m
            np.testing.assert_allclose(g[other], w[other], atol=2e-5, rtol=0)
            np.testing.assert_allclose(g[is_m], np.asarray(mesh_ref[a])[is_m],
                                       atol=2e-5, rtol=0)


def test_mesh_detail_matches_jax():
    """The mesh pack and `intersect.mesh_detail` against the JAX package's
    `integrator._mesh_detail_p` on every triangle: hit point, normal,
    interpolated corner colors and has_col."""
    js, ts = scenes()
    T = ts.tri_va.shape[0]
    rs = np.random.RandomState(8)
    tid = rs.randint(-1, T, size=N).astype(np.int32)
    o, d, _ = rays("coherent", seed=9)
    jo, jd = (tuple(jnp.asarray(a[:, k]) for k in range(3)) for a in (o, d))
    want = jintegrator._mesh_detail_p(js, jo, jd, None, jnp.asarray(tid))
    got = tint.mesh_detail(tint.mesh_tables(ts)[1], planar(o), planar(d),
                           torch.from_numpy(tid))
    for w, g in zip(want[:3], got[:3]):
        for a in range(3):
            np.testing.assert_allclose(g[a].numpy(), np.asarray(w[a]),
                                       atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
