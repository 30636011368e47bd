"""The port's soft-shadow factors (the plain PyTorch version of the CUDA
kernel B6) against the JAX package's jnp megabatch
`integrator._shadow_factor_jnp`, the semantics its Pallas kernel claims,
and against that Pallas kernel in interpret mode where it is cheap (no
meshes). Same scene tables, hit points, ray times and keys, made from a
seed with numpy; both compat modes (cube or sphere light jitter).

The factors must be equal: every draw comes from the same PCG streams,
and the mean is the sum times f32(1/K), as jnp.mean compiles. The Pallas
kernel divides by K instead, so it may differ from both in the last bit
(atol 1e-6, the JAX package's own tolerance between the two).

One tie, counted: a hit point ON a mesh shoots shadow rays that start
eps above its own surface, and at a grazing angle the self-hit's t rounds
to +-0. The reference quirk keeps a mesh out of the shadow test when its
closest raw hit lies below eps (Scene.h:224), so whether that rounding
lands at -0.0 (a hit at t >= 0, the mesh drops out) or a hair below (no
hit, the next surface counts) flips one sample. The JAX walk's normals
and plane offsets are computed under XLA:CPU's fused multiply-adds, the
port's are not; such lanes are bounded below 3% of the mesh lanes."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer.core.config import RenderConfig as JConfig
from tracer.kernels import shadow as jshadow
from tracer.render import integrator as jintegrator
from tracer.scene.builder import Material as JMaterial
from tracer.scene.builder import SceneBuilder as JSceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import shadow as tshadow
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import add_standin

K = 4
N = 600


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def lit_builder():
    """tests/test_kernels.py's lit scene: two lights, an opaque sphere, a
    half-transparent glass sphere and a floor quad."""
    sb = JSceneBuilder()
    sb.add_light((-2., 4., 3.), radius=1.0)
    sb.add_light((3., 2., 1.), radius=0.5)
    sb.add_sphere((0., 0., 0.), 1.0, JMaterial(diffuse=(0.8, 0.3, 0.2)))
    sb.add_sphere((1.5, 0.4, -1.0), 0.5,
                  JMaterial(diffuse=(0.2, 0.2, 0.9), transparency=0.5,
                            mtype=1))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      JMaterial(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return sb


def mesh_builder():
    """The lit scene with a half-transparent stand-in mesh above the floor
    and an opaque one beside it."""
    sb = lit_builder()
    m = add_standin(sb, 500, 0, "pond_flamingo")
    m.material.transparency = 0.5
    m.translate((-4.5, 2.0, 1.5))
    add_standin(sb, 300, 1, "pond_flamingo").translate((-1.0, 2.2, 0.5))
    return sb


def above_builder():
    """A light straight above the edge of an opaque stand-in mesh (its
    largest vertex x and mean z, rounded to 1/64) and the floor: the
    central ray from a floor point under the light's centre is parallel
    to y, and the mesh hides part of the light from it."""
    sb = JSceneBuilder()
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      JMaterial(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    m = add_standin(sb, 300, 1, "pond_flamingo").translate((-1.0, 2.2, 0.5))
    v = np.asarray(m.verts)
    cx, cz = np.round([v[:, 0].max() * 64, v[:, 2].mean() * 64]) / 64
    sb.add_light((cx, 5., cz), radius=0.5)
    return sb


@functools.lru_cache(maxsize=None)
def scenes(name):
    sb = dict(lit=lit_builder, random_spheres=jzoo.setup_random_spheres,
              mesh=mesh_builder, above=above_builder)[name]()
    # the numpy BVH builder: test_torch_accel.py holds the native ones
    js = jcompile(sb, use_native=False)
    return js, port_scene(js)


def floor_points(seed=0):
    """Seeded hit points just above the floor (penumbrae of every
    occluder), ray times and keys."""
    rs = np.random.RandomState(seed)
    p = np.stack([rs.uniform(-4, 4, N), np.full(N, -1.4),
                  rs.uniform(-4, 4, N)]).astype(np.float32)
    tm = rs.rand(N).astype(np.float32)
    keys = rs.randint(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    return p, tm, keys


def run_both(name, compat, p, tm, keys, live=None):
    js, ts = scenes(name)
    jc = JConfig(compat=compat, shadow_rays=K, kernels="off")
    want = np.stack([np.asarray(jintegrator._shadow_factor_jnp(
        js, jc, tuple(jnp.asarray(c) for c in p), jnp.asarray(tm),
        jnp.asarray(keys), jc.epsilon, i))
        for i in range(js.light_pos.shape[0])])
    lv = None if live is None else torch.from_numpy(live)
    got = tshadow.shadow_factors(
        ts, TConfig(compat=compat, shadow_rays=K),
        tuple(torch.from_numpy(c) for c in p), torch.from_numpy(tm),
        torch.from_numpy(keys.astype(np.int64)), 1e-5, lv).numpy()
    return want, got


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("name", ["lit", "random_spheres", "mesh"])
def test_shadow_factors_match_jax(name, compat):
    p, tm, keys = floor_points()
    if name == "random_spheres":      # its floor lies at y = -4
        p[1] = -3.999
        p[0] *= 3.0
        p[2] = p[2] * 4.0 - 20.0
    want, got = run_both(name, compat, p, tm, keys)
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (want < 1.0).mean() < 0.95      # penumbrae and full light
    if name == "mesh":
        # the meshes cast shadows here: without them the factors differ
        js, _ = scenes("lit")
        jc = JConfig(compat=compat, shadow_rays=K)
        bare = np.asarray(jintegrator._shadow_factor_jnp(
            js, jc, tuple(jnp.asarray(c) for c in p), jnp.asarray(tm),
            jnp.asarray(keys), 1e-5, 0))
        assert (bare != want[0]).sum() > 10


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_dead_lanes_return_one(compat):
    p, tm, keys = floor_points(1)
    live = np.random.RandomState(2).rand(N) < 0.7
    want, got = run_both("mesh", compat, p, tm, keys, live)
    np.testing.assert_array_equal(got[:, live], want[:, live])
    assert (got[:, ~live] == 1.0).all()


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_pallas_kernel_table_only(compat):
    """The JAX package's Pallas shadow kernel (interpret mode) on the
    table-only lit scene: equal to the port to its last bit."""
    js, ts = scenes("lit")
    p, tm, keys = floor_points(3)
    jc = JConfig(compat=compat, shadow_rays=K, kernels="on")
    want = np.stack([np.asarray(f) for f in jshadow.shadow_factors(
        js, jc, tuple(jnp.asarray(c) for c in p), jnp.asarray(tm),
        jnp.asarray(keys), jc.epsilon)])
    _, got = run_both("lit", compat, p, tm, keys)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert want.std() > 0


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_light_straight_above_the_point(compat):
    """ROADMAP Queue C, the reference's union shadow walk: hit points
    straight under the light's centre make the central ray's x and z
    components 0, so `icx` and `icz` are inf in
    tracer/kernels/shadow.py:291-294. The port walks each sample's own ray
    and equals the JAX package's jnp path there (finite, within 2e-5).
    What the JAX package's Pallas kernel gives (interpret mode, as
    `test_pallas_kernel_table_only`) is recorded: finite and equal to the
    jnp path. Its slab test takes (bound -+ rho - px) * inf, which is
    +-inf and sound wherever the bound is not exactly px +- rho; only a
    node box at exactly that distance gives 0 * inf = NaN and is pruned,
    and such a box lies rho from the central segment, beyond every
    sample's reach, so the fault does not show in the factors here."""
    js, ts = scenes("above")
    p, tm, keys = floor_points(8)
    lp = np.asarray(js.light_pos)[0]
    p[0], p[2] = lp[0], lp[2]       # every lane under the light's centre
    assert (lp[0] - p[0] == 0).all() and (lp[2] - p[2] == 0).all()
    want, got = run_both("above", compat, p, tm, keys)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert 0.0 < want.mean() < 1.0 and want.std() > 0   # a penumbra
    jc = JConfig(compat=compat, shadow_rays=K, kernels="on")
    pallas = np.stack([np.asarray(f) for f in jshadow.shadow_factors(
        js, jc, tuple(jnp.asarray(c) for c in p), jnp.asarray(tm),
        jnp.asarray(keys), jc.epsilon)])
    assert np.isfinite(pallas).all()
    np.testing.assert_allclose(pallas, want, atol=1e-6, rtol=0)


def test_shadow_tables_match_jax():
    js, ts = scenes("mesh")
    for a, b in zip(jshadow.shadow_tables(js), tshadow.shadow_tables(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tshadow.shadow_tables(ts)[3].numpy(),
        np.asarray(js.mat_transparency[js.mesh_mat]))


def test_points_on_a_mesh_count_the_self_hit_ties():
    """Hit points on the opaque mesh's own triangles (the grazing self-hit
    of the module docstring): equal factors but for counted ties, each a
    whole number of samples."""
    js, ts = scenes("mesh")
    rs = np.random.RandomState(4)
    ids = rs.choice(np.nonzero(np.asarray(js.tri_mesh)[:-1] == 1)[0], N)
    w = rs.dirichlet((1.0, 1.0, 1.0), N).astype(np.float32)
    a, b, c = (np.asarray(t)[ids] for t in (js.tri_a, js.tri_b, js.tri_c))
    p = (w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c).T.astype(np.float32)
    _, tm, keys = floor_points(5)
    want, got = run_both("mesh", "reference", np.ascontiguousarray(p), tm,
                         keys)
    diff = got != want
    assert diff.any(axis=0).mean() < 0.03
    steps = np.abs(got - want)[diff] * K
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-5)


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_shadow_walks_stop_at_the_light(compat):
    """The shadow walk starts with its best t at t_light (the TPU walk's
    per-lane tmax): on the mesh scene's shadow rays it decides `blocked`
    (closest raw hit in [eps, t_light)) exactly as the unbounded walk
    does, returns the unbounded hit wherever that lies below t_light,
    and visits fewer nodes where the light lies between a point and a
    mesh. `shadow_factors_plain`'s per-ray counts add up to its totals,
    and its factors equal the JAX package's."""
    _, ts = scenes("mesh")
    p, tm, keys = floor_points(6)
    # half the points beyond the small light, which then lies between
    # them and the opaque mesh: their walks stop at the light
    rs = np.random.RandomState(7)
    h = N // 2
    p[:, h:] = np.stack([rs.uniform(5.0, 8.0, N - h),
                         rs.uniform(1.9, 2.5, N - h),
                         rs.uniform(0.2, 1.4, N - h)]).astype(np.float32)
    cfg = TConfig(compat=compat, shadow_rays=K)
    tables = tshadow.shadow_tables(ts)
    tree = tshadow.ktraverse.traverse_tables(ts)
    pt = tuple(torch.from_numpy(c) for c in p)
    kt = torch.from_numpy(keys.astype(np.int64))
    light = tables[0]
    rays = [tshadow._sample_rays(
        cfg, light[i], pt, trng.salted(kt, trng.SHADOW_LIGHT_POS, i), k)
        for i in range(light.shape[0]) for k in range(K)]
    so = tuple(torch.cat([r[0][a] for r in rays]) for a in range(3))
    sd = tuple(torch.cat([r[1][a] for r in rays]) for a in range(3))
    tl = torch.cat([r[2] for r in rays])
    live = torch.ones_like(tl, dtype=torch.bool)
    eps = 1e-5
    pruned = 0
    for m in range(ts.mesh_mat.shape[0]):
        free, bound = {}, {}
        t_u, tri_u = tshadow.ktraverse.mesh_walk_plain(ts, so, sd, m, live,
                                                       tree, free)
        t_b, tri_b = tshadow.ktraverse.mesh_walk_plain(ts, so, sd, m, live,
                                                       tree, bound, tmax=tl)
        np.testing.assert_array_equal(((t_b >= eps) & (t_b < tl)).numpy(),
                                      ((t_u >= eps) & (t_u < tl)).numpy())
        below = t_u < tl
        np.testing.assert_array_equal(t_b[below].numpy(), t_u[below].numpy())
        np.testing.assert_array_equal(tri_b[below].numpy(),
                                      tri_u[below].numpy())
        assert (tri_b[~below] == -1).all()
        assert (t_b[~below] == tl[~below]).all()
        pruned += free["visits"] - bound["visits"]
    assert pruned > 0
    cnt = {}
    got = tshadow.shadow_factors_plain(
        ts, cfg, pt, torch.from_numpy(tm), kt, eps,
        torch.ones(N, dtype=torch.bool), tables, tree, cnt)
    L = ts.light_pos.shape[0]
    assert cnt["rays"] == L * K * N
    assert cnt["lane_counts"].shape == (2, L * K * N)
    assert int(cnt["lane_counts"][0].sum()) == cnt["visits"]
    assert int(cnt["lane_counts"][1].sum()) == cnt["tests"]
    want, _ = run_both("mesh", compat, p, tm, keys)
    np.testing.assert_array_equal(got.numpy(), want)
