"""The compiled routes beyond the Cornell family (`render/graphs.py`): the
general training step (the replay's vjp: image sky, lights, meshes,
texels), the plain autodiff step (`custom_vjp="off"`), the occupancy frame
of `benchmark --occupancy` and the sharded frame and step, on the CPU at
32x18, 3 bounces, 2 spp.

A capture runs on the card only
(`tests/test_torch_card_routes.py::test_graph_general_*` holds each
replay bit-equal to its eager body there); here the CPU runs what
decides whether a capture can work:

- **Sync-free bodies.** Each body runs through a stub cache (its key,
  warm-up and "capture") with every read of a tensor's values to the host
  patched to raise (`tests/test_torch_graphs.py::no_reads`), after the
  scene's host constants were read, as the entry points read them before a
  capture: the general step on `testing.rt_weekend_standin` (image sky,
  texels, 3 lights) and on a lit 288-triangle stand-in mesh, the plain
  autodiff step on Cornell and on rt_weekend_standin, and the occupancy
  frame on rt_weekend_standin. The replay's image-sky size comes from the
  forward (`_TraceRecordReplay`'s ctx), not from a read of the card. The
  plain BVH walk alone may read (its lockstep loop): on the card it is
  B5's and B6's kernel.
- **The rule.** `graphs.GraphCache.active`, which the steps and the
  sharded frame read, takes a graph on CUDA tensors whatever the scene
  and `custom_vjp`; not on CPU tensors, with `kernels="off"`, inside
  `disabled()` or over a gloo mesh (a one-rank gloo group in this
  process).
- **Replays equal the eager steps.** Through the stub cache, 3 `fit`
  steps on rt_weekend_standin (the general backward), 3 plain autodiff
  steps and 3 sharded steps on the (1, 1) mesh equal the eager steps bit
  for bit (losses, grad norms, params and the checkpoint's Adam state);
  and a replayed general step's gradients equal `jax.grad` of the JAX
  package's loss on the same scene, run op by op (`jax.disable_jit`, as
  tests/test_torch_general_bwd.py runs `jax.vjp`), within that file's
  tolerance: rtol 1e-4, atol 1e-4 * max|g| per leaf.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_graphs import (READS, NoUpdate, StubBackend,
                                     StubCache, no_reads)
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch import cli as tcli
from tracer_torch import train as TT
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.dist import launch, sharding
from tracer_torch.kernels import traverse as ktraverse
from tracer_torch.render import camera as tcam
from tracer_torch.render import graphs
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import replay_bwd as trb
from tracer_torch.scene import device as tdevice
from tracer_torch.scene.builder import Material, MeshObject, SceneBuilder
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo as tzoo
from tracer_torch.testing import rt_weekend_standin, standin_mesh

W, H, SPP, B, K = 32, 18, 2, 3, 2
RTW_TRAIN = ["mat_diffuse", "sph_center", "tex_data"]
TENSOR_READS = {name: getattr(torch.Tensor, name) for name in READS}


def reads_allowed(fn):
    """`fn` with the reads of the card allowed while it runs: the plain
    BVH walk (`traverse.mesh_walk_plain`, whose lockstep loop reads
    whether a lane still walks), which on the card is B5's kernel (and
    B6's walk) and reads nothing there."""
    def wrapped(*args, **kwargs):
        refused = {name: getattr(torch.Tensor, name) for name in READS}
        for name, f in TENSOR_READS.items():
            setattr(torch.Tensor, name, f)
        try:
            return fn(*args, **kwargs)
        finally:
            for name, f in refused.items():
                setattr(torch.Tensor, name, f)
    return wrapped


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def rtw_builder(zoo):
    return rt_weekend_standin(zoo, sky_hw=(16, 32), tex_hw=(16, 32))


def lit_mesh():
    """A 288-triangle stand-in facing the camera, one light, a floor."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((1., 4., 4.), radius=1.0, color=(1.0, 1.0, 1.0))
    verts, tris, colors = standin_mesh(300, seed=2)
    m = MeshObject(verts, tris, vert_colors=colors,
                   material=Material(diffuse=(0.5, 0.5, 0.5)))
    m.scale((2.6,) * 3).rotate_y(90).translate((0., 0., 1.))
    sb.add_mesh(m)
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return compile_scene(sb, device="cpu")


SCENES = {
    "rt_weekend": lambda: compile_scene(rtw_builder(tzoo), device="cpu"),
    "lit_mesh": lit_mesh,
    "cornell": lambda: compile_scene(tzoo.setup_cornell_box(W / H),
                                     device="cpu"),
}


def camera():
    return tcam.default_camera(W / H, device="cpu")


def pids():
    return torch.arange(W * H, dtype=torch.int32)


def config(**kw):
    return TConfig(max_bounces=B, shadow_rays=K, **kw)


def target():
    return torch.from_numpy(np.random.RandomState(0).rand(
        H, W, 3).astype(np.float32))


def stub_cache(monkeypatch):
    """A stub cache as the process's cache (`graphs.CACHE`), which `fit`,
    `make_step`, the CLI's frame and the sharded route take."""
    cache = StubCache(backend=StubBackend())
    monkeypatch.setattr(graphs, "CACHE", cache)
    return cache


STEPS = {   # scene, trainables, custom_vjp
    "general_rt_weekend": ("rt_weekend", RTW_TRAIN, "on"),
    "general_lit_mesh": ("lit_mesh", ["mesh_verts", "mat_diffuse"], "on"),
    "plain_ad_cornell": ("cornell", ["mat_diffuse", "sph_center"], "off"),
    "plain_ad_rt_weekend": ("rt_weekend", ["mat_diffuse", "sph_center"],
                            "off"),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_step_bodies_read_nothing_from_the_card(monkeypatch, case):
    name, trainable, custom_vjp = STEPS[case]
    scene, cam = SCENES[name](), camera()
    cfg = TT.guard_config(config(custom_vjp=custom_vjp), trainable)
    assert not trb.hand_bwd_ok(scene, cfg) or custom_vjp == "off"
    cache = stub_cache(monkeypatch)
    params = TT.split_params(scene, cam, trainable)
    step = TT.make_step(NoUpdate(), cfg, torch.zeros(H, W, 3), W, H, SPP)
    tintegrator.host_constants(scene)
    monkeypatch.setattr(ktraverse, "mesh_walk_plain",
                        reads_allowed(ktraverse.mesh_walk_plain))
    with no_reads(monkeypatch):
        for _ in range(2):   # warm-up and capture, then a replay
            loss, gnorm = step(params, scene, cam, pids(), 0)
    assert len(cache) == 1 and cache.graphs()[0].replays == 1
    assert float(gnorm) > 0.0 and float(loss) > 0.0
    for k, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k


def test_occupancy_frame_reads_nothing_from_the_card(monkeypatch):
    scene, cam, cfg = SCENES["rt_weekend"](), camera(), config()
    assert scene.has_sky_image
    rays = tcli.benchmark_rays(cam, cfg, W, H, pids())
    tables = tintegrator.prepare(scene)
    want = tcli.occupancy_frame(scene, cfg, *rays, tables)
    cache = stub_cache(monkeypatch)
    with no_reads(monkeypatch):
        got = [tcli.occupancy_frame(scene, cfg, *rays, tables)
               for _ in range(2)]
    assert len(cache) == 1 and cache.graphs()[0].replays == 1
    for mean, occ in got:
        assert torch.equal(mean, want[0]) and torch.equal(occ, want[1])
    assert want[1].shape == (B,) and float(want[1][0]) == 1.0


@pytest.fixture
def gloo_mesh():
    """The (1, 1) mesh of a one-rank gloo group in this process."""
    port = launch.free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield sharding.make_ray_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_the_graph_rule(monkeypatch, gloo_mesh):
    pid = pids()
    groupless = sharding.RayMesh({"dp": 1, "sp": 1})
    assert gloo_mesh.group is not None
    assert groupless.capturable and not gloo_mesh.capturable
    # CPU tensors: the process's cache is not active
    for custom_vjp in ("on", "off"):
        assert not graphs.CACHE.active(pid, config(custom_vjp=custom_vjp))
    cache = stub_cache(monkeypatch)
    for custom_vjp in ("on", "off"):
        cfg = config(custom_vjp=custom_vjp)
        assert cache.active(pid, cfg)
        assert cache.active(pid, cfg, groupless)
        assert not cache.active(pid, cfg, gloo_mesh)
        assert not cache.active(pid, config(custom_vjp=custom_vjp,
                                            kernels="off"))
        with cache.disabled():
            assert not cache.active(pid, cfg)
    # the sharded frame: graphed without grad on a mesh without gloo,
    # eager under grad, over gloo and inside disabled()
    scene, cam, cfg = SCENES["cornell"](), camera(), config()
    want = sharding.sharded_sum(scene, cam, cfg, W, H, pid, SPP, 0,
                                groupless)
    assert len(cache) == 0   # grad mode on: eager
    with torch.no_grad():
        for mesh in (gloo_mesh, groupless):
            got = sharding.sharded_sum(scene, cam, cfg, W, H, pid, SPP, 0,
                                       mesh)
            assert torch.equal(got, want)
        with cache.disabled():
            sharding.sharded_sum(scene, cam, cfg, W, H, pid, SPP, 0,
                                 groupless)
    # the sharded frame is the frame's graph of one sample, run once a
    # sample of the rank's block (the sp sum's all-reduce follows it)
    (g,) = cache.graphs()
    assert g.key[0] == "frame" and g.replays == 0 and g.runs == SPP - 1


def ckpt_leaves(d):
    with np.load(os.path.join(d, "train.npz")) as z:
        return {k: z[k] for k in z.files}


FITS = {   # scene, trainables, config, mesh
    "general_rt_weekend": ("rt_weekend", RTW_TRAIN, {}, False),
    "plain_ad_cornell": ("cornell", ["mat_diffuse", "sph_center"],
                         dict(custom_vjp="off"), False),
    "sharded_cornell": ("cornell", ["mat_diffuse", "sph_center"], {}, True),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_stub_graphed_fit_equals_eager(monkeypatch, tmp_path, case):
    name, trainable, kw, sharded = FITS[case]
    scene, cam = SCENES[name](), camera()
    mesh = sharding.RayMesh({"dp": 1, "sp": 1}) if sharded else None
    runs = {}
    for run in ("eager", "compiled"):
        with monkeypatch.context() as m:
            if run == "compiled":
                cache = StubCache(backend=StubBackend())
                m.setattr(graphs, "CACHE", cache)
            d = str(tmp_path / run)
            s1, c1, hist = TT.fit(scene, cam, config(**kw), target(),
                                  trainable, steps=3, lr=1e-2, width=W,
                                  height=H, nsamples=SPP, seed=0,
                                  ckpt_dir=d, ckpt_every=3, mesh=mesh)
        runs[run] = (hist, TT.split_params(s1, c1, trainable),
                     ckpt_leaves(d))
    (g,) = cache.graphs()
    assert g.key[0] == "step" and g.replays == 2
    (ha, pa, la), (hb, pb, lb) = runs["eager"], runs["compiled"]
    assert [(h["loss"], h["grad_norm"]) for h in ha] == [
        (h["loss"], h["grad_norm"]) for h in hb]
    assert ha[0]["grad_norm"] > 0.0
    for k in trainable:
        assert torch.equal(pa[k], pb[k]), k
    assert sorted(la) == sorted(lb)
    for k in la:   # params, Adam's count, first and second moments
        assert np.array_equal(la[k], lb[k]), k


def test_replayed_general_step_matches_jax(monkeypatch):
    """The second call of a stubbed general step on rt_weekend_standin (a
    replay) against `jax.grad` of the JAX package's loss, op by op."""
    js = jcompile(rtw_builder(jzoo))
    ts = port_scene(js)
    tgt = target()
    cfg = TT.guard_config(config(), RTW_TRAIN)
    assert not trb.hand_bwd_ok(ts, cfg)
    cache = stub_cache(monkeypatch)
    cam = camera()
    params = TT.split_params(ts, cam, RTW_TRAIN)
    step = TT.make_step(NoUpdate(), cfg, tgt, W, H, SPP)
    for _ in range(2):
        step(params, ts, cam, pids(), 0)
    assert cache.graphs()[0].replays == 1

    jcfg = JConfig(max_bounces=B, shadow_rays=K, kernels="off",
                   packed_atlas="off")
    jpid = jnp.arange(W * H, dtype=jnp.int32)
    jtgt = jnp.asarray(tgt.numpy().reshape(-1, 3))

    def loss(*leaves):
        s2 = dataclasses.replace(js, **dict(zip(RTW_TRAIN, leaves)))
        acc = sum(jrenderer._render_batch(
            s2, jcam.default_camera(W / H), jcfg, W, H, jpid, jnp.int32(s),
            jax.random.key(0)) for s in range(SPP))
        return jnp.mean((acc / SPP - jtgt) ** 2)

    with jax.disable_jit():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(getattr(js, k) for k in RTW_TRAIN))
    for k, w in zip(RTW_TRAIN, want):
        w = np.asarray(w, np.float64)
        got = params[k].grad.numpy().astype(np.float64).reshape(w.shape)
        assert np.isfinite(got).all(), k
        assert np.abs(got).max() > 0.0, k
        np.testing.assert_allclose(got, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
