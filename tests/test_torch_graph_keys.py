"""The compiled entry points keyed as `jax.jit` keys them
(`tracer_torch/render/graphs.py`), on the CPU at 32x18, 3 bounces, 1-4
spp, through the stub cache of tests/test_torch_graphs.py (a "replay"
reruns the body on the graph's static copies):

- **Keys by shape.** A new camera, new scene tensors of the same shapes
  (the same builder compiled again), a new seed, first sample or spp keep
  a frame's key: one capture, every later call a replay, bit-equal to
  the eager body. A new shape, dtype, `requires_grad`, config field,
  width, height, `dark_sky` value or image-sky size is a new key.
- **One sample body.** Frames over 3 cameras x 2 seeds x spp {1, 4} take
  1 capture, each bit-equal to `render_pixels`; one of them, a replay
  with a new camera and seed, against the JAX package's `render_pixels`
  within 2e-5 * spp (its jnp path); the launches of a replay of the
  sample graph times the spp equal the eager frame's.
- **Steps.** A stub-graphed training step on new leaves and on a scene
  compiled again from the same builder, with a new seed, takes 1
  capture; losses, grad norms and gradients bit-equal to the eager
  steps (both backward routes of Cornell).
- **The copy-in rule.** An argument is copied into its static copy when
  it is another tensor (also one at a freed tensor's address) or was
  written in place; the carry always; no body, copy-in included, reads
  the card, and two scenes taking turns keep their host constants.
- **The tables' memo** (`integrator.prepare`). An unchanged scene's
  second `prepare` returns the same tables, which a graphed frame then
  copies in never again; an edit in place (a float, an index, a mesh or a
  light input) or by `dataclasses.replace` (a tensor or another field)
  builds them again, and the next graphed frame is bit-equal to the eager
  frame of a scene compiled afresh with the edit; the last 8 scenes are
  kept; no frame writes a table; a training step whose optimizer writes
  the leaves builds them at every step.
"""

import dataclasses
import gc

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_graphs import (NoUpdate, StubBackend, StubCache,
                                     no_reads)
from tests.test_torch_replay_bwd import port_scene
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch import train as TT
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import shade as kshade
from tracer_torch.render import camera as tcam
from tracer_torch.render import graphs
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene.device import compile_scene as tcompile
from tracer_torch.scenes import zoo as tzoo
from tracer_torch.testing import flamingo_standin, rt_weekend_standin

W, H, B = 32, 18, 3
CFG = TConfig(max_bounces=B)


def cornell():
    """(JAX scene, port scene) of the Cornell box."""
    js = jcompile(jzoo.setup_cornell_box(W / H))
    return js, port_scene(js)


def orbit(k):
    """Camera k of a path around the box: (position, quaternion) as f32
    arrays, each package builds its camera from them."""
    a = 0.15 * k
    pos = np.array([6.1 * np.sin(a), 0.3 * k, 6.1 * np.cos(a)], np.float32)
    q = tcam.look_at_quaternion(pos, (0.0, 0.0, 0.0)).numpy()
    return pos, q.astype(np.float32)


def port_camera(k):
    pos, q = orbit(k)
    return dataclasses.replace(tcam.default_camera(W / H, device="cpu"),
                               position=torch.from_numpy(pos),
                               quaternion=torch.from_numpy(q))


def pids(dtype=torch.int32):
    return torch.arange(W * H, dtype=dtype)


def stub():
    return StubCache(backend=StubBackend())


def eager(ts, cam, spp, seed, first=0, cfg=CFG):
    with torch.no_grad():
        return trenderer.render_pixels(ts, cam, cfg, W, H, pids(), spp,
                                       seed, first)


CHANGES = {   # what the second frame changes: (camera, scene, seed, first, spp)
    "camera": dict(cam=1),
    "scene": dict(recompile=True),
    "seed": dict(seed=7),
    "first_sample": dict(first=4),
    "spp": dict(spp=3),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_frame_replays_for_new_tensors_seed_and_samples(change):
    js, ts = cornell()
    base = dict(cam=0, recompile=False, seed=0, first=0, spp=2)
    cache = stub()
    keys = []
    for kw in (base, dict(base, **CHANGES[change])):
        scene = port_scene(jcompile(jzoo.setup_cornell_box(W / H))) \
            if kw["recompile"] else ts
        cam = port_camera(kw["cam"])
        keys.append(trenderer.frame_key(scene, cam, CFG, W, H, pids()))
        got = trenderer.render_frame(scene, cam, CFG, W, H, pids(),
                                     kw["spp"], kw["seed"], kw["first"],
                                     cache=cache)
        assert torch.equal(got, eager(scene, cam, kw["spp"], kw["seed"],
                                      kw["first"]))
    assert keys[0] == keys[1]
    (g,) = cache.graphs()
    assert cache.captures == 1 and g.replays == 1
    # the first call's first sample is the warm-up, every other a replay
    assert g.runs == base["spp"] - 1 + kw["spp"]


def sky_scene():
    return tcompile(rt_weekend_standin(tzoo, sky_hw=(16, 32),
                                       tex_hw=(16, 32)), device="cpu")


def _written(scene, name, value):
    """`scene` with its scalar `name` a new tensor that was written in
    place to `value`."""
    t = getattr(scene, name).clone()
    t.fill_(value)
    return dataclasses.replace(scene, **{name: t})


DIFFS = {   # (scene maker, change of (scene, pixel ids, cfg, width, height))
    "shape": lambda s, p, c, w, h: (s, p[:100], c, w, h),
    "dtype": lambda s, p, c, w, h: (s, p.to(torch.int64), c, w, h),
    "requires_grad": lambda s, p, c, w, h: (dataclasses.replace(
        s, mat_diffuse=s.mat_diffuse.clone().requires_grad_(True)), p, c,
        w, h),
    "cfg": lambda s, p, c, w, h: (s, p, dataclasses.replace(
        c, compat="physical"), w, h),
    "width": lambda s, p, c, w, h: (s, p, c, w + 1, h),
    "height": lambda s, p, c, w, h: (s, p, c, w, h + 1),
    "dark_sky": lambda s, p, c, w, h: (_written(
        s, "dark_sky", 1.0 - float(s.dark_sky)), p, c, w, h),
    "sky_size": lambda s, p, c, w, h: (_written(
        s, "sky_w", int(s.sky_w) // 2), p, c, w, h),
}


@pytest.mark.parametrize("diff", sorted(DIFFS))
def test_frame_key_differs(diff):
    ts = sky_scene() if diff == "sky_size" else cornell()[1]
    assert ts.has_sky_image == (diff == "sky_size")
    cam = port_camera(0)
    k0 = trenderer.frame_key(ts, cam, CFG, W, H, pids())
    s, p, c, w, h = DIFFS[diff](ts, pids(), CFG, W, H)
    assert trenderer.frame_key(s, cam, c, w, h, p) != k0
    # the same change made again is the same key
    assert trenderer.frame_key(s, cam, c, w, h, p) == \
        trenderer.frame_key(s, cam, c, w, h, p.clone())


def test_camera_path_seeds_and_spp_one_capture():
    _, ts = cornell()
    cache = stub()
    n = 0
    for k in range(3):
        cam = port_camera(k)
        for seed in (0, 1):
            for spp in (1, 4):
                got = trenderer.render_frame(ts, cam, CFG, W, H, pids(), spp,
                                             seed, cache=cache)
                assert torch.equal(got, eager(ts, cam, spp, seed)), \
                    (k, seed, spp)
                n += 1
    (g,) = cache.graphs()
    assert cache.captures == 1 and g.replays == n - 1
    assert g.runs == 3 * 2 * (1 + 4) - 1


def test_graphed_frame_with_new_camera_and_seed_matches_jax():
    js, ts = cornell()
    cache = stub()
    spp, seed, k = 4, 3, 2
    trenderer.render_frame(ts, port_camera(0), CFG, W, H, pids(), 1, 0,
                           cache=cache)
    got = trenderer.render_frame(ts, port_camera(k), CFG, W, H, pids(), spp,
                                 seed, cache=cache).numpy()
    assert cache.captures == 1 and cache.graphs()[0].replays == 1
    pos, q = orbit(k)
    jc = dataclasses.replace(jcam.default_camera(W / H),
                             position=jnp.asarray(pos),
                             quaternion=jnp.asarray(q))
    want = np.asarray(jrenderer.render_pixels(
        js, jc, JConfig(max_bounces=B, kernels="off"), W, H,
        jnp.arange(W * H, dtype=jnp.int32), spp, jax.random.key(seed)))
    np.testing.assert_allclose(got, want, atol=2e-5 * spp, rtol=0)
    assert got.max() > 0.0


STEPS = {   # trainables, config
    "hand_written": (["mat_diffuse", "sph_center", "cam_quaternion"], CFG),
    "plain_ad": (["mat_diffuse", "sph_center"],
                 dataclasses.replace(CFG, custom_vjp="off")),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_step_replays_for_new_leaves_and_scene(case):
    trainable, cfg = STEPS[case]
    spp = 1
    target = torch.from_numpy(np.random.RandomState(0).rand(
        H, W, 3).astype(np.float32))
    runs = []
    for cache in (None, stub()):
        _, ts = cornell()
        cam = port_camera(0)
        params = TT.split_params(ts, cam, trainable)
        opt = TT._adam_default(1e-2)([params[k] for k in sorted(params)])
        step = TT.make_step(opt, cfg, target, W, H, spp, cache=cache)
        out = []
        for i in range(2):   # Adam writes the leaves in place between
            loss, gnorm = step(params, ts, cam, pids(), i)
            out.append((loss, gnorm, [params[k].grad.clone()
                                      for k in sorted(params)]))
        # new leaves on a scene compiled again from the same builder
        _, ts2 = cornell()
        params2 = TT.split_params(ts2, cam, trainable)
        step2 = TT.make_step(NoUpdate(), cfg, target, W, H, spp,
                             cache=cache)
        loss, gnorm = step2(params2, ts2, cam, pids(), 5)
        out.append((loss, gnorm, [params2[k].grad.clone()
                                  for k in sorted(params2)]))
        runs.append(out)
    assert cache.captures == 1 and len(cache) == 1
    assert cache.graphs()[0].replays == 2
    for (l0, g0, d0), (l1, g1, d1) in zip(*runs):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
        assert all(torch.equal(a, b) for a, b in zip(d0, d1))
    assert float(runs[0][0][1]) > 0.0


def test_bodies_and_copy_in_read_nothing(monkeypatch):
    _, ts = cornell()
    _, ts2 = cornell()
    cams = [port_camera(k) for k in range(2)]
    cache = stub()
    params = TT.split_params(ts, cams[0], ["mat_diffuse", "sph_center"])
    step = TT.make_step(NoUpdate(), CFG, torch.zeros(H, W, 3), W, H, 2,
                        cache=cache)
    for s in (ts, ts2):   # the entry points read these before a capture
        tintegrator.host_constants(s)
    with no_reads(monkeypatch):
        for i, (s, cam, spp) in enumerate(((ts, cams[0], 2),
                                           (ts2, cams[1], 3))):
            trenderer.render_frame(s, cam, CFG, W, H, pids(), spp, i,
                                   first_sample=i, cache=cache)
        for i in range(2):
            step(params, ts, cams[0], pids(), i)
            with torch.no_grad():   # an update in place: copied in
                for p in params.values():
                    p.mul_(1.01)
    assert cache.captures == 2
    assert [g.replays for g in cache.graphs()] == [1, 1]


def test_host_constants_of_scenes_taking_turns(monkeypatch):
    """Two scenes of the same shapes in turns (a graph serves both) read
    their host constants once each, not at every call."""
    scenes = [cornell()[1] for _ in range(2)]
    want = [tintegrator.host_constants(s) for s in scenes]
    with no_reads(monkeypatch):
        for _ in range(3):
            for s, w in zip(scenes, want):
                assert tintegrator.host_constants(s) == w
                tintegrator.prepare(s)


def table_counts():
    return tintegrator.TABLE_BUILDS, tintegrator.TABLE_REUSES


def port_cornell():
    """The Cornell box with a small light under its ceiling, so that its
    walls' colours reach most pixels at 3 bounces."""
    sb = tzoo.setup_cornell_box(W / H)
    sb.add_light((0.0, 1.5, 0.5), radius=0.3, color=(1.0, 1.0, 1.0))
    return tcompile(sb, device="cpu")


def small_flamingo():
    return tcompile(flamingo_standin(tzoo, n_tris=600), device="cpu")


def written(name, op):
    """The edit that writes the scene's tensor `name` in place by `op`."""
    def edit(scene):
        op(getattr(scene, name))
        return scene
    return edit


EDITS = {   # (scene maker, the edit: the scene after it)
    "mat_diffuse": (port_cornell, written("mat_diffuse",
                                          lambda t: t.mul_(0.5))),
    "quad_mat": (port_cornell, written("quad_mat",
                                       lambda t: t.copy_(t.roll(1)))),
    "mesh_verts": (small_flamingo, written("mesh_verts",
                                           lambda t: t.add_(0.05))),
    "light_pos": (sky_scene, written("light_pos", lambda t: t.add_(0.3))),
    "replace_tensor": (port_cornell, lambda s: dataclasses.replace(
        s, sph_center=s.sph_center + 0.1)),
    "replace_field": (sky_scene, lambda s: dataclasses.replace(
        s, sphere_uv_needed=False)),
}


def test_prepare_reuses_an_unchanged_scenes_tables():
    """A second `prepare` of an unchanged scene returns the same table
    tensors, and a second graphed frame copies none of them in."""
    ts = port_cornell()
    first = tintegrator.prepare(ts)
    b, r = table_counts()
    again = tintegrator.prepare(ts)
    assert table_counts() == (b, r + 1)
    assert again is first
    cache = stub()
    for k in range(2):
        trenderer.render_frame(ts, port_camera(k), CFG, W, H, pids(), 1, k,
                               cache=cache)
        if k == 0:
            (g,) = cache.graphs()
            stamps = list(g.stamps)
    assert g.replays == 1
    args = trenderer._frame_args(ts, port_camera(1), pids(), 1)
    unique = graphs.key_of((), args)[1]
    table_ids = {id(t) for t in graphs.tensors(first)}
    scene_ids = {id(t) for t in graphs.tensors(ts)}
    at = [i for i, t in enumerate(unique) if id(t) in table_ids]
    assert len(at) == len(table_ids) >= 4
    assert all(g.stamps[i] is stamps[i] for i in at)
    # the scene's tensors stay too; the camera and pixel ids are new
    assert all(g.stamps[i] is stamps[i] for i, t in enumerate(unique)
               if id(t) in scene_ids)
    assert any(g.stamps[i] is not stamps[i] for i in range(len(unique)))


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_an_edited_scene_builds_its_tables_again(edit):
    """An edit in place or by `dataclasses.replace` builds the tables
    again, and the next graphed frame is the eager frame of a scene
    compiled afresh with the same edit, bit for bit."""
    make, change = EDITS[edit]
    scene, cam, cache = make(), port_camera(0), stub()
    for _ in range(2):
        before = trenderer.render_frame(scene, cam, CFG, W, H, pids(), 2, 0,
                                        cache=cache)
    scene = change(scene)
    b, r = table_counts()
    got = trenderer.render_frame(scene, cam, CFG, W, H, pids(), 2, 0,
                                 cache=cache)
    assert table_counts() == (b + 1, r)
    assert torch.equal(got, eager(change(make()), cam, 2, 0))
    assert not torch.equal(got, before)


def test_table_memo_keeps_the_last_eight_scenes():
    """Two scenes taking turns build their tables once each; a ninth
    scene evicts the least recently used."""
    ts = port_cornell()
    scenes = [dataclasses.replace(ts, mat_diffuse=ts.mat_diffuse.clone())
              for _ in range(9)]
    b, r = table_counts()
    for _ in range(3):
        for s in scenes[:2]:
            tintegrator.prepare(s)
    assert table_counts() == (b + 2, r + 4)
    for s in scenes[2:]:
        tintegrator.prepare(s)
    assert table_counts() == (b + 9, r + 4)
    tintegrator.prepare(scenes[1])
    assert table_counts() == (b + 9, r + 5)
    tintegrator.prepare(scenes[0])
    assert table_counts() == (b + 10, r + 5)


@pytest.mark.parametrize("make", [port_cornell, small_flamingo, sky_scene],
                         ids=["cornell", "flamingo", "sky"])
def test_frames_write_no_table(make):
    """No frame, graphed or eager, writes a table in place: what makes
    their reuse sound."""
    scene = make()
    tables = tintegrator.prepare(scene)
    versions = [t._version for t in graphs.tensors(tables)]
    cache = stub()
    for k in range(2):
        trenderer.render_frame(scene, port_camera(k), CFG, W, H, pids(), 2,
                               k, cache=cache)
    eager(scene, port_camera(0), 2, 0)
    assert tintegrator.prepare(scene) is tables
    assert [t._version for t in graphs.tensors(tables)] == versions


def test_training_steps_build_their_tables_every_step():
    """A step whose optimizer writes the leaves in place builds the
    tables at every step; with no update the next step reuses them."""
    ts, cam = port_cornell(), port_camera(0)
    target = torch.zeros(H, W, 3)
    params = TT.split_params(ts, cam, ["mat_diffuse", "sph_center"])
    opt = TT._adam_default(1e-2)([params[k] for k in sorted(params)])
    cache = stub()
    adam, keep = (TT.make_step(u, CFG, target, W, H, 1, cache=cache)
                  for u in (opt, NoUpdate()))
    # the last Adam update is the keeping step's first change
    for i, (step, grew) in enumerate([(adam, (1, 0))] * 3 + [
            (keep, (1, 0)), (keep, (0, 1))]):
        b, r = table_counts()
        step(params, ts, cam, pids(), i)
        assert table_counts() == (b + grew[0], r + grew[1]), i
    assert cache.captures == 1


def counting(module, fn):
    def wrapped(*a, **k):
        module.LAUNCHES += 1
        return fn(*a, **k)
    return wrapped


def test_launches_of_a_sample_replay_times_spp(monkeypatch):
    """On the CPU the wrappers run their plain versions and count nothing;
    here they count each call, as on the card each launch."""
    for m, name in ((kintersect, "first_hits"), (kshade, "shade_scatter")):
        monkeypatch.setattr(m, name, counting(m, getattr(m, name)))
    for m in graphs.COUNTED.values():
        monkeypatch.setattr(m, "LAUNCHES", 0)
    _, ts = cornell()
    cam = port_camera(0)
    cache = stub()
    per_sample = dict(first_hits=B, shade_scatter=B)
    for spp in (2, 1, 4):
        for c in (None, cache):
            before = graphs.launch_counts()
            if c is None:
                eager(ts, cam, spp, 0)
            else:
                trenderer.render_frame(ts, cam, CFG, W, H, pids(), spp, 0,
                                       cache=c)
            after = graphs.launch_counts()
            grew = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            assert grew == {k: n * spp for k, n in per_sample.items()}, \
                (spp, c)
    (g,) = cache.graphs()
    assert g.launches == per_sample and g.runs == 2 + 1 + 4 - 1


def test_copy_in_rule():
    cache = stub()

    def body(x, y, acc, idx):
        acc += x * idx + y
        idx += 1
        return acc

    def run(x, y, steps=3, first=1):
        return cache.call(("toy",), body, (x, y),
                          carry=(torch.zeros(4), torch.tensor(first)),
                          steps=steps)

    def want(x, y, steps=3, first=1):
        return sum(x * i + y for i in range(first, first + steps))

    x, y = torch.arange(4.0), torch.ones(4)
    assert torch.equal(run(x, y), want(x, y))
    (g,) = cache.graphs()
    sx, sy = g.inputs
    # written in place: copied in; the same tensor unchanged: not copied
    x.mul_(2.0)
    stamp_y = g.stamps[1]
    assert torch.equal(run(x, y, steps=2, first=0), want(x, y, 2, 0))
    assert torch.equal(sx, x) and g.stamps[1] is stamp_y
    # another tensor after the last one was freed (it may take the same
    # address, at the same version 0): copied
    del x
    gc.collect()
    x2 = torch.full((4,), 5.0)
    assert x2._version == 0
    assert torch.equal(run(x2, y), want(x2, y))
    # one tensor given twice is one static copy; the aliasing is in the key
    assert torch.equal(run(y, y), want(y, y))
    assert cache.captures == 2 and len(cache.graphs()[1].inputs) == 1
    with pytest.raises(ValueError):
        run(x2, y, steps=0)
