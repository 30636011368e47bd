"""The compiled entry points (`tracer_torch/render/graphs.py`) on the CPU.

A CUDA graph is captured and replayed on the card only
(`tests/test_torch_card_routes.py::test_graph_*` holds the replays
bit-equal to the eager bodies there);
here the CPU runs what decides whether a capture can work and what the
cache does around it:

- **Sync-free bodies.** A capture refuses every read of the card. The
  frame body (`renderer.render_frame`) and the Cornell training step's body
  (`train.make_step`) run at 32x18 with `Tensor.item`, `__float__`,
  `__int__`, `__index__`, `__bool__`, `tolist`, `numpy` and `cpu` patched
  to raise, after the host constants were read (as the entry points read
  them before a capture): any read left in a body fails here.
- **The key.** The arguments enter by shape: new tensors of the same
  shapes (scene, camera, pixel ids), a new seed, spp or first sample keep
  the key (one graph); a new shape, config, `requires_grad` or `dark_sky`
  value gives another.
- **The split `prepare`.** `integrator.prepare`'s tables equal the JAX
  package's, its host constants the JAX scene's scalars; and the hand-written
  sweep, which takes `dark_sky` from `_TraceRecordReplay`'s ctx, gives
  `jax.vjp`'s gradient on the same scene, rays and keys (the tolerance of
  tests/test_torch_replay_bwd.py) with every read of the card refused
  during the backward.
- **Launch counts.** The capture-and-replay bookkeeping with a stub graph:
  the warm-up's launches count, the capture's are taken back, each replay
  adds the capture's increase; a failed capture raises and caches nothing;
  the cache evicts the least recently used graph. Through the stub, the
  frame and three training steps equal the eager ones bit for bit.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_replay_bwd import phase1_builder, port_scene, rays
from tracer.core import rng as jrng
from tracer.core.config import RenderConfig as JConfig
from tracer.kernels import intersect as jint
from tracer.kernels import shade as jshade
from tracer.render import integrator as jintegrator
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch import train as TT
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.kernels import intersect as tint
from tracer_torch.kernels import shade as tshade
from tracer_torch.render import camera as tcam
from tracer_torch.render import graphs
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.render import replay_bwd as trb
from tracer_torch.testing import fill_cornell_textures, rt_weekend_standin

W, H, SPP, B = 32, 18, 2, 3
READS = ("item", "__float__", "__int__", "__index__", "__bool__", "tolist",
         "numpy", "cpu")


@contextlib.contextmanager
def no_reads(monkeypatch):
    """Every read of a tensor's values to the host raises inside."""
    with monkeypatch.context() as m:
        for name in READS:
            def refuse(self, *a, _name=name, **k):
                raise AssertionError(f"Tensor.{_name}: a read of the card")
            m.setattr(torch.Tensor, name, refuse)
        yield


def cornell(textured=False):
    sb = jzoo.setup_cornell_box(W / H)
    if textured:
        sb = fill_cornell_textures(sb)
    js = jcompile(sb)
    return js, port_scene(js)


def camera():
    return tcam.default_camera(W / H, device="cpu")


def pids():
    return torch.arange(W * H, dtype=torch.int32)


class NoUpdate:
    """An optimizer that updates nothing: the step's body alone."""

    def zero_grad(self, set_to_none=True):
        pass

    def step(self):
        pass


@pytest.mark.parametrize("textured", [False, True])
def test_bodies_read_nothing_from_the_card(monkeypatch, textured):
    _, ts = cornell(textured)
    cam = camera()
    cfg = TConfig(max_bounces=B)
    tintegrator.host_constants(ts)
    with no_reads(monkeypatch):
        img = trenderer.render_frame(ts, cam, cfg, W, H, pids(), SPP, 0)
    assert img.shape == (W * H, 3) and bool(torch.isfinite(img).all())
    trainable = ["mat_diffuse", "sph_center", "cam_quaternion"]
    if textured:   # texels train on the exact atlas (train.guard_config)
        trainable += ["tex_data"]
    tcfg = TT.guard_config(cfg, trainable)
    params = TT.split_params(ts, cam, trainable)
    assert trb.hand_bwd_ok(ts, tcfg)
    step = TT.make_step(NoUpdate(), tcfg, torch.zeros(H, W, 3), W, H, SPP)
    with no_reads(monkeypatch):
        loss, gnorm = step(params, ts, cam, pids(), 0)
    assert float(gnorm) > 0.0 and float(loss) > 0.0
    for k, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k


def test_frame_key():
    _, ts = cornell()
    cam, cfg = camera(), TConfig(max_bounces=B)
    pid = pids()

    def key(scene=ts, camera=cam, cfg=cfg, pid=pid):
        return trenderer.frame_key(scene, camera, cfg, W, H, pid)

    k0 = key()
    assert key() == k0 and hash(key()) == hash(k0)
    # the arguments enter by shape: new pixel ids, scene and camera
    # tensors of the same shapes are the same key
    assert key(pid=pid.clone()) == k0
    md = ts.mat_diffuse.clone()
    assert key(scene=dataclasses.replace(ts, mat_diffuse=md)) == k0
    assert key(camera=dataclasses.replace(
        cam, position=cam.position.clone())) == k0
    # the seed, the spp and the first sample are not in it: one graph
    cache = StubCache(backend=StubBackend())
    for seed, first, spp in ((0, 0, SPP), (1, 0, SPP), (0, 4, SPP),
                             (0, 0, 1)):
        trenderer.render_frame(ts, cam, cfg, W, H, pid, spp, seed, first,
                               cache=cache)
    assert len(cache) == 1 and cache.captures == 1
    # a new shape, config, or a tensor that requires grad: another key
    assert key(pid=pid[:100]) != k0
    assert key(cfg=dataclasses.replace(cfg, max_bounces=4)) != k0
    assert key(cfg=dataclasses.replace(cfg, compat="physical")) != k0
    assert key(scene=dataclasses.replace(
        ts, sky_data=ts.sky_data.repeat(2, 1))) != k0
    assert key(scene=dataclasses.replace(
        ts, mat_diffuse=ts.mat_diffuse.detach().requires_grad_(True))) != k0
    # dark_sky: a new tensor of the same value is the same key, a new value
    # written in place another (a host constant, in the key by value)
    dark = ts.dark_sky.clone()
    s1 = dataclasses.replace(ts, dark_sky=dark)
    k1 = key(scene=s1)
    assert k1 == k0 and key(scene=s1) == k1
    dark.fill_(1.0 - float(dark))
    assert key(scene=s1) != k1
    assert tintegrator.host_constants(s1).dark_sky == float(dark)


def test_prepare_split_matches_jax():
    for js, ts in (cornell(True), (
            lambda j: (j, port_scene(j)))(jcompile(rt_weekend_standin(
                jzoo, sky_hw=(16, 32), tex_hw=(16, 32))))):
        host = tintegrator.host_constants(ts)
        assert host.dark_sky == float(js.dark_sky)
        assert host.sky_wh == ((int(js.sky_w), int(js.sky_h))
                               if js.has_sky_image else None)
        tables = tintegrator.prepare(ts)
        jsph, jquad, _ = jint.intersect_tables(js)
        np.testing.assert_array_equal(tables.intersect[0].numpy(),
                                      np.asarray(jsph))
        np.testing.assert_array_equal(tables.intersect[1].numpy(),
                                      np.asarray(jquad))
        mat, light, dark = tables.shade
        np.testing.assert_array_equal(
            mat.numpy(), np.asarray(jshade.shade_mat_table(js)))
        np.testing.assert_array_equal(
            light.numpy(), np.asarray(jshade._light_table(js)))
        assert dark == host.dark_sky and tables.sky == host.sky_wh


def test_sweep_takes_dark_sky_from_the_forward(monkeypatch):
    sb = phase1_builder()
    sb.dark_sky = False   # the procedural sky: dark_sky has a gradient
    js = jcompile(sb)
    ts = port_scene(js)
    assert trb.hand_bwd_ok(ts, TConfig())
    n = 32
    o, d, tm = rays(n, seed=0)
    g = np.random.RandomState(5).normal(size=(n, 3)).astype(np.float32)
    fields = ("mat_diffuse", "sph_center", "quad_v0", "dark_sky")
    jcfg = JConfig(max_bounces=B, kernels="off")
    jkeys = jrng.ray_keys(jax.random.key(11), jnp.arange(n, dtype=jnp.int32))
    jo = jnp.asarray(np.stack([c.numpy() for c in o], -1))
    jd = jnp.asarray(np.stack([c.numpy() for c in d], -1))

    def f(*params):
        s2 = dataclasses.replace(js, **dict(zip(fields, params)))
        return jintegrator.trace(s2, jcfg, jo, jd, jnp.asarray(tm.numpy()),
                                 jkeys)

    _, vjp = jax.vjp(f, *(getattr(js, k) for k in fields))
    want = vjp(jnp.asarray(g))
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in fields}
    out = tintegrator.trace(dataclasses.replace(ts, **leaves),
                            TConfig(max_bounces=B), o, d, tm,
                            trng.ray_keys(11, torch.arange(n)))
    with no_reads(monkeypatch):
        out.backward(torch.from_numpy(g))
    for k, w in zip(fields, want):
        w = np.asarray(w, np.float64)
        got = leaves[k].grad.numpy().astype(np.float64).reshape(w.shape)
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(got, w, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=k)
    assert np.abs(leaves["dark_sky"].grad.numpy()).max() > 0.0


class StubGraph:
    """What a captured graph does, on the CPU: a replay recomputes the body
    on the static inputs into the static outputs, launching nothing that
    counts."""

    def __init__(self, body, inputs, outputs):
        self.body, self.inputs, self.outputs = body, inputs, outputs
        self.replays = 0

    def replay(self):
        before = graphs.launch_counts()
        new = self.body(*self.inputs)
        for k, m in graphs.COUNTED.items():
            m.LAUNCHES = before[k]
        for s, t in zip(_leaves(self.outputs), _leaves(new)):
            s.copy_(t)
        self.replays += 1


def _leaves(x):
    return graphs.tensors(x)


class StubBackend:
    def __init__(self):
        self.fail = False
        self.released = 0

    def warm_up(self, body, inputs):
        return body(*inputs)

    def capture(self, body, inputs):
        out = body(*inputs)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return StubGraph(body, inputs, out), out, dict(
            capture_s=0.0, instantiate_s=0.0), 0

    def release(self):
        self.released += 1


class StubCache(graphs.GraphCache):
    """A cache that takes CPU tensors (`active` without the card)."""

    def on_card(self, t):
        return True


def test_launch_counts_with_a_stub_graph(monkeypatch):
    for m in graphs.COUNTED.values():
        monkeypatch.setattr(m, "LAUNCHES", 0)
    cache = StubCache(max_graphs=2, backend=StubBackend())

    def body(x):   # two first-hit and one bounce-adjoint launches a call
        graphs.COUNTED["first_hits"].LAUNCHES += 2
        graphs.COUNTED["bounce_bwd"].LAUNCHES += 1
        return {"y": x * 2.0, "z": [x.sum(), None]}

    x = torch.arange(4.0)
    out = cache.call("a", body, (x,))
    assert torch.equal(out["y"], x * 2.0) and out["z"][1] is None
    # the warm-up counts, the capture does not
    counts = graphs.launch_counts()
    assert counts["first_hits"] == 2 and counts["bounce_bwd"] == 1
    assert sum(counts.values()) == 3
    (g,) = cache.graphs()
    assert g.launches == dict(first_hits=2, bounce_bwd=1)
    assert cache.captures == 1 and cache.last is g
    for r in range(1, 4):
        out = cache.call("a", body, (x + r,))
        assert torch.equal(out["y"], (x + r) * 2.0)
        assert float(out["z"][0]) == float((x + r).sum())
        counts = graphs.launch_counts()
        assert counts["first_hits"] == 2 + 2 * r
        assert counts["bounce_bwd"] == 1 + r
    assert g.replays == 3 and g.graph.replays == 3
    # the result is a copy: the next replay does not change it
    kept = out["y"].clone()
    cache.call("a", body, (x,))
    assert torch.equal(out["y"], kept)
    # a failed capture raises, caches nothing, counts only the warm-up
    cache.backend.fail = True
    before = graphs.launch_counts()
    with pytest.raises(RuntimeError, match="capturing"):
        cache.call("b", body, (x,))
    assert "b" not in cache and len(cache) == 1 and cache.captures == 1
    after = graphs.launch_counts()
    assert after["first_hits"] == before["first_hits"] + 2
    cache.backend.fail = False
    # least recently used first out
    cache.call("b", body, (x,))
    cache.call("a", body, (x,))
    cache.call("c", body, (x,))
    assert "b" not in cache and "a" in cache and "c" in cache
    assert cache.backend.released == 1
    with cache.disabled():
        assert not cache.active(x, TConfig())
    assert cache.active(x, TConfig()) and not cache.active(
        x, TConfig(kernels="off"))
    cache.clear()
    assert len(cache) == 0


def test_stub_graphed_frame_and_steps_equal_eager():
    _, ts = cornell()
    cam, cfg = camera(), TConfig(max_bounces=B)
    cache = StubCache(backend=StubBackend())
    want = trenderer.render_frame(ts, cam, cfg, W, H, pids(), SPP, 0)
    for _ in range(3):   # warm-up and capture, then replays
        got = trenderer.render_frame(ts, cam, cfg, W, H, pids(), SPP, 0,
                                     cache=cache)
        assert torch.equal(got, want)
    assert len(cache) == 1 and cache.graphs()[0].replays == 2
    trainable = ["mat_diffuse", "sph_center"]
    target = torch.from_numpy(np.random.RandomState(0).rand(
        H, W, 3).astype(np.float32))
    runs = []
    for c in (None, cache):
        params = TT.split_params(ts, cam, trainable)
        opt = TT._adam_default(1e-2)([params[k] for k in sorted(params)])
        step = TT.make_step(opt, cfg, target, W, H, SPP, cache=c)
        hist = [step(params, ts, cam, pids(), 0) for _ in range(3)]
        runs.append((hist, {k: v.detach().clone() for k, v in
                            params.items()}, opt.state_dict()))
    assert len(cache) == 2 and cache.graphs()[1].replays == 2
    (h0, p0, s0), (h1, p1, s1) = runs
    for (l0, g0), (l1, g1) in zip(h0, h1):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
    for k in trainable:
        assert torch.equal(p0[k], p1[k]), k
    for i, st in s0["state"].items():
        for name, v in st.items():
            assert torch.equal(v, s1["state"][i][name]), (i, name)
