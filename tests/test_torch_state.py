"""Who owns the bounce state, and the slim first-hit record.

The shade pass (B2) updates the bounce state in place, so `trace` keeps
its own state buffers: the caller's rays stay as they were, and tracing
the same rays twice gives the same radiance. The first-hit pass (B1)
gives the bounce loop a slim record; the full dict of `first_hits` adds
the winning quad's table columns, which must equal the plain version's
per-lane fields. All on the CPU through the plain versions, which write
the same buffers the kernels write; `tracer` (the JAX package) is held
against the same renders in tests/test_torch_render.py."""

import numpy as np
import pytest
import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import intersect as tint
from tracer_torch.kernels import shade as tshade
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator, renderer
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo
from tracer_torch.testing import fill_cornell_textures

W, H = 24, 14


def box(textured):
    sb = zoo.setup_cornell_box(W / H)
    if textured:
        sb = fill_cornell_textures(sb)
    return compile_scene(sb, device="cpu")


def camera_rays(scene, seed=0):
    cam = tcam.default_camera(W / H, device="cpu")
    pid = torch.arange(W * H, dtype=torch.int32)
    return renderer.camera_batch(cam, W, H, pid, 0, seed)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("textured", [False, True])
def test_trace_owns_its_state(textured, grad):
    """The caller's o, d and time are unchanged after `trace` (also on the
    record-replay path, where o and d carry grad), and a second call on
    the same rays gives the same radiance."""
    scene = box(textured)
    o, d, tm, keys = camera_rays(scene)
    if grad:
        o = tuple(c.clone().requires_grad_(True) for c in o)
        d = tuple(c.clone().requires_grad_(True) for c in d)
    before = [c.detach().clone() for c in (*o, *d, tm)]
    cfg = RenderConfig()
    r1 = integrator.trace(scene, cfg, o, d, tm, keys)
    for c, b in zip((*o, *d, tm), before):
        assert torch.equal(c.detach(), b)
    r2 = integrator.trace(scene, cfg, o, d, tm, keys)
    assert torch.equal(r1.detach(), r2.detach())
    assert float(r1.detach().abs().max()) > 0.0
    if grad:   # the backward still returns the rays' cotangents
        r1.sum().backward()
        assert all(c.grad is not None and bool(torch.isfinite(c.grad).all())
                   for c in (*o, *d))


@pytest.mark.parametrize("last", [False, True])
def test_shade_scatter_updates_in_place(last):
    """B2's plain version writes the state it is given: the returned
    tensors are the state's own; a lane that is not active keeps its
    state bit for bit; an active lane that misses keeps o, d and
    throughput and is no longer active; before the last bounce the rest
    move on, and the result equals what a fresh copy gives."""
    scene = box(False)
    o, d, tm, keys = camera_rays(scene)
    state = integrator._init_state(o, d, tm)
    rs = np.random.RandomState(1)
    state["active"].copy_(torch.from_numpy(rs.rand(W * H) < 0.7))
    for c in state["acc"]:
        c.copy_(torch.from_numpy(rs.uniform(0, 0.3, W * H)
                                 .astype(np.float32)))
    k1 = tint.first_hits(scene, state["o"], state["d"], tm, state["active"],
                         slim=True)
    # some active lanes miss: point them away from the box
    miss_lanes = torch.from_numpy(rs.rand(W * H) < 0.2) & state["active"]
    k1["j"] = torch.where(miss_lanes, -1, k1["j"])
    before = integrator.copy_state(state)
    ids = {k: [id(c) for c in v] if isinstance(v, tuple) else id(v)
           for k, v in state.items()}
    bkeys = rng.salted(keys, 0)
    out = tshade.shade_scatter(scene, RenderConfig(), state, bkeys, k1, 6,
                               last=last)
    again = tshade.shade_scatter(scene, RenderConfig(),
                                 integrator.copy_state(before), bkeys, k1,
                                 6, last=last)
    if last:
        assert [id(c) for c in out] == ids["acc"]
        assert all(torch.equal(a, b) for a, b in zip(out, again))
    else:
        assert out is state
        assert {k: [id(c) for c in v] if isinstance(v, tuple) else id(v)
                for k, v in out.items()} == ids
        for key in ("o", "d", "throughput", "acc"):
            assert all(torch.equal(a, b)
                       for a, b in zip(out[key], again[key])), key
    dead = ~before["active"]
    keep = ("acc",) if last else ("o", "d", "throughput", "acc")
    for key in keep:
        for a, b in zip(state[key], before[key]):
            assert torch.equal(a[dead], b[dead]), key
    act = before["active"]
    if last:
        assert torch.equal(state["active"], before["active"])
        for a, b in zip(state["o"], before["o"]):
            assert torch.equal(a, b)
    else:
        missed = act & miss_lanes
        assert missed.any() and not bool(state["active"][missed].any())
        assert torch.equal(state["active"], act & (k1["j"] >= 0))
        for key in ("o", "d", "throughput"):
            for a, b in zip(state[key], before[key]):
                assert torch.equal(a[missed], b[missed]), key
        moved = act & ~miss_lanes
        assert not torch.equal(state["d"][0][moved], before["d"][0][moved])
    # the active lanes gathered radiance (the box's light and the sky)
    assert bool((state["acc"][0][act] != before["acc"][0][act]).any())


@pytest.mark.parametrize("tex_out", [0, 1, 2])
def test_slim_record_and_quad_fields(tex_out):
    """The slim record holds the kernel's fields only; the full dict's
    tangent frame and atlas masks are the winning quad's table columns
    (`quad_fields`), as the plain version computes them per lane, 0 where
    no quad wins."""
    scene = box(tex_out > 0)
    o, d, tm, _ = camera_rays(scene)
    live = torch.from_numpy(np.random.RandomState(2).rand(W * H) < 0.8)
    tables = tint.intersect_tables(scene)
    full = tint.first_hits(scene, o, d, tm, live, tex_out=tex_out,
                           tables=tables)
    slim = tint.first_hits(scene, o, d, tm, live, tex_out=tex_out,
                           tables=tables, slim=True)
    want = set(tint.SLIM_FIELDS) | ({"idx_t", "idx_n"} if tex_out == 2
                                    else set())
    assert set(slim) == want
    assert set(full) == want | {"tan", "bitan", "ptex", "pnm"}
    for k in slim:
        a, b = slim[k], full[k]
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), k
        else:
            assert torch.equal(a, b), k
    got = tint.quad_fields(tables[1], scene.sph_center.shape[0], full["j"],
                           tex_out)
    for k in ("tan", "bitan"):
        for x, y in zip(got[k], full[k]):
            assert torch.equal(x, y), k
    for k in ("ptex", "pnm"):
        assert torch.equal(got[k], full[k]), k
    is_q = full["j"] >= scene.sph_center.shape[0]
    assert bool((full["tan"][0][is_q] != 0).any() or
                (full["tan"][1][is_q] != 0).any())
    if tex_out:
        assert bool((full["ptex"][is_q & live] > 0.5).any())


def test_copy_state_is_a_copy():
    """`copy_state` gives buffers of its own with the same values."""
    scene = box(False)
    o, d, tm, _ = camera_rays(scene)
    st = integrator._init_state(o, d, tm)
    cp = integrator.copy_state(st)
    for key in ("o", "d", "throughput", "acc"):
        for a, b in zip(st[key], cp[key]):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(st["active"], cp["active"])
    assert cp["time"] is st["time"]
    cp["d"][0].add_(1.0)
    assert torch.equal(st["d"][0], d[0])
    # the caller's rays were copied too
    assert st["o"][0].data_ptr() != o[0].data_ptr()
