"""The port's spans (`tracer_torch/core/spans.py`) on the CPU.

- **They appear.** Under `torch.profiler` a frame of `render` and of
  `render_image_multihost` (the one-rank mesh) holds `render.launch`,
  `render.prepare` inside it, then `render.copy_out` and
  `render.to_image`, read back from the exported Chrome trace by the
  benchmark's own parser (`portbench.trace.parse`).
- **The graph cache's.** Through the stub backend of
  tests/test_torch_graphs.py: a first call emits `graph.warmup` and
  `graph.capture`, a later one `graph.copy_in` and one `graph.replay`
  for all its replays, and no capture span.
- **The step's.** A `make_step` step, eager and stub-graphed, emits
  `step.launch` with `step.prepare` inside it, then `step.optimizer`.
- **Gated off.** With no profiler running, `span` never calls
  `record_function` and costs under a microsecond a span.
"""

import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import trace
from tests.test_torch_graphs import StubBackend, StubCache
from tracer_torch import train as TT
from tracer_torch.core import spans
from tracer_torch.core.config import RenderConfig
from tracer_torch.dist import multihost, sharding
from tracer_torch.render import renderer
from tracer_torch.render.camera import default_camera
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo

W, H, SPP = 32, 18, 2


@pytest.fixture(scope="module")
def cornell():
    scene = compile_scene(zoo.setup_cornell_box(W / H), device="cpu")
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=2)
    return scene, default_camera(W / H, device="cpu"), cfg


def traced(fn, tmp_path) -> list:
    """The spans of `fn()` run under the profiler (host activities), as
    the benchmark reads them: [trace.Span] in order of start."""
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window:test"):
            fn()
    prof.export_chrome_trace(str(path))
    return sorted(trace.parse(path, "test").spans, key=lambda s: s.start)


def only(ss, name):
    (s,) = [s for s in ss if s.name == name]
    return s


def end(s):
    return s.start + s.dur


def inside(child, parent):
    return parent.start <= child.start and end(child) <= end(parent)


@pytest.mark.parametrize("entry", ["render", "render_image_multihost"])
def test_a_frame_emits_the_render_spans(cornell, tmp_path, entry):
    scene, cam, cfg = cornell
    if entry == "render":
        def frame():
            return renderer.render(scene, cam, cfg)
    else:
        mesh = sharding.make_ray_mesh(1, 1)

        def frame():
            return multihost.render_image_multihost(scene, cam, cfg, mesh)
    ss = traced(frame, tmp_path)
    assert {s.name for s in ss} == {"render.launch", "render.prepare",
                                    "render.copy_out", "render.to_image"}
    launch, prep = only(ss, "render.launch"), only(ss, "render.prepare")
    copy, image = only(ss, "render.copy_out"), only(ss, "render.to_image")
    assert inside(prep, launch)
    assert end(launch) <= copy.start and end(copy) <= image.start


def test_graph_spans_name_the_capture_and_the_replays(cornell, tmp_path):
    scene, cam, cfg = cornell
    cache = StubCache(backend=StubBackend())
    pid = torch.arange(W * H, dtype=torch.int32)

    def frame():
        renderer.render_frame(scene, cam, cfg, W, H, pid, 1, 0, cache=cache)

    first = [s.name for s in traced(frame, tmp_path)]
    assert first == ["render.prepare", "graph.warmup", "graph.capture"]
    cam2 = default_camera(W / H, device="cpu")

    def frame2():
        renderer.render_frame(scene, cam2, cfg, W, H, pid, 3, 0, cache=cache)

    second = [s.name for s in traced(frame2, tmp_path)]
    assert second == ["render.prepare", "graph.copy_in", "graph.replay"]
    assert cache.captures == 1 and cache.graphs()[0].graph.replays == 3


@pytest.mark.parametrize("graphed", [False, True])
def test_a_step_emits_the_step_spans(cornell, tmp_path, graphed):
    scene, cam, cfg = cornell
    target = np.random.RandomState(0).rand(H, W, 3).astype(np.float32)
    params = TT.split_params(scene, cam, ["mat_diffuse", "sph_center"])
    opt = TT._adam_default(1e-2)([params[k] for k in sorted(params)])
    cache = StubCache(backend=StubBackend()) if graphed else None
    step = TT.make_step(opt, cfg, target, W, H, 1, cache=cache)
    pid = torch.arange(W * H, dtype=torch.int32)
    for _ in range(1 + graphed):     # stub-graphed: captured, then replayed
        ss = traced(lambda: step(params, scene, cam, pid, 0), tmp_path)
    names = [s.name for s in ss]
    want = ["step.launch", "step.prepare"]
    want += ["graph.copy_in", "graph.replay"] if graphed else []
    assert names == want + ["step.optimizer"]
    launch = only(ss, "step.launch")
    assert inside(only(ss, "step.prepare"), launch)
    assert end(launch) <= only(ss, "step.optimizer").start


def test_off_without_a_profiler(cornell, monkeypatch):
    """No `record_function` without a profiler (a bare one costs ~9 µs
    a call), and a gated-off span under 1 µs (the best of 5 rounds of
    10**5)."""
    scene, cam, cfg = cornell

    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    renderer.render(scene, cam, cfg)
    params = TT.split_params(scene, cam, ["mat_diffuse"])
    opt = TT._adam_default(1e-2)([params["mat_diffuse"]])
    step = TT.make_step(opt, cfg, np.zeros((H, W, 3), np.float32), W, H, 1)
    step(params, scene, cam, torch.arange(W * H, dtype=torch.int32), 0)

    def spans_off():
        for _ in range(10 ** 5):
            with spans.span("render.launch"):
                pass

    best = min(timeit.repeat(spans_off, number=1, repeat=5))
    assert best / 10 ** 5 < 1e-6, f"{best * 10:.3f} µs a span"
