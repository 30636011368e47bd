"""Benchmark: Cornell-box throughput on the card (the port of `bench.py`).

    python -m tracer_torch.bench
    python -m tracer_torch.cli benchmark            # the same, from the CLI
    BENCH_SCENES=1 python -m tracer_torch.bench     # + five zoo scenes

Prints ONE JSON line with the keys of the JAX package's `bench.py`:
  {"metric": "primary_rays_per_s_fwd_cornell", "value": N, "unit": "rays/s",
   "vs_baseline": N/50e6, "total_rays_per_s", "fwdbwd_primary_rays_per_s",
   "fwdbwd_no_texgrad_rays_per_s", "config", "device"}
and, with BENCH_SCENES set, "per_scene_fwd_rays_per_s" (1 spp each).
Sizes come from BENCH_WIDTH (850), BENCH_HEIGHT (480), BENCH_SPP (16) and
BENCH_REPS (3). "device" is the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them, or "cpu" when the caller asks for the CPU (every kernel's plain
PyTorch version: a check of the code, not a measurement of a device).

Baseline: BASELINE.md's north star of >= 50M forward primary rays/s on
Cornell. "Primary rays" = width*height*spp camera rays; each costs up to
`max_bounces` scene traversals plus `lights*shadow_rays*max_bounces`
shadow traversals (`per_primary`), reported as `total_rays_per_s`.

The timed bodies are plain functions, so that tests call them (on the
card, `tests/test_torch_card_routes.py`): `frame_scalar` (the frame's
mean radiance, `render_pixels(...) / spp` then `.mean()`), `grad_sum` (every gradient entry of the protocol
loss summed to one scalar, through `loss.backward()`: the hand-written
sweep on B3, B4 where the atlas has texels; `protocol_step` gives the
gradients too), `per_primary`. Their inputs come from `inputs(...)`,
which takes the device (default "cuda"). The random streams start from
seed 0, the port's `jax.random.key(0)`. On the card `frame_scalar` and
`protocol_step` replay CUDA graphs (`render/graphs.py`), as `bench.py`
times `jax.jit(frame)` and `jax.jit(gsum)`: the first call runs the body
and captures it, every later call replays it (the frame: `render_frame`'s
graph of one sample, once a sample).

Timing discipline (`timeit`): one untimed call (on first use the nvcc
build; then the first run and the graph's capture), then `reps` calls
queued without a synchronise, then one read of the last scalar to the
host, which waits for every queued call (the card runs one stream in
order). A frame's 5,481 launches are enqueued as 16 graph launches, one a
sample, after the frame's tables (built eagerly, a few dozen small
launches), so the queued wall is the card's time, not the host's enqueue
(eager, the card idled 0.91-0.95 of a 16-spp Cornell frame, PERF.md
section 5). A
host synchronisation inside the timed body would bound how far the host
runs ahead of the card; `torch.cuda.set_sync_debug_mode("warn")` counts
none in a replayed frame or protocol step and at most one in an eager
step, after the first call on a scene
(`tests/test_torch_card_routes.py::test_graph_*`): the
frame's one read, `dark_sky` for the shade kernel, is memoised per scene
(`integrator.host_constants`), and the backward sweep takes it from the
forward.

Pixel ids: `bench.py` pads the ray list to a whole number of its kernels'
128-row tiles (`pad_rows(408,000)` = 409,600 ids, the last 1,600 repeating
pixels 0-1,599) but counts 408,000 rays. The port's kernels take any ray
count, so the port traces `arange(width * height)` and counts the same
408,000: the JAX bench traces 0.39% more rays than it counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import NamedTuple

import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.render import graphs, integrator
from tracer_torch.render.camera import Camera, default_camera
from tracer_torch.render.renderer import render_frame, render_pixels
from tracer_torch.scene.device import DeviceScene, compile_scene
from tracer_torch.scenes import zoo

BASELINE_RAYS_PER_S = 50e6
SEED = 0
TRAINABLE = ("mat_diffuse", "sph_center", "tex_data")
NO_TEXGRAD = ("mat_diffuse", "sph_center")
SCENES = ("flamingo", "raccoon", "backrooms_pool", "rt_in_a_weekend",
          "random_spheres")


class Inputs(NamedTuple):
    """One benchmarked frame: scene, camera and config on one device,
    the frame's size, its pixel ids and samples per pixel."""
    scene: DeviceScene
    camera: Camera
    cfg: RenderConfig
    width: int
    height: int
    pixel_ids: torch.Tensor
    spp: int


def inputs(sb, width, height, spp, device="cuda", camera=None) -> Inputs:
    """Compile the scene builder `sb` on `device` (the card unless the
    caller asks for the CPU); the camera defaults to the reference app's
    startup pose at the frame's aspect."""
    if camera is None:
        camera = default_camera(aspect=width / height, device=device)
    return Inputs(compile_scene(sb, device=device), camera,
                  RenderConfig(width=width, height=height, nsamples=spp),
                  width, height,
                  torch.arange(width * height, dtype=torch.int32,
                               device=device), spp)


def frame_scalar(b: Inputs):
    """The frame's mean radiance (`bench.py`'s `frame`): a 0-d tensor on
    the frame's device, not yet read to the host. On the card the frame
    is `renderer.render_frame`'s graph (`render/graphs.py`, as `bench.py`
    times `jax.jit(frame)`: one sample, replayed once a sample), then the
    mean."""
    with torch.no_grad():
        acc = render_frame(b.scene, b.camera, b.cfg, b.width, b.height,
                           b.pixel_ids, b.spp, SEED)
        return (acc / b.spp).mean()


def protocol_step(b: Inputs, trainable=TRAINABLE):
    """The protocol step: (every gradient entry summed to a 0-d tensor,
    the loss, {name: gradient}) for the protocol loss (the frame's mean
    radiance) with respect to the `trainable` scene fields. Its leaves are
    detached views of the body's scene tensors, made inside the body. On
    the card (`graphs.CACHE.active`), one graph on every scene
    (`bench.py`'s `jax.jit(gsum)`): forward, `loss.backward()` (the
    hand-written, the general or the plain autodiff backward) and the
    sum, keyed by its arguments' shapes (the scene, camera, pixel ids, the
    seed word and the tables); on the CPU, with `kernels="off"` and inside
    `graphs.CACHE.disabled()` the eager body, whose autograd graph
    `backward()` frees before the function returns."""
    def body(scene, camera, pid, word, tables):
        params = {k: getattr(scene, k).detach().requires_grad_(True)
                  for k in trainable}
        scene = dataclasses.replace(scene, **params)
        with torch.enable_grad():
            acc = render_pixels(scene, camera, b.cfg, b.width, b.height,
                                pid, b.spp, word, tables=tables)
            loss = (acc / b.spp).mean()
            loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        return sum(g.sum() for g in grads.values()), loss.detach(), grads

    args = (b.scene, b.camera, b.pixel_ids,
            rng.seed_tensor(SEED, b.pixel_ids.device),
            integrator.prepare(b.scene))
    if not graphs.CACHE.active(b.pixel_ids, b.cfg):
        return body(*args)
    return graphs.CACHE.call(("bench_step", b.cfg, b.width, b.height, b.spp,
                              tuple(trainable)), body, args)


def grad_sum(b: Inputs, trainable=TRAINABLE):
    """Every gradient entry of the protocol loss with respect to the
    `trainable` scene fields, summed to a 0-d tensor (`bench.py`'s `gsum`
    / `gsum_nt`): `protocol_step`'s first result."""
    return protocol_step(b, trainable)[0]


def per_primary(scene, cfg: RenderConfig) -> int:
    """Traversals a primary ray costs at most: one a bounce, plus
    `shadow_rays` shadow rays a light a bounce."""
    n_lights = int(scene.light_pos.shape[0])
    return cfg.max_bounces * (1 + n_lights * cfg.shadow_rays)


def timeit(fn, reps):
    """Seconds a call: one untimed call, then `reps` calls queued, then one
    read of the last call's scalar to the host."""
    float(fn())
    t0 = time.perf_counter()
    rs = [fn() for _ in range(reps)]
    float(rs[-1])
    return (time.perf_counter() - t0) / reps


def device_label(device) -> str:
    """The card's `name, power.limit` from nvidia-smi, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={idx}"], capture_output=True,
        text=True, check=True).stdout.strip()


def main(device="cuda") -> dict:
    """Run the benchmark on `device`, print its JSON line and return it."""
    width = int(os.environ.get("BENCH_WIDTH", 850))
    height = int(os.environ.get("BENCH_HEIGHT", 480))
    spp = int(os.environ.get("BENCH_SPP", 16))
    reps = int(os.environ.get("BENCH_REPS", 3))

    b = inputs(zoo.setup_cornell_box(width / height), width, height, spp,
               device)
    n_pix = width * height
    dt = timeit(lambda: frame_scalar(b), reps)
    rays_s = n_pix * spp / dt
    dt_bwd = timeit(lambda: grad_sum(b), reps)
    dt_nt = timeit(lambda: grad_sum(b, NO_TEXGRAD), reps)

    out = {
        "metric": "primary_rays_per_s_fwd_cornell",
        "value": round(rays_s),
        "unit": "rays/s",
        "vs_baseline": round(rays_s / BASELINE_RAYS_PER_S, 4),
        "total_rays_per_s": round(rays_s * per_primary(b.scene, b.cfg)),
        "fwdbwd_primary_rays_per_s": round(n_pix * spp / dt_bwd),
        "fwdbwd_no_texgrad_rays_per_s": round(n_pix * spp / dt_nt),
        "config": f"{width}x{height}@{spp}spp b{b.cfg.max_bounces}",
        "device": device_label(device),
    }
    if os.environ.get("BENCH_SCENES"):
        per_scene = {}
        for name in SCENES:
            s = inputs(zoo.BY_NAME[name](), width, height, 1, device,
                       camera=b.camera)
            dt1 = timeit(lambda s=s: frame_scalar(s), reps)
            per_scene[name] = round(n_pix / dt1)
        out["per_scene_fwd_rays_per_s"] = per_scene
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
