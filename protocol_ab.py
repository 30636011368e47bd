"""A/B timing of the flagship protocol step on one GPU.

    python3 protocol_ab.py ROOT LABEL

Imports `tracer_torch` from the checkout at ROOT (for example the working
tree, `.`, and an unpacked parent commit) and times the 16-spp protocol
fwd+bwd of `bench.py` at 850x480 (`render_pixels(...).div(16).mean()
.backward()`, mat_diffuse, sph_center and tex_data trainable) on the
Cornell box and the textured Cornell: one warm-up step, then 5 steps, each
ending in `torch.cuda.synchronize()`, then one step under torch.profiler
(device-busy ms, device launches, and the device ms of the first-hit,
shade and bounce-adjoint kernels). Prints one JSON line per box, tagged
with LABEL. Compare two checkouts only inside one call, in turns (parent,
change, change, parent)."""
import dataclasses
import json
import os
import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))
os.chdir(root)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile
from tracer_torch.core.config import RenderConfig
from tracer_torch.render import renderer
from tracer_torch.render.camera import default_camera
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo
from tracer_torch.testing import FULL, fill_cornell_textures
W, H, SPP = 850, 480, 16
dev = torch.device("cuda", 0)
for name, sb in (("cornell", zoo.setup_cornell_box(W / H)),
                 ("cornell_textured",
                  fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL))):
    scene = compile_scene(sb, device=dev)
    cam = default_camera(W / H, device=dev)
    cfg = RenderConfig(max_bounces=6)
    pid = torch.arange(W * H, dtype=torch.int32, device=dev)

    def step():
        p = {k: getattr(scene, k).clone().requires_grad_(True)
             for k in ("mat_diffuse", "sph_center", "tex_data")}
        s2 = dataclasses.replace(scene, **p)
        renderer.render_pixels(s2, cam, cfg, W, H, pid, SPP, 0).div(
            SPP).mean().backward()

    step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    print(json.dumps({"ab": label, "scene": name,
                      "step_s": [round(t, 4) for t in ts],
                      "median_s": round(statistics.median(ts), 4),
                      "busy_ms": round(sum(e.self_device_time_total
                                           for e in evs) / 1e3, 2),
                      "launches": sum(e.count for e in evs),
                      "kernel_ms": {k: round(sum(
                          e.self_device_time_total for e in evs
                          if k in e.key) / 1e3, 3)
                          for k in ("first_hits", "shade_scatter",
                                    "bounce_bwd")}}), flush=True)
