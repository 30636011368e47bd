"""A/B timing of the BVH walk (B5) and the soft shadows (B6) on one GPU.

    python3 walk_ab.py ROOT LABEL

Imports `tracer_torch` from the checkout at ROOT (for example the working
tree, `.`, and an unpacked parent commit) and times B5
(`mesh_closest_hits`) and B6 (`shadow_factors`, default compat) on the
camera rays of one 850x480 sample (bounce 0) and the rays the kernel path
scatters from them (bounce 1), on flamingo_standin, flamingo_pond_standin
and 17 meshes (`testing.mesh_grid`): each kernel's device time per call
(torch.profiler, 20 calls after a warm-up) and its per-call time (CUDA
events, the wrapper's host work included). Prints one JSON line per scene
and bounce, tagged with LABEL. Compare two checkouts only inside one call,
in turns (parent, change, change, parent)."""
import json
import os
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))
os.chdir(root)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from tracer_torch.core import rng  # noqa: E402
from tracer_torch.core.config import RenderConfig  # noqa: E402
from tracer_torch.kernels import intersect as kintersect  # noqa: E402
from tracer_torch.kernels import shadow as kshadow  # noqa: E402
from tracer_torch.kernels import traverse as ktraverse  # noqa: E402
from tracer_torch.render import integrator, renderer  # noqa: E402
from tracer_torch.render.camera import default_camera  # noqa: E402
from tracer_torch.scene.device import compile_scene  # noqa: E402
from tracer_torch.scenes import zoo  # noqa: E402
from tracer_torch.testing import (  # noqa: E402
    flamingo_pond_standin, flamingo_standin, mesh_grid)

W, H, REPS = 850, 480, 20
dev = torch.device("cuda", 0)


def device_ms(fn, name):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.self_device_time_total for e in prof.key_averages()
                     if name in e.key) / 1e3 / REPS, 4)


def call_ms(fn):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return round(t0.elapsed_time(t1) / REPS, 4)


for name, sb in (("flamingo_standin", flamingo_standin(zoo)),
                 ("flamingo_pond_standin", flamingo_pond_standin(zoo)),
                 ("mesh_grid_17", mesh_grid(zoo.SceneBuilder(), 17, 1_000))):
    scene = compile_scene(sb, device=dev)
    tables = integrator.prepare(scene)
    cam = default_camera(W / H, device=dev)
    pid = torch.arange(W * H, dtype=torch.int32, device=dev)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    cfg = RenderConfig()
    state = integrator._init_state(o, d, tm)
    for b in (0, 1):
        live = state["active"]

        def walk():
            return ktraverse.mesh_closest_hits(
                scene, state["o"], state["d"], live, tables=tables.tree)

        t_raw, tri_raw = walk()
        k1 = kintersect.first_hits(
            scene, state["o"], state["d"], state["time"], live,
            tables=tables.intersect, t_mesh=t_raw, tri_mesh=tri_raw,
            mesh=tables.mesh)
        hit = live & (k1["j"] >= 0)
        bkeys = rng.salted(keys, b)

        def shadow():
            return kshadow.shadow_factors(
                scene, cfg, k1["p"], state["time"], bkeys, cfg.epsilon, hit,
                tables=tables.shadow, tree=tables.tree)

        print(json.dumps({
            "ab": label, "scene": name, "bounce": b,
            "meshes": scene.mesh_mat.shape[0], "live": int(live.sum()),
            "b5_device_ms": device_ms(walk, "traverse"),
            "b5_ms": call_ms(walk),
            "b6_device_ms": device_ms(shadow, "shadow"),
            "b6_ms": call_ms(shadow)}), flush=True)
        state, _ = integrator._bounce_core(scene, cfg, keys, state, b,
                                           tables=tables)
