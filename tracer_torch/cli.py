"""Command-line interface (the port of `tracer/cli.py`): the same
subcommands and flags, plus `--device` (default `cuda`; `cpu` runs every
kernel's plain PyTorch version).

    python -m tracer_torch.cli render --scene cornell_box --out rendu.ppm
    python -m tracer_torch.cli render --spp 16 --ckpt-dir build/tiles
    python -m tracer_torch.cli probe --scene cornell_box --x 220 --y 270
    python -m tracer_torch.cli benchmark --occupancy
    python -m tracer_torch.cli grad-check
    python -m tracer_torch.cli train --steps 40 --ckpt-dir build/train
    python -m tracer_torch.cli scenes

`render` replaces the reference's `r` key, `benchmark --occupancy` its FPS
counter, `probe` its MONORAY single-ray trace of one pixel. The bare
`benchmark` runs `tracer_torch.bench` (the JAX package's bench.py), which
reads its sizes from BENCH_* env vars, as the JAX CLI's does. `train` draws
its initial perturbation from `torch.Generator().manual_seed(seed + 1)`:
without JAX the port cannot reproduce `jax.random.normal`, so its start
differs from `python -m tracer.cli train`'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _build(name: str, width: int, height: int, seed: int, device, cfg=None):
    from tracer_torch.scene.device import compile_scene
    from tracer_torch.scenes import zoo

    if name not in zoo.BY_NAME:
        raise SystemExit(f"unknown scene {name!r}; try: "
                         + ", ".join(sorted(zoo.BY_NAME)))
    fn = zoo.BY_NAME[name]
    if name == "cornell_box":
        sb = fn(width / height)
    elif name == "random_spheres":
        sb = fn(seed)
    else:
        sb = fn()
    kw = {}
    if cfg is not None:  # BVH build knobs ride the config (Constants.h:15-16)
        kw = dict(leaf_width=cfg.bvh_leaf_size,
                  bvh_max_depth=cfg.bvh_max_depth)
    return compile_scene(sb, device=device, **kw)


def _camera(args):
    """Camera from the pose flags (default: the reference app's startup
    pose: eye (0, 0, 6.1), identity orientation, fov 45).
    `--cam-pos/--cam-quat/--look-at/--fov` reach any trackball pose."""
    from tracer_torch.render.camera import default_camera, look_at_quaternion

    dev = args.device

    def vec(s, n, name):
        parts = [float(x) for x in s.split(",")]
        if len(parts) != n:
            raise SystemExit(f"--{name} wants {n} comma-separated floats")
        return torch.tensor(parts, dtype=torch.float32, device=dev)

    cam = default_camera(aspect=args.width / args.height, device=dev)
    if args.cam_pos:
        cam = dataclasses.replace(cam,
                                  position=vec(args.cam_pos, 3, "cam-pos"))
    if args.cam_quat and args.look_at:
        raise SystemExit("--cam-quat and --look-at are exclusive")
    if args.cam_quat:
        q = vec(args.cam_quat, 4, "cam-quat")
        cam = dataclasses.replace(
            cam, quaternion=q / torch.clamp_min(torch.linalg.norm(q), 1e-20))
    if args.look_at:
        cam = dataclasses.replace(cam, quaternion=look_at_quaternion(
            cam.position, vec(args.look_at, 3, "look-at")))
    if args.fov is not None:
        cam = dataclasses.replace(cam, fov_deg=torch.tensor(
            args.fov, dtype=torch.float32, device=dev))
    return cam


def _config(args, **kw):
    from tracer_torch.core.config import RenderConfig
    return RenderConfig(width=args.width, height=args.height,
                        max_bounces=args.bounces, compat=args.compat,
                        seed=args.seed, bvh_leaf_size=args.bvh_leaf,
                        bvh_max_depth=args.bvh_depth,
                        ray_sort=args.ray_sort, **kw)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def cmd_render(args):
    from tracer_torch.render.renderer import render_image

    cfg = _config(args, nsamples=args.spp, shadow_rays=args.shadow_rays)
    scene = _build(args.scene, args.width, args.height, args.seed,
                   args.device, cfg)
    cam = _camera(args)
    t0 = time.perf_counter()
    render_image(scene, cam, cfg, args.out, progress=args.progress,
                 ckpt_dir=args.ckpt_dir, tile=args.tile)
    dt = time.perf_counter() - t0
    n_rays = args.width * args.height * args.spp
    print(f"rendered {args.scene} {args.width}x{args.height}@{args.spp}spp "
          f"-> {args.out} in {dt:.2f}s ({n_rays / dt / 1e6:.2f} Mrays/s "
          f"incl. kernel build)")


def cmd_probe(args):
    """MONORAY: trace a single pixel's ray and print the radiance."""
    from tracer_torch.core import rng
    from tracer_torch.render import integrator
    from tracer_torch.render.camera import generate_rays

    cfg = _config(args)
    scene = _build(args.scene, args.width, args.height, args.seed,
                   args.device, cfg)
    cam = _camera(args)
    f32 = dict(dtype=torch.float32, device=args.device)
    u = torch.tensor([args.x / args.width], **f32)
    v = torch.tensor([args.y / args.height], **f32)
    o, d = generate_rays(cam, u, v)
    keys = rng.ray_keys(cfg.seed, torch.tensor(
        [args.y * args.width + args.x], device=args.device))
    rad = integrator.trace(scene, cfg, o, d, torch.zeros(1, **f32), keys)
    print(json.dumps({
        "pixel": [args.x, args.y],
        "origin": [float(c[0]) for c in o],
        "direction": [float(c[0]) for c in d],
        "radiance": rad[0].tolist(),
    }))


def _compile_stats(args):
    """benchmark --compile: the port's counterpart of the JAX package's
    trace / lower / compile seconds: the kernels' build
    (`kernels/_build.py`: one nvcc per source, then a link, or a cached
    library of the same sources and flags), then the first run of the
    flagship frame chunk (render_pixels on the selected scene)."""
    from tracer_torch.kernels import _build as kbuild
    from tracer_torch.render.renderer import render_pixels

    cfg = _config(args)
    on_card = torch.device(args.device).type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        kbuild.library()
    t_build = time.perf_counter() - t0
    scene = _build(args.scene, args.width, args.height, args.seed,
                   args.device, cfg)
    cam = _camera(args)
    pid = torch.arange(args.width * args.height, dtype=torch.int32,
                       device=args.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        v = float(render_pixels(scene, cam, cfg, args.width, args.height,
                                pid, args.spp, cfg.seed).mean())
    t_run = time.perf_counter() - t0
    print(json.dumps({
        "scene": args.scene,
        "config": f"{args.width}x{args.height}@{args.spp}spp "
                  f"b{cfg.max_bounces}",
        "build_s": round(t_build, 3),
        "build_cached": on_card and kbuild.BUILD_SECONDS is None,
        "nvcc_s": (round(kbuild.BUILD_SECONDS, 3)
                   if kbuild.BUILD_SECONDS is not None else None),
        "first_run_s": round(t_run, 3),
        "mean_radiance": v,
        "device": _device_name(args.device),
    }))


def cmd_benchmark(args):
    if args.compile_stats:
        return _compile_stats(args)
    if not (args.occupancy or args.profile):
        from tracer_torch import bench
        bench.main(device=args.device)
        return

    from tracer_torch.core import rng
    from tracer_torch.render import integrator
    from tracer_torch.render.camera import generate_rays

    cfg = _config(args)
    scene = _build(args.scene, args.width, args.height, args.seed,
                   args.device, cfg)
    cam = _camera(args)
    n = args.width * args.height
    pid = torch.arange(n, dtype=torch.int32, device=args.device)
    # the JAX package's benchmark rays: one jittered ray a pixel, the
    # per-pixel keys not salted by a sample
    keys = rng.ray_keys(cfg.seed, pid)
    jit_uv = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER), (2,))
    x = (pid % args.width).to(torch.float32)
    y = (pid // args.width).to(torch.float32)
    o, d = generate_rays(cam, (x + jit_uv[:, 0]) / args.width,
                         (y + jit_uv[:, 1]) / args.height)
    tm = rng.uniform(rng.salted(keys, rng.RAY_TIME))
    tables = integrator.prepare(scene)

    def frame():
        rad, aux = integrator.trace(scene, cfg, o, d, tm, keys,
                                    tables=tables, with_aux=True)
        return rad.mean(), aux["occupancy"]

    with torch.no_grad():
        mean, occ = frame()   # warm-up (and, on the card, the build)
        _sync(args.device)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(args.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(args.profile, exist_ok=True)
            with profile(activities=acts) as prof:
                mean, occ = frame()
                _sync(args.device)
            path = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace written to {path}", file=sys.stderr)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            mean, occ = frame()
            float(mean)   # one read of the card a frame
        dt = (time.perf_counter() - t0) / reps
    print(json.dumps({
        "scene": args.scene,
        "config": f"{args.width}x{args.height} b{cfg.max_bounces} 1spp",
        "primary_rays_per_s": round(n / dt),
        "occupancy_per_bounce": [round(float(v), 4) for v in occ.cpu()],
        "device": _device_name(args.device),
    }))


def cmd_grad_check(args):
    """Autograd against central differences (`diff/fd.py`) on four small
    scenes: a sphere's centre and radius and its material's albedo, a mesh
    vertex, and two atlas texels. (The JAX package's CLI takes the albedo
    of material row 1, which this one-material scene lacks: JAX clamps the
    read and drops the write, so its check holds 0 against 0. The port
    checks row 0.)"""
    from tracer_torch.core import rng
    from tracer_torch.core.config import RenderConfig
    from tracer_torch.diff.fd import compare_ad_fd
    from tracer_torch.render import integrator
    from tracer_torch.render.camera import default_camera, generate_rays
    from tracer_torch.scene.builder import Material, MeshObject, SceneBuilder
    from tracer_torch.scene.device import compile_scene

    dev = args.device
    sb = SceneBuilder()
    sb.add_light((-2., 4., 3.), radius=0.0)
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    scene = compile_scene(sb, device=dev)
    cfg = RenderConfig(max_bounces=1)
    cam = default_camera(aspect=1.0, device=dev)
    n = 5
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.linspace(0.48, 0.52, n, **f32)
    o, d = generate_rays(cam, u, torch.full((n,), 0.5, **f32))
    keys = rng.ray_keys(0, torch.arange(n, dtype=torch.int32, device=dev))
    tm = torch.zeros(n, **f32)

    def with_row(table, idx, p):
        t = table.clone()
        t[idx] = p.to(dev)
        return t

    results = {}
    for pname, field, idx in [("sphere_center", "sph_center", 0),
                              ("sphere_radius", "sph_radius", 0),
                              ("albedo", "mat_diffuse", 0)]:
        def loss(p, field=field, idx=idx):
            s2 = dataclasses.replace(scene, **{field: with_row(
                getattr(scene, field), idx, p)})
            return integrator.trace(s2, cfg, o, d, tm, keys).sum().cpu()
        p0 = getattr(scene, field)[idx].cpu().numpy()
        _, _, err, ok = compare_ad_fd(loss, p0)
        results[pname] = {"max_abs_err": err, "ok": ok}

    # mesh vertex positions (shared-vertex grads, reference Mesh.h:111-124)
    sbm = SceneBuilder()
    sbm.add_light((-2., 4., 3.), radius=0.0)
    sbm.add_mesh(MeshObject(
        [(-1.5, -1.0, 0.0), (0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
         (1.5, -1.0, 0.0)], [(0, 1, 2), (1, 3, 2)],
        material=Material(diffuse=(0.7, 0.4, 0.2))))
    scm = compile_scene(sbm, device=dev)
    om, dm = generate_rays(cam, torch.linspace(0.44, 0.56, n, **f32),
                           torch.full((n,), 0.45, **f32))

    def loss_v(p):
        s2 = dataclasses.replace(scm, mesh_verts=with_row(scm.mesh_verts, 1,
                                                          p))
        return integrator.trace(s2, cfg, om, dm, tm, keys).sum().cpu()

    _, _, err, ok = compare_ad_fd(loss_v, scm.mesh_verts[1].cpu().numpy())
    results["mesh_vertex"] = {"max_abs_err": err, "ok": ok}

    # texture-atlas texels (Material.cpp:82-88)
    sbt = SceneBuilder()
    sbt.add_light((0., 0., 5.), radius=0.0)
    img = (np.arange(4 * 4 * 3).reshape(4, 4, 3) * 5 + 16).astype(np.uint8)
    mt = Material(diffuse=(1.0, 1.0, 1.0))
    mt.texture_type = 2
    mt.texture_id = sbt.add_texture(img)
    sbt.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 4., 4., mt)
    sct = compile_scene(sbt, device=dev)
    ot, dt_ = generate_rays(cam, torch.linspace(0.35, 0.65, n, **f32),
                            torch.full((n,), 0.5, **f32))

    # the perturbed texels leave the u8 grid that the packed twins encode:
    # read the exact atlas, as training does (train.guard_config)
    cfg_t = dataclasses.replace(cfg, packed_atlas="off")

    def loss_t(p):
        s2 = dataclasses.replace(sct, tex_data=p)
        return integrator.trace(s2, cfg_t, ot, dt_, tm, keys).sum()

    p0 = sct.tex_data.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(loss_t(p0), p0)
    g_ad = g_ad.cpu().numpy().astype(np.float64)
    touched = np.argwhere(np.abs(g_ad).sum(axis=1) > 0)[:, 0][:2]
    ok_t = touched.size > 0
    err_t = 0.0
    p0n = sct.tex_data.cpu().numpy().astype(np.float64)
    with torch.no_grad():
        for i in touched:
            for a in range(3):
                dp = np.zeros_like(p0n)
                dp[i, a] = 1e-3
                lp = float(loss_t(torch.tensor(p0n + dp, **f32)))
                lm = float(loss_t(torch.tensor(p0n - dp, **f32)))
                fd = (lp - lm) / 2e-3
                err_t = max(err_t, abs(g_ad[i, a] - fd))
                ok_t &= abs(g_ad[i, a] - fd) < 1e-2 + 5e-2 * max(abs(fd),
                                                                 1.0)
    results["texels"] = {"max_abs_err": err_t, "ok": bool(ok_t)}

    print(json.dumps(results, indent=2))
    if not all(r["ok"] for r in results.values()):
        sys.exit(1)


def cmd_train(args):
    """Inverse rendering: render a target from the true scene, perturb the
    trainable parameters, recover them by Adam through the differentiable
    renderer. With --ckpt-dir, an interrupted run resumes bit-exactly
    ((params, Adam state, step) checkpoints, in the JAX package's layout).
    The perturbation is drawn from torch.Generator().manual_seed(seed + 1)
    (not jax.random.normal: the port has no JAX)."""
    from tracer_torch import train as T
    from tracer_torch.render.renderer import render_pixels

    cfg = _config(args, nsamples=args.spp, shadow_rays=args.shadow_rays)
    scene = _build(args.scene, args.width, args.height, args.seed,
                   args.device, cfg)
    cam = _camera(args)
    trainable = [t.strip() for t in args.train.split(",") if t.strip()]

    pid = torch.arange(args.width * args.height, dtype=torch.int32,
                       device=args.device)
    gcfg = T.guard_config(cfg, trainable)
    with torch.no_grad():
        target = render_pixels(scene, cam, gcfg, args.width, args.height,
                               pid, args.spp, cfg.seed) / args.spp

    # deterministic perturbation of every trainable parameter
    true_params = {k: v.detach() for k, v in
                   T.split_params(scene, cam, trainable).items()}
    gen = torch.Generator().manual_seed(args.seed + 1)
    pert = {}
    for k, v in sorted(true_params.items()):
        scale = args.perturb * (float(v.abs().mean()) + 0.1)
        noise = torch.randn(tuple(v.shape), generator=gen,
                            dtype=torch.float32)
        pert[k] = v + scale * noise.to(v.device)
    scene0, cam0 = T.apply_params(scene, cam, pert)

    def dist(params):
        return {k: float((params[k].detach() - true_params[k]).abs().max())
                for k in true_params}

    print(json.dumps({"event": "start", "trainable": trainable,
                      "param_err": dist(pert)}))
    s2, c2, hist = T.fit(scene0, cam0, cfg, target, trainable,
                         steps=args.steps, lr=args.lr, width=args.width,
                         height=args.height, nsamples=args.spp,
                         seed=cfg.seed, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log=print)
    final = T.split_params(s2, c2, trainable)
    print(json.dumps({"event": "done",
                      "loss_first": hist[0]["loss"] if hist else None,
                      "loss_last": hist[-1]["loss"] if hist else None,
                      "param_err": dist(final)}))


def cmd_scenes(args):
    from tracer_torch.scenes import zoo
    for i, (name, _) in sorted(zoo.SCENES.items()):
        print(f"{i:2d}  {name}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tracer_torch", description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda: the "
                             "CUDA kernels; cpu: their plain versions)")

    def common(sp):
        device(sp)
        sp.add_argument("--scene", default="cornell_box")
        sp.add_argument("--width", type=int, default=850)
        sp.add_argument("--height", type=int, default=480)
        sp.add_argument("--bounces", type=int, default=6)
        sp.add_argument("--compat", default="reference",
                        choices=["reference", "physical"])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--bvh-leaf", type=int, default=16,
                        dest="bvh_leaf",
                        help="BVH leaf width (triangles per leaf)")
        sp.add_argument("--bvh-depth", type=int, default=64,
                        dest="bvh_depth", help="BVH max depth")
        sp.add_argument("--ray-sort", default="auto", dest="ray_sort",
                        choices=["auto", "off"],
                        help="kept for the JAX package's flag set; no "
                             "effect in the port (rays walk in ray order)")
        sp.add_argument("--cam-pos", default=None, metavar="X,Y,Z",
                        help="camera position (default 0,0,6.1 — the "
                             "reference app's startup pose)")
        sp.add_argument("--cam-quat", default=None, metavar="W,X,Y,Z",
                        help="camera orientation quaternion")
        sp.add_argument("--look-at", default=None, metavar="X,Y,Z",
                        help="aim the camera at this point "
                             "(alternative to --cam-quat)")
        sp.add_argument("--fov", type=float, default=None,
                        help="vertical field of view in degrees "
                             "(default 45, Camera.cpp:24)")

    r = sub.add_parser("render", help="ray trace a scene to an image")
    common(r)
    r.add_argument("--spp", type=int, default=20)
    r.add_argument("--shadow-rays", type=int, default=10)
    r.add_argument("--out", default="rendu.ppm")
    r.add_argument("--progress", action="store_true")
    r.add_argument("--ckpt-dir", default=None,
                   help="tile-checkpoint dir: atomic per-tile saves; "
                        "re-running resumes, re-rendering only missing tiles")
    r.add_argument("--tile", type=int, default=128,
                   help="checkpoint tile size (with --ckpt-dir)")
    r.set_defaults(fn=cmd_render)

    pr = sub.add_parser("probe", help="MONORAY single-ray debug probe")
    common(pr)
    pr.add_argument("--x", type=int, default=220)
    pr.add_argument("--y", type=int, default=270)
    pr.set_defaults(fn=cmd_probe)

    b = sub.add_parser("benchmark", help="Cornell rays/s benchmark; "
                       "--occupancy/--profile give per-bounce counters "
                       "and a torch.profiler trace for any scene")
    common(b)
    b.add_argument("--spp", type=int, default=16)
    b.add_argument("--compile", dest="compile_stats",
                   action="store_true",
                   help="report the kernels' build seconds (nvcc, or a "
                        "cached library) and the first frame's")
    b.add_argument("--occupancy", action="store_true",
                   help="report per-bounce active-lane occupancy + rays/s")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of one frame "
                        "to DIR/trace.json")
    b.set_defaults(fn=cmd_benchmark)

    g = sub.add_parser("grad-check", help="AD vs finite-difference check")
    device(g)
    g.set_defaults(fn=cmd_grad_check)

    t = sub.add_parser(
        "train", help="inverse rendering: recover perturbed scene params "
        "by Adam through the renderer; checkpoints + exact resume (the "
        "perturbation comes from torch.Generator().manual_seed(seed + 1), "
        "so it differs from the JAX package's)")
    common(t)
    t.add_argument("--spp", type=int, default=4)
    t.add_argument("--shadow-rays", type=int, default=4)
    t.add_argument("--train", default="mat_diffuse",
                   help="comma list of trainable fields "
                        "(scene fields, cam_position or cam_quaternion)")
    t.add_argument("--steps", type=int, default=40)
    t.add_argument("--lr", type=float, default=1e-2)
    t.add_argument("--perturb", type=float, default=0.05,
                   help="relative scale of the initial perturbation")
    t.add_argument("--ckpt-dir", default=None,
                   help="save (params, Adam state, step) here; re-running "
                        "resumes exactly (a tracer checkpoint too)")
    t.add_argument("--ckpt-every", type=int, default=10)
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("scenes", help="list built-in scenes")
    s.set_defaults(fn=cmd_scenes)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
