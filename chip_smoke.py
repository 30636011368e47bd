"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tracer_torch/kernels/csrc/`, holds
each against its plain PyTorch version at the flagship shapes, renders the
Cornell box at 850x480, 16 spp, 6 bounces through
`tracer_torch.render.renderer.render`, checks that the render went through
both kernels, and repeats the checks on a Cornell whose textures and normal
maps are seeded arrays (the pair-atlas branch). Every phase prints one
line; any failure is an uncaught exception and a non-zero exit. The last
two lines are a JSON record of the kernels and `{"ok": true, ...}`.

Tolerances: discrete outputs (winning primitive, material, texel row/sub,
active flags) must match exactly; float outputs within atol=2e-5, the
tolerance the JAX package holds its own kernels to (tests/test_kernels.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available()"
                     " is false)")

from tracer_torch.core import rng  # noqa: E402
from tracer_torch.core.config import RenderConfig  # noqa: E402
from tracer_torch.io.ppm import write_ppm  # noqa: E402
from tracer_torch.kernels import _build  # noqa: E402
from tracer_torch.kernels import intersect as kintersect  # noqa: E402
from tracer_torch.kernels import shade as kshade  # noqa: E402
from tracer_torch.render import integrator, renderer  # noqa: E402
from tracer_torch.render.camera import default_camera  # noqa: E402
from tracer_torch.scene.device import compile_scene  # noqa: E402
from tracer_torch.scenes import zoo  # noqa: E402
from tracer_torch.testing import FULL, fill_cornell_textures  # noqa: E402

W, H, SPP, BOUNCES = 850, 480, 16, 6
PAIR_SPP = 2
ATOL = 2e-5
DEV = torch.device("cuda", 0)
DISCRETE = ("j", "tid", "mid", "row", "sub", "active")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def timed(fn, reps):
    """ms per call on the card (CUDA events around `reps` calls after one
    warm-up call; the wrapper's host work included)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, kernel):
    """The kernel's own device time per launch, from torch.profiler (the
    per-call times above also hold the wrapper's host work)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in evs)
    if n == 0:
        return "not-measured"
    return f"{sum(e.self_device_time_total for e in evs) / 1e3 / n:.4f}"


def flat(rec):
    """Flatten a first-hit record or a bounce state into {name: tensor}."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, tuple):
            for a, t in zip("xyz", v):
                out[f"{k}.{a}"] = t
        else:
            out[k] = v
    return out


def compare(got, want, mask=None):
    """(discrete mismatches, max |float error|) between two records."""
    got, want = flat(got), flat(want)
    mism, err = 0, 0.0
    for k, w in want.items():
        g = got[k]
        if mask is not None:
            g, w = g[mask], w[mask]
        if k in DISCRETE or not torch.is_floating_point(w):
            mism += int((g != w).sum())
        else:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{k}: non-finite kernel output")
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    return mism, err


def check(name, mism, err):
    if mism != 0 or err > ATOL:
        raise AssertionError(f"{name}: {mism} discrete mismatches, "
                             f"max_abs_err {err:.3g} > {ATOL}")


def kernel_phase(label, scene, stats):
    """B1 and B2 against their plain versions at the flagship shapes:
    bounce-0 camera rays and bounce-1 scattered rays of one sample."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    tables = integrator.prepare(scene)
    itab, stab = tables
    use_pair = scene.pair_pack.shape[0] > 1
    cfgs = {c: RenderConfig(compat=c) for c in ("reference", "physical")}
    state = integrator._init_state(o, d, tm)
    winners = set()
    for b in (0, 1):
        bkeys = rng.salted(keys, b)
        args = (scene, state["o"], state["d"], state["time"],
                state["active"], 1e-5, int(use_pair))

        def fh(mode):
            return kintersect.first_hits(*args, kernels=mode, tables=itab)

        k1 = fh("auto")
        k1p = fh("off")
        live = state["active"]
        mism, err = compare(k1, k1p, live)
        check(f"first_hits {label} b{b}", mism, err)
        winners |= set(k1p["j"][live].unique().tolist())
        ms = timed(lambda: fh("auto"), 20)
        pms = timed(lambda: fh("off"), 3)
        say("B1", scene=label, bounce=b, rays=int(live.sum()),
            mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}",
            device_ms=device_ms(lambda: fh("auto"), 20, "first_hits"))
        stats["first_hits"].append((err, ms, pms))
        nxt = None
        for compat, last in (("reference", False), ("reference", True),
                             ("physical", False)):
            cfg = cfgs[compat]

            def sh(mode):
                return kshade.shade_scatter(
                    scene, cfg, state, bkeys, k1p, BOUNCES - b,
                    use_pair=use_pair, last=last, kernels=mode,
                    tables=stab)

            got, want = sh("auto"), sh("off")
            if last:
                got, want = dict(acc=got), dict(acc=want)
            mism, err = compare(got, want)
            # physical draws cos/sin, which may differ by an ulp
            check(f"shade_scatter {label} b{b} {compat} last={last}",
                  mism, err)
            ms = timed(lambda: sh("auto"), 20)
            pms = timed(lambda: sh("off"), 3)
            say("B2", scene=label, bounce=b, compat=compat, last=last,
                mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
                plain_ms=f"{pms:.4f}",
                device_ms=device_ms(lambda: sh("auto"), 20, "shade_scatter"))
            stats["shade_scatter"].append((err, ms, pms))
            if compat == "reference" and not last:
                nxt = want
        state = nxt
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    prims = set(range(scene.n_sph_real)) | set(
        range(S, S + scene.n_quad_real))
    say("B1", scene=label, primitives_that_win=len(winners & prims),
        of=len(prims))


def render_phase(label, sb, spp):
    """The render through the normal entry point, with launch counts,
    then the 1-spp radiance against the plain path on the card."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    renderer.render(scene, cam, cfg, nsamples=1)  # warm-up
    torch.cuda.synchronize()
    kintersect.LAUNCHES = 0
    kshade.LAUNCHES = 0
    t0 = time.perf_counter()
    img = renderer.render(scene, cam, cfg)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = {"first_hits": kintersect.LAUNCHES,
                "shade_scatter": kshade.LAUNCHES}
    for name, n in launches.items():
        if n != spp * BOUNCES:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {spp * BOUNCES}")
    if img.shape != (H, W, 3) or not bool(
            torch.isfinite(torch.from_numpy(img)).all()):
        raise AssertionError(f"{label}: bad image {img.shape}")
    cfg_off = RenderConfig(nsamples=spp, width=W, height=H,
                           max_bounces=BOUNCES, kernels="off")
    t0 = time.perf_counter()
    renderer.render(scene, cam, cfg_off)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    rk = renderer.render_pixels(scene, cam, cfg, W, H, pid, 1, cfg.seed)
    rp = renderer.render_pixels(scene, cam, cfg_off, W, H, pid, 1, cfg.seed)
    err = float((rk - rp).abs().max())
    check(f"render {label} 1-spp radiance", 0, err)
    out = os.path.join(tempfile.mkdtemp(), "rendu.ppm")
    write_ppm(out, img)
    say("render", scene=label, size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        frame_s=f"{frame_s:.4f}", plain_frame_s=f"{plain_s:.4f}",
        radiance_max_abs_err=f"{err:.3g}", mean=f"{img.mean():.6f}",
        launches=launches, ppm=out)
    return launches


def main():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.PTXAS_INFO.splitlines()
             if "registers" in ln]
    say("build", seconds=f"{build_s:.2f}",
        nvcc_seconds=_build.BUILD_SECONDS, ptxas=ptxas)

    stats = {"first_hits": [], "shade_scatter": []}
    flat_sb = zoo.setup_cornell_box(W / H)
    pair_sb = fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL)
    kernel_phase("cornell", compile_scene(flat_sb, device=DEV), stats)
    pair_scene = compile_scene(pair_sb, device=DEV)
    if not pair_scene.pair_mode or pair_scene.pair_pack.shape[0] <= 1:
        raise AssertionError("textured Cornell did not build a pair atlas")
    kernel_phase("cornell_textured", pair_scene, stats)

    launches = render_phase("cornell", flat_sb, SPP)
    render_phase("cornell_textured", pair_sb, PAIR_SPP)

    # the first bounce-1 timing of the flat Cornell stands for each kernel
    rows = []
    for kname, src, tpu in (
            ("first_hits", "tracer_torch/kernels/csrc/first_hits.cu",
             "tracer/kernels/intersect.py:382"),
            ("shade_scatter", "tracer_torch/kernels/csrc/shade_scatter.cu",
             "tracer/kernels/shade.py:382")):
        recs = stats[kname]
        err = max(r[0] for r in recs)
        ms, pms = recs[1 if kname == "first_hits" else 3][1:]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[kname],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
