"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tracer_torch/kernels/csrc/`, holds
each against its plain PyTorch version at the flagship shapes, renders the
Cornell box at 850x480, 16 spp, 6 bounces through
`tracer_torch.render.renderer.render`, checks that the render went through
the forward kernels, and repeats the checks on a Cornell whose textures and
normal maps are seeded arrays (the pair-atlas branch). Then the backward:
the record variants of the forward kernels, the bounce-adjoint kernel and
the texel fold against their plain versions on one recorded 850x480
sample, and the flagship protocol's fwd+bwd (`render_pixels` +
`loss.backward()`, mat_diffuse, sph_center and tex_data trainable) on both
boxes, with its launch counts and its 1-spp gradients held against the
plain path. Every phase prints one line; any failure is an uncaught
exception and a non-zero exit. The last two lines are a JSON record of the
kernels and `{"ok": true, ...}`.

Tolerances: discrete outputs (winning primitive, material, texel indices,
active flags) must match exactly; forward float outputs within atol=2e-5,
the tolerance the JAX package holds its own kernels to
(tests/test_kernels.py). The bounce adjoint: 0 mismatches on pass-through
lanes and 2e-5 * max(1, |plain|) elsewhere (the same expressions, built
with --fmad=false; cosf/sinf may differ by an ulp). The fold and the
gradients: f32 summation order (the kernel sums a texel's run in sorted
order, the plain scatter in stream order; the one-hot matmuls sum in
cuBLAS's order): rtol 1e-5 / atol 1e-5 * max|plain| for the fold, max
relative error 1e-4 for the 1-spp gradients.
"""

from __future__ import annotations

import dataclasses
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
from tracer_torch.kernels import fold as kfold  # noqa: E402
from tracer_torch.kernels import intersect as kintersect  # noqa: E402
from tracer_torch.kernels import shade as kshade  # noqa: E402
from tracer_torch.kernels import shade_bwd as kbwd  # noqa: E402
from tracer_torch.render import integrator, renderer  # noqa: E402
from tracer_torch.render import replay_bwd  # noqa: E402
from tracer_torch.render.camera import default_camera  # noqa: E402
from tracer_torch.scene.device import compile_scene  # noqa: E402
from tracer_torch.scenes import zoo  # noqa: E402
from tracer_torch.testing import FULL, fill_cornell_textures  # noqa: E402

W, H, SPP, BOUNCES = 850, 480, 16, 6
PAIR_SPP = 2
ATOL = 2e-5
BWD_RTOL = 2e-5     # bounce adjoint vs plain, relative to max(1, |plain|)
FOLD_RTOL = 1e-5    # fold vs plain (f32 summation order)
GRAD_RTOL = 1e-4    # 1-spp protocol gradients vs the plain path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
DEV = torch.device("cuda", 0)
DISCRETE = ("j", "tid", "mid", "row", "sub", "idx_t", "idx_n", "active")
TRAINABLE = ("mat_diffuse", "sph_center", "tex_data")


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
    """The kernel's own device time per call of `fn`, from torch.profiler:
    every CUDA kernel whose name holds `kernel` (the per-call times above
    also hold the wrapper's host work and its glue kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    if sum(e.count for e in evs) == 0:
        return "not-measured"
    return f"{sum(e.self_device_time_total for e in evs) / 1e3 / reps:.4f}"


def nbytes(*ts):
    """Bytes of the given tensors (tuples are flattened)."""
    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += nbytes(*t)
        elif isinstance(t, dict):
            out += nbytes(*t.values())
        elif t is not None:
            out += t.numel() * t.element_size()
    return out


def bound_ms(nb):
    """The least time the card could take to move `nb` bytes (every
    input read once, every output written once), in ms."""
    return nb / HBM_BYTES_PER_S * 1e3


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
        bms = bound_ms(nbytes(args[1:5], itab, k1))
        say("B1", scene=label, bounce=b, rays=int(live.sum()),
            mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}",
            device_ms=device_ms(lambda: fh("auto"), 20, "first_hits"),
            bound_ms=f"{bms:.4f}")
        stats["first_hits"].append((err, ms, pms, bms))
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
            bms = bound_ms(shade_bytes(state, k1p, use_pair, last, got))
            say("B2", scene=label, bounce=b, compat=compat, last=last,
                mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
                plain_ms=f"{pms:.4f}",
                device_ms=device_ms(lambda: sh("auto"), 20, "shade_scatter"),
                bound_ms=f"{bms:.4f}")
            stats["shade_scatter"].append((err, ms, pms, bms))
            if compat == "reference" and not last:
                nxt = want
        state = nxt
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    prims = set(range(scene.n_sph_real)) | set(
        range(S, S + scene.n_quad_real))
    say("B1", scene=label, primitives_that_win=len(winners & prims),
        of=len(prims))


def shade_bytes(state, k1, use_pair, last, out):
    """What B2 must read and write per call in this slice (no lights):
    the state and hit fields its outputs depend on, and the outputs. The
    last bounce needs only d.y (sky), throughput, acc, active, j, mid and
    u, v; the others add o, d.x, d.z, the key, p and n; the pair atlas adds
    row, sub, ptex, pnm, the two texel words and the tangent frame."""
    one = nbytes(state["d"][0])          # one f32 / i32 row
    rows = 3 + 3 + 1 + 1 + 2             # acc, throughput, d.y, j, mid, u v
    if not last:
        rows += 3 + 2 + 1 + 3 + 3        # o, d.x d.z, key, p, n
    if use_pair:
        rows += 4 + 2 + 6                # row sub ptex pnm, words, tan bitan
    return rows * one + nbytes(state["active"]) + nbytes(out)


def record_phase(scene, stats):
    """B1 tex_out=2 and B2 rec_out (the record forward of the backward)
    against their plain versions at the flagship shapes, on the textured
    box: camera rays and the bounce-1 rays scattered from them."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    itab, stab = integrator.prepare(scene)
    cfg = RenderConfig()
    state = integrator._init_state(o, d, tm)
    for b in (0, 1):
        bkeys = rng.salted(keys, b)

        def fh(mode):
            return kintersect.first_hits(
                scene, state["o"], state["d"], state["time"],
                state["active"], 1e-5, 2, kernels=mode, tables=itab)

        k1, k1p = fh("auto"), fh("off")
        live = state["active"]
        mism, err = compare(k1, k1p, live)
        check(f"first_hits tex_out=2 b{b}", mism, err)
        if int((k1p["idx_t"][live] > 0).sum()) == 0:
            raise AssertionError("tex_out=2: no lane reads the atlas")
        ms = timed(lambda: fh("auto"), 20)
        say("B1-rec", scene="cornell_textured", bounce=b, tex_out=2,
            rays=int(live.sum()), mismatches=mism, max_abs_err=f"{err:.3g}",
            ms=f"{ms:.4f}", plain_ms=f"{timed(lambda: fh('off'), 3):.4f}",
            device_ms=device_ms(lambda: fh("auto"), 20, "first_hits"),
            bound_ms=f"{bound_ms(nbytes(state['o'], state['d'], tm, live,
                                        itab, k1)):.4f}")
        stats["first_hits"].append((err, ms, None, None))

        def sh(mode):
            return kshade.shade_scatter(
                scene, cfg, state, bkeys, k1p, BOUNCES - b, use_pair=True,
                kernels=mode, tables=stab, rec_out=True)

        (got, grec), (want, wrec) = sh("auto"), sh("off")
        mism, err = compare(dict(got, rec=grec), dict(want, rec=wrec))
        check(f"shade_scatter rec_out b{b}", mism, err)
        ms = timed(lambda: sh("auto"), 20)
        bms = bound_ms(shade_bytes(state, k1p, True, False, (got, grec)))
        say("B2-rec", scene="cornell_textured", bounce=b, rec_out=True,
            mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{timed(lambda: sh('off'), 3):.4f}",
            device_ms=device_ms(lambda: sh("auto"), 20, "shade_scatter"),
            bound_ms=f"{bms:.4f}")
        stats["shade_scatter"].append((err, ms, None, None))
        state = want


def record_sample(scene, cfg):
    """One recorded 850x480 sample (kernels on): the backward's inputs."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
        _, rec, states = integrator._trace_loop(
            scene, cfg, o, d, tm, keys, integrator.prepare(scene),
            with_rec=True)
    return tm, keys, rec, states


def bwd_phase(label, scene, stats):
    """B3 against its plain version on the recorded inputs of one sample:
    the last bounce and bounce 0, both compat modes."""
    tables = kbwd.bwd_tables(scene)
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    has_pair = scene.pair_pack.shape[0] > 1
    gen = torch.Generator(device=DEV).manual_seed(5)
    N = W * H
    for compat in ("reference", "physical"):
        cfg = RenderConfig(compat=compat, max_bounces=BOUNCES)
        tm, keys, rec, states = record_sample(scene, cfg)
        for b in (BOUNCES - 1, 0):
            last = b == BOUNCES - 1
            gcar = torch.randn((12, N), generator=gen, device=DEV)
            if last:
                gcar[:9] = 0.0
            st10, j = states[b], rec[b][0][0]
            args = (st10, j, rec[b][1], tables, rng.salted(keys, b), tm,
                    gcar, float(BOUNCES - b), float(scene.dark_sky))
            kw = dict(S=S, Q=Q, ref=compat == "reference",
                      eps=cfg.epsilon, has_pair=has_pair, last=last)

            def run(mode):
                return kbwd.bounce_bwd_tiles(*args, kernels=mode, **kw)

            got, want = run("auto"), run("off")
            dead = st10[9] < 0.5
            mism, err = 0, 0.0
            for g, w in zip(got, want):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"bounce_bwd {label}: non-finite")
                mism += int((g[:, dead] != w[:, dead]).sum())
                rel = (g - w).abs() / torch.clamp_min(w.abs(), 1.0)
                err = max(err, float(rel.max()))
            if mism != 0 or err > BWD_RTOL:
                raise AssertionError(
                    f"bounce_bwd {label} {compat} b{b}: {mism} pass-through "
                    f"mismatches, max rel err {err:.3g} > {BWD_RTOL}")
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            ms = timed(lambda: run("auto"), 20)
            pms = timed(lambda: run("off"), 3)
            n_act = int((~dead).sum())
            bms = bound_ms(bwd_bytes(n_act, N, last, has_pair, tables))
            # a probe of what warps that mix active and dead lanes cost:
            # the same lanes with the active ones first
            perm = torch.argsort(dead.to(torch.int32), stable=True)
            pargs = (st10[:, perm], j[perm], rec[b][1][:, perm], tables,
                     args[4][perm], tm[perm], gcar[:, perm], *args[7:])
            say("B3", scene=label, compat=compat, bounce=b, last=last,
                lanes=N, active=n_act,
                passthrough_mismatches=mism,
                max_rel_err=f"{err:.3g}", max_abs_err=f"{abs_err:.3g}",
                ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
                device_ms=device_ms(lambda: run("auto"), 20, "bounce_bwd"),
                active_first_device_ms=device_ms(
                    lambda: kbwd.bounce_bwd_tiles(*pargs, **kw), 20,
                    "bounce_bwd"),
                bound_ms=f"{bms:.4f}")
            stats["bounce_bwd"].append((abs_err, ms, pms, bms))


def bwd_bytes(n_active, n, last, has_pair, tables):
    """What B3 must read and write per call. An active lane reads st10,
    j, time, the texel record (img and ptex; with an atlas also rnm and
    pnm) and gpix, and before the last bounce also the key and the
    next-state cotangents; a lane that is not active reads its active
    flag and, before the last bounce, the next-state cotangents it passes
    through; every lane writes a, b and c (62 f32); the small tables are
    read once."""
    live = 10 + 1 + 1 + (8 if has_pair else 4) + 3 + (0 if last else 1 + 9)
    dead = 1 + (0 if last else 9)
    return (4 * (n_active * live + (n - n_active) * dead + n * 62)
            + nbytes(tables))


def tf32_phase():
    """The sweep's accumulation matmuls run in full f32 where the caller
    allows TF32, and leave the caller's setting as it was: rows of
    1 + 2**-13 (exact in f32, 1 in TF32) summed 256 to a column give
    256 + 2**-5, exact in f32 in any summation order."""
    rows = torch.full((45, 4096), 1.0 + 2.0 ** -13, device=DEV)
    idx = torch.arange(4096, device=DEV) % 16
    want = 256.0 + 2.0 ** -5
    torch.backends.cuda.matmul.allow_tf32 = True
    got = replay_bwd._onehot_accum(torch.zeros((45, 16), device=DEV), idx,
                                   rows)
    restored = torch.backends.cuda.matmul.allow_tf32
    oh = (idx[:, None] == torch.arange(16, device=DEV)[None, :]).float()
    tf32_err = float((rows @ oh - want).abs().max())  # the product in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    err = float((got - want).abs().max())
    if err != 0.0 or not restored:
        raise AssertionError(f"one-hot accumulation: max |err| {err} under "
                             f"a caller's TF32, setting restored {restored}")
    say("tf32", accum_max_abs_err=err, caller_setting_restored=restored,
        same_product_in_tf32_err=tf32_err)


def fold_phase(scene, stats):
    """B4 against its plain version on the real update stream of one
    textured sample (bounces 0..4 of 850x480: 2.04M updates), its
    determinism, the library yardstick, and a skewed stream."""
    cfg = RenderConfig(max_bounces=BOUNCES)
    tm, keys, rec, states = record_sample(scene, cfg)
    N = W * H
    g = torch.full((N, 3), 1.0 / (3 * N * SPP), device=DEV)
    with torch.no_grad():
        _, _, _, _, gtex = replay_bwd.replay_backward(
            scene, cfg, tm, keys, rec, states, g)
    idx = torch.cat([r[0][2] for r in rec[:-1]])
    gx, gy, gz = (torch.cat([t[a] for t in gtex]) for a in range(3))
    data = torch.zeros_like(scene.tex_data)
    P, M = data.shape[0], idx.numel()

    def run(mode, ix=idx):
        return kfold.sorted_fold(data, ix, gx, gy, gz, kernels=mode)

    got, want = run("auto"), run("off")
    scale = float(want.abs().max())
    bad = (got - want).abs() > FOLD_RTOL * want.abs() + FOLD_RTOL * scale
    err = float((got - want).abs().max())
    if bool(bad.any()) or scale == 0.0:
        raise AssertionError(f"sorted_fold: {int(bad.sum())} texels off "
                             f"(max abs err {err:.3g}, max|plain| {scale})")
    again = run("auto")
    if not torch.equal(got, again):
        raise AssertionError("sorted_fold: two runs differ (not "
                             "deterministic)")
    ms = timed(lambda: run("auto"), 20)
    pms = timed(lambda: run("off"), 3)
    g3 = torch.stack([gx, gy, gz], dim=1)
    lms = timed(lambda: torch.zeros_like(data).index_add_(0, idx, g3), 20)
    bms = bound_ms(nbytes(idx, gx, gy, gz, data, got))
    hot = idx.clone()
    hot[: M // 2] = torch.randint(0, 5, (M // 2,), device=DEV,
                                  generator=torch.Generator(
                                      device=DEV).manual_seed(1),
                                  dtype=hot.dtype)
    hms = timed(lambda: run("auto", hot), 5)
    say("B4", scene="cornell_textured", updates=M, texels=P,
        max_abs_err=f"{err:.3g}", max_abs_plain=f"{scale:.3g}",
        deterministic=True, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        library_ms=f"{lms:.4f}",
        device_ms=device_ms(lambda: run("auto"), 20, "sorted_fold"),
        bound_ms=f"{bms:.4f}", skewed_ms=f"{hms:.4f}",
        skewed_device_ms=device_ms(lambda: run("auto", hot), 5,
                                   "sorted_fold"))
    stats["sorted_fold"].append((err, ms, pms, bms, lms))


def protocol_grads(scene, cam, cfg, spp, trainable):
    """The bench.py protocol loss and its gradients: (loss, {name: grad})."""
    params = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in trainable}
    s2 = dataclasses.replace(scene, **params)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    loss = renderer.render_pixels(s2, cam, cfg, W, H, pid, spp,
                                  cfg.seed).div(spp).mean()
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}


def reset_launches():
    for m in (kintersect, kshade, kbwd, kfold):
        m.LAUNCHES = 0


def protocol_phase(label, sb, spp, trainable=TRAINABLE):
    """fwd+bwd of the protocol loss through render_pixels and
    loss.backward(), with launch counts, then the 1-spp gradients against
    the same backward on the plain path (kernels="off") on the card."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(max_bounces=BOUNCES)
    # warm-up: one whole step, so the timed step, as in a training loop,
    # finds the allocator's cache grown (the first step of a box pays
    # ~0.15 s of cudaMalloc for the record)
    protocol_grads(scene, cam, cfg, spp, trainable)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = protocol_grads(scene, cam, cfg, spp, trainable)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {"first_hits": kintersect.LAUNCHES,
                "shade_scatter": kshade.LAUNCHES,
                "bounce_bwd": kbwd.LAUNCHES, "sorted_fold": kfold.LAUNCHES}
    folds = spp if ("tex_data" in trainable
                    and scene.tex_data.shape[0] > 1) else 0
    expect = {"first_hits": spp * BOUNCES, "shade_scatter": spp * BOUNCES,
              "bounce_bwd": spp * BOUNCES, "sorted_fold": folds}
    if launches != expect:
        raise AssertionError(f"protocol {label}: launches {launches}, "
                             f"expected {expect}")
    peak = torch.cuda.max_memory_allocated()
    for k, gr in grads.items():
        if not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"protocol {label}: {k} grad not finite")
    if float(grads["mat_diffuse"].abs().max()) == 0.0:
        raise AssertionError(f"protocol {label}: mat_diffuse grad is zero")
    # 1 spp against the plain path on the card
    _, gk = protocol_grads(scene, cam, cfg, 1, trainable)
    _, gp = protocol_grads(scene, cam, dataclasses.replace(cfg,
                                                           kernels="off"),
                           1, trainable)
    rel = {}
    for k in trainable:
        scale = float(gp[k].abs().max())
        diff = float((gk[k] - gp[k]).abs().max())
        rel[k] = diff / scale if scale > 0 else diff
        if rel[k] > GRAD_RTOL:
            raise AssertionError(f"protocol {label}: {k} 1-spp grad rel "
                                 f"err {rel[k]:.3g} > {GRAD_RTOL}")
    say("protocol", scene=label, size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        trainable="+".join(trainable), loss=f"{float(loss):.6g}",
        fwdbwd_s=f"{step_s:.4f}",
        fwdbwd_primary_rays_per_s=f"{W * H * spp / step_s:.0f}",
        peak_mem_gb=f"{peak / 1e9:.3f}", launches=launches,
        grad_max_abs={k: f"{float(v.abs().max()):.3g}"
                      for k, v in grads.items()},
        grad_rel_err_1spp={k: f"{v:.3g}" for k, v in rel.items()})
    return launches


def profile_phase(label, sb, trainable=TRAINABLE):
    """Where the time of one 16-spp protocol fwd+bwd goes (or, with no
    trainable field, of one 16-spp forward `render_pixels`): torch.profiler
    over the step (its wall includes the profiler's own overhead), device
    busy time summed over every kernel, the idle share, and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(max_bounces=BOUNCES)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)

    def step():
        if trainable:
            protocol_grads(scene, cam, cfg, SPP, trainable)
        else:
            with torch.no_grad():
                renderer.render_pixels(scene, cam, cfg, W, H, pid, SPP,
                                       cfg.seed)

    step()                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    say("profile", scene=label, spp=SPP,
        step="+".join(trainable) if trainable else "forward",
        wall_ms=f"{wall_ms:.1f}", device_busy_ms=f"{busy_ms:.1f}",
        idle_share=f"{1.0 - busy_ms / wall_ms:.3f}",
        device_launches=sum(e.count for e in evs),
        top=[(e.key[:48], f"{e.self_device_time_total / 1e3:.2f}ms",
              e.count) for e in top])


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
             if "registers" in ln or "spill" in ln]
    say("build", seconds=f"{build_s:.2f}",
        nvcc_seconds=_build.BUILD_SECONDS, ptxas=ptxas)

    stats = {"first_hits": [], "shade_scatter": [], "bounce_bwd": [],
             "sorted_fold": []}
    flat_sb = zoo.setup_cornell_box(W / H)
    pair_sb = fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL)
    flat_scene = compile_scene(flat_sb, device=DEV)
    kernel_phase("cornell", flat_scene, stats)
    pair_scene = compile_scene(pair_sb, device=DEV)
    if not pair_scene.pair_mode or pair_scene.pair_pack.shape[0] <= 1:
        raise AssertionError("textured Cornell did not build a pair atlas")
    kernel_phase("cornell_textured", pair_scene, stats)

    render_phase("cornell", flat_sb, SPP)
    render_phase("cornell_textured", pair_sb, PAIR_SPP)

    # the backward
    tf32_phase()
    record_phase(pair_scene, stats)
    bwd_phase("cornell", flat_scene, stats)
    bwd_phase("cornell_textured", pair_scene, stats)
    fold_phase(pair_scene, stats)
    launches = protocol_phase("cornell", flat_sb, SPP)
    launches_tex = protocol_phase("cornell_textured", pair_sb, SPP)
    protocol_phase("cornell_textured", pair_sb, SPP,
                   trainable=("mat_diffuse", "sph_center"))
    launches["sorted_fold"] = launches_tex["sorted_fold"]
    profile_phase("cornell", flat_sb, trainable=())
    profile_phase("cornell", flat_sb)
    profile_phase("cornell_textured", pair_sb)

    # representative calls: B1 cornell bounce 1, B2 cornell bounce 1
    # reference, B3 cornell reference bounce 0, B4 the textured stream.
    # Launch counts: the flat box's 16-spp protocol run (B4: the
    # textured box's, the flat box has no atlas to fold onto)
    rows = []
    for kname, src, tpu, pick in (
            ("first_hits", "tracer_torch/kernels/csrc/first_hits.cu",
             "tracer/kernels/intersect.py:382", 1),
            ("shade_scatter", "tracer_torch/kernels/csrc/shade_scatter.cu",
             "tracer/kernels/shade.py:382", 3),
            ("bounce_bwd", "tracer_torch/kernels/csrc/bounce_bwd.cu",
             "tracer/kernels/shade_bwd.py:97", 1),
            ("sorted_fold", "tracer_torch/kernels/csrc/sorted_fold.cu",
             "tracer/kernels/fold.py:120", 0)):
        recs = stats[kname]
        err = max(r[0] for r in recs)
        ms, pms, bms = recs[pick][1:4]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[kname],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": "bytes",
                     "library_ms": recs[pick][4] if kname == "sorted_fold"
                     else None})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
