"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --dist    # the build, distribution and the
                                    # multi-host harness alone
    python3 chip_smoke.py --bench   # the build and the rays/s benchmark
    python3 chip_smoke.py --graph   # the build and the compiled entry
                                    # points against their eager bodies
                                    # (one NCCL rank's sharded ones too)

Builds the port's CUDA kernels from `tracer_torch/kernels/csrc/` (printing
each kernel's registers and spills), holds each against its plain PyTorch
version at the flagship shapes (B1 and B2 bounce by bounce, all six
bounces of both boxes, with each bounce's live share and the byte and
operation bounds of the slim record and the in-place state), renders the
Cornell box at 850x480, 16 spp, 6 bounces through
`tracer_torch.render.renderer.render`, checks that the render went through
the forward kernels and the finish kernel, and repeats the checks on a
Cornell whose textures and normal maps are seeded arrays (the pair-atlas
branch). The finish kernel (`kernels/finish.py`) against numpy's finish
on the Cornell frame's film and on a film of special values, with its
time, its bound, the plain time and the image's pinned and pageable
copies (`[finish]`). The camera kernel (`kernels/camera.py`) against the
torch chain of `renderer.camera_batch`, bit for bit, with its time, its
bound and the chain's time and launches (`[camera]`). Then the backward:
the record variants of the forward kernels, the bounce adjoint (B3, with
the row-cotangent tables it adds to) and the texel fold (B4, on the real
record and on all-zero, skewed, non-finite, empty and odd-sized streams)
against their plain versions on one recorded 850x480 sample, each also run
twice for bit equality, and the flagship protocol's fwd+bwd
(`render_pixels` + `loss.backward()`, mat_diffuse, sph_center and tex_data
trainable) on both boxes, with its launch counts, its 1-spp gradients held
against the plain path, and a profile that counts the GEMM launches left in
the step (none per bounce). Then lit mesh scenes: the BVH walk (B5) and the
soft shadows (B6) against their plain versions on 408,000 lanes
(flamingo_standin: `setup_flamingo` with a 52,900-triangle stand-in mesh;
the flamingo_pond layout with stand-ins of 11,236 and 52,900 triangles;
random_spheres, whose shadows test tables only), with each ray's walk steps
(p50/p90/p99/max, counted by the plain versions), the persistent blocks,
and probes of the JAX package's sorted dispatch in front of them; B1 and B2
with mesh and light inputs, and the renders of flamingo_standin (16 spp)
and random_spheres (4 spp) through `render`, their launch counts and their
1-spp radiance held against the plain path. Last, the scenes that the
first port's fixed limits refused: lit walls of 700, 1,300 and 3,000
quads (`testing.tiled_wall`: the tables of B1, then B2 and B6 outgrow
dynamic shared memory and are read through L2) and 17 meshes
(`testing.mesh_grid`: B5 keeps 16 roots in shared memory and reads the
17th through L1), B5, B1, B6 and B2 against their plain versions at
bounces 0 and 1, with the table variant each took (checked against the
one the case is there to exercise). Then every zoo scene and its
gradient: on `testing.rt_weekend_standin` (`setup_rt_in_a_weekend` with a
seeded 1024x2048 sky and 512x1024 sun texture: an image sky, a textured
emissive sphere, 3 lights) B1 with the sphere-UV index (tex_out 1 and 2)
and B2 with the image sky (with and without rec_out) against their plain
versions at bounces 0 and 1 under both compat modes, each beside the
same call without the new input; its 16-spp render through `render`
(B1, B2 and B6 launched 96 times) and that of `raccoon_standin` (a sky,
three textured glass and mirror spheres, a 5,000-triangle stand-in
mesh); the textured Cornell under `packed_atlas="off"` (the general
route: B1, then torch ops; B2 does not run there); and the general
backward (the replay's vjp, outside the hand-written class) of the
protocol step on rt_weekend_standin (mat_diffuse, sph_center, tex_data;
the fold holds every bounce, the last one too) and on flamingo_standin
(mesh_verts, mat_diffuse, sph_center), with the step's median wall time
over reps and its spread, the peak memory, the launch counts, whether
every rep's gradients have the same bits, the same step with the row
sums on `index_add_` in turns beside it, and the 1-spp gradients against
the plain path, and a profile of the rt_weekend_standin step (device
busy, idle share, launches, top kernels). Then the replay's row sums
(`kernels/rowsum.py`, the row-sum kernel of `csrc/row_sum.cu`): the
kernels left in the general and the plain autodiff steps whose names say
that they sum by atomics or scatter (`[atomics]`, on the kernel's route
and on `index_add_`'s, with torch's deterministic mode once as a
diagnostic, restored afterwards), and the row-sum kernel against its
plain version (`index_add_`) on the row sums those steps make at every
table shape: sphere and material rows, the lit textured box's quads and
1024² atlases, tiled_wall_3000's 3,000 quads and flamingo_standin's mesh
vertices (`[rowsum]`: error, bit-equality of two calls, ms, device ms,
`index_add_`'s ms, the byte bound).
Last, the port's entry points (`entry_point_phases`), each path with the
launch counts reset just before it and read just after: `train.fit` at
850x480, 6 bounces (`[train]` lines: Cornell at 16 spp with mat_diffuse,
sph_center and cam_quaternion, 5 steps, a bit-equal resume of params and
Adam state; the textured Cornell at 16 spp with tex_data and mat_diffuse,
whose guard renders the exact atlas, so B2 is not launched, with the
first step's gradients against the plain path and the stale-pack check;
rt_weekend_standin at 4 spp through the general backward, whose resume is
held bit-equal too: its row sums run in a fixed order), each with
its losses, grad norms, step walls, peak memory, launches a step, the Adam
update alone and the checkpoint's load and save; the tiled checkpointed
render of Cornell (`[tiled]`: 28 tiles of 128x128 px, bit-equal to the
direct render, half the tiles deleted and resumed, a pure skip, host 1 of
2); and the CLI in-process (`[cli]`: render, render --ckpt-dir, probe,
benchmark --occupancy / --compile / --profile, the bare benchmark,
grad-check, train, scenes, then `python -m tracer_torch.cli scenes` in a
subprocess). Then the compiled entry points (`graph_phase`,
`tracer_torch/render/graphs.py`: CUDA graphs captured at a first call and
replayed from the second), each against its eager body in the same call
(`[graph]` lines): the Cornell 16-spp frame and the bench's frame scalar,
the Cornell and textured Cornell 16-spp protocol steps, the frames of
flamingo_standin, rt_weekend_standin (fused and general) and
random_spheres at 4 spp, 4 `fit` steps on Cornell and their resume, the
28-tile render against the direct frame: every output bit-equal, the
launches of a replay, the host syncs of a compiled and an eager call,
walls in turns, the device's idle share under the profiler, each graph's
capture seconds and pool; and a body that reads the card, whose capture
must raise. Then the keys by shape (`graph_keys_phase`): a camera path of
8 cameras around the Cornell box at 16 spp on one capture, the seed,
first-sample and spp sweeps on that graph with none, the sample graph's
kernels, capture and pool, and the textured training step on new leaves
and a second `compile_scene` of the same builder (one capture; 8 more
calls on new leaves, none) with the cost of copying its leaves in, each
frame and step bit-equal to its eager body with the formula's launches.
Then the compiled routes beyond the Cornell family
(`graph_general_phase`): the general 16-spp protocol step on
rt_weekend_standin and flamingo_standin, the plain autodiff step
(custom_vjp="off") on Cornell at 16 spp and flamingo_standin at 4 spp, 4
`fit` steps on rt_weekend_standin at 4 spp and their resume, and the
`benchmark --occupancy` frame, each held as above (a replay's launches
equal to the eager call's, 0 host syncs in a replay). The Cornell renders
and protocol steps above go through the same graphs (their timed call is
a replay); the phases that time, spy on or profile the eager general and
plain autodiff steps run inside `graphs.CACHE.disabled()`. Then
distribution (`dist_phases`): (a) a process group of one rank over NCCL,
whose (1, 1) mesh renders the 16-spp Cornell frame by a graph bit-equal
to its eager body and to `render_pixels / 16`, and whose `fit(mesh=)`,
compiled with its all-reduce in the graph, equals its eager run, its
resume and `fit()` bit for bit over 4 steps (`[graph]` lines); (b) two
ranks sharing the card over gloo (NCCL refuses two
ranks on one card) on the (2, 1) and (1, 2) meshes: the gathered frame
against the unsharded render (bit-equal on (2, 1), within 1e-5 on
(1, 2)), `train_step` within rtol 1e-4 of the unsharded step, each rank's
launches, walls and seconds in collectives, and `render_image_multihost`
on 2 hosts x 1 bit-equal to `render`; (c) `dryrun_multichip(2)`; (d) with
two cards, (b) over NCCL too (the line says which variant ran), and with
four, four NCCL ranks on (2, 2) and (4, 1), the pod mesh sized by the
card count, `dryrun_multichip(4)` and README's four-card recipe (shell
processes joined by the env vars); each step's gradients and grad norm
are held against the unsharded step's, and each rank's compiled frame
and step against its eager ones (graphs on NCCL, eager on gloo by the
rule; `[graph]` lines). Last, the
plain autodiff backward (`plain_ad_phase`, custom_vjp="off"): the Cornell
16-spp protocol step and flamingo_standin at 4 spp (mesh_verts), their
walls, peak memory, launches (B1 once a bounce, B5 and B6 on the mesh
scene, the row sums; no B2, B3 or B4), whether every rep's gradients
have the same bits, and 1-spp gradients against kernels="off" and
against custom_vjp="on". Then the rays/s benchmark (`bench_phase`):
`tracer_torch.bench.main()` at 850x480, 16 spp, 6 bounces, 3 reps, with
BENCH_SCENES=1 (its JSON on a `[bench]` line, its launches against what
its calls must launch, its peak memory), then its timed bodies one call at
a time: the walls of 3 synced calls (median, spread) of the frame and of
both protocol steps with one call's launches, the host synchronisations
of one call (torch's sync debug mode), the peak memory of one step and of
3 steps queued, and the 1-spp frame scalar against kernels="off".
Last, the multi-host weak-scaling harness (`multihost_phase`,
`tracer_torch.bench_multihost.driver()`: gloo ranks sharing the one card,
one rank a host, a plumbing run; with `--dist` on four cards, NCCL at 2
ranks a host), its JSON on a line of its own, its keys against
MULTIHOST_SCALING.json's. Every phase prints one line; any failure is
an uncaught exception and a non-zero exit. The last three lines are the
card's name and power limit (nvidia-smi), a JSON record of the seven
kernels and `{"ok": true, ...}`.

Tolerances: discrete outputs (winning primitive, material, texel indices,
active flags) must match exactly; forward float outputs within atol=2e-5,
the tolerance the JAX package holds its own kernels to
(tests/test_kernels.py). The bounce adjoint: 0 mismatches on pass-through
lanes and 2e-5 * max(1, |plain|) elsewhere (the same expressions, built
with --fmad=false; cosf/sinf may differ by an ulp). Its tables, the fold
and the gradients: f32 summation order (the kernels sum in a fixed tree
and sorted order, the plain versions in cuBLAS's and stream order): the
tables within 1e-5 of their largest entry, the fold rtol 1e-5 / atol
1e-5 * max|plain| (NaN and inf where the plain fold has them), the row
sums (and their plain version) against float64 sums within their f32
summation error bounds (`rowsum_check`), max relative error 1e-4 for
the 1-spp gradients. B5's (t, tri) and B6's
factors must match exactly. B1's sphere-UV index and B2's image sky: 0
discrete mismatches (a mismatch where B1's texture coordinates differ
from the plain version's by at most an ulp of acos / atan2 would be
counted as `ulp_ties` and explained; any other fails).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available()"
                     " is false)")

from tracer_torch import cli  # noqa: E402
from tracer_torch import train as T  # noqa: E402
from tracer_torch.core import rng  # noqa: E402
from tracer_torch.core.config import RenderConfig  # noqa: E402
from tracer_torch.io.ppm import write_ppm  # noqa: E402
from tracer_torch.kernels import _build  # noqa: E402
from tracer_torch.kernels import camera as kcamera  # noqa: E402
from tracer_torch.kernels import finish as kfinish  # noqa: E402
from tracer_torch.kernels import fold as kfold  # noqa: E402
from tracer_torch.kernels import intersect as kintersect  # noqa: E402
from tracer_torch.kernels import rowsum as krowsum  # noqa: E402
from tracer_torch.kernels import shade as kshade  # noqa: E402
from tracer_torch.kernels import shade_bwd as kbwd  # noqa: E402
from tracer_torch.kernels import shadow as kshadow  # noqa: E402
from tracer_torch.kernels import traverse as ktraverse  # noqa: E402
from tracer_torch.render import graphs, integrator, renderer  # noqa: E402
from tracer_torch.render import replay_bwd  # noqa: E402
from tracer_torch.render.camera import (  # noqa: E402
    Camera, default_camera, look_at_quaternion)
from tracer_torch.render.film import TileManifest, to_image  # noqa: E402
from tracer_torch.scene.device import compile_scene  # noqa: E402
from tracer_torch.scenes import zoo  # noqa: E402
from tracer_torch.testing import (  # noqa: E402
    FULL, fill_cornell_textures, finish_film, flamingo_pond_standin,
    flamingo_standin, mesh_grid, raccoon_standin, rt_weekend_standin,
    tiled_wall)

W, H, SPP, BOUNCES = 850, 480, 16, 6
PAIR_SPP = 2
ATOL = 2e-5
BWD_RTOL = 2e-5     # bounce adjoint vs plain, relative to max(1, |plain|)
FOLD_RTOL = 1e-5    # fold vs plain (f32 summation order)
GRAD_RTOL = 1e-4    # 1-spp protocol gradients vs the plain path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM peak f32 rate outside the tensor cores
# f32 operations of the plain walk's expressions: a node visit (the slab
# test: 6 sub, 6 mul, 12 min/max, 2 min/max, 1 compare) and a triangle
# test (dot products, the division, the point, the barycentrics, the
# compares); a sphere or quad test of the shadow pass; a shadow sample ray
# (jitter draw, offset, length, normalisation, origin) with its hashes
OPS_VISIT, OPS_TRI, OPS_TABLE, OPS_SAMPLE = 27, 45, 30, 60
# B1: a live lane's winner detail (a sphere's or a quad's: dot and cross
# products, two square roots, three divisions), on top of OPS_TABLE per
# sphere and quad it tests; B2: an active lane's shading and scatter
# (sky, material select, checker, normal map, emission, BSDF, hash rounds,
# state update) and each light's term
OPS_DETAIL, OPS_SHADE, OPS_LIGHT = 60, 150, 25
DEV = torch.device("cuda", 0)
DISCRETE = ("j", "tid", "mid", "row", "sub", "idx_t", "idx_n", "active")
TRAINABLE = ("mat_diffuse", "sph_center", "tex_data")
# what one B4 call runs on the card: its kernels and the copy out = data
FOLD_OPS = ("fold_", "Memcpy DtoD")
LARGE_M = 400       # unused material rows that push B3's tables to global


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


def enqueue_ms(fn, reps):
    """Host ms per call of `fn` to enqueue its work (no synchronise inside
    the timed calls): what a host-bound caller pays per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return f"{(t1 - t0) * 1e3 / reps:.4f}"


def timed_fresh(fn, make, reps):
    """ms per call on the card of fn(x), each call on its own input x =
    make(), all made before the timed window: a call that updates its
    input in place (B2) is not timed on its own output."""
    xs = [make() for _ in range(reps + 1)]
    fn(xs[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x in xs[1:]:
        fn(x)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms_fresh(fn, make, reps, kernel):
    """`device_ms` of fn(x), each call on its own input x = make(), all
    made before the profiled window."""
    xs = iter([make() for _ in range(reps + 1)])
    return device_ms(lambda: fn(next(xs)), reps, kernel)


def device_ms(fn, reps, kernel):
    """The kernel's own device time per call of `fn`, from torch.profiler:
    every CUDA kernel (or copy) whose name holds `kernel` or one of a tuple
    of names (the per-call times above also hold the wrapper's host work
    and its glue kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    evs = [e for e in prof.key_averages()
           if any(k in e.key for k in names)]
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


def lane_bytes(live, *per_lane):
    """Bytes of inputs that a kernel reads only on live lanes: the live
    mask for every lane, the per-lane tensors ([..., N], tuples flattened)
    for the live lanes only."""
    return nbytes(live) + int(live.sum()) * nbytes(*per_lane) // live.numel()


def tree_bytes(scene, tree, cnt):
    """The tree bytes a walk must read, from the plain walk's marks
    (`primitives.skip_walk`): the used columns of every node any lane read
    (lo, hi: 6 f32; leaf row, skip: 2 i32) and of every real triangle in a
    leaf any lane tested (18 of its slot's 32 f32)."""
    if "nodes_seen" not in cnt:
        return 0
    _, nodes_i, leaf = tree
    rows = nodes_i[cnt["leaves_seen"], 0].long()
    tids = leaf[rows].reshape(-1, scene.leaf_width, ktraverse.TRI_COLS)[..., 17]
    real = int((tids != float(scene.tri_a.shape[0] - 1)).sum())
    return 32 * int(cnt["nodes_seen"].sum()) + 72 * real


def bound_ms(nb):
    """The least time the card could take to move `nb` bytes (every
    input read once, every output written once), in ms."""
    return nb / HBM_BYTES_PER_S * 1e3


def bound2(nb, ops):
    """(bound_ms, bound_by): the larger of the byte time and the
    operation time at the card's peak f32 rate."""
    b, o = bound_ms(nb), ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


class Rec(NamedTuple):
    """One kernel's comparison and timing, a candidate row of the
    `kernels` record."""
    err: float
    ms: float
    plain_ms: float | None
    bound_ms: float | None
    bound_by: str = "bytes"
    library_ms: float | None = None


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


def kernel_phase(label, scene, stats, bounces=(0, 1)):
    """B1 and B2 against their plain versions at the flagship shapes,
    bounce by bounce: camera rays, then the rays the plain path scatters
    from them. Each line gives the live share, the kernel's device time and
    per-call time (B1 as the bounce loop calls it, the slim record; B2 on
    a fresh copy of the state per call, since it updates it in place),
    `bound_ms` (the function's full outputs for every lane, as the first
    kernels wrote them), `bound_new_ms` (the bytes the slim record and the
    in-place state need), the operations bound `ops_ms` and `bound2_ms`,
    the larger of `bound_new_ms` and `ops_ms`."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    tables = integrator.prepare(scene)
    itab, stab = tables.intersect, tables.shade
    use_pair = scene.pair_pack.shape[0] > 1
    cfgs = {c: RenderConfig(compat=c) for c in ("reference", "physical")}
    state = integrator._init_state(o, d, tm)
    winners = set()
    Nm = scene.mesh_mat.shape[0]
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    L = scene.light_pos.shape[0]
    n_tests = min(scene.n_sph_real, S) + min(scene.n_quad_real, Q)
    for b in bounces:
        bkeys = rng.salted(keys, b)
        args = (scene, state["o"], state["d"], state["time"],
                state["active"], 1e-5, int(use_pair))
        mesh_in = {}
        if Nm > 0:
            t_raw, tri_raw = ktraverse.mesh_closest_hits(
                scene, state["o"], state["d"], state["active"],
                tables=tables.tree)
            mesh_in = dict(t_mesh=t_raw, tri_mesh=tri_raw, mesh=tables.mesh)

        def fh(mode, slim=False):
            return kintersect.first_hits(*args, kernels=mode, tables=itab,
                                         slim=slim, **mesh_in)

        k1 = fh("auto")
        k1p = fh("off")
        live = state["active"]
        mism, err = compare(k1, k1p, live)
        check(f"first_hits {label} b{b}", mism, err)
        winners |= set(k1p["j"][live].unique().tolist())
        N, n_live = live.numel(), int(live.sum())
        ms = timed(lambda: fh("auto", True), 20)
        pms = timed(lambda: fh("off"), 3)
        bms = bound_ms(lane_bytes(live, args[1:4], mesh_in.get("t_mesh"),
                                  mesh_in.get("tri_mesh"))
                       + nbytes(itab, k1, mesh_in.get("mesh")))
        nb_new = (first_hits_bytes(live, int(use_pair), Nm)
                  + nbytes(itab, mesh_in.get("mesh")))
        ops = n_live * (n_tests * OPS_TABLE + OPS_DETAIL)
        b2ms, by = bound2(nb_new, ops)
        say("B1", scene=label, bounce=b, rays=n_live,
            live_share=f"{n_live / N:.3f}",
            meshes=Nm, mesh_winners=int((k1p["j"][live] >= S + Q).sum()),
            tables=kintersect.TABLES, blocks=kintersect.BLOCKS,
            mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}",
            device_ms=device_ms(lambda: fh("auto", True), 20, "first_hits"),
            bound_ms=f"{bms:.4f}", bound_new_ms=f"{bound_ms(nb_new):.4f}",
            ops_ms=f"{ops / F32_OPS_PER_S * 1e3:.4f}",
            bound2_ms=f"{b2ms:.4f}", bound_by=by)
        # the record's bound is that of the contract timed: the slim record
        stats["first_hits"].append(Rec(err, ms, pms, b2ms, by))
        nxt = None
        for compat, last in (("reference", False), ("reference", True),
                             ("physical", False)):
            cfg = cfgs[compat]
            shadows = integrator._shadow_factors_all(
                scene, cfg, k1p["p"], state["time"], bkeys,
                live & (k1p["j"] >= 0), tables)

            def sh(mode, st):
                return kshade.shade_scatter(
                    scene, cfg, st, bkeys, k1p, BOUNCES - b,
                    shadows=shadows, use_pair=use_pair, last=last,
                    kernels=mode, tables=stab, mesh=tables.mesh,
                    quad=itab[1])

            def fresh():
                return integrator.copy_state(state)

            got, want = sh("auto", fresh()), sh("off", fresh())
            if last:
                got, want = dict(acc=got), dict(acc=want)
            mism, err = compare(got, want)
            # physical draws cos/sin, which may differ by an ulp
            check(f"shade_scatter {label} b{b} {compat} last={last}",
                  mism, err)
            ms = timed_fresh(lambda st: sh("auto", st), fresh, 20)
            pms = timed_fresh(lambda st: sh("off", st), fresh, 3)
            # mesh winners also read tid and their 24-float pack row
            hits = live & (k1p["j"] >= 0)
            mesh_rows = 100 * int((live & (k1p["j"] >= S + Q)).sum())
            bms = bound_ms(shade_bytes(state, use_pair, last, L) + mesh_rows)
            nb_new = shade_bytes_new(live, hits, use_pair, last, L) + \
                mesh_rows + nbytes(stab[:2])
            ops = n_live * (OPS_SHADE + L * OPS_LIGHT)
            b2ms, by = bound2(nb_new, ops)
            say("B2", scene=label, bounce=b, compat=compat, last=last,
                meshes=Nm, lights=L, active=n_live,
                live_share=f"{n_live / N:.3f}",
                hit_share=f"{int(hits.sum()) / N:.3f}",
                tables=kshade.TABLES, blocks=kshade.BLOCKS,
                mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
                plain_ms=f"{pms:.4f}",
                device_ms=device_ms_fresh(lambda st: sh("auto", st), fresh,
                                          20, "shade_scatter"),
                bound_ms=f"{bms:.4f}",
                bound_new_ms=f"{bound_ms(nb_new):.4f}",
                ops_ms=f"{ops / F32_OPS_PER_S * 1e3:.4f}",
                bound2_ms=f"{b2ms:.4f}", bound_by=by)
            # the record's bound is that of the contract timed: in place
            stats["shade_scatter"].append(Rec(err, ms, pms, b2ms, by))
            if compat == "reference" and not last:
                nxt = want
        state = nxt
    prims = set(range(scene.n_sph_real)) | set(
        range(S, S + scene.n_quad_real))
    say("B1", scene=label, primitives_that_win=len(winners & prims),
        of=len(prims))


def first_hits_bytes(live, tex_out, n_meshes):
    """What B1 must read and write per call under the slim record: every
    lane's live flag and the integer fields a consumer indexes with
    (j, tid, mid, row, sub; with tex_out=2 also idx_t, idx_n); a live
    lane's o, d, time and mesh hits (t, tri per mesh), and its p, n, u,
    v. Every f32 / i32 is 4 B."""
    n_int = 7 if tex_out == 2 else 5
    return (nbytes(live) + 4 * live.numel() * n_int
            + 4 * int(live.sum()) * (7 + 2 * n_meshes + 8))


def shade_bytes(state, use_pair, last, n_lights=0, rec_out=False):
    """What B2 must read and write per call, as the first kernel's
    contract had it (a fresh output for every lane): the state and hit
    fields its outputs depend on, and the outputs. Every lane reads its
    active flag and acc, and before the last bounce o, d and throughput (a
    lane that is not active passes them on). An active lane also reads j,
    mid, u, v and its shadow factors; on the last bounce throughput and
    d.y (sky), before it the key, p and n; with the pair atlas row, sub,
    ptex, pnm, the two texel words and the tangent frame. The outputs, as
    counted then: acc, before the last bounce also o, d, time, throughput
    and the active flags; with rec_out the [6, N] texel record. Every f32
    / i32 is 4 B."""
    active = state["active"]
    N = active.numel()
    every = 3 + (0 if last else 3 + 3 + 3)
    live = 1 + 1 + 2 + n_lights + (3 + 1 if last else 1 + 3 + 3)
    if use_pair:
        live += 4 + 2 + 6
    out = (4 * N * (3 if last else 13) + (0 if last else N)
           + (24 * N if rec_out else 0))
    return nbytes(active) + 4 * (N * every + int(active.sum()) * live) + out


def shade_bytes_new(active, hits, use_pair, last, n_lights=0):
    """What B2 must read and write per call with the state in place:
    every lane's active flag; an active lane's j, mid, u, v, p, n, d,
    throughput, acc and shadow factors, with the pair atlas row, sub and
    the two texel words, before the last bounce its key; it writes acc,
    and before the last bounce a lane that hits its o, d and throughput, a
    lane that misses its active flag. Every f32 / i32 is 4 B."""
    n_act, n_hit = int(active.sum()), int(hits.sum())
    rd = 2 + 2 + 3 + 3 + 3 + 3 + 3 + n_lights + (0 if last else 1)
    if use_pair:
        rd += 4
    wr = 4 * 3 * n_act
    if not last:
        wr += 4 * 9 * n_hit + (n_act - n_hit)
    return nbytes(active) + 4 * rd * n_act + wr


def record_phase(scene, stats):
    """B1 tex_out=2 and B2 rec_out (the record forward of the backward)
    against their plain versions at the flagship shapes, on the textured
    box: camera rays and the bounce-1 rays scattered from them."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    tables = integrator.prepare(scene)
    itab, stab = tables.intersect, tables.shade
    cfg = RenderConfig()
    state = integrator._init_state(o, d, tm)
    for b in (0, 1):
        bkeys = rng.salted(keys, b)

        def fh(mode, slim=False):
            return kintersect.first_hits(
                scene, state["o"], state["d"], state["time"],
                state["active"], 1e-5, 2, kernels=mode, tables=itab,
                slim=slim)

        k1, k1p = fh("auto"), fh("off")
        live = state["active"]
        mism, err = compare(k1, k1p, live)
        check(f"first_hits tex_out=2 b{b}", mism, err)
        if int((k1p["idx_t"][live] > 0).sum()) == 0:
            raise AssertionError("tex_out=2: no lane reads the atlas")
        ms = timed(lambda: fh("auto", True), 20)
        say("B1-rec", scene="cornell_textured", bounce=b, tex_out=2,
            rays=int(live.sum()),
            live_share=f"{int(live.sum()) / live.numel():.3f}",
            mismatches=mism, max_abs_err=f"{err:.3g}",
            ms=f"{ms:.4f}", plain_ms=f"{timed(lambda: fh('off'), 3):.4f}",
            device_ms=device_ms(lambda: fh("auto", True), 20, "first_hits"),
            bound_ms=f"{bound_ms(lane_bytes(live, state['o'], state['d'],
                                            state['time'])
                                 + nbytes(itab, k1)):.4f}",
            bound_new_ms=f"{bound_ms(first_hits_bytes(live, 2, 0)
                                     + nbytes(itab)):.4f}")
        stats["first_hits"].append(Rec(err, ms, None, None))

        def sh(mode, st):
            return kshade.shade_scatter(
                scene, cfg, st, bkeys, k1p, BOUNCES - b, use_pair=True,
                kernels=mode, tables=stab, rec_out=True, quad=itab[1])

        def fresh():
            return integrator.copy_state(state)

        (got, grec), (want, wrec) = sh("auto", fresh()), sh("off", fresh())
        mism, err = compare(dict(got, rec=grec), dict(want, rec=wrec))
        check(f"shade_scatter rec_out b{b}", mism, err)
        ms = timed_fresh(lambda st: sh("auto", st), fresh, 20)
        bms = bound_ms(shade_bytes(state, True, False, rec_out=True))
        hits = live & (k1p["j"] >= 0)
        nb_new = (shade_bytes_new(live, hits, True, False)
                  + nbytes(grec) + nbytes(stab[:2]))
        say("B2-rec", scene="cornell_textured", bounce=b, rec_out=True,
            live_share=f"{int(live.sum()) / live.numel():.3f}",
            mismatches=mism, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{timed_fresh(lambda st: sh('off', st), fresh, 3):.4f}",
            device_ms=device_ms_fresh(lambda st: sh("auto", st), fresh, 20,
                                      "shade_scatter"),
            bound_ms=f"{bms:.4f}", bound_new_ms=f"{bound_ms(nb_new):.4f}")
        stats["shade_scatter"].append(Rec(err, ms, None, None))
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


def bit_equal(x, y):
    """Same bits (NaN included), or both None."""
    if x is None or y is None:
        return x is None and y is None
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def bwd_phase(label, scene, stats):
    """B3 against its plain version on the recorded inputs of one sample:
    the last bounce and bounce 0, both compat modes, seeded next-state
    cotangents and a seeded nonzero running table. a and b are held per
    lane (0 pass-through mismatches, BWD_RTOL), the tables within
    FOLD_RTOL of their largest entry (summation order), and two runs must
    give the same bits. On the flat box one more case pads the material
    table with LARGE_M unused rows, so that the warp tables no longer fit
    in shared memory and live in global scratch."""
    tables = kbwd.bwd_tables(scene)
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    has_pair = scene.pair_pack.shape[0] > 1
    gen = torch.Generator(device=DEV).manual_seed(5)
    N = W * H
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    large = (tables[0], tables[1], torch.cat(
        [tables[2], tables[2][-1:].expand(LARGE_M, -1)]))
    for compat in ("reference", "physical"):
        cfg = RenderConfig(compat=compat, max_bounces=BOUNCES)
        tm, keys, rec, states = record_sample(scene, cfg)
        cases = [(BOUNCES - 1, tables), (0, tables)]
        if compat == "reference" and not has_pair:
            cases.append((0, large))
        for b, tabs in cases:
            M = tabs[2].shape[0]
            C = kbwd.table_size(S, Q, M)
            last = b == BOUNCES - 1
            gnext = None if last else torch.randn((10, N), generator=gen,
                                                  device=DEV)
            gpix = torch.randn((3, N), generator=gen, device=DEV)
            acc = torch.randn((C,), generator=gen, device=DEV)
            st10, j = states[b], rec[b][0][0]
            args = (st10, j, rec[b][1], tabs, rng.salted(keys, b), tm,
                    gnext, gpix, acc, float(BOUNCES - b),
                    float(scene.dark_sky))
            kw = dict(S=S, Q=Q, ref=compat == "reference",
                      eps=cfg.epsilon, has_pair=has_pair, last=last)

            def run(mode, inputs=args):
                return kbwd.bounce_bwd_tiles(*inputs, kernels=mode, **kw)

            got, want = run("auto"), run("off")
            if not all(bit_equal(g, h) for g, h in zip(got, run("auto"))):
                raise AssertionError(f"bounce_bwd {label} {compat} b{b}: "
                                     "two runs differ")
            dead = st10[9] < 0.5
            mism, err, abs_err = 0, 0.0, 0.0
            for g, w in zip(got[:2], want[:2]):
                if w is None:
                    continue
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"bounce_bwd {label}: non-finite")
                mism += int((g[:, dead] != w[:, dead]).sum())
                rel = (g - w).abs() / torch.clamp_min(w.abs(), 1.0)
                err = max(err, float(rel.max()))
                abs_err = max(abs_err, float((g - w).abs().max()))
            if mism != 0 or err > BWD_RTOL:
                raise AssertionError(
                    f"bounce_bwd {label} {compat} b{b}: {mism} pass-through "
                    f"mismatches, max rel err {err:.3g} > {BWD_RTOL}")
            scale = float(want[2].abs().max())
            tab_err = float((got[2] - want[2]).abs().max())
            if not tab_err <= FOLD_RTOL * scale:
                raise AssertionError(
                    f"bounce_bwd {label} {compat} b{b}: tables max err "
                    f"{tab_err:.3g} > {FOLD_RTOL} x {scale:.3g}")
            abs_err = max(abs_err, tab_err)
            ms = timed(lambda: run("auto"), 20)
            pms = timed(lambda: run("off"), 3)
            n_act = int((~dead).sum())
            bms = bound_ms(bwd_bytes(n_act, N, last, has_pair, tabs, acc))
            # a probe: the same lanes with the active ones first
            perm = torch.argsort(dead.to(torch.int32), stable=True)
            pargs = (st10[:, perm], j[perm], rec[b][1][:, perm], tabs,
                     args[4][perm], tm[perm],
                     None if last else gnext[:, perm], gpix[:, perm],
                     *args[8:])
            say("B3", scene=label, compat=compat, bounce=b, last=last,
                lanes=N, active=n_act, active_share=f"{n_act / N:.3f}",
                table_entries=C, warp_tables=(
                    "shared" if kbwd.scratch_plan(C, sms)[0] else "global"),
                passthrough_mismatches=mism, deterministic=True,
                max_rel_err=f"{err:.3g}", max_abs_err=f"{abs_err:.3g}",
                table_max_abs_err=f"{tab_err:.3g}",
                table_max_abs=f"{scale:.3g}",
                ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
                host_ms=enqueue_ms(lambda: run("auto"), 20),
                device_ms=device_ms(lambda: run("auto"), 20, "bounce_bwd"),
                reduce_device_ms=device_ms(lambda: run("auto"), 20,
                                           "bounce_bwd_reduce"),
                active_first_device_ms=device_ms(
                    lambda: run("auto", pargs), 20, "bounce_bwd"),
                bound_ms=f"{bms:.4f}")
            stats["bounce_bwd"].append(Rec(abs_err, ms, pms, bms))


def bwd_bytes(n_active, n, last, has_pair, tables, acc):
    """What B3 must read and write per call. An active lane reads st10,
    j, time and gpix, with the pair atlas the texel record (8 f32), and
    before the last bounce the key and the next-state cotangents (the
    previous call's a: 10 f32); a lane that is not active reads its
    active flag and, before the last bounce, the next-state cotangents it
    passes through; every lane writes a (10 f32) and, with the pair
    atlas, b (6 f32); the small tables are read once and the running
    tables read and written once."""
    live = 10 + 1 + 1 + 3 + (8 if has_pair else 0) + (0 if last else 1 + 10)
    dead = 1 + (0 if last else 10)
    out = 10 + (6 if has_pair else 0)
    return (4 * (n_active * live + (n - n_active) * dead + n * out)
            + nbytes(tables) + 2 * nbytes(acc))


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


def fold_check(name, got, want):
    """B4 against its plain version: NaN and inf where the plain fold has
    them, the rest within FOLD_RTOL (summation order); the max |err|."""
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isinf(), want.isinf())):
        raise AssertionError(f"sorted_fold {name}: non-finite texels differ")
    fin = torch.isfinite(want)
    g, w = got[fin], want[fin]
    if not bool(torch.equal(got[want.isinf()], want[want.isinf()])):
        raise AssertionError(f"sorted_fold {name}: infinite texels differ")
    scale = float(w.abs().max()) if w.numel() else 0.0
    err = float((g - w).abs().max()) if w.numel() else 0.0
    bad = (g - w).abs() > FOLD_RTOL * w.abs() + FOLD_RTOL * scale
    if bool(bad.any()):
        raise AssertionError(f"sorted_fold {name}: {int(bad.sum())} texels "
                             f"off (max abs err {err:.3g}, max|plain| "
                             f"{scale:.3g})")
    return err, scale


def fold_phase(scene, stats):
    """B4 against its plain version on the real update stream of one
    textured sample (bounces 0..4 of 850x480: 2.04M updates, passed as the
    backward passes them, one row per bounce), its determinism, the
    library yardstick, and the streams that bound its contract: all
    zeros, skewed, one NaN and one inf, empty, a texel and update count
    that is a multiple of no tile or chunk, atlases small enough for one
    and two radix passes, and more rows than the kernel reads in place."""
    cfg = RenderConfig(max_bounces=BOUNCES)
    tm, keys, rec, states = record_sample(scene, cfg)
    N = W * H
    g = torch.full((N, 3), 1.0 / (3 * N * SPP), device=DEV)
    with torch.no_grad():
        _, _, _, _, gtex = replay_bwd.replay_backward(
            scene, cfg, tm, keys, rec, states, g,
            integrator.host_constants(scene).dark_sky)
    idxs = [r[0][2] for r in rec[:-1]]
    gs = [tuple(t[0:3]) for t in gtex]
    data = torch.zeros_like(scene.tex_data)
    P = data.shape[0]

    def run(mode, ix=idxs, gg=gs, d=data):
        return kfold.fold_updates(d, ix, gg, kernels=mode)

    def cat(ix=idxs, gg=gs):
        return (torch.cat(ix), *(torch.cat([t[a] for t in gg])
                                 for a in range(3)))

    idx, gx, gy, gz = cat()
    M = idx.numel()
    survivors = int(((gx != 0) | (gy != 0) | (gz != 0)).sum())
    gen = torch.Generator(device=DEV).manual_seed(1)
    hot = idx.clone()
    hot[: M // 2] = torch.randint(0, 5, (M // 2,), device=DEV, generator=gen,
                                  dtype=hot.dtype)
    hot_rows = list(hot.split(N))
    bad_g = [tuple(c.clone() for c in t) for t in gs]
    bad_g[1][0][N // 3] = float("nan")
    bad_g[3][2][N // 5] = float("inf")
    zero_g = [tuple(torch.zeros_like(c) for c in t) for t in gs]
    Po, Mo = 1_000_003, 1_234_567           # prime, and no tile's multiple
    odd_ix = [torch.randint(0, Po, (Mo,), device=DEV, generator=gen,
                            dtype=torch.int32)]
    odd_g = [tuple(torch.randn((Mo,), device=DEV, generator=gen)
                   for _ in range(3))]
    odd_d = torch.randn((Po, 3), device=DEV, generator=gen)
    # smaller atlases sort in fewer radix passes (ids below 2^8, 2^16),
    # and more segments than the kernel reads in place are joined first
    small = {}
    for name, Ps, ns, rows in (("one_pass", 200, 50_000, 1),
                               ("two_passes", 40_000, 300_000, 2),
                               ("many_segments", 5_000, 1_000, 20)):
        small[name] = dict(
            ix=[torch.randint(0, Ps, (ns,), device=DEV, generator=gen,
                              dtype=torch.int32) for _ in range(rows)],
            gg=[tuple(torch.randn((ns,), device=DEV, generator=gen)
                      for _ in range(3)) for _ in range(rows)],
            d=torch.randn((Ps, 3), device=DEV, generator=gen))
    empty_ix = [torch.zeros((0,), dtype=torch.int32, device=DEV)]
    empty_g = [tuple(torch.zeros((0,), device=DEV) for _ in range(3))]
    cases = {"real": {}, "all_zero": dict(gg=zero_g),
             "skewed": dict(ix=hot_rows), "nan_inf": dict(gg=bad_g),
             "empty": dict(ix=empty_ix, gg=empty_g),
             "odd_sizes": dict(ix=odd_ix, gg=odd_g, d=odd_d), **small}
    out = {}
    for name, kw in cases.items():
        got, want = run("auto", **kw), run("off", **kw)
        err, scale = fold_check(name, got, want)
        if not bit_equal(got, run("auto", **kw)):
            raise AssertionError(f"sorted_fold {name}: two runs differ")
        if name == "real" and scale == 0.0:
            raise AssertionError("sorted_fold: the real stream is all zero")
        if name in ("all_zero", "empty") and not torch.equal(got, kw.get(
                "d", data)):
            raise AssertionError(f"sorted_fold {name}: out != data")
        out[name] = err
    ms = timed(lambda: run("auto"), 20)
    pms = timed(lambda: run("off"), 3)
    g3 = torch.stack([gx, gy, gz], dim=1)
    lms = timed(lambda: torch.zeros_like(data).index_add_(0, idx, g3), 20)
    bms = bound_ms(nbytes(idx, gx, gy, gz, data, data))
    say("B4", scene="cornell_textured", updates=M, survivors=survivors,
        texels=P, max_abs_err={k: f"{v:.3g}" for k, v in out.items()},
        deterministic=True, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        library_ms=f"{lms:.4f}", host_ms=enqueue_ms(lambda: run("auto"), 20),
        device_ms=device_ms(lambda: run("auto"), 20, FOLD_OPS),
        bound_ms=f"{bms:.4f}",
        skewed_ms=f"{timed(lambda: run('auto', ix=hot_rows), 5):.4f}",
        skewed_device_ms=device_ms(lambda: run("auto", ix=hot_rows), 5,
                                   FOLD_OPS),
        all_zero_ms=f"{timed(lambda: run('auto', gg=zero_g), 5):.4f}",
        dense_ms=f"{timed(lambda: run('auto', **cases['odd_sizes']), 5):.4f}",
        dense_device_ms=device_ms(lambda: run("auto", **cases["odd_sizes"]),
                                  5, FOLD_OPS))
    stats["sorted_fold"].append(Rec(max(out.values()), ms, pms, bms,
                                    library_ms=lms))


def protocol_grads(scene, cam, cfg, spp, trainable):
    """The bench.py protocol loss and its gradients: (loss, {name: grad}),
    by `bench.protocol_step` (seed 0): a graph on the card for the
    hand-written backward's scenes with the kernels on, replayed from the
    second call with the same inputs; the eager body elsewhere."""
    from tracer_torch import bench
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    _, loss, grads = bench.protocol_step(
        bench.Inputs(scene, cam, cfg, W, H, pid, spp), tuple(trainable))
    return loss, grads


KERNEL_MODULES = dict(first_hits=kintersect, shade_scatter=kshade,
                      bounce_bwd=kbwd, sorted_fold=kfold,
                      traverse=ktraverse, shadow=kshadow, row_sum=krowsum,
                      finish=kfinish, camera=kcamera)


def camera_launches(spp, trainable):
    """The camera kernel's launches of `spp` samples: one a sample, none
    where a camera field trains (the torch chain makes those rays)."""
    return 0 if any(t.startswith("cam_") for t in trainable) else spp


def reset_launches():
    for m in KERNEL_MODULES.values():
        m.LAUNCHES = 0


def launch_counts(*names):
    return {k: KERNEL_MODULES[k].LAUNCHES for k in names}


def call_launches(scene, cfg, spp, trainable=(), frames=0):
    """Kernel launches of one frame of `spp` samples on the hand-written
    route (with `trainable`, of one protocol step): each sample runs
    every kernel of its route once a bounce, B3 once a bounce in the
    backward, B4 once a sample where tex_data trains and the atlas has
    texel rows to fold onto; the finish once for each of `frames` images
    made (`renderer.render`; `render_frame` and the steps make none); the
    camera once a sample (`camera_launches`). Kernels not launched are
    left out."""
    n = spp * cfg.max_bounces
    out = dict(first_hits=n,
               shade_scatter=n if integrator._fused(scene, cfg) else 0,
               bounce_bwd=n if trainable else 0,
               sorted_fold=spp if ("tex_data" in trainable
                                   and scene.tex_data.shape[0] > 1) else 0,
               traverse=n if scene.mesh_mat.shape[0] > 0 else 0,
               shadow=n if scene.light_pos.shape[0] > 0 else 0,
               finish=frames, camera=camera_launches(spp, trainable))
    return {k: v for k, v in out.items() if v}


def launched(*names):
    """The launch counts of `names` that are not 0."""
    return {k: v for k, v in launch_counts(*names).items() if v}


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
    launches = launched(*KERNEL_MODULES)
    expect = call_launches(scene, cfg, spp, trainable)
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
        # the eager step: the graphed one is profiled in the [graph] phase
        with graphs.CACHE.disabled():
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

    def launches_of(part):
        return sum(e.count for e in evs if part in e.key.lower())

    # the sweep adds the row cotangents inside B3: the only matmuls left
    # are the two small ones per backward that map the tables' motion blur
    # onto mat_mb, none per bounce
    def device_of(part):
        return sum(e.self_device_time_total for e in evs
                   if part in e.key) / 1e3

    gemms = launches_of("gemm")
    if trainable and gemms > 2 * SPP:
        raise AssertionError(f"profile {label}: {gemms} GEMM launches in "
                             f"one step, more than 2 per sample")
    say("profile", scene=label, spp=SPP,
        step="+".join(trainable) if trainable else "forward",
        wall_ms=f"{wall_ms:.1f}", device_busy_ms=f"{busy_ms:.1f}",
        idle_share=f"{1.0 - busy_ms / wall_ms:.3f}",
        device_launches=sum(e.count for e in evs),
        gemm_launches=gemms, cat_launches=launches_of("catarray"),
        b1_device_ms=f"{device_of('first_hits_kernel'):.3f}",
        b1_launches=launches_of("first_hits_kernel"),
        b2_device_ms=f"{device_of('shade_scatter_kernel'):.3f}",
        b2_launches=launches_of("shade_scatter_kernel"),
        top=[(e.key[:48], f"{e.self_device_time_total / 1e3:.2f}ms",
              e.count) for e in top])


def render_phase(label, sb, spp, plain_frame=True, **cfg_kw):
    """The render through the normal entry point, with launch counts (the
    finish kernel once a frame), two more frames (mesh scenes: the frame
    time's spread), then the 1-spp radiance against the plain path on the
    card. `plain_frame`: also time
    the plain path's whole frame (the walk's and the shadows' plain
    versions make that minutes long on the mesh scenes, whose plain time
    is given at 1 spp instead). `cfg_kw`: more RenderConfig fields (the
    exact atlas: packed_atlas="off", whose general route runs no B2)."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES,
                       **cfg_kw)
    renderer.render(scene, cam, cfg)  # warm-up: the frame's graph captured
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = renderer.render(scene, cam, cfg)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = launched(*KERNEL_MODULES)
    meshes = scene.mesh_mat.shape[0] > 0
    fused = integrator._fused(scene, cfg)
    expect = call_launches(scene, cfg, spp, frames=1)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    if img.shape != (H, W, 3) or not bool(
            torch.isfinite(torch.from_numpy(img)).all()):
        raise AssertionError(f"{label}: bad image {img.shape}")
    extra = {}
    if meshes:
        frames = [frame_s]
        for _ in range(2):
            t0 = time.perf_counter()
            renderer.render(scene, cam, cfg)
            torch.cuda.synchronize()
            frames.append(time.perf_counter() - t0)
        extra["frames_s"] = [f"{t:.4f}" for t in frames]
    cfg_off = dataclasses.replace(cfg, kernels="off")
    if plain_frame:
        t0 = time.perf_counter()
        renderer.render(scene, cam, cfg_off)
        torch.cuda.synchronize()
        extra["plain_frame_s"] = f"{time.perf_counter() - t0:.4f}"
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    rk = renderer.render_pixels(scene, cam, cfg, W, H, pid, 1, cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp = renderer.render_pixels(scene, cam, cfg_off, W, H, pid, 1, cfg.seed)
    torch.cuda.synchronize()
    extra["plain_1spp_s"] = f"{time.perf_counter() - t0:.4f}"
    err = float((rk - rp).abs().max())
    check(f"render {label} 1-spp radiance", 0, err)
    out = os.path.join(tempfile.mkdtemp(), "rendu.ppm")
    write_ppm(out, img)
    say("render", scene=label, size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        route="fused" if fused else "general", frame_s=f"{frame_s:.4f}",
        **extra,
        radiance_max_abs_err=f"{err:.3g}", mean=f"{img.mean():.6f}",
        launches=launches, ppm=out)
    return launches


def walls_ms(walls):
    """Median, least and most of sorted walls in seconds, as ms."""
    return dict(median=f"{walls[len(walls) // 2] * 1e3:.4f}",
                min=f"{walls[0] * 1e3:.4f}", max=f"{walls[-1] * 1e3:.4f}")


def finish_phase(sb, stats, reps=50):
    """The frame's finish (`kernels/finish.py`, `csrc/finish.cu`) against
    its plain version (`film.to_image` after `film / np.float32(n)`) at
    850x480: on the Cornell frame's 16-spp film from `render_frame`, and
    on a film with every case the finish meets (`testing.finish_film`:
    zeros of both signs, negatives, values above 1, infinities, NaN,
    denormals), with gamma and without. NaN must lie exactly where numpy
    has NaN; elsewhere (zeros compared without their sign) the kernel must
    be within 2 ulp of numpy with gamma (CUDA's powf against numpy's
    float32 power) and equal without it. Then, on the Cornell film: the
    kernel's device time against its byte bound, its time with the
    wrapper's host work, the plain version's time (the film's pageable
    copy and numpy's finish), and, in turns, the image's copy to the host
    into pinned memory of its own (as `renderer.finish_frame` copies it)
    beside a pageable `.cpu().numpy()`, and the whole `finish_frame`."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=BOUNCES)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        film = renderer.render_frame(scene, cam, cfg, W, H, pid, SPP,
                                     cfg.seed)
    special = torch.from_numpy(finish_film(W * H, seed=1)).to(DEV)
    ulps, err = {}, 0.0
    for name, f, n in (("cornell", film, SPP), ("special", special, 20)):
        mean = f.cpu().numpy() / np.float32(n)
        for gamma in (True, False):
            want = to_image(mean, W * H, 1, gamma).reshape(-1)
            got = kfinish.finish(f, n, gamma).cpu().numpy().reshape(-1)
            nan = np.isnan(want)
            if not np.array_equal(np.isnan(got), nan):
                raise AssertionError(f"finish {name} gamma={gamma}: NaN "
                                     f"where numpy has none, or none "
                                     f"where it has")
            a, b = got[~nan] + np.float32(0), want[~nan] + np.float32(0)
            gap = int(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64)).max())
            if gap > (2 if gamma else 0):
                raise AssertionError(f"finish {name} gamma={gamma}: {gap} "
                                     f"ulp from numpy")
            ulps[name + ("_gamma" if gamma else "")] = gap
            err = max(err, float(np.abs(a - b).max()))
    if float((film == 0).float().mean()) == 0.0:
        raise AssertionError("finish: the Cornell film has no zeros")
    img = kfinish.finish(film, SPP)
    ms = timed(lambda: kfinish.finish(film, SPP), 200)
    pms = timed(lambda: to_image(film.cpu().numpy() / np.float32(SPP), W, H),
                5)
    bms = bound_ms(nbytes(film, img))

    def pinned():
        host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host.copy_(img, non_blocking=True)
        torch.cuda.current_stream(DEV).synchronize()
        return host.numpy()

    walls = in_turns(dict(
        pinned=pinned, pageable=lambda: img.cpu().numpy(),
        finish_frame=lambda: renderer.finish_frame(film, SPP, W, H)), reps)
    say("finish", scene="cornell", size=f"{W}x{H}", spp=SPP,
        film_zero_share=f"{float((film == 0).float().mean()):.4f}",
        ulp_max=ulps, max_abs_err=f"{err:.3g}", ms=f"{ms:.4f}",
        device_ms=device_ms(lambda: kfinish.finish(film, SPP), 200,
                            "finish_kernel"),
        host_ms=enqueue_ms(lambda: kfinish.finish(film, SPP), 200),
        bound_ms=f"{bms:.4f}", plain_ms=f"{pms:.4f}",
        copy_pinned_ms=walls_ms(walls["pinned"]),
        copy_pageable_ms=walls_ms(walls["pageable"]),
        finish_frame_ms=walls_ms(walls["finish_frame"]), reps=reps)
    stats["finish"].append(Rec(err, ms, pms, bms))


def float_bits(t):
    """A float tensor's bits as int64 (NaN and the sign of zero kept)."""
    return t.contiguous().view(torch.int32).to(torch.int64)


def camera_phase(stats, reps=200):
    """The camera kernel (`kernels/camera.py`, `csrc/camera.cu`) against
    the torch chain of `renderer.camera_batch` (kernels="off") at 850x480:
    the default camera and a turned one (a quaternion of length 1.07), all
    pixels (int32 ids) and a 128x128 tile (int64 ids), seeds as ints and as
    words on the card, sample indices as ints and 0-d tensors. The keys,
    the jitter, the time, o and d must be the chain's bit for bit (the
    line gives the mismatches and the largest ulp gap of each). Then, with
    the seed word and sample index on the card as a compiled frame gives
    them: the kernel's device time against its byte bound, its time with
    the wrapper, the host's enqueue, and the chain's time and launches a
    sample."""
    f32 = dict(dtype=torch.float32, device=DEV)
    eye = (1.4, 0.9, 5.2)
    cams = dict(default=default_camera(W / H, device=DEV),
                turned=Camera(torch.tensor(eye, **f32),
                              look_at_quaternion(eye, (0.1, -0.2, 0.0),
                                                 device=DEV) * 1.07,
                              torch.tensor(38.5, **f32),
                              torch.tensor(W / H, **f32)))
    full = torch.arange(W * H, dtype=torch.int32, device=DEV)
    x, y = torch.meshgrid(torch.arange(100, 228, device=DEV),
                          torch.arange(64, 192, device=DEV), indexing="xy")
    tile = (y * W + x).reshape(-1)
    s_dev = torch.full((), 19, dtype=torch.int64, device=DEV)
    names = ("keys", "jitter", "time", "o", "d")
    mism, ulp, cases = dict.fromkeys(names, 0), dict.fromkeys(names, 0), 0
    for cam in cams.values():
        for pid in (full, tile):
            for seed in (0, 2 ** 31 + 12_345):
                for sample in (0, 7, s_dev):
                    keys = rng.salted(rng.ray_keys(seed, pid), sample)
                    jit = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER),
                                      (2,)).T
                    o, d, tm, _ = renderer.camera_batch(cam, W, H, pid,
                                                        sample, seed, "off")
                    for sd in (seed, rng.seed_tensor(seed, DEV)):
                        got = kcamera.camera_rays(cam, W, H, pid, sample, sd,
                                                  jitter=True)
                        pairs = dict(
                            keys=(got[3], keys),
                            jitter=(float_bits(got[4]), float_bits(jit)),
                            time=(float_bits(got[2]), float_bits(tm)),
                            o=(float_bits(torch.stack(got[0])),
                               float_bits(torch.stack(o))),
                            d=(float_bits(torch.stack(got[1])),
                               float_bits(torch.stack(d))))
                        for k, (a, b) in pairs.items():
                            mism[k] += int((a != b).sum())
                            ulp[k] = max(ulp[k], int((a - b).abs().max()))
                        cases += 1
    cam = cams["turned"]
    word = rng.seed_tensor(2 ** 31 + 12_345, DEV)

    def kernel():
        return kcamera.camera_rays(cam, W, H, full, s_dev, word)

    def chain():
        return renderer.camera_batch(cam, W, H, full, s_dev, word, "off")

    out = kernel()
    bms = bound_ms(nbytes(full, out[3], out[0], out[1], out[2]))
    ms = timed(kernel, reps)
    pms = timed(chain, 20)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain()
        torch.cuda.synchronize()
    chain_launches = sum(e.count for e in prof.key_averages()
                         if e.self_device_time_total > 0)
    say("camera", size=f"{W}x{H}", cases=cases, mismatches=mism,
        ulp_max=ulp, ms=f"{ms:.4f}",
        device_ms=device_ms(kernel, reps, "camera_kernel"),
        host_ms=enqueue_ms(kernel, reps), bound_ms=f"{bms:.4f}",
        plain_ms=f"{pms:.4f}", plain_launches=chain_launches)
    if any(mism.values()):
        raise AssertionError(f"camera: the kernel is not the torch chain "
                             f"bit for bit: {mism}, ulp {ulp}")
    stats["camera"].append(Rec(0.0, ms, pms, bms))


def sky_uv_phase(label, scene, stats):
    """B1 with the sphere-UV texel index (`sphere_tex`, tex_out 1 and 2)
    and B2 with the image sky (and the sphere winners' masks, `mat_pair`,
    with and without `rec_out`) against their plain versions on a scene
    with textured spheres and an image skybox, at bounces 0 and 1 under
    both compat modes. Each line gives the same call's time without the
    new input (B1 without `sphere_tex`; B2 with the sky switched off:
    `has_sky_image=False`) beside it. The plain versions take acos, atan2
    and asin from torch's CUDA math, the kernels from the same library
    built with --fmad=false: a discrete mismatch is allowed only where the
    two sides' texture coordinates (B1) differ by at most one ulp, and
    each is counted (`ulp_ties`)."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    tables = integrator.prepare(scene)
    itab, stab = tables.intersect, tables.shade
    stex, mpair = tables.sphere_tex, tables.mat_pair
    if stex is None or mpair is None or not scene.has_sky_image:
        raise AssertionError(f"{label}: no sphere-UV tables or no sky")
    no_sky = dataclasses.replace(scene, has_sky_image=False)
    state = integrator._init_state(o, d, tm)
    S = scene.sph_center.shape[0]
    L = scene.light_pos.shape[0]
    for b in (0, 1):
        bkeys = rng.salted(keys, b)
        live = state["active"]
        n_live = int(live.sum())
        for tex_out in (1, 2):
            def fh(mode, uv=True):
                return kintersect.first_hits(
                    scene, state["o"], state["d"], state["time"], live,
                    1e-5, tex_out, kernels=mode, tables=itab, slim=True,
                    sphere_tex=stex if uv else None)

            k1, k1p = fh("auto"), fh("off")
            mism, err = compare(k1, k1p, live)
            ties = 0
            if mism:   # only where u or v moved by one ulp
                du = (k1["u"] != k1p["u"]) | (k1["v"] != k1p["v"])
                one = ((k1["u"] - k1p["u"]).abs()
                       <= torch.finfo(torch.float32).eps * k1p["u"].abs()
                       ) & ((k1["v"] - k1p["v"]).abs()
                            <= torch.finfo(torch.float32).eps
                            * k1p["v"].abs())
                bad = torch.zeros_like(live)
                for key in ("j", "tid", "mid", "row", "sub", "idx_t",
                            "idx_n"):
                    if key in k1:
                        bad |= live & (k1[key] != k1p[key])
                ties = int(bad.sum())
                if bool((bad & ~(du & one)).any()):
                    raise AssertionError(
                        f"first_hits {label} b{b} tex_out={tex_out}: "
                        f"{mism} discrete mismatches not explained by an "
                        f"ulp of u, v")
                mism = 0
            check(f"first_hits {label} b{b} sphere_uv tex_out={tex_out}",
                  mism, err)
            sph = live & (k1p["j"] >= 0) & (k1p["j"] < S)
            ms = timed(lambda: fh("auto"), 20)
            ms_old = timed(lambda: fh("auto", uv=False), 20)
            pms = timed(lambda: fh("off"), 3)
            nb = (first_hits_bytes(live, tex_out, 0) + nbytes(itab, stex))
            b2ms, by = bound2(nb, n_live * (
                (scene.n_sph_real + scene.n_quad_real) * OPS_TABLE
                + OPS_DETAIL))
            say("B1_uv", scene=label, bounce=b, tex_out=tex_out,
                rays=n_live, sphere_winners=int(sph.sum()),
                textured_sphere_winners=int(
                    (sph & (mpair[k1p["mid"].long(), 0] > 0.5)).sum()),
                mismatches=mism, ulp_ties=ties, max_abs_err=f"{err:.3g}",
                ms=f"{ms:.4f}", ms_without_uv=f"{ms_old:.4f}",
                device_ms=device_ms(lambda: fh("auto"), 20, "first_hits"),
                device_ms_without_uv=device_ms(lambda: fh("auto", uv=False),
                                               20, "first_hits"),
                plain_ms=f"{pms:.4f}", bound2_ms=f"{b2ms:.4f}", bound_by=by)
            if tex_out == 1:
                stats["first_hits_uv"].append(Rec(err, ms, pms, b2ms, by))
        k1p = kintersect.first_hits(
            scene, state["o"], state["d"], state["time"], live, 1e-5, 2,
            kernels="off", tables=itab, slim=True, sphere_tex=stex)
        nxt = None
        for compat in ("reference", "physical"):
            cfg = RenderConfig(compat=compat)
            shadows = integrator._shadow_factors_all(
                scene, cfg, k1p["p"], state["time"], bkeys,
                live & (k1p["j"] >= 0), tables)
            for rec_out in (False, True):
                def sh(mode, st, sc=scene):
                    return kshade.shade_scatter(
                        sc, cfg, st, bkeys, k1p, BOUNCES - b,
                        shadows=shadows, use_pair=True, kernels=mode,
                        tables=stab, quad=itab[1], rec_out=rec_out,
                        mat_pair=mpair)

                def fresh():
                    return integrator.copy_state(state)

                got, want = sh("auto", fresh()), sh("off", fresh())
                if rec_out:
                    got, want = (dict(got[0], rec=got[1]),
                                 dict(want[0], rec=want[1]))
                mism, err = compare(got, want)
                check(f"shade_scatter {label} b{b} {compat} sky "
                      f"rec_out={rec_out}", mism, err)
                miss = live & (k1p["j"] < 0)
                ms = timed_fresh(lambda st: sh("auto", st), fresh, 20)
                ms_old = timed_fresh(lambda st: sh("auto", st, no_sky),
                                     fresh, 20)
                pms = timed_fresh(lambda st: sh("off", st), fresh, 3)
                hits = live & (k1p["j"] >= 0)
                nb = (shade_bytes_new(live, hits, True, False, L)
                      + 4 * int(miss.sum()) + nbytes(stab[:2], mpair)
                      + (32 * n_live if rec_out else 0))
                b2ms, by = bound2(nb, n_live * (OPS_SHADE + L * OPS_LIGHT))
                say("B2_sky", scene=label, bounce=b, compat=compat,
                    rec_out=rec_out, active=n_live,
                    miss_share=f"{int(miss.sum()) / live.numel():.3f}",
                    mismatches=mism, max_abs_err=f"{err:.3g}",
                    ms=f"{ms:.4f}", ms_without_sky=f"{ms_old:.4f}",
                    device_ms=device_ms_fresh(lambda st: sh("auto", st),
                                              fresh, 20, "shade_scatter"),
                    device_ms_without_sky=device_ms_fresh(
                        lambda st: sh("auto", st, no_sky), fresh, 20,
                        "shade_scatter"),
                    plain_ms=f"{pms:.4f}", bound2_ms=f"{b2ms:.4f}",
                    bound_by=by)
                if not rec_out:
                    stats["shade_scatter_sky"].append(
                        Rec(err, ms, pms, b2ms, by))
                if compat == "reference" and not rec_out:
                    nxt = want
        state = nxt


# the tables a replayed bounce gathers rows of, and the scene fields each
# is built from (`integrator._geo_packs`): a table that requires grad
# sends its lanes' cotangents through one row sum a bounce
ROW_TABLES = dict(
    sph_pack=("sph_center", "sph_radius", "mat_mb"),
    quad_pack=("quad_v0", "quad_er", "quad_eu", "quad_tan", "quad_bitan",
               "mat_mb"),
    matf=("mat_texscale", "mat_check1", "mat_check2", "mat_diffuse",
          "mat_light_color", "mat_light_intensity", "mat_emissive",
          "mat_transparency", "mat_ior"))


def rowsum_launches(scene, trainable, spp):
    """Row sums (`kernels/rowsum.py`) of one protocol step on the general
    backward or the plain autodiff route, whose bounces gather the rows
    of each table that requires grad (`integrator._gather_hit_p`): mat_mb
    twice in `_geo_packs`, the sphere, quad and material rows once each,
    the mesh vertices of the three corners. A row sum runs where its
    rows reach the loss: the geometry's rows (hit point and normal) on
    the last bounce only through the direct light of a lit scene, the
    material rows on every bounce (emission). Both routes read no texel
    row whose atlas trains here (the replay takes the recorded texels; no
    plain autodiff phase trains texels)."""
    t = set(trainable)
    counts = dict(sph_pack=scene.sph_center.shape[0],
                  quad_pack=scene.quad_v0.shape[0],
                  matf=scene.mat_diffuse.shape[0])
    used = {k for k, fields in ROW_TABLES.items()
            if counts[k] > 0 and t & set(fields)}
    geo = (2 if "mat_mb" in t else 0) + len(used - {"matf"})
    if scene.mesh_mat.shape[0] > 0 and "mesh_verts" in t:
        geo += 3
    lit = scene.light_pos.shape[0] > 0
    return spp * (BOUNCES * ("matf" in used)
                  + (BOUNCES if lit else BOUNCES - 1) * geo)


def general_launches(scene, cfg, spp, trainable):
    """Kernel launches of one protocol or training step of `spp` samples
    on the general backward (custom_vjp="on" outside the hand-written
    class) or the plain autodiff route (custom_vjp="off"): B1, B5 on mesh
    scenes and B6 on lit ones once a bounce; B2 once a bounce on the fused
    record forward (not on the plain autodiff route); no B3; B4 once a
    sample where tex_data trains and the atlas has texel rows (not on the
    plain autodiff route, whose phases train no texels); the row sums of
    `rowsum_launches`; the camera once a sample (`camera_launches`).
    Kernels not launched are left out."""
    n = spp * cfg.max_bounces
    plain_ad = cfg.custom_vjp == "off"
    texels = "tex_data" in trainable and scene.tex_data.shape[0] > 1
    out = dict(first_hits=n,
               shade_scatter=n if (integrator._fused(scene, cfg)
                                   and not plain_ad) else 0,
               sorted_fold=spp if texels and not plain_ad else 0,
               traverse=n if scene.mesh_mat.shape[0] > 0 else 0,
               shadow=n if scene.light_pos.shape[0] > 0 else 0,
               row_sum=rowsum_launches(scene, trainable, spp),
               camera=camera_launches(spp, trainable))
    return {k: v for k, v in out.items() if v}


def times(counts, k):
    """The launch counts `counts` of one call, `k` calls over."""
    return {name: v * k for name, v in counts.items()}


def index_add_route(idx, g, rows, kernels="auto"):
    """The row sums on their plain version (`index_add_`, float atomics on
    the card): the general backward's route before the row-sum kernel."""
    return krowsum.row_sum_plain(idx, g, rows)


@contextlib.contextmanager
def row_sum_as(fn):
    """Run the block with `krowsum.row_sum` replaced by `fn`."""
    real = krowsum.row_sum
    krowsum.row_sum = fn
    try:
        yield
    finally:
        krowsum.row_sum = real


def grads_equal(a, b):
    return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)


def eager_route(fn):
    """`fn` with every entry point on its eager body
    (`graphs.CACHE.disabled()`): the phases that time, spy on or profile
    the eager general and plain autodiff steps (a spy or a swapped row
    sum runs in Python, which a replay does not). Their compiled twins
    are `[graph]` lines."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with graphs.CACHE.disabled():
            return fn(*args, **kwargs)
    return wrapped


@eager_route
def general_protocol_phase(label, sb, spp, trainable, reps=3):
    """fwd+bwd of the protocol loss on a scene outside the hand-written
    class (lights, meshes, an image sky, textured spheres): the record
    forward on the kernels, then the general backward (the replay's vjp
    by torch.autograd, one sample at a time) and the texel fold. Prints
    the step's wall time (median of `reps` after a warm-up, and the
    spread), the peak memory, the launch counts (B3 is 0: no hand-written
    sweep here; B4 once a sample when tex_data trains, its stream holding
    every bounce, the last one too, on a lit scene; the row sums one a
    gathered table a bounce), whether every rep's gradients have the same
    bits (`deterministic`), and the 1-spp gradients against the same
    backward on the plain path. Beside it, in the same call and in turns
    (kernel, index_add_, index_add_, kernel, ...), the same step with the
    row sums on their plain version, `index_add_`: its walls and whether
    its gradients repeat."""
    scene = compile_scene(sb, device=DEV)
    if replay_bwd.hand_bwd_ok(scene, RenderConfig()):
        raise AssertionError(f"{label}: inside the hand-written class")
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(max_bounces=BOUNCES)
    segs = []
    fold = kfold.fold_updates

    def spy(data_g, idxs, gs, kernels="auto"):
        segs.append(len(idxs))
        return fold(data_g, idxs, gs, kernels)

    routes = dict(kernel=krowsum.row_sum, index_add=index_add_route)

    def step(route):
        with row_sum_as(routes[route]):
            return protocol_grads(scene, cam, cfg, spp, trainable)

    kfold.fold_updates = spy
    try:
        step("kernel")                                     # warm-up
        step("index_add")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = dict(kernel=[], index_add=[])
        runs = dict(kernel=[], index_add=[])
        for i in range(2 * reps):
            route = ("kernel", "index_add")[(i + 1) // 2 % 2]
            if i == 0:
                reset_launches()
                segs.clear()
            t0 = time.perf_counter()
            loss, grads = step(route)
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
            runs[route].append(grads)
            if i == 0:
                launches = launch_counts(*KERNEL_MODULES)
                fold_segs = sorted(set(segs))
        peak = torch.cuda.max_memory_allocated()
    finally:
        kfold.fold_updates = fold
    grads = runs["kernel"][0]
    same = {r: all(grads_equal(runs[r][0], x) for x in runs[r][1:])
            for r in runs}
    if not same["kernel"]:
        raise AssertionError(f"general protocol {label}: two backward "
                             f"passes gave different gradients")
    lit = scene.light_pos.shape[0] > 0
    texels = "tex_data" in trainable and scene.tex_data.shape[0] > 1
    expect = general_launches(scene, cfg, spp, trainable)
    if {k: v for k, v in launches.items() if v} != expect:
        raise AssertionError(f"general protocol {label}: launches "
                             f"{launches}, expected {expect}")
    if texels and fold_segs != [BOUNCES if (
            lit or scene.emissive_tex_image) else BOUNCES - 1]:
        raise AssertionError(f"general protocol {label}: fold segments "
                             f"{fold_segs}")
    for k, gr in grads.items():
        if not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"general protocol {label}: {k} grad not "
                                 f"finite")
        if float(gr.abs().max()) == 0.0:
            raise AssertionError(f"general protocol {label}: {k} grad is "
                                 f"zero")
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
            raise AssertionError(f"general protocol {label}: {k} 1-spp "
                                 f"grad rel err {rel[k]:.3g} > {GRAD_RTOL}")
    kw = sorted(walls["kernel"])
    say("general_protocol", scene=label, size=f"{W}x{H}", spp=spp,
        bounces=BOUNCES, trainable="+".join(trainable),
        loss=f"{float(loss):.6g}",
        step_s_median=f"{kw[len(kw) // 2]:.4f}",
        step_s_min=f"{kw[0]:.4f}", step_s_max=f"{kw[-1]:.4f}",
        reps=reps, deterministic=same["kernel"],
        index_add_step_s=spread(sorted(walls["index_add"])),
        index_add_deterministic=same["index_add"],
        peak_mem_gb=f"{peak / 1e9:.3f}", launches=launches,
        fold_segments=fold_segs,
        grad_max_abs={k: f"{float(v.abs().max()):.3g}"
                      for k, v in grads.items()},
        grad_rel_err_1spp={k: f"{v:.3g}" for k, v in rel.items()})
    return launches


# the row-sum kernels (csrc/row_sum.cu); one call also runs the zero fill
ROWSUM_KERNELS = ("rs_digit_counts", "rs_count_scan", "rs_scatter",
                  "rs_chunk_maps", "rs_carries", "rs_runs")
ROWSUM_OPS = ROWSUM_KERNELS + ("Memset",)
# kernel names of sums by atomics or by scatter: index_add_ runs
# `indexFuncSmallIndex` / `indexFuncLargeIndex` (float atomics) on the
# card; index_put_'s accumulate runs `indexing_backward_kernel`, which
# sorts and sums a run in a warp
ATOMIC_NAMES = ("index_add", "indexfunc", "scatter_add", "index_put",
                "atomic", "indexing_backward")
ATOMIC_SUMS = ("index_add", "indexfunc", "scatter_add")


def rowsum_check(name, got, want, idx, g):
    """The row-sum kernel's sums against the float64 sums of the same
    cotangents, each within its f32 summation error bound,
    depth * 2^-24 * (the sum of |g| over the row's lanes), depth a bound
    on the chain of f32 additions a lane's cotangent passes through in
    the kernel (csrc/row_sum.cu: in each of its three scans PER in a
    thread, 5 in a warp's scan and the 8 warps before it; and the chunks'
    carries, one a chunk); the plain
    version's (`index_add_`, any order) within (lanes - 1) * 2^-24 * that
    sum. Returns (max |kernel - plain|, max |plain|)."""
    li = idx.reshape(-1).long()
    g64 = g.double()
    exact = torch.zeros(want.shape, dtype=torch.float64,
                        device=DEV).index_add_(0, li, g64)
    absum = torch.zeros_like(exact).index_add_(0, li, g64.abs())
    lanes = torch.bincount(li, minlength=want.shape[0]).double()[:, None]
    nf = -(-idx.numel() // krowsum.CHUNK)
    depth = 3 * (krowsum.CHUNK // 256 + 5 + 8) + nf
    u = 2.0 ** -24
    bad_k = (got.double() - exact).abs() > depth * u * absum
    bad_p = (want.double() - exact).abs() > torch.clamp_min(
        lanes - 1, 0) * u * absum
    if bool(bad_k.any()) or bool(bad_p.any()):
        raise AssertionError(
            f"{name}: {int(bad_k.sum())} kernel and {int(bad_p.sum())} "
            f"plain sums of {want.numel()} beyond their f32 summation "
            f"bounds (max |kernel - f64| "
            f"{float((got.double() - exact).abs().max()):.3g})")
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err, scale


@eager_route
def capture_row_sums(scene, cfg, trainable):
    """The row sums of one 1-spp protocol step, as the backward made them:
    {(rows, columns): (idx, g)}, of each table shape the call with the
    largest cotangent (then the most lanes)."""
    cam = default_camera(W / H, device=DEV)
    calls, score = {}, {}
    real = krowsum.row_sum

    def spy(idx, g, rows, kernels="auto"):
        key = (rows, g.shape[1])
        sc = (float(g.abs().max()) if g.numel() else 0.0, idx.numel())
        if key not in calls or sc > score[key]:
            calls[key], score[key] = (idx.clone(), g.clone()), sc
        return real(idx, g, rows, kernels)

    with row_sum_as(spy):
        protocol_grads(scene, cam, cfg, 1, trainable)
    return calls


def rowsum_phase(cases, stats):
    """The row-sum kernel against its plain version (`index_add_`) on the
    row sums a protocol step makes on the card (captured from a 1-spp
    step): the small tables (sphere and material rows of
    rt_weekend_standin and flamingo_standin; the textured Cornell box's
    quads, spheres and mat_mb, with a light added so that the geometry's
    rows get a gradient, on the plain autodiff route), tiled_wall_3000's
    3,000 quads and material rows, flamingo_standin's mesh vertices, and
    the lit textured box's 1024² atlases on the plain autodiff route. For
    each: the sums against float64 sums, within their f32 summation error
    bounds (`rowsum_check`), max |err| against the plain version,
    bit-equality of two calls, the
    kernel's ms (CUDA events, its host work included) and device ms
    (profiler), `index_add_`'s ms on the same inputs, and the bound
    (the larger of idx, cotangents and table over 3.35 TB/s and N * C
    additions over 67 TFLOP/s: the bytes). `cases`: (label,
    scene builder, trainable, custom_vjp)."""
    for label, sb, trainable, custom_vjp in cases:
        scene = compile_scene(sb, device=DEV)
        cfg = RenderConfig(max_bounces=BOUNCES, custom_vjp=custom_vjp)
        calls = capture_row_sums(scene, cfg, trainable)
        if not calls:
            raise AssertionError(f"rowsum {label}: no row sum in the step")
        for (rows, cols), (idx, g) in sorted(calls.items()):
            def run(mode, idx=idx, g=g, rows=rows):
                return krowsum.row_sum(idx, g, rows, kernels=mode)

            got, want = run("auto"), run("off")
            err, scale = rowsum_check(f"row_sum {label} {rows}x{cols}",
                                      got, want, idx, g)
            if not bit_equal(got, run("auto")):
                raise AssertionError(f"row_sum {label} {rows}x{cols}: two "
                                     f"calls differ")
            ms = timed(lambda: run("auto"), 20)
            lms = timed(lambda: torch.zeros_like(want).index_add_(
                0, idx.long(), g), 20)
            pms = timed(lambda: run("off"), 20)
            # each lane's cotangent added once: N * C f32 additions
            bms, by = bound2(nbytes(idx, g, want), idx.numel() * cols)
            say("rowsum", scene=label, table=f"{rows}x{cols}",
                lanes=idx.numel(), max_abs_err=f"{err:.3g}",
                max_abs_plain=f"{scale:.3g}", deterministic=True,
                ms=f"{ms:.4f}",
                device_ms=device_ms(lambda: run("auto"), 20, ROWSUM_OPS),
                index_add_ms=f"{lms:.4f}", plain_ms=f"{pms:.4f}",
                bound_ms=f"{bms:.4f}", bound_by=by, passes=max(1, (
                    (max(rows - 1, 1)).bit_length() + 7) // 8))
            stats["row_sum"].append((f"{label} {rows}x{cols}",
                                     Rec(err, ms, pms, bms, by,
                                         library_ms=lms)))


def lit_textured_cornell():
    """The textured Cornell box with a small light under its ceiling: a
    scene whose geometry and normal maps get a gradient (in the unlit box
    the radiance is constant in them between discrete changes)."""
    sb = fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL)
    sb.add_light((0.0, 1.5, 0.5), radius=0.3, color=(1.0, 1.0, 1.0))
    return sb


@eager_route
def atomics_phase(label, sb, spp, trainable, custom_vjp="on"):
    """The kernels of one protocol step (the general backward, or the
    plain autodiff route with custom_vjp="off") whose names say that they
    sum by atomics or scatter (ATOMIC_NAMES), with their launches and
    device ms, on the row-sum kernel's route and on the `index_add_`
    route; the row-sum kernels' launches and device ms. Fails if an
    atomic sum (ATOMIC_SUMS) is left on the kernel's route.
    Then, as a diagnostic, the same step once under
    torch.use_deterministic_algorithms(True, warn_only=True), restored
    afterwards: the warnings it raises name the step's ops that have no
    deterministic implementation on the card."""
    from torch.profiler import ProfilerActivity, profile
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(max_bounces=BOUNCES, custom_vjp=custom_vjp)
    out = {}
    for route, fn in (("kernel", krowsum.row_sum),
                      ("index_add", index_add_route)):
        with row_sum_as(fn):
            protocol_grads(scene, cam, cfg, spp, trainable)   # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                protocol_grads(scene, cam, cfg, spp, trainable)
                torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
        hits = [(e.key[:60], e.count,
                 f"{e.self_device_time_total / 1e3:.3f}ms") for e in evs
                if any(a in e.key.lower() for a in ATOMIC_NAMES)]
        rs = [e for e in evs if any(k in e.key for k in ROWSUM_KERNELS)]
        rs_ms = sum(e.self_device_time_total for e in rs) / 1e3
        out[route] = dict(atomic_kernels=hits,
                          rowsum_kernel_launches=sum(e.count for e in rs),
                          rowsum_device_ms=f"{rs_ms:.3f}")
    bad = [h for h in out["kernel"]["atomic_kernels"]
           if any(a in h[0].lower() for a in ATOMIC_SUMS)]
    if bad:
        raise AssertionError(f"atomics {label}: atomic row sums left on "
                             f"the kernel route: {bad}")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            protocol_grads(scene, cam, cfg, spp, trainable)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    notes = sorted({str(w.message).split("\n")[0][:100] for w in caught
                    if "determinis" in str(w.message)})
    say("atomics", scene=label, spp=spp, custom_vjp=custom_vjp,
        trainable="+".join(trainable), kernel_route=out["kernel"],
        index_add_route=out["index_add"],
        deterministic_mode_diagnostic="on, then restored to "
        f"{prev[0]}", deterministic_mode_warnings=notes)


# ---------------------------------------------------------------------------
# Training, the tiled render and the CLI: the port's entry points
# ---------------------------------------------------------------------------

class TimedAdam(torch.optim.Adam):
    """`train.fit`'s default Adam (optax.adam's betas and eps) that keeps
    the wall time of each update, the card synchronised around it, and the
    gradients its first update was given."""

    def __init__(self, leaves, lr):
        super().__init__(leaves, lr=lr, betas=T.ADAM_BETAS, eps=T.ADAM_EPS)
        self.update_ms, self.first_grads = [], None

    def step(self, closure=None):
        if self.first_grads is None:
            self.first_grads = [p.grad.clone() for g in self.param_groups
                                for p in g["params"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().step(closure)
        torch.cuda.synchronize()
        self.update_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def train_start(scene, cam, trainable, offsets, seed):
    """(scene, camera) with each trainable field moved by a seeded normal
    offset of scale offsets[name]."""
    gen = torch.Generator().manual_seed(seed)
    pert = {}
    for k, v in sorted(T.split_params(scene, cam, trainable).items()):
        noise = torch.randn(tuple(v.shape), generator=gen).to(DEV)
        pert[k] = v.detach() + offsets[k] * noise
    return T.apply_params(scene, cam, pert)


def train_target(scene, cam, cfg, trainable, spp):
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        return renderer.render_pixels(scene, cam, T.guard_config(
            cfg, trainable), W, H, pid, spp, cfg.seed) / spp


def ckpt_leaves(path):
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def leaves_equal(a, b):
    return sorted(a) == sorted(b) and all(
        a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]) for f in a)


def ckpt_roundtrip(path, scene, cam, trainable, lr):
    """Load `path` into fresh leaves and Adam, save it again: (load s,
    save s, whether the restored state is bit-equal to the saved one)."""
    params = T.split_params(scene, cam, trainable)
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=lr,
                           betas=T.ADAM_BETAS, eps=T.ADAM_EPS)
    t0 = time.perf_counter()
    T._load_ckpt(path, params, opt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    again = path + ".again.npz"
    t0 = time.perf_counter()
    T._save_ckpt(again, int(ckpt_leaves(path)["step"]), params, opt)
    save_s = time.perf_counter() - t0
    return load_s, save_s, leaves_equal(ckpt_leaves(path),
                                        ckpt_leaves(again))


def fit_launches(steps, expect):
    """Per-step launches of the last `fit` (the counts were reset just
    before it), checked against `expect` a step."""
    got = {k: v / steps for k, v in launch_counts(*expect).items()}
    if got != expect:
        raise AssertionError(f"train: launches a step {got}, expected "
                             f"{expect}")
    return {k: int(v) for k, v in got.items()}


def train_phase(label, sb, spp, trainable, offsets, steps, lr, expect,
                resume_exact, grad_check=False, stale_check=False,
                must_fall=True):
    """`train.fit` at 850x480, 6 bounces, compat="reference", from a
    seeded start: each step's loss and grad norm, the steps' wall time
    (median, min, max of steps 2 on), peak memory, kernel launches a step,
    the optimizer's update alone. Then the resume: `steps - 2` steps into
    a checkpoint, a fresh `fit` from it to `steps`, held against the
    uninterrupted run (bit-equal params and Adam state where
    `resume_exact`, else the max |difference| is printed), and the
    checkpoint's load and save seconds with the restored state bit-equal
    to the saved one. `grad_check`: the first step's gradients against
    the same gradients on the plain path. `stale_check`: the
    returned scene's packs are invalidated (1-spp radiance with the
    kernels equal to kernels="off") and the texels left the u8 grid."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    target = train_target(scene, cam, cfg, trainable, spp)
    s0, c0 = train_start(scene, cam, trainable, offsets, seed=1)
    kw = dict(trainable=trainable, steps=steps, lr=lr, width=W, height=H,
              nsamples=spp)
    tmp = tempfile.mkdtemp()
    opts = []

    def timed_adam(leaves):
        opts.append(TimedAdam(leaves, lr))
        return opts[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sa, ca, hist = T.fit(s0, c0, cfg, target, optimizer=timed_adam,
                         ckpt_dir=os.path.join(tmp, "a"), ckpt_every=steps,
                         **kw)
    torch.cuda.synchronize()
    launches = fit_launches(steps, expect)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if not all(np.isfinite(gnorms)) or (must_fall
                                        and not losses[-1] < losses[0]):
        raise AssertionError(f"train {label}: losses {losses}, grad norms "
                             f"{gnorms}")
    walls = sorted(h["step_s"] for h in hist[1:])
    extra = {}
    if grad_check:
        extra["first_grad_rel_err_vs_plain"] = first_grads_vs_plain(
            opts[0].first_grads, s0, c0, cfg, trainable, target, spp)
    if stale_check:
        extra.update(stale_pack_check(sa, ca, cfg, scene))

    # resume: steps - 2 steps, then a fresh fit to `steps`
    T.fit(s0, c0, cfg, target, ckpt_dir=os.path.join(tmp, "b"),
          ckpt_every=steps, **{**kw, "steps": steps - 2})
    sb_, cb, hist_b = T.fit(s0, c0, cfg, target,
                            ckpt_dir=os.path.join(tmp, "b"),
                            ckpt_every=steps, **kw)
    if [h["step"] for h in hist_b] != [steps - 1, steps]:
        raise AssertionError(f"train {label}: resumed steps "
                             f"{[h['step'] for h in hist_b]}")
    pa, pb = (T.split_params(s, c, trainable) for s, c in ((sa, ca),
                                                           (sb_, cb)))
    diff = max(float((pa[k] - pb[k]).detach().abs().max())
               for k in trainable)
    a, b = (os.path.join(tmp, x, "train.npz") for x in "ab")
    same_state = leaves_equal(ckpt_leaves(a), ckpt_leaves(b))
    if resume_exact and not (diff == 0.0 and same_state):
        raise AssertionError(f"train {label}: resumed run differs "
                             f"(params {diff:.3g}, state equal "
                             f"{same_state})")
    load_s, save_s, restored = ckpt_roundtrip(b, s0, c0, trainable, lr)
    if not restored:
        raise AssertionError(f"train {label}: restored state differs from "
                             f"the saved one")
    say("train", scene=label, size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        trainable="+".join(trainable), lr=lr,
        offsets={k: offsets[k] for k in trainable}, steps=steps,
        losses=[f"{x:.6g}" for x in losses],
        grad_norms=[f"{x:.4g}" for x in gnorms],
        step_s_median=f"{walls[len(walls) // 2]:.4f}",
        step_s_min=f"{walls[0]:.4f}", step_s_max=f"{walls[-1]:.4f}",
        adam_update_ms=f"{np.median(opts[0].update_ms):.3f}",
        peak_mem_gb=f"{peak / 1e9:.3f}", launches_per_step=launches,
        resume="bit-equal" if diff == 0.0 and same_state else "differs",
        resume_max_abs_diff=f"{diff:.3g}", resume_state_equal=same_state,
        ckpt_load_s=f"{load_s:.4f}", ckpt_save_s=f"{save_s:.4f}",
        ckpt_kb=f"{os.path.getsize(b) / 1e3:.1f}", **extra)
    return opts[0]


def first_grads_vs_plain(first, s0, c0, cfg, trainable, target, spp):
    """The first step's gradients (`first`, by sorted name, as `fit` took
    them with the kernels) against the same loss's gradients on the plain
    path (kernels="off"): max relative error a field."""
    cfg = dataclasses.replace(T.guard_config(cfg, trainable), kernels="off")
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    params = T.split_params(s0, c0, trainable)
    s, cm = T.apply_params(s0, c0, params)
    img = renderer.render_pixels(s, cm, cfg, W, H, pid, spp, cfg.seed) / spp
    torch.mean((img - target) ** 2).backward()
    rel = {}
    for k, g in zip(sorted(trainable), first):
        scale = float(params[k].grad.abs().max())
        d = float((g - params[k].grad).abs().max())
        rel[k] = d / scale if scale > 0 else d
        if not rel[k] <= GRAD_RTOL:
            raise AssertionError(f"train: first-step {k} gradient rel err "
                                 f"{rel[k]:.3g} > {GRAD_RTOL}")
    return {k: f"{v:.3g}" for k, v in rel.items()}


def stale_pack_check(s1, c1, cfg, pristine):
    """tests/test_train.py:155-166 on the card: the trained scene's packs
    are invalidated, so its 1-spp radiance with the kernels equals
    kernels="off", and the texels left the u8 grid."""
    if s1.pair_mode or s1.pair_pack.shape[0] != 1:
        raise AssertionError("train: packs not invalidated")
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        rk, rp = (renderer.render_pixels(s1, c1, c, W, H, pid, 1, cfg.seed)
                  for c in (cfg, dataclasses.replace(cfg, kernels="off")))
    err = float((rk - rp).abs().max())
    moved = float((s1.tex_data - pristine.tex_data).abs().max())
    check("train stale-pack radiance", 0, err)
    if not moved > 1e-4:
        raise AssertionError(f"train: texels moved only {moved:.3g}")
    return dict(stale_pack_err=f"{err:.3g}", texels_moved=f"{moved:.4g}")


def tiled_phase(label, sb, spp, tile=128):
    """`render(ckpt_dir=..., tile=128)` against the direct render: the
    image bit for bit, both walls; then every other tile file deleted and
    the resume (only those re-rendered: the kept files' mtimes unchanged),
    a third call that renders nothing, and host 1 of 2 in a fresh store
    (only its tiles, equal to the first store's)."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    renderer.render(scene, cam, cfg, nsamples=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = renderer.render(scene, cam, cfg)
    direct_s = time.perf_counter() - t0
    d = tempfile.mkdtemp()
    man = TileManifest(W, H, tile, d)
    reset_launches()
    t0 = time.perf_counter()
    img = renderer.render(scene, cam, cfg, ckpt_dir=d, tile=tile)
    tiled_s = time.perf_counter() - t0
    launches = launch_counts("first_hits", "shade_scatter")
    n = man.n_tiles
    if launches != dict(first_hits=n * spp * BOUNCES,
                        shade_scatter=n * spp * BOUNCES):
        raise AssertionError(f"tiled {label}: launches {launches}")
    if not np.array_equal(img, direct):
        raise AssertionError(f"tiled {label}: image differs from the direct "
                             f"render by {np.abs(img - direct).max():.3g}")
    files = sorted(os.listdir(d))
    if len(files) != n:
        raise AssertionError(f"tiled {label}: {len(files)} tile files")
    for f in files[::2]:
        os.remove(os.path.join(d, f))
    kept = {f: os.path.getmtime(os.path.join(d, f)) for f in files[1::2]}
    t0 = time.perf_counter()
    img2 = renderer.render(scene, cam, cfg, ckpt_dir=d, tile=tile)
    resume_s = time.perf_counter() - t0
    every = {f: os.path.getmtime(os.path.join(d, f)) for f in files}
    t0 = time.perf_counter()
    reset_launches()
    img3 = renderer.render(scene, cam, cfg, ckpt_dir=d, tile=tile)
    skip_s = time.perf_counter() - t0
    if (launch_counts("first_hits")["first_hits"] != 0
            or every != {f: os.path.getmtime(os.path.join(d, f))
                         for f in files}
            or any(every[f] != t for f, t in kept.items())
            or not (np.array_equal(img2, direct)
                    and np.array_equal(img3, direct))):
        raise AssertionError(f"tiled {label}: resume re-rendered kept tiles "
                             f"or changed the image")
    d2 = tempfile.mkdtemp()
    t0 = time.perf_counter()
    renderer.render(scene, cam, cfg, ckpt_dir=d2, tile=tile, host=1,
                    n_hosts=2)
    host_s = time.perf_counter() - t0
    mine = sorted(os.listdir(d2))
    if mine != files[1::2] or not all(np.array_equal(
            man.load_tile(t)[0], TileManifest(W, H, tile, d2).load_tile(t)[0])
            for t in range(1, n, 2)):
        raise AssertionError(f"tiled {label}: host 1 of 2 wrote {mine}")
    say("tiled", scene=label, size=f"{W}x{H}", spp=spp, tile=tile, tiles=n,
        direct_s=f"{direct_s:.4f}", tiled_s=f"{tiled_s:.4f}",
        resume_half_s=f"{resume_s:.4f}", skip_s=f"{skip_s:.4f}",
        host_1_of_2_s=f"{host_s:.4f}", image="bit-equal",
        launches=launches)


def cli_phase():
    """`tracer_torch.cli.main([...])` in-process for each subcommand
    (render, render --ckpt-dir, probe, benchmark --occupancy / --compile /
    --profile, grad-check, train, scenes), at the CLI's default 850x480
    and 6 bounces: each one's wall time and its JSON, then one
    `python -m tracer_torch.cli scenes` in a subprocess."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    tiles = tempfile.mkdtemp()
    runs = [
        ("render", ["render", "--spp", "16", "--out",
                    os.path.join(out_dir, "cornell_box.ppm")]),
        ("render_ckpt", ["render", "--spp", "16", "--ckpt-dir", tiles,
                         "--out", os.path.join(out_dir, "cornell_tiled.png")]),
        ("probe", ["probe", "--x", "240", "--y", "70"]),
        ("occupancy", ["benchmark", "--occupancy"]),
        ("compile", ["benchmark", "--compile"]),
        ("profile", ["benchmark", "--profile",
                     os.path.join(out_dir, "profile")]),
        ("benchmark", ["benchmark"]),
        ("grad_check", ["grad-check"]),
        ("train", ["train", "--steps", "3", "--spp", "4"]),
        ("scenes", ["scenes"]),
    ]
    for name, argv in runs:
        if name == "compile":
            # the frame's graph of these shapes is cached by `render`: the
            # compile split is a first call's, in a cache without it
            graphs.CACHE.clear()
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)     # raises (SystemExit too) on failure
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue().strip()
        kv = dict(cmd='"' + " ".join(argv) + '"', wall_s=f"{wall:.3f}")
        if name.startswith("render"):
            # the direct render: one chunk of 16 spp; the tiled one: 28
            # tiles of 128x128 px
            calls = 16 * BOUNCES * (1 if name == "render" else 28)
            n = launch_counts("first_hits", "shade_scatter")
            if n != dict(first_hits=calls, shade_scatter=calls):
                raise AssertionError(f"cli {name}: launches {n}")
            kv["launches"] = n
        if name == "compile":
            res = json.loads(text.splitlines()[-1])
            split = ("nvcc_s", "warmup_s", "capture_s", "instantiate_s",
                     "first_replay_s")
            if any(res[k] is None for k in split[1:]):
                raise AssertionError(f"cli benchmark --compile: {res}")
        if name == "grad_check":
            res = json.loads(text)
            if not all(r["ok"] for r in res.values()):
                raise AssertionError(f"cli grad-check: {res}")
            kv["result"] = json.dumps(res, separators=(",", ":"))
        elif name == "scenes":
            kv["scenes"] = len(text.splitlines())
        elif text.splitlines() and text.splitlines()[-1].startswith("{"):
            kv["json"] = text.splitlines()[-1]
        else:
            kv["out"] = text.splitlines()[-1] if text else ""
        say("cli", name=name, **kv)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "tracer_torch.cli",
                          "scenes"], capture_output=True, text=True,
                         timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0 or len(res.stdout.splitlines()) != 11:
        raise AssertionError(f"python -m tracer_torch.cli scenes: "
                             f"{res.returncode} {res.stderr[-500:]}")
    say("cli", name="module_entry", cmd="python -m tracer_torch.cli scenes",
        wall_s=f"{time.perf_counter() - t0:.3f}",
        scenes=len(res.stdout.splitlines()))


def lanes_phase_inputs(scene, tables):
    """The inputs of B5 and B6 at the flagship shapes: the camera rays of
    one sample (bounce 0) and the rays the kernel path scatters from them
    (bounce 1), each with its first-hit record and keys."""
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    cfg = RenderConfig()
    state = integrator._init_state(o, d, tm)
    out = []
    for b in (0, 1):
        t_raw = tri_raw = None
        if scene.mesh_mat.shape[0] > 0:
            t_raw, tri_raw = ktraverse.mesh_closest_hits(
                scene, state["o"], state["d"], state["active"],
                tables=tables.tree)
        k1 = kintersect.first_hits(
            scene, state["o"], state["d"], state["time"], state["active"],
            tables=tables.intersect, t_mesh=t_raw, tri_mesh=tri_raw,
            mesh=tables.mesh)
        # the bounce updates its state in place: keep a copy of its input
        out.append((b, integrator.copy_state(state), k1, rng.salted(keys, b)))
        state, _ = integrator._bounce_core(scene, cfg, keys, state, b,
                                           tables=tables)
    return out


def percentiles(x):
    """[p50, p90, p99, max] of a per-ray count (a 1-D integer tensor)."""
    n = x.numel()
    if n == 0:
        return [0, 0, 0, 0]
    xs = torch.sort(x).values
    return [int(xs[min(n - 1, int(q * n))]) for q in (0.5, 0.9, 0.99)] + [
        int(xs[-1])]


def sort_probe(key, live):
    """The permutation of the JAX package's sorted dispatch (a stable sort
    by `key`, the lanes that are not live last) and the live mask in that
    order."""
    order = torch.argsort(torch.where(live, key, 1 << 20), stable=True)
    return order, live[order]


def grid_key(c, scene, cells):
    """The position bucket of the sorted dispatch: a cells^3 grid over the
    union of the meshes' root boxes."""
    roots = torch.as_tensor(scene.mesh_root, device=c[0].device)
    lo, hi = scene.bvh_lo[roots].amin(0), scene.bvh_hi[roots].amax(0)
    top = cells - 0.001
    inv = top / torch.clamp_min(hi - lo, 1e-6)
    return sum(torch.clamp((c[a] - lo[a]) * inv[a], 0.0, top)
               .to(torch.int64) * cells ** (2 - a) for a in range(3))


def walk_sorted(scene, o, d, live, tree):
    """B5 behind the JAX package's sorted ray queue (a probe: the port
    walks in ray order): rays bucketed by direction octant and an 8^3
    grid, dead lanes last, walked in that order, the results put back in
    ray order."""
    octant = ((d[0] < 0).to(torch.int64) + 2 * (d[1] < 0).to(torch.int64)
              + 4 * (d[2] < 0).to(torch.int64))
    perm, live_s = sort_probe(octant * 512 + grid_key(o, scene, 8), live)
    t_s, tri_s = ktraverse.mesh_closest_hits(
        scene, tuple(c[perm] for c in o), tuple(c[perm] for c in d), live_s,
        tables=tree)
    t, tri = torch.empty_like(t_s), torch.empty_like(tri_s)
    t[:, perm], tri[:, perm] = t_s, tri_s
    return t, tri


def shadow_sorted(scene, cfg, p, tm, keys, live, tables):
    """B6 behind the JAX package's position-sorted dispatch (a probe): hit
    points bucketed on a 16^3 grid, dead lanes last, the factors put back
    in lane order."""
    perm, live_s = sort_probe(grid_key(p, scene, 16), live)
    out_s = kshadow.shadow_factors(
        scene, cfg, tuple(c[perm] for c in p), tm[perm], keys[perm],
        cfg.epsilon, live_s, tables=tables.shadow, tree=tables.tree)
    out = torch.empty_like(out_s)
    out[:, perm] = out_s
    return out


def walk_phase(label, scene, stats):
    """B5 against its plain version on every lane of one sample's bounce-0
    and bounce-1 rays: (t, tri) must match exactly. The plain walk counts
    the node visits and triangle tests that the bound is computed from,
    and each ray's (their p50/p90/p99/max). A probe times the same rays
    behind the JAX package's sorted queue (`walk_sorted`): the kernel's
    device time and the whole dispatch, sort included."""
    tables = integrator.prepare(scene)
    Nm = scene.mesh_mat.shape[0]
    for b, state, _, _ in lanes_phase_inputs(scene, tables):
        o, d, live = state["o"], state["d"], state["active"]

        def run(mode):
            return ktraverse.mesh_closest_hits(scene, o, d, live,
                                               kernels=mode,
                                               tables=tables.tree)

        t_k, tri_k = run("auto")
        blocks = ktraverse.BLOCKS

        def run_sorted():
            return walk_sorted(scene, o, d, live, tables.tree)

        t_s, tri_s = run_sorted()
        if not (torch.equal(t_s, t_k) and torch.equal(tri_s, tri_k)):
            raise AssertionError(f"traverse {label} b{b}: the sorted order "
                                 "changes a result")
        cnt = {}
        t_p, tri_p = ktraverse.mesh_closest_hits_plain(scene, o, d, live,
                                                       tables.tree, cnt)
        # the plain version's time, without the counting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run("off")
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        mism = int(((t_k != t_p) | (tri_k != tri_p)).sum())
        if mism:
            raise AssertionError(f"traverse {label} b{b}: {mism} of "
                                 f"{t_k.numel()} (t, tri) mismatches")
        n_live = int(live.sum())
        ms = timed(lambda: run("auto"), 10)
        nb = (lane_bytes(live, o, d) + nbytes(t_k, tri_k)
              + tree_bytes(scene, tables.tree, cnt))
        ops = cnt.get("visits", 0) * OPS_VISIT + cnt.get("tests", 0) * OPS_TRI
        bms, by = bound2(nb, ops)
        lc = cnt["lane_counts"]
        say("B5", scene=label, bounce=b, lanes=o[0].numel(), live=n_live,
            meshes=Nm, tree_nodes=scene.bvh_lo.shape[0],
            triangles=scene.tri_a.shape[0] - 1, mismatches=mism,
            hits=int((tri_p >= 0).sum()),
            visits_per_ray=f"{cnt.get('visits', 0) / max(n_live, 1):.2f}",
            max_visits=cnt.get("max_visits", 0),
            tests_per_ray=f"{cnt.get('tests', 0) / max(n_live, 1):.2f}",
            visits_p50_p90_p99_max=percentiles(lc[0]),
            tests_p50_p90_p99_max=percentiles(lc[1]),
            nodes_read=int(cnt["nodes_seen"].sum()),
            leaves_tested=int(cnt["leaves_seen"].sum()),
            persistent_blocks=blocks,
            ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            device_ms=device_ms(lambda: run("auto"), 10, "traverse"),
            sorted_device_ms=device_ms(run_sorted, 10, "traverse"),
            sorted_dispatch_ms=f"{timed(run_sorted, 10):.4f}",
            bound_ms=f"{bms:.4f}", bound_by=by,
            byte_bound_ms=f"{bound_ms(nb):.4f}")
        stats["traverse"].append(Rec(0.0, ms, pms, bms, by))


def shadow_phase(label, scene, stats):
    """B6 against its plain version at the live hit points of one sample's
    bounce-0 and bounce-1 rays, on all 408,000 lanes, both compat modes:
    the factors must match exactly. The plain megabatch counts the shadow
    rays, table tests, node visits and triangle tests that the bound is
    computed from, and each shadow ray's visits and tests (their
    p50/p90/p99/max). Probes time the kernel on the same lanes with the
    live ones first and, on mesh scenes, behind the JAX package's sorted
    dispatch (`shadow_sorted`: the kernel's device time and the whole
    dispatch, sort included)."""
    tables = integrator.prepare(scene)
    meshes = scene.mesh_mat.shape[0] > 0
    for b, state, k1, bkeys in lanes_phase_inputs(scene, tables):
        live = state["active"] & (k1["j"] >= 0)
        p, tm = k1["p"], state["time"]
        for compat in ("reference", "physical"):
            cfg = RenderConfig(compat=compat)

            def run(mode):
                return kshadow.shadow_factors(
                    scene, cfg, p, tm, bkeys, cfg.epsilon, live,
                    kernels=mode, tables=tables.shadow, tree=tables.tree)

            def run_sorted():
                return shadow_sorted(scene, cfg, p, tm, bkeys, live, tables)

            got = run("auto")
            blocks = kshadow.BLOCKS
            extra = {}
            if meshes:
                if not torch.equal(run_sorted(), got):
                    raise AssertionError(f"shadow {label} b{b} {compat}: "
                                         "the sorted order changes a factor")
                extra["sorted_device_ms"] = device_ms(run_sorted, 5, "shadow")
                extra["sorted_dispatch_ms"] = f"{timed(run_sorted, 5):.4f}"
            cnt = {}
            want = kshadow.shadow_factors_plain(
                scene, cfg, p, tm, bkeys, cfg.epsilon, live, tables.shadow,
                tables.tree, cnt)
            # the plain version's time, without the counting
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run("off")
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            mism = int((got != want).sum())
            if mism:
                raise AssertionError(f"shadow {label} b{b} {compat}: {mism}"
                                     f" of {want.numel()} factors differ")
            ms = timed(lambda: run("auto"), 5)
            nb = (lane_bytes(live, p, tm, bkeys.to(torch.int32))
                  + nbytes(got, tables.shadow)
                  + tree_bytes(scene, tables.tree, cnt))
            ops = (cnt.get("rays", 0) * OPS_SAMPLE
                   + cnt.get("table_tests", 0) * OPS_TABLE
                   + cnt.get("visits", 0) * OPS_VISIT
                   + cnt.get("tests", 0) * OPS_TRI)
            bms, by = bound2(nb, ops)
            rays = max(cnt.get("rays", 0), 1)
            # a probe of what packing the live lanes together costs: the
            # same lanes with the live ones first
            lfirst = torch.argsort((~live).to(torch.int32), stable=True)
            pargs = (tuple(c[lfirst] for c in p), tm[lfirst], bkeys[lfirst],
                     cfg.epsilon, live[lfirst])
            lc = cnt["lane_counts"]
            say("B6", scene=label, bounce=b, compat=compat,
                lanes=live.numel(), live=int(live.sum()),
                lights=scene.light_pos.shape[0],
                meshes=scene.mesh_mat.shape[0], mismatches=mism,
                lit_mean=f"{float(got[:, live].mean()):.4f}",
                shadow_rays=cnt.get("rays", 0),
                table_tests_per_ray=f"{cnt.get('table_tests', 0) / rays:.2f}",
                visits_per_ray=f"{cnt.get('visits', 0) / rays:.2f}",
                max_visits=cnt.get("max_visits", 0),
                tests_per_ray=f"{cnt.get('tests', 0) / rays:.2f}",
                visits_p50_p90_p99_max=percentiles(lc[0]),
                tests_p50_p90_p99_max=percentiles(lc[1]),
                persistent_blocks=blocks,
                ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
                device_ms=device_ms(lambda: run("auto"), 5, "shadow"),
                live_first_device_ms=device_ms(
                    lambda: kshadow.shadow_factors(
                        scene, cfg, *pargs, tables=tables.shadow,
                        tree=tables.tree), 5, "shadow"),
                **extra,
                bound_ms=f"{bms:.4f}", bound_by=by,
                byte_bound_ms=f"{bound_ms(nb):.4f}")
            stats["shadow"].append(Rec(0.0, ms, pms, bms, by))


def limits_phase(label, sb, expect):
    """The scenes the first port's fixed limits refused on the card (B1's
    and B6's 48 KB of shared tables, B5's and B6's 16 meshes), at one
    850x480 sample, bounces 0 and 1: B5 (mesh scenes), B1, B6 and B2
    against their plain versions, with 0 discrete mismatches and B5's and
    B6's results exact, and where each kernel's tables sat: dynamic shared
    memory or, beyond a block's 227 KB, L2. `expect` is the placement
    (b1, b6, b2) the case is there to exercise."""
    scene = compile_scene(sb, device=DEV)
    tables = integrator.prepare(scene)
    itab = tables.intersect
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    cfg = RenderConfig()
    state = integrator._init_state(o, d, tm)
    Nm = scene.mesh_mat.shape[0]
    S_real, Q_real = scene.n_sph_real, scene.n_quad_real
    S, Q = scene.sph_center.shape[0], scene.quad_v0.shape[0]
    for b in (0, 1):
        bkeys = rng.salted(keys, b)
        live = state["active"]
        mism, err, extra = 0, 0.0, {}
        mesh_in = {}
        if Nm > 0:
            def walk(mode):
                return ktraverse.mesh_closest_hits(
                    scene, state["o"], state["d"], live, kernels=mode,
                    tables=tables.tree)

            (t_k, tri_k), (t_p, tri_p) = walk("auto"), walk("off")
            mism += int(((t_k != t_p) | (tri_k != tri_p)).sum())
            mesh_in = dict(t_mesh=t_p, tri_mesh=tri_p, mesh=tables.mesh)

        def fh(mode):
            return kintersect.first_hits(
                scene, state["o"], state["d"], state["time"], live,
                kernels=mode, tables=itab, **mesh_in)

        k1, k1p = fh("auto"), fh("off")
        extra["b1_tables"] = kintersect.TABLES
        m1, e1 = compare(k1, k1p, live)
        if Nm > 0:
            # lanes won by a mesh whose root B5 reads through L1
            beyond = int((k1p["j"][live] >= S + Q + ktraverse.ROOT_CACHE)
                         .sum())
            extra["b5_roots_shared"] = min(Nm, ktraverse.ROOT_CACHE)
            extra["mesh_wins_beyond"] = beyond
            if Nm > ktraverse.ROOT_CACHE and beyond == 0:
                raise AssertionError(f"limits {label} b{b}: no lane hits a "
                                     "mesh whose root is read through L1")
        hit = live & (k1p["j"] >= 0)

        def shadow(mode):
            return kshadow.shadow_factors(
                scene, cfg, k1p["p"], state["time"], bkeys, cfg.epsilon, hit,
                kernels=mode, tables=tables.shadow, tree=tables.tree)

        sh_k, sh_p = shadow("auto"), shadow("off")
        extra["b6_tables"] = kshadow.TABLES
        mism += int((sh_k != sh_p).sum())

        def shade(mode):
            return kshade.shade_scatter(
                scene, cfg, integrator.copy_state(state), bkeys, k1p,
                BOUNCES - b, shadows=sh_p, kernels=mode, tables=tables.shade,
                mesh=tables.mesh, quad=itab[1])

        st_k, st_p = shade("auto"), shade("off")
        extra["b2_tables"] = kshade.TABLES
        m2, e2 = compare(st_k, st_p)
        mism, err = mism + m1 + m2, max(e1, e2)
        check(f"limits {label} b{b}", mism, err)
        took = (extra["b1_tables"], extra["b6_tables"], extra["b2_tables"])
        if took != expect:
            raise AssertionError(f"limits {label} b{b}: tables (B1, B6, B2) "
                                 f"sat in {took}, expected {expect}")
        say("limits", scene=label, bounce=b, spheres=S_real, quads=Q_real,
            meshes=Nm, lights=scene.light_pos.shape[0],
            live=int(live.sum()), hits=int(hit.sum()),
            winners=len(set(k1p["j"][live].unique().tolist())),
            # B1's rows in shared memory are padded to 12 and 48 floats
            b1_shared_kb=f"{(S_real * 12 + Q_real * 48) * 4 / 1024:.1f}",
            b6_table_kb=f"{(scene.light_pos.shape[0] * 4 + S_real * 9
                            + Q_real * 20 + Nm) * 4 / 1024:.1f}",
            b2_table_kb=f"{(tables.shade[0].numel() + tables.shade[1].numel()
                            + scene.quad_v0.shape[0] * 8) * 4 / 1024:.1f}",
            **extra, mismatches=mism, max_abs_err=f"{err:.3g}",
            lit_mean=f"{float(sh_k[:, hit].mean()):.4f}")
        state = st_p


def entry_point_phases(flat_sb, pair_sb, rtw_sb):
    """Training (`train.fit`), the tiled checkpointed render and the CLI,
    each path with the counts reset just before it and read just after."""
    n = SPP * BOUNCES
    none = dict(traverse=0, shadow=0, row_sum=0)
    train_phase("cornell", flat_sb, SPP,
                ("mat_diffuse", "sph_center", "cam_quaternion"),
                dict(mat_diffuse=0.05, sph_center=0.02,
                     cam_quaternion=0.002), steps=5, lr=2e-3,
                expect=dict(first_hits=n, shade_scatter=n, bounce_bwd=n,
                            sorted_fold=0, **none),
                resume_exact=True)
    # texels train: guard_config renders the exact atlas (general route,
    # no B2), the hand-written sweep (B3) and the fold (B4) stay
    train_phase("cornell_textured", pair_sb, SPP, ("tex_data", "mat_diffuse"),
                dict(tex_data=0.05, mat_diffuse=0.05), steps=3, lr=1e-2,
                expect=dict(first_hits=n, shade_scatter=0, bounce_bwd=n,
                            sorted_fold=SPP, **none),
                resume_exact=True, grad_check=True, stale_check=True)
    # the general backward: its row sums run in a fixed order (the
    # row-sum kernel), so the resumed run is held bit-equal to the
    # uninterrupted one. Its loss need not fall: each sphere sits under
    # a light, and Adam's first steps (about lr a component) move the
    # spheres' shadows, whose visibility the gradient does not see
    rtw_spp = 4
    rtw_trainable = ("mat_diffuse", "sph_center", "tex_data")
    train_phase("rt_weekend_standin", rtw_sb, rtw_spp, rtw_trainable,
                dict(mat_diffuse=0.05, sph_center=0.02, tex_data=0.05),
                steps=3, lr=1e-2,
                expect=dict(first_hits=rtw_spp * BOUNCES, shade_scatter=0,
                            bounce_bwd=0, sorted_fold=rtw_spp, traverse=0,
                            shadow=rtw_spp * BOUNCES,
                            row_sum=rowsum_launches(
                                compile_scene(rtw_sb, device=DEV),
                                rtw_trainable, rtw_spp)),
                resume_exact=True, must_fall=False)
    tiled_phase("cornell", flat_sb, SPP)
    cli_phase()


# ---------------------------------------------------------------------------
# The compiled entry points (tracer_torch/render/graphs.py): CUDA graphs
# ---------------------------------------------------------------------------

def in_turns(fns, reps, warm=True):
    """{name: sorted walls}: one warm-up call of each of `fns` ({name: fn},
    each call ending in a synchronise; skipped with `warm=False`, where the
    caller has just called each), then `reps` rounds that call each once,
    the order reversed every other round (a, b, b, a, ...)."""
    names = list(fns)
    for n in names if warm else ():
        fns[n]()
        torch.cuda.synchronize()
    walls = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[n]()
            torch.cuda.synchronize()
            walls[n].append(time.perf_counter() - t0)
    return {n: sorted(w) for n, w in walls.items()}


_PROFILED = []   # whether this process has run the profiler yet


def profiled(fn):
    """(wall ms, device busy ms, idle share, kernels) of one call of `fn`
    under torch.profiler, right after the caller's own calls of `fn`; the
    process's first use of the profiler is profiled twice and the second
    kept (the first traced call cost the tracer seconds). A
    replayed graph's kernels are counted as the eager ones are."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(1 if _PROFILED else 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    _PROFILED.append(True)
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    return wall, busy, 1.0 - busy / wall, sum(e.count for e in evs), {
        k: sum(e.count for e in evs if k in e.key)
        for k in ("first_hits_kernel", "shade_scatter_kernel",
                  "bounce_bwd_kernel")}


def all_bit_equal(a, b):
    """Two pytrees of tensors with the same bits."""
    if isinstance(a, torch.Tensor):
        return bit_equal(a.contiguous(), b.contiguous())
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(all_bit_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(all_bit_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def graph_check(label, compiled, eager, want_launches=None, reps=0,
                profile=False, captures=1, **extra):
    """One compiled entry point against its eager body in the same call:
    the first call (the warm-up's result, then the capture; with
    `captures=0` a replay of a graph of the same shapes already cached),
    a replay and the eager body, all bit-equal; the launches of the replay and of the
    eager call (the counts reset just before each and read just after),
    which must be equal (and `want_launches`, where given), the kernels
    of the path having run; the host synchronisations of that replay and
    that eager call; with `reps`, the walls of both in turns (median and
    spread, after those calls); with `profile` ("both", or "compiled"
    where the eager step's profile is another line's), the device busy
    time and idle share. Each line also gives the graph's warm-up,
    capture and instantiate seconds, its pool, the peak memory allocated
    over the first call, the replay and the eager call, and the graph's
    runs in the replayed call (a frame's: one a sample).
    Returns (host syncs of the replay, of the eager call, the replay's
    launches)."""
    cache = graphs.CACHE
    n0 = cache.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = compiled()
    g = cache.graphs()[-1]   # the graph last captured or replayed
    if cache.captures != n0 + captures:
        raise AssertionError(f"graph {label}: {cache.captures - n0} "
                             f"captures at the first call, {captures} "
                             f"expected")
    replays0, runs0 = g.replays, g.runs
    out = {}

    def run(name, fn):
        def call():
            out[name] = fn()
        reset_launches()
        syncs, where = host_syncs(call)
        return launched(*KERNEL_MODULES), syncs, where

    launches, syncs, where = run("replay", compiled)
    if g.replays != replays0 + 1 or cache.captures != n0 + captures:
        raise AssertionError(f"graph {label}: the second call did not "
                             f"replay the graph")
    runs = g.runs - runs0
    with cache.disabled():
        eager_launches, syncs_eager, where_eager = run("eager", eager)
    if not launches or launches != eager_launches or (
            want_launches is not None and launches != want_launches):
        raise AssertionError(f"graph {label}: a replay's launches "
                             f"{launches}, the eager call's "
                             f"{eager_launches}, expected {want_launches}")
    if not (all_bit_equal(first, out["eager"])
            and all_bit_equal(out["replay"], out["eager"])):
        raise AssertionError(f"graph {label}: compiled differs from eager")
    if syncs:
        raise AssertionError(f"graph {label}: {syncs} host syncs in a "
                             f"replay: {where}")
    kv = dict(extra, vs_eager="bit-equal", captures=captures,
              graph_runs_a_call=runs, launches_a_replay=launches,
              launches_eager="equal", host_syncs=syncs,
              host_syncs_eager=syncs_eager, sync_at_eager=where_eager,
              warmup_s=f"{g.times['warmup_s']:.3f}",
              capture_s=f"{g.times['capture_s']:.3f}",
              instantiate_s=f"{g.times['instantiate_s']:.3f}",
              pool_gb=f"{g.pool_bytes / 1e9:.3f}",
              peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    walls = {}
    if reps:
        def off():
            with cache.disabled():
                return eager()
        walls = in_turns(dict(eager=off, compiled=compiled), reps,
                         warm=False)
        kv.update(wall_s_eager=spread(walls["eager"]),
                  wall_s_compiled=spread(walls["compiled"]))
    if profile:
        # the idle share under the profiler, and against the median wall
        # of the calls above, which ran without it
        for name, fn in (("compiled", compiled), ("eager", eager)):
            if profile == "compiled" and name == "eager":
                continue
            with contextlib.ExitStack() as st:
                if name == "eager":
                    st.enter_context(cache.disabled())
                wall, busy, idle, n, per = profiled(fn)
            med = walls[name][len(walls[name]) // 2] * 1e3
            kv[f"profile_{name}"] = dict(
                wall_ms=f"{wall:.1f}", device_busy_ms=f"{busy:.1f}",
                idle_share=f"{idle:.3f}",
                idle_share_vs_median_wall=f"{1.0 - busy / med:.3f}",
                device_launches=n, **per)
    say("graph", case=label, **kv)
    return syncs, syncs_eager, launches


def fit_check(label, scene, cam, cfg, trainable, offsets, lr, want,
              mesh=None, steps=4):
    """`train.fit` for `steps` steps from a seeded start, compiled (a
    graph captured at the first step, replayed from the second) against
    eager (`graphs.CACHE.disabled()`), and a compiled run of `steps` - 2
    steps resumed to `steps`; with `mesh`, also unsharded `fit()`
    compiled. Every run's losses, grad norms, params and checkpointed Adam
    state bit-equal to the compiled one; one capture a run; the launches
    of the compiled run equal to the eager run's and to `want`, one
    step's launches by the formula (`call_launches`, `general_launches`),
    `steps` times (a replay counts what it stands for). Prints the walls of steps 2 on, and of a kept
    compiled step (`make_step`) the host syncs of a replay (0) and its
    profile."""
    cache = graphs.CACHE
    target = train_target(scene, cam, cfg, trainable, cfg.nsamples)
    s0, c0 = train_start(scene, cam, trainable, offsets, seed=1)
    kw = dict(trainable=trainable, lr=lr, width=W, height=H,
              nsamples=cfg.nsamples, ckpt_every=steps, seed=cfg.seed)
    tmp = tempfile.mkdtemp()
    runs = {}
    names = ("compiled", "eager", "resumed") + (
        ("unsharded",) if mesh is not None else ())
    for name in names:
        d = os.path.join(tmp, name)
        m = None if name == "unsharded" else mesh
        with contextlib.ExitStack() as st:
            if name == "eager":
                st.enter_context(cache.disabled())
            if name == "resumed":
                T.fit(s0, c0, cfg, target, steps=steps - 2, ckpt_dir=d,
                      mesh=m, **kw)
            reset_launches()
            n0 = cache.captures
            s1, c1, hist = T.fit(s0, c0, cfg, target, steps=steps,
                                 ckpt_dir=d, mesh=m, **kw)
            torch.cuda.synchronize()
        runs[name] = (T.split_params(s1, c1, trainable), hist,
                      ckpt_leaves(os.path.join(d, "train.npz")),
                      launch_counts(*KERNEL_MODULES), cache.captures - n0)
    pa, ha, la, na, capa = runs["compiled"]
    ne, cape = runs["eager"][3], runs["eager"][4]
    if (na != ne or {k: v for k, v in na.items() if v} != times(want, steps)
            or capa != 1 or cape != 0):
        raise AssertionError(f"graph {label}: launches {na} compiled, {ne} "
                             f"eager, {times(want, steps)} expected; {capa} "
                             f"and {cape} captures")
    for name in names[1:]:
        pb, hb, lb, _, capb = runs[name]
        steps_b = [(h["loss"], h["grad_norm"]) for h in hb]
        if not (steps_b == [(h["loss"], h["grad_norm"])
                            for h in ha][-len(hb):]
                and all(bit_equal(pa[k].detach(), pb[k].detach())
                        for k in trainable) and leaves_equal(la, lb)):
            raise AssertionError(f"graph {label}: {name} run differs from "
                                 f"the compiled one")
    walls = {name: sorted(h["step_s"] for h in runs[name][1][1:])
             for name in ("compiled", "eager")}
    # the compiled step alone (`fit` reads each step's loss to the host
    # for its log): its host syncs and its profile, on a kept step
    params = T.split_params(s0, c0, trainable)
    step = T.make_step(
        T._adam_default(lr)([params[k] for k in sorted(params)]),
        T.guard_config(cfg, trainable), target, W, H, cfg.nsamples, mesh)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)

    def call():
        return step(params, s0, c0, pid, cfg.seed)

    # new leaves of the same shapes: the compiled run's graph replays
    n0 = cache.captures
    call()
    g = cache.graphs()[-1]   # the graph the kept step replayed
    replays0 = g.replays
    call()
    syncs, where = host_syncs(call)
    if syncs or g.replays != replays0 + 2 or cache.captures != n0:
        raise AssertionError(f"graph {label}: {syncs} host syncs in a "
                             f"replayed step ({where}), "
                             f"{g.replays - replays0} replays of 2, "
                             f"{cache.captures - n0} captures for new "
                             f"leaves of the same shapes")
    wall, busy, idle, n, _ = profiled(call)
    med = walls["compiled"][len(walls["compiled"]) // 2] * 1e3
    say("graph", case=label, steps=steps, spp=cfg.nsamples,
        trainable="+".join(trainable),
        mesh=dict(mesh.shape) if mesh is not None else None,
        vs_eager="bit-equal", resume="bit-equal",
        kept_step_new_leaves="replayed, 0 captures",
        **({"vs_unsharded": "bit-equal"} if mesh is not None else {}),
        launches_a_step={k: v // steps for k, v in na.items() if v},
        step_s_eager=spread(walls["eager"]),
        step_s_compiled=spread(walls["compiled"]), host_syncs_step=syncs,
        profile_compiled=dict(
            wall_ms=f"{wall:.1f}", device_busy_ms=f"{busy:.1f}",
            idle_share=f"{idle:.3f}",
            idle_share_vs_median_wall=f"{1.0 - busy / med:.3f}",
            device_launches=n),
        capture_s=f"{g.times['capture_s']:.3f}",
        instantiate_s=f"{g.times['instantiate_s']:.3f}",
        pool_gb=f"{g.pool_bytes / 1e9:.3f}",
        losses=[f"{h['loss']:.6g}" for h in ha])


def graph_phase(flat_sb, pair_sb, reps=3):
    """The compiled entry points against their eager bodies, in the same
    call, at 850x480, 6 bounces (`[graph]` lines): each replays a cached
    graph from its second call on, bit-equal to the eager body
    (`graph_check`): the Cornell 16-spp frame (`renderer.render_frame`) and
    `bench.frame_scalar`; the Cornell and textured Cornell 16-spp protocol
    steps (`bench.protocol_step`: the summed gradient, the loss and the
    gradients of mat_diffuse, sph_center and tex_data); the frames of
    flamingo_standin (B5, B6), rt_weekend_standin (fused, and the general
    forward under packed_atlas="off") and random_spheres at 4 spp. The
    host syncs of a compiled frame and step (0) and of the eager ones (at
    most 1 a step); walls (median and spread of `reps` after a warm-up,
    eager beside compiled, in turns) and the device's idle share under the
    profiler for the frame and the step. Then `fit` on Cornell: 4 steps
    compiled against 4 eager (losses, grad norms, params and the Adam
    state bit-equal; the walls of steps 2-4; launches a step), and a
    compiled run of 2 steps resumed to 4, bit-equal to the uninterrupted
    one. Then the 28-tile render (compiled, one graph a tile shape)
    bit-equal to the direct frame, its walls beside the eager tiled
    render's. Last, a body that reads the card must fail at its capture:
    it raises, nothing is cached, no eager result stands in, and the
    card works on. Each graph's capture seconds and pool bytes are
    printed."""
    from tracer_torch import bench
    cache = graphs.CACHE
    cache.clear()
    cam = default_camera(W / H, device=DEV)
    flat = compile_scene(flat_sb, device=DEV)
    pair = compile_scene(pair_sb, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=BOUNCES)
    total = {}

    def add(counts, times=1):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v * times

    def frame(scene, spp, c=cfg):
        return lambda: renderer.render_frame(scene, cam, c, W, H, pid, spp,
                                             c.seed)

    want = call_launches(flat, cfg, SPP)
    sync_frame, _, _ = graph_check("cornell_frame", frame(flat, SPP),
                                frame(flat, SPP), want, reps, profile=True)
    add(want)
    bf = bench.Inputs(flat, cam, cfg, W, H, pid, SPP)
    # the bench's frame is the frame's graph, already captured above
    graph_check("bench_frame_scalar", lambda: bench.frame_scalar(bf),
                lambda: bench.frame_scalar(bf), want, captures=0)
    add(want)
    for label, scene in (("cornell", flat), ("cornell_textured", pair)):
        b = bench.Inputs(scene, cam, cfg, W, H, pid, SPP)
        want = call_launches(scene, cfg, SPP, TRAINABLE)
        sync_step, sync_eager, _ = graph_check(
            f"{label}_protocol_step",
            lambda b=b: bench.protocol_step(b, TRAINABLE),
            lambda b=b: bench.protocol_step(b, TRAINABLE), want, reps,
            profile=label == "cornell")
        add(want)
        if sync_frame or sync_step or sync_eager > 1:
            raise AssertionError(
                f"graph: host syncs: a compiled frame {sync_frame}, a "
                f"compiled step {sync_step}, an eager step {sync_eager}")
    cache.clear()
    rtw = compile_scene(rt_weekend_standin(zoo), device=DEV)
    for label, scene, spp, kw in (
            ("flamingo_standin", compile_scene(flamingo_standin(zoo),
                                               device=DEV), 4, {}),
            ("rt_weekend_standin", rtw, 4, {}),
            ("rt_weekend_standin_general", rtw, 4,
             dict(packed_atlas="off")),
            ("random_spheres", compile_scene(zoo.setup_random_spheres(),
                                             device=DEV), 4, {})):
        c = dataclasses.replace(cfg, nsamples=spp, **kw)
        want = call_launches(scene, c, spp)
        graph_check(f"{label}_frame", frame(scene, spp, c),
                    frame(scene, spp, c), want)
        add(want)
        cache.clear()
    if sorted(total) != sorted(("first_hits", "shade_scatter", "bounce_bwd",
                                "sorted_fold", "traverse", "shadow",
                                "camera")):
        raise AssertionError(f"graph: replays launched {total}")

    # fit on Cornell: compiled against eager, and the compiled resume
    fit_train = ("mat_diffuse", "sph_center", "cam_quaternion")
    fit_check("cornell_fit", flat, cam, cfg, fit_train,
              dict(mat_diffuse=0.05, sph_center=0.02, cam_quaternion=0.002),
              2e-3, call_launches(flat, cfg, SPP, fit_train))
    cache.clear()

    # the tiled render: compiled (a graph a tile shape) against the direct
    # frame, and its walls beside the eager tiled render's
    direct = renderer.render(flat, cam, cfg)
    g = cache.last
    if (g.key[0] != "frame" or g.replays != 0
            or not np.array_equal(renderer.render(flat, cam, cfg), direct)
            or g.replays != 1):
        raise AssertionError("graph: the second render did not replay its "
                             "frame's graph, or differs from the first")

    def tiled():
        return renderer.render(flat, cam, cfg, ckpt_dir=tempfile.mkdtemp())

    def tiled_eager():
        with cache.disabled():
            return tiled()

    n0 = cache.captures
    walls = in_turns(dict(eager=tiled_eager, compiled=tiled), reps)
    reset_launches()
    img = tiled()
    n_tiles = TileManifest(W, H, 128, tempfile.mkdtemp()).n_tiles
    tiled_launches = launched(*KERNEL_MODULES)
    if tiled_launches != {**{k: v * n_tiles for k, v in
                             call_launches(flat, cfg, SPP).items()},
                          "finish": 1}:
        raise AssertionError(f"graph tiled: launches {tiled_launches}")
    if not np.array_equal(img, direct) or cache.captures - n0 != 4:
        raise AssertionError(f"graph tiled: image differs from the direct "
                             f"frame, or {cache.captures - n0} captures")
    say("graph", case="cornell_tiled", tiles=n_tiles, image="bit-equal",
        direct_render="replayed, bit-equal",
        captures=cache.captures - n0, launches=tiled_launches,
        wall_s_eager=spread(walls["eager"]),
        wall_s_compiled=spread(walls["compiled"]))
    for g in cache.graphs():
        say("graph", pool=g.key[0], pixels=g.carry[0].shape[0],
            replays=g.replays, runs=g.runs,
            warmup_s=f"{g.times['warmup_s']:.3f}",
            capture_s=f"{g.times['capture_s']:.3f}",
            instantiate_s=f"{g.times['instantiate_s']:.3f}",
            pool_gb=f"{g.pool_bytes / 1e9:.3f}")
    cache.clear()

    # a body that reads the card fails at its capture, with no fallback
    def reads(p):
        acc = renderer.render_pixels(flat, cam, cfg, W, H, p, 1, 0)
        if float(acc.sum()) < 0.0:
            acc = -acc
        return acc

    reset_launches()
    err = None
    try:
        cache.call(("must_fail",), reads, (pid,))
    except RuntimeError as e:
        err = str(e).strip().splitlines()[0]
    torch.cuda.synchronize()
    one = call_launches(flat, cfg, 1)
    if err is None or ("must_fail",) in cache or launched(
            *KERNEL_MODULES) != one:
        raise AssertionError(f"graph: the reading body was captured "
                             f"({err!r}, launches "
                             f"{launched(*KERNEL_MODULES)})")
    again = renderer.render_frame(flat, cam, cfg, W, H, pid, 1, 0)
    with cache.disabled():
        ref = renderer.render_frame(flat, cam, cfg, W, H, pid, 1, 0)
    if not bit_equal(again, ref):
        raise AssertionError("graph: frames after the failed capture differ")
    say("graph", case="capture_must_fail", raised=f'"{err}"', cached=False,
        launches_warmup_only=one)
    cache.clear()


def orbit_camera(k, n):
    """Camera k of a path of n around the Cornell box: an arc of 40
    degrees at the default camera's distance (6.1), rising 0.1 a camera,
    each looking at the box's centre."""
    a = np.radians(-20.0 + 40.0 * k / max(n - 1, 1))
    pos = (6.1 * np.sin(a), 0.1 * k - 0.35, 6.1 * np.cos(a))
    return dataclasses.replace(
        default_camera(W / H, device=DEV),
        position=torch.tensor(pos, dtype=torch.float32, device=DEV),
        quaternion=look_at_quaternion(pos, (0.0, 0.0, 0.0), device=DEV))


class KeepLeaves:
    """An optimizer that updates nothing: `train.make_step`'s body alone."""

    def zero_grad(self, set_to_none=True):
        pass

    def step(self):
        pass


def frame_calls(label, scene, cfg, calls, pid):
    """Compiled frames against their eager bodies in the same call:
    `calls` is a list of (camera, seed, first sample, spp); each compiled
    call (`renderer.render_frame`, synced wall, launches) is followed by
    its eager body (inside `graphs.CACHE.disabled()`), bit-equal with the
    same launches, which must be the formula's (`call_launches`). Returns
    (compiled walls, eager walls, captures over the compiled calls)."""
    cache = graphs.CACHE
    walls = {"compiled": [], "eager": []}
    captures = 0
    for cam, seed, first, spp in calls:
        outs, counts = [], []
        for route in ("compiled", "eager"):
            with contextlib.ExitStack() as st:
                if route == "eager":
                    st.enter_context(cache.disabled())
                n0 = cache.captures
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(renderer.render_frame(scene, cam, cfg, W, H, pid,
                                                  spp, seed, first))
                torch.cuda.synchronize()
                walls[route].append(time.perf_counter() - t0)
                counts.append(launched(*KERNEL_MODULES))
                captures += cache.captures - n0
        want = call_launches(scene, cfg, spp)
        if not bit_equal(*outs) or counts != [want, want]:
            raise AssertionError(
                f"graph {label}: seed {seed}, first sample {first}, spp "
                f"{spp}: compiled differs from eager, or launches {counts} "
                f"against {want}")
    return walls["compiled"], walls["eager"], captures


def graph_keys_phase(flat_sb, pair_sb, reps=6):
    """The compiled entry points keyed as `jax.jit` keys them, at 850x480,
    6 bounces (`[graph]` lines): the arguments by shape, the seed a device
    scalar, the frame one graph of one sample replayed once a sample.
    Each frame is held bit-equal to its eager body with the formula's
    launches (`frame_calls`). A camera path of 8 cameras around the
    Cornell box at 16 spp takes 1 capture (frames 2-8 replay); then, on
    that graph with 0 captures, seeds 0-2, first samples 0 and 16, spp 1,
    4, 16 and 64; the sample graph's kernels (the profiler's device
    launches of a 16-spp and a 1-spp frame: 15 samples apart), capture,
    instantiation and pool. Then the textured Cornell 16-spp training
    step (tex_data, mat_diffuse; the exact atlas, B3, B4): 2 Adam steps,
    then new leaves on a second `compile_scene` of the same builder with
    a new camera and seed, compiled (1 capture) against eager (losses,
    grad norms and gradients bit-equal, the formula's launches a step);
    8 more calls on new leaves take 0 captures, and the pools then held;
    and the copy-in of the leaves (tex_data's 25 MB, copied at every step
    because Adam writes it in place): the step's wall with the leaves
    written since the last call (copied in) and without (not copied), in
    turns, and the copy alone on CUDA events."""
    t_phase = time.perf_counter()
    cache = graphs.CACHE
    cache.clear()
    flat = compile_scene(flat_sb, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=BOUNCES)
    cams = [orbit_camera(k, 8) for k in range(8)]

    walls, ewalls, captures = frame_calls(
        "camera_path", flat, cfg, [(c, cfg.seed, 0, SPP) for c in cams], pid)
    (g,) = cache.graphs()
    if captures != 1 or g.runs != 8 * SPP - 1:
        raise AssertionError(f"graph camera_path: {captures} captures, "
                             f"{g.runs} runs of the sample graph")
    say("graph", case="camera_path", cameras=8, spp=SPP, captures=captures,
        vs_eager="bit-equal", launches_a_frame=call_launches(flat, cfg, SPP),
        first_frame_s=f"{walls[0]:.4f}",
        warmup_s=f"{g.times['warmup_s']:.3f}",
        capture_s=f"{g.times['capture_s']:.3f}",
        instantiate_s=f"{g.times['instantiate_s']:.3f}",
        wall_s_frames_2_8=spread(sorted(walls[1:])),
        wall_s_eager=spread(sorted(ewalls)),
        pool_gb=f"{g.pool_bytes / 1e9:.3f}")
    for label, calls in (
            ("seed_sweep", [(cams[0], sd, 0, SPP) for sd in (0, 1, 2)]),
            ("first_sample_sweep", [(cams[0], cfg.seed, f, SPP)
                                    for f in (0, 16)]),
            ("spp_sweep", [(cams[0], cfg.seed, 0, n)
                           for n in (1, 4, 16, 64)])):
        walls, ewalls, captures = frame_calls(label, flat, cfg, calls, pid)
        if captures or len(cache) != 1:
            raise AssertionError(f"graph {label}: {captures} captures, "
                                 f"{len(cache)} graphs")
        say("graph", case=label, seed_first_spp=[c[1:] for c in calls],
            captures=0, vs_eager="bit-equal",
            wall_s=[f"{w:.4f}" for w in walls],
            wall_s_eager=[f"{w:.4f}" for w in ewalls])
    n = {}
    for spp in (1, SPP):
        n[spp] = profiled(lambda spp=spp: renderer.render_frame(
            flat, cams[0], cfg, W, H, pid, spp, cfg.seed))
    per_sample = (n[SPP][3] - n[1][3]) / (SPP - 1)
    say("graph", case="sample_body", device_launches_a_frame=n[SPP][3],
        device_launches_1spp=n[1][3], kernels_a_sample=f"{per_sample:.1f}",
        outside_the_samples=f"{n[1][3] - per_sample:.1f}",
        profile_16spp=dict(wall_ms=f"{n[SPP][0]:.1f}",
                           device_busy_ms=f"{n[SPP][1]:.1f}",
                           idle_share=f"{n[SPP][2]:.3f}"),
        capture_s=f"{g.times['capture_s']:.3f}",
        instantiate_s=f"{g.times['instantiate_s']:.3f}",
        pool_gb=f"{g.pool_bytes / 1e9:.3f}", runs=g.runs, replays=g.replays)
    cache.clear()

    # the textured training step on new leaves and a scene compiled again
    trainable = ("tex_data", "mat_diffuse")
    tcfg = T.guard_config(cfg, trainable)
    pair_a = compile_scene(pair_sb, device=DEV)
    pair_b = compile_scene(pair_sb, device=DEV)   # the same builder again
    target = torch.zeros((W * H, 3), dtype=torch.float32, device=DEV)
    want = call_launches(pair_a, tcfg, SPP, trainable)
    runs = {}
    for route in ("compiled", "eager"):
        with contextlib.ExitStack() as st:
            if route == "eager":
                st.enter_context(cache.disabled())
            n0 = cache.captures
            out, counts, swalls = [], [], []
            for scene, cam, seeds in ((pair_a, cams[0], (0, 1)),
                                      (pair_b, cams[1], (5,))):
                params = T.split_params(scene, cam, trainable)
                leaves = [params[k] for k in sorted(params)]
                step = T.make_step(T._adam_default(1e-2)(leaves), tcfg,
                                   target, W, H, SPP)
                for seed in seeds:
                    reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss, gnorm = step(params, scene, cam, pid, seed)
                    torch.cuda.synchronize()
                    swalls.append(time.perf_counter() - t0)
                    counts.append(launched(*KERNEL_MODULES))
                    out.append([loss, gnorm] + [p.grad.clone()
                                                for p in leaves])
            runs[route] = (out, counts, swalls, cache.captures - n0)
    (oc, cc, wc, capc), (oe, ce, we, cape) = runs["compiled"], runs["eager"]
    if (capc, cape) != (1, 0) or any(c != want for c in cc + ce) or not all(
            all(bit_equal(x, y) for x, y in zip(a, b))
            for a, b in zip(oc, oe)):
        raise AssertionError(f"graph same_shape_step: captures {capc} / "
                             f"{cape}, launches {cc} / {ce} against {want}, "
                             f"or compiled differs from eager")
    (g,) = cache.graphs()
    n0 = cache.captures
    for i in range(8):   # 8 more calls, each on new leaves
        scene = (pair_a, pair_b)[i % 2]
        params = T.split_params(scene, cams[i], trainable)
        T.make_step(KeepLeaves(), tcfg, target, W, H, SPP)(
            params, scene, cams[i], pid, i)
    torch.cuda.synchronize()
    if cache.captures != n0 or len(cache) != 1:
        raise AssertionError(f"graph same_shape_step: {cache.captures - n0} "
                             f"captures in 8 calls on new leaves")
    held = sum(x.pool_bytes for x in cache.graphs())
    # the copy-in: leaves written since the last call are copied, others
    # not; the step's wall either way, in turns
    params = T.split_params(pair_a, cams[0], trainable)
    step = T.make_step(KeepLeaves(), tcfg, target, W, H, SPP)

    def no_copy():
        step(params, pair_a, cams[0], pid, 0)

    def copy_in():
        with torch.no_grad():   # written in place, as Adam writes them
            for p in params.values():
                p.add_(0.0)
        step(params, pair_a, cams[0], pid, 0)

    no_copy()
    turns = in_turns(dict(copy_in=copy_in, no_copy=no_copy), reps)
    bufs = [torch.empty_like(p) for p in params.values()]
    copy_ms = timed(lambda: [b.copy_(p.detach()) for b, p in
                             zip(bufs, params.values())], 20)
    nbytes_leaves = sum(p.numel() * p.element_size()
                        for p in params.values())
    say("graph", case="same_shape_step", scene="cornell_textured",
        trainable="+".join(trainable), spp=SPP,
        calls="2 Adam steps, new leaves on a second compile_scene with a "
              "new camera and seed",
        captures=capc, vs_eager="bit-equal", launches_a_step=want,
        step_s_compiled=[f"{w:.4f}" for w in wc],
        step_s_eager=[f"{w:.4f}" for w in we],
        capture_s=f"{g.times['capture_s']:.3f}",
        instantiate_s=f"{g.times['instantiate_s']:.3f}",
        new_leaves_calls=8, captures_after=cache.captures - n0,
        graphs_held=len(cache), pools_held_gb=f"{held / 1e9:.3f}",
        parent_rule_pools_gb=f"{8 * g.pool_bytes / 1e9:.3f}",
        reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.3f}",
        wall_s_copy_in=spread(turns["copy_in"]),
        wall_s_no_copy=spread(turns["no_copy"]),
        leaves_mb=f"{nbytes_leaves / 1e6:.1f}", copy_ms=f"{copy_ms:.4f}",
        copy_bound_ms=f"{bound_ms(2 * nbytes_leaves):.4f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    cache.clear()


def graph_general_phase(flat_sb, rtw_sb, flam_sb, reps=3):
    """The compiled routes beyond the Cornell family against their eager
    bodies, in the same call, at 850x480, 6 bounces (`[graph]` lines,
    `graph_check`): the 16-spp protocol step (`bench.protocol_step`) on
    the general backward, rt_weekend_standin (mat_diffuse, sph_center,
    tex_data: B1, B2, B6, B4 and the row sums in the graph) and
    flamingo_standin (mesh_verts, mat_diffuse, sph_center: B5 too); the
    plain autodiff step (custom_vjp="off": B1, B5, B6 for the selections,
    the bounces under `torch.utils.checkpoint`, the row sums) on Cornell
    at 16 spp and flamingo_standin at 4 spp; 4 `fit` steps on
    rt_weekend_standin at 4 spp and their resume (`fit_check`); the
    `benchmark --occupancy` frame (`cli.occupancy_frame`) on Cornell.
    Each: bit-equal outputs, a replay's launches equal to the eager
    call's, 0 host syncs in a replay, the walls of `reps` calls in turns,
    the compiled call's idle share under the profiler (the eager general
    step's is `profile_phase`'s line), capture, instantiate seconds and
    pool. Each replay's launches are also held against the formula
    (`general_launches`, `call_launches`). Returns the launches of a
    replay of the rt_weekend_standin 16-spp general step (the counts reset
    just before it): the kernels line's row-sum count."""
    from tracer_torch import bench
    cache = graphs.CACHE
    cache.clear()
    cam = default_camera(W / H, device=DEV)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=BOUNCES)
    flat = compile_scene(flat_sb, device=DEV)
    rtw = compile_scene(rtw_sb, device=DEV)
    flam = compile_scene(flam_sb, device=DEV)
    rtw_train = ("mat_diffuse", "sph_center", "tex_data")
    flam_train = ("mesh_verts", "mat_diffuse", "sph_center")
    plain = dataclasses.replace(cfg, custom_vjp="off")
    replays = {}
    for label, scene, c, spp, trainable in (
            ("rt_weekend_standin_general", rtw, cfg, SPP, rtw_train),
            ("flamingo_standin_general", flam, cfg, SPP, flam_train),
            ("cornell_plain_ad", flat, plain, SPP,
             ("mat_diffuse", "sph_center")),
            ("flamingo_standin_plain_ad", flam, plain, 4, flam_train)):
        b = bench.Inputs(scene, cam, c, W, H, pid, spp)
        if replay_bwd.hand_bwd_ok(scene, c) and c.custom_vjp == "on":
            raise AssertionError(f"graph {label}: inside the hand-written "
                                 f"class")
        _, _, replays[label] = graph_check(
            f"{label}_protocol_step",
            lambda b=b, t=trainable: bench.protocol_step(b, t),
            lambda b=b, t=trainable: bench.protocol_step(b, t),
            general_launches(scene, c, spp, trainable), reps=reps,
            profile="compiled", spp=spp, custom_vjp=c.custom_vjp,
            trainable="+".join(trainable))
        cache.clear()
    c4 = dataclasses.replace(cfg, nsamples=4)
    fit_check("rt_weekend_standin_fit", rtw, cam, c4, rtw_train,
              dict(mat_diffuse=0.05, sph_center=0.02, tex_data=0.05), 1e-2,
              general_launches(rtw, T.guard_config(c4, rtw_train), 4,
                               rtw_train))
    cache.clear()
    # the occupancy frame: the rays and tables made once, as the CLI does
    # (so its graph runs no camera kernel)
    rays = cli.benchmark_rays(cam, cfg, W, H, pid)
    tables = integrator.prepare(flat)
    want = call_launches(flat, cfg, 1)
    del want["camera"]
    graph_check("cornell_occupancy_frame",
                lambda: cli.occupancy_frame(flat, cfg, *rays, tables),
                lambda: cli.occupancy_frame(flat, cfg, *rays, tables),
                want, reps=reps, profile="both")
    cache.clear()
    return replays["rt_weekend_standin_general"]


# ---------------------------------------------------------------------------
# Distribution (tracer_torch/dist/) and the plain autodiff backward
# ---------------------------------------------------------------------------

def walls_of(fn, reps):
    """(result of the last call, sorted walls of `reps` calls after one
    warm-up call, each ending in a synchronise, launches of the first)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for r in range(reps):
        if r == 0:
            reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r == 0:
            launches = launch_counts(*KERNEL_MODULES)
    return out, sorted(walls), {k: v for k, v in launches.items() if v}


def spread(walls):
    return dict(median=f"{walls[len(walls) // 2]:.4f}",
                min=f"{walls[0]:.4f}", max=f"{walls[-1]:.4f}")


STEP_FIELDS = ("sph_center", "sph_radius", "mat_diffuse")
# sharding.train_step's trainables
STEP_TRAINABLE = ["sph_center", "sph_radius", "mat_diffuse", "tex_data",
                  "mesh_verts", "cam_position"]


def step_result(loss, s1, c1):
    return dict(loss=float(loss), cam_position=c1.position.cpu().numpy(),
                **{k: getattr(s1, k).cpu().numpy() for k in STEP_FIELDS})


@eager_route
def step_grads(scene, cam, cfg, pid, target, spp, mesh):
    """(grad norm, {leaf: gradient}) of `train_step`'s step on `mesh`:
    `train.make_step`, the step it delegates to, with its trainables and
    SGD, run once and eagerly (a graph of new leaves would never replay);
    the gradients as the update reads them, after the mesh's reduction (a
    leaf without one: zeros)."""
    params = T.split_params(scene, cam, STEP_TRAINABLE)
    opt = torch.optim.SGD([params[k] for k in sorted(params)], lr=1e-2)
    step = T.make_step(opt, T.guard_config(cfg, STEP_TRAINABLE), target, W,
                       H, spp, mesh)
    _, gnorm = step(params, scene, cam, pid, 0)
    return float(gnorm), {
        k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.cpu().numpy()) for k, p in params.items()}


def sharded_graphs(scene, cam, cfg, pid, target, spp, mesh, reps, blk):
    """This rank's compiled sharded frame and step against the eager
    ones: the frame (`render_pixels_sharded` without grad) `reps` times
    after its first call, bit-equal to `blk` (the eager frame); a kept
    `make_step(mesh=)` (SGD on `train_step`'s trainables) compiled and
    eager, `reps` + 2 steps each from the same start, every step's loss
    and the final params bit-equal, a replay's launches equal to the
    eager step's; the host syncs of a compiled frame and step, and the
    captures (one a route where the mesh's collectives are NCCL's, none
    on gloo, which stays eager by the rule)."""
    cache = graphs.CACHE
    n0 = cache.captures
    frame = torch.no_grad()(lambda: sharding_frame(scene, cam, cfg, pid,
                                                   spp, mesh))
    got, fwalls, flaunch = walls_of(frame, reps)
    if not bit_equal(got, blk):
        raise AssertionError(f"graph sharded {dict(mesh.shape)}: the "
                             f"compiled frame differs from the eager one")
    fsyncs, _ = host_syncs(frame)
    runs = {}
    for name in ("eager", "compiled"):
        params = T.split_params(scene, cam, STEP_TRAINABLE)
        opt = torch.optim.SGD([params[k] for k in sorted(params)], lr=1e-2)
        fn = T.make_step(opt, T.guard_config(cfg, STEP_TRAINABLE), target,
                         W, H, spp, mesh)
        losses = []

        def call(fn=fn, params=params, losses=losses):
            loss, _ = fn(params, scene, cam, pid, 0)
            losses.append(loss)
            return loss

        with contextlib.ExitStack() as st:
            if name == "eager":
                st.enter_context(cache.disabled())
            _, walls, launches = walls_of(call, reps)
            syncs, _ = host_syncs(call)
        runs[name] = (torch.stack(losses), params, walls, launches, syncs)
    (le, pe, _, ne, _), (lc, pc, swalls, nc, ssyncs) = (runs["eager"],
                                                         runs["compiled"])
    if not (bit_equal(le, lc) and ne == nc and all(
            bit_equal(pe[k].detach(), pc[k].detach()) for k in pe)):
        raise AssertionError(f"graph sharded {dict(mesh.shape)}: the "
                             f"compiled steps differ from the eager ones "
                             f"(launches {nc} against {ne})")
    graphed = mesh.capturable
    captures = cache.captures - n0
    if captures != (2 if graphed else 0) or (graphed and (fsyncs
                                                          or ssyncs)):
        raise AssertionError(f"graph sharded {dict(mesh.shape)}: "
                             f"{captures} captures, host syncs {fsyncs} / "
                             f"{ssyncs}")
    cache.clear()
    return dict(graphed=graphed, captures=captures, frame_walls=fwalls,
                frame_launches=flaunch, frame_syncs=fsyncs,
                step_walls=swalls, step_launches=nc, step_syncs=ssyncs,
                step_walls_eager=runs["eager"][2])


def sharding_frame(scene, cam, cfg, pid, spp, mesh):
    from tracer_torch.dist import sharding
    return sharding.render_pixels_sharded(scene, cam, cfg, W, H, pid, spp,
                                          cfg.seed, mesh)


def dist_rank(shapes, spp, reps, pod):
    """One rank of a multi-rank phase: for each mesh shape, the sharded
    16-spp Cornell frame (`render_pixels_sharded`) and `train_step`, each
    `reps` times after a warm-up, eagerly (`graphs.CACHE.disabled()`;
    `train_step` is eager anyway): walls, this rank's launches, the
    bytes its collectives send (`sharding.collective_spans`), rank 0's
    gathered film, the step's result, and its gradients and grad norm
    (`step_grads`); then the compiled frame and step against the eager
    ones (`sharded_graphs`); with `pod`, rank 0's `render_image_multihost`
    frame on the host-major mesh (`make_pod_mesh()`)."""
    import torch.distributed as dist

    from tracer_torch.dist import multihost, sharding

    dev = torch.device("cuda", torch.cuda.current_device())   # this rank's
    scene = compile_scene(zoo.setup_cornell_box(W / H), device=dev)
    cam = default_camera(W / H, device=dev)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    pid = torch.arange(W * H, dtype=torch.int32, device=dev)
    target = torch.zeros((W * H, 3), dtype=torch.float32)
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(),
               card=dev.index)
    for shape in shapes:
        mesh = sharding.make_ray_mesh(*shape)
        spans = []

        @torch.no_grad()
        def frame():
            with graphs.CACHE.disabled(), \
                    sharding.collective_spans() as s:
                blk = sharding_frame(scene, cam, cfg, pid, spp, mesh)
            spans[:] = s
            return blk

        def step():
            with sharding.collective_spans() as s:
                res = sharding.train_step(scene, cam, cfg, W, H, pid,
                                          target, spp, 0, mesh)
            spans[:] = s
            return res

        blk, fwalls, flaunch = walls_of(frame, reps)
        fcoll = sum(b for _, b in spans)
        film = multihost.gather_film(blk, mesh).cpu().numpy()
        res, swalls, slaunch = walls_of(step, reps)
        out[shape] = dict(
            coord=(mesh.dp_rank, mesh.sp_rank), frame_walls=fwalls,
            frame_launches=flaunch, frame_coll_bytes=fcoll,
            step_walls=swalls, step_launches=slaunch,
            step_coll_bytes=sum(b for _, b in spans),
            step=step_result(*res),
            grads=step_grads(scene, cam, cfg, pid, target, spp, mesh),
            film=film if dist.get_rank() == 0 else None,
            compiled=sharded_graphs(scene, cam, cfg, pid, target, spp,
                                    mesh, reps, blk))
    if pod:
        pmesh = multihost.make_pod_mesh()
        img = multihost.render_image_multihost(scene, cam, cfg, pmesh)
        graphs.CACHE.clear()
        out["pod"] = dict(shape=dict(pmesh.shape),
                          img=img if dist.get_rank() == 0 else None)
    return out


def dist_world1_phase(sb, spp):
    """(a) A process group of one rank over NCCL at full width: the
    (1, 1) mesh's sharded frame compiled (a graph of the render; a
    `[graph]` line against its eager body) and equal to `render_pixels /
    spp` bit for bit; `fit(mesh=)` for 4 steps compiled (the graph holds
    the render, the loss, the backward and the all-reduce of the
    gradients) against eager, its resume and the unsharded `fit()`, bit
    for bit (`fit_check`), on the trainables of the Cornell training
    cell."""
    import torch.distributed as dist

    from tracer_torch.dist import launch, multihost, sharding

    multihost.initialize(f"localhost:{launch.free_port()}", 1, 0,
                         device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = sharding.make_ray_mesh(1, 1)
        scene = compile_scene(sb, device=DEV)
        cam = default_camera(W / H, device=DEV)
        cfg = RenderConfig(nsamples=spp, width=W, height=H,
                           max_bounces=BOUNCES)
        pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
        frame = torch.no_grad()(lambda: sharding_frame(scene, cam, cfg, pid,
                                                       spp, mesh))
        graph_check("nccl_world1_sharded_frame", frame, frame,
                    call_launches(scene, cfg, spp), reps=3,
                    profile="compiled", mesh="1x1", backend="nccl")
        with torch.no_grad():
            want = renderer.render_pixels(scene, cam, cfg, W, H, pid, spp,
                                          cfg.seed) / spp
        if not bit_equal(frame(), want):
            raise AssertionError("dist (1, 1): render differs from "
                                 "render_pixels / spp")
        graphs.CACHE.clear()
        fit_train = ("mat_diffuse", "sph_center", "cam_quaternion")
        fit_check("nccl_world1_fit_mesh", scene, cam, cfg, fit_train,
                  dict(mat_diffuse=0.05, sph_center=0.02,
                       cam_quaternion=0.002), 2e-3,
                  call_launches(scene, cfg, spp, fit_train), mesh=mesh)
        say("dist_world1", backend="nccl", mesh="1x1", size=f"{W}x{H}",
            spp=spp, bounces=BOUNCES, frame_vs_render_pixels="bit-equal",
            fit_vs_fit="bit-equal")
    finally:
        multihost.shutdown()


def dist_ranks_phase(sb, spp, n, backend, shapes, local_world_size,
                     pod_shape, reps=3):
    """(b) and (d): n ranks (gloo sharing the one card, or NCCL with a
    card each) on each (n_dp, n_sp) of `shapes`: the gathered 16-spp
    Cornell frame against the unsharded render (bit-equal where sp is 1,
    else within 1e-5), `train_step`'s loss and params within rtol 1e-4 of
    the unsharded step's, its gradients (rtol 1e-4, atol 1e-5 * the
    leaf's largest) and grad norm (rtol 1e-4) against the unsharded
    step's (a gradient scaled by n_sp, or missing a block, fails), each
    rank's launches, walls (median and spread) and seconds in
    collectives, beside the unsharded frame and step walls; then
    `render_image_multihost` on `make_pod_mesh()` (LOCAL_WORLD_SIZE
    `local_world_size`, or unset: the card count) against `render`,
    bit-equal where its sp is 1, else within 1e-5 once the gamma is
    undone (image ** 2.2). Each rank's compiled frame and step against its
    eager ones (`sharded_graphs`, a `[graph]` line a rank: NCCL ranks
    replay graphs, gloo ranks stay eager by the rule). The kernel library
    is built (`main`) before the ranks start."""
    from tracer_torch.dist import launch, sharding

    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    pid = torch.arange(W * H, dtype=torch.int32, device=DEV)
    target = torch.zeros((W * H, 3))
    one = sharding.make_ray_mesh(1, 1)
    film, fwalls, _ = walls_of(torch.no_grad()(
        lambda: renderer.render_pixels(scene, cam, cfg, W, H, pid, spp,
                                       cfg.seed) / spp), reps)
    film = film.cpu().numpy()
    res, swalls, slaunch = walls_of(lambda: sharding.train_step(
        scene, cam, cfg, W, H, pid, target, spp, 0, one), reps)
    want_step = step_result(*res)
    want_gnorm, want_grads = step_grads(scene, cam, cfg, pid, target, spp,
                                        one)
    image = renderer.render(scene, cam, cfg)
    say("dist_unsharded", size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        frame_s=spread(fwalls), step_s=spread(swalls),
        step_launches=slaunch, grad_norm=f"{want_gnorm:.6g}")
    t0 = time.perf_counter()
    ranks = launch.run(dist_rank, n, (shapes, spp, reps, True),
                       device="cuda", backend=backend,
                       local_world_size=local_world_size)
    group_s = time.perf_counter() - t0
    # a rank takes card rank % count: gloo's two ranks share the one card
    # of the driver's machine, and take two of a machine with more
    cards = len({r["card"] for r in ranks})
    variant = f"{backend}-{cards}-card" + "s" * (cards > 1)
    for shape in shapes:
        err = float(np.abs(ranks[0][shape]["film"] - film).max())
        if err > (0.0 if shape[1] == 1 else 1e-5):
            raise AssertionError(f"dist {shape}: film err {err}")
        step_err = grad_rel = 0.0
        for r in ranks:
            got = r[shape]["step"]
            for k, w in want_step.items():
                if not np.allclose(got[k], w, rtol=1e-4, atol=1e-7):
                    raise AssertionError(f"dist {shape} rank {r['rank']}: "
                                         f"step {k} differs")
                step_err = max(step_err, float(np.max(np.abs(
                    np.asarray(got[k]) - w))))
            gnorm, grads = r[shape]["grads"]
            if abs(gnorm - want_gnorm) > 1e-4 * want_gnorm:
                raise AssertionError(f"dist {shape} rank {r['rank']}: grad "
                                     f"norm {gnorm} vs {want_gnorm}")
            for k, w in want_grads.items():
                scale = float(np.abs(w).max()) if w.size else 0.0
                if not np.allclose(grads[k], w, rtol=1e-4,
                                   atol=1e-5 * scale):
                    raise AssertionError(f"dist {shape} rank {r['rank']}: "
                                         f"gradient of {k} differs")
                if scale > 0:
                    grad_rel = max(grad_rel, float(
                        np.abs(grads[k] - w).max()) / scale)
        for r in ranks:
            x = r[shape]
            say("dist", variant=variant, backend=r["backend"],
                mesh=f"{shape[0]}x{shape[1]}", rank=r["rank"],
                card=r["card"], coord=x["coord"],
                frame_s=spread(x["frame_walls"]),
                frame_launches=x["frame_launches"],
                frame_collective_bytes=x["frame_coll_bytes"],
                step_s=spread(x["step_walls"]),
                step_launches=x["step_launches"],
                step_collective_bytes=x["step_coll_bytes"])
            c = x["compiled"]
            say("graph", case="sharded", variant=variant,
                mesh=f"{shape[0]}x{shape[1]}", rank=r["rank"],
                graphed=c["graphed"], captures=c["captures"],
                frame_vs_eager="bit-equal", steps_vs_eager="bit-equal",
                launches_a_step=c["step_launches"],
                host_syncs_frame=c["frame_syncs"],
                host_syncs_step=c["step_syncs"],
                frame_s_compiled=spread(c["frame_walls"]),
                frame_s_eager=spread(x["frame_walls"]),
                step_s_compiled=spread(c["step_walls"]),
                step_s_eager=spread(c["step_walls_eager"]))
        say("dist_check", variant=variant, mesh=f"{shape[0]}x{shape[1]}",
            film_max_abs_err=f"{err:.3g}",
            step_max_abs_err=f"{step_err:.3g}",
            grad_max_err_of_leaf_max=f"{grad_rel:.3g}")
    pod = ranks[0]["pod"]
    if pod_shape["sp"] == 1:
        pod_err, tol = float(np.abs(pod["img"] - image).max()), 0.0
    else:   # the sample sums' order differs: held on the linear scale
        pod_err, tol = float(np.abs(pod["img"] ** 2.2
                                    - image ** 2.2).max()), 1e-5
    if pod["shape"] != pod_shape or pod_err > tol:
        raise AssertionError(f"dist pod {pod['shape']}: "
                             f"render_image_multihost err {pod_err}")
    say("dist_pod", variant=variant, mesh=pod["shape"],
        render_image_multihost_max_abs_err=f"{pod_err:.3g}",
        group_s=f"{group_s:.2f}")


def readme_recipe_phase(n):
    """README's n-card recipe, as written there: n shell-started
    processes, one a card, joined by JAX_COORDINATOR / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID / LOCAL_RANK / LOCAL_WORLD_SIZE, each running one rank
    of the dry-run step (`python -m tracer_torch.dist.dryrun`). Every
    process is waited for, or killed."""
    from tracer_torch.dist import launch

    port = launch.free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tracer_torch.dist.dryrun"],
        env=dict(os.environ, JAX_COORDINATOR=f"localhost:{port}",
                 JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("README recipe failed:\n" + "\n".join(outs))
    lines = [o.strip().splitlines()[-1] for o in outs]
    losses = {ln.split("loss=")[1].split()[0] for ln in lines}
    if len(losses) != 1:
        raise AssertionError(f"README recipe: the ranks differ: {lines}")
    say("readme_recipe", ranks=n, loss=losses.pop(),
        seconds=f"{time.perf_counter() - t0:.2f}")


def dist_phases(sb):
    """(a) world size 1 over NCCL, (b) two ranks on the one card over
    gloo, (c) the dry-run twin on two ranks, (d) with two cards, (b) over
    NCCL; with four, also four NCCL ranks on (2, 2) and (4, 1), the pod
    mesh from the card count, `dryrun_multichip(4)` and README's
    four-card recipe."""
    from tracer_torch.dist.dryrun import dryrun_multichip

    cards = torch.cuda.device_count()
    dist_world1_phase(sb, SPP)
    dist_ranks_phase(sb, SPP, 2, "gloo", [(2, 1), (1, 2)], 1,
                     {"dp": 2, "sp": 1})
    t0 = time.perf_counter()
    res = dryrun_multichip(2, device="cuda")
    say("dryrun", n=2, mesh=res["mesh"], loss=f"{res['loss']:.6g}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    if cards < 2:
        say("dist", variant="nccl-2-cards", ran=False, cards=cards)
        return
    dist_ranks_phase(sb, SPP, 2, "nccl", [(2, 1), (1, 2)], 1,
                     {"dp": 2, "sp": 1})
    if cards < 4:
        return
    dist_ranks_phase(sb, SPP, 4, "nccl", [(2, 2), (4, 1)], None,
                     {"dp": 1, "sp": 4})
    t0 = time.perf_counter()
    res = dryrun_multichip(4, device="cuda")
    say("dryrun", n=4, mesh=res["mesh"], loss=f"{res['loss']:.6g}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    readme_recipe_phase(4)


@eager_route
def plain_ad_phase(label, sb, spp, trainable, reps=3):
    """(e) The protocol step on the plain autodiff backward
    (custom_vjp="off": the general bounce under autograd, each bounce but
    the last rematerialized, the kernels giving only the selections):
    wall (median of `reps` after a warm-up, and the spread), peak memory,
    launches (B1, B5, B6 once a bounce, the row sums one a gathered table
    a bounce; no B2, B3 or B4), whether every rep's gradients have the
    same bits (`deterministic`), and the 1-spp gradients against the
    plain path (kernels="off") and against custom_vjp="on", within
    GRAD_RTOL."""
    scene = compile_scene(sb, device=DEV)
    cam = default_camera(W / H, device=DEV)
    cfg = RenderConfig(max_bounces=BOUNCES, custom_vjp="off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []

    def step():
        out = protocol_grads(scene, cam, cfg, spp, trainable)
        runs.append(out[1])
        return out

    (loss, grads), walls, launches = walls_of(step, reps)
    peak = torch.cuda.max_memory_allocated()
    deterministic = all(grads_equal(runs[0], x) for x in runs[1:])
    if not deterministic:
        raise AssertionError(f"plain_ad {label}: two backward passes gave "
                             f"different gradients")
    expect = general_launches(scene, cfg, spp, trainable)
    if launches != expect:
        raise AssertionError(f"plain_ad {label}: launches {launches}, "
                             f"expected {expect}")
    for k, gr in grads.items():
        if not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"plain_ad {label}: {k} grad not finite")
    if float(grads["mat_diffuse"].abs().max()) == 0.0:
        raise AssertionError(f"plain_ad {label}: mat_diffuse grad is zero")
    _, gk = protocol_grads(scene, cam, cfg, 1, trainable)
    rel = {}
    for ref, c in (("plain", dict(kernels="off")), ("on", dict(
            custom_vjp="on"))):
        _, gp = protocol_grads(scene, cam, dataclasses.replace(cfg, **c), 1,
                               trainable)
        for k in trainable:
            scale = float(gp[k].abs().max())
            diff = float((gk[k] - gp[k]).abs().max())
            rel[f"{k}_vs_{ref}"] = diff / scale if scale > 0 else diff
    for k, v in rel.items():
        if v > GRAD_RTOL:
            raise AssertionError(f"plain_ad {label}: 1-spp grad {k} rel err "
                                 f"{v:.3g} > {GRAD_RTOL}")
    say("plain_ad", scene=label, size=f"{W}x{H}", spp=spp, bounces=BOUNCES,
        trainable="+".join(trainable), loss=f"{float(loss):.6g}",
        step_s=spread(walls), reps=reps, deterministic=deterministic,
        peak_mem_gb=f"{peak / 1e9:.3f}",
        launches=launches,
        grad_rel_err_1spp={k: f"{v:.3g}" for k, v in rel.items()})


# ---------------------------------------------------------------------------
# The rays/s benchmark (tracer_torch/bench.py)
# ---------------------------------------------------------------------------

# bench.py:129-139, the keys of its JSON line
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "total_rays_per_s",
              "fwdbwd_primary_rays_per_s", "fwdbwd_no_texgrad_rays_per_s",
              "config", "device")


def host_syncs(fn):
    """(count, {file:line: count}) of the host synchronisations one call of
    `fn` makes, from torch's sync debug mode (a warning each, attributed
    to the Python line that made it)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if "called a synchronizing" in str(w.message):
            k = f"{os.path.relpath(w.filename)}:{w.lineno}"
            where[k] = where.get(k, 0) + 1
    return sum(where.values()), where




def bench_phase(reps=3):
    """`tracer_torch.bench.main()` at its full size (850x480, 16 spp, 6
    bounces, 3 reps) with BENCH_SCENES=1, its launch counts reset just
    before and read just after, its JSON on a `[bench]` line; then, beside
    it, the timed bodies one call at a time: the walls of `reps` synced
    calls (median, spread) of the frame and both steps with the launches
    of one call, the host synchronisations of one frame and one step,
    the peak memory of one step and of `reps` steps queued as the bench
    queues them, and the frame scalar at 1 spp against kernels="off"."""
    from tracer_torch import bench
    env = dict(BENCH_WIDTH=str(W), BENCH_HEIGHT=str(H), BENCH_SPP=str(SPP),
               BENCH_REPS=str(reps), BENCH_SCENES="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = bench.main()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = launched(*KERNEL_MODULES)
    peak_main = torch.cuda.max_memory_allocated()
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != ret:
        raise AssertionError(f"bench: printed {lines!r}")
    if sorted(ret) != sorted(BENCH_KEYS + ("per_scene_fwd_rays_per_s",)):
        raise AssertionError(f"bench: keys {sorted(ret)}")
    if list(ret["per_scene_fwd_rays_per_s"]) != list(bench.SCENES):
        raise AssertionError(f"bench: scenes {ret['per_scene_fwd_rays_per_s']}")
    rates = [ret[k] for k in ("value", "total_rays_per_s",
                              "fwdbwd_primary_rays_per_s",
                              "fwdbwd_no_texgrad_rays_per_s")]
    rates += list(ret["per_scene_fwd_rays_per_s"].values())
    if not all(np.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"bench: rates {rates}")
    if ret["config"] != f"{W}x{H}@{SPP}spp b{BOUNCES}":
        raise AssertionError(f"bench: config {ret['config']}")

    # what main ran: the Cornell frame, then both steps, 1 + reps calls
    # each, then each scene's 1-spp frame, 1 + reps calls
    b = bench.inputs(zoo.setup_cornell_box(W / H), W, H, SPP, DEV)
    calls = 1 + reps
    expect = {}

    def add(counts, times):
        for k, v in counts.items():
            expect[k] = expect.get(k, 0) + v * times

    frame_n = call_launches(b.scene, b.cfg, SPP)
    step_n = call_launches(b.scene, b.cfg, SPP, bench.TRAINABLE)
    step_nt = call_launches(b.scene, b.cfg, SPP, bench.NO_TEXGRAD)
    add(frame_n, calls)
    add(step_n, calls)
    add(step_nt, calls)
    scene_n = {}
    for name in bench.SCENES:
        s = bench.inputs(zoo.BY_NAME[name](), W, H, 1, DEV, camera=b.camera)
        scene_n[name] = call_launches(s.scene, s.cfg, 1)
        add(scene_n[name], calls)
    if launches != expect:
        raise AssertionError(f"bench: launches {launches}, expected "
                             f"{expect}")
    say("bench", wall_s=f"{wall:.3f}", launches=launches,
        peak_mem_gb=f"{peak_main / 1e9:.3f}",
        per_scene_launches_a_frame=scene_n)
    say("bench", json=lines[0])

    # the timed bodies one call at a time
    for label, fn, want in (
            ("frame", lambda: bench.frame_scalar(b), frame_n),
            ("fwdbwd", lambda: bench.grad_sum(b), step_n),
            ("fwdbwd_no_texgrad",
             lambda: bench.grad_sum(b, bench.NO_TEXGRAD), step_nt)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        v, walls, got = walls_of(lambda: float(fn()), reps)
        peak = torch.cuda.max_memory_allocated()
        if got != want:
            raise AssertionError(f"bench {label}: launches {got}, "
                                 f"expected {want}")
        if not np.isfinite(v):
            raise AssertionError(f"bench {label}: scalar {v}")
        n_sync, msgs = host_syncs(fn)
        kv = {}
        if label != "frame":
            # reps steps queued as timeit queues them: each step's graph
            # is freed by backward() before the next is queued
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bench.timeit(fn, reps)
            kv["peak_mem_queued_gb"] = (
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        say("bench", body=label, scalar=f"{v:.9g}", wall_s=spread(walls),
            reps=reps,
            primary_rays_per_s_median=f"{W * H * SPP / walls[reps // 2]:.0f}",
            launches=got, host_syncs=n_sync, sync_at=msgs,
            peak_mem_gb=f"{peak / 1e9:.3f}", **kv)

    b1 = b._replace(spp=1)
    got = float(bench.frame_scalar(b1))
    want = float(bench.frame_scalar(
        b1._replace(cfg=dataclasses.replace(b1.cfg, kernels="off"))))
    err = abs(got - want)
    check("bench 1-spp frame scalar", 0, err)
    say("bench", check="frame_scalar_1spp_vs_plain", kernels=f"{got:.9g}",
        plain=f"{want:.9g}", abs_err=f"{err:.3g}", tol=ATOL)


# ---------------------------------------------------------------------------
# The multi-host weak-scaling harness (tracer_torch/bench_multihost.py)
# ---------------------------------------------------------------------------

def key_tree(d):
    """The keys of a JSON object and of the objects in it."""
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def multihost_phase():
    """`tracer_torch.bench_multihost.driver()` as `python -m
    tracer_torch.bench_multihost` runs it: the 1-host, 2-host and indep
    groups (gloo ranks sharing the card, one rank a host, on one card;
    NCCL at 2 ranks a host, one card a rank, on four). The driver prints
    its JSON on a line of its own; its keys, and those of the objects in
    it, must be MULTIHOST_SCALING.json's, and every rate positive."""
    from tracer_torch import bench_multihost

    t0 = time.perf_counter()
    res = bench_multihost.driver()
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "MULTIHOST_SCALING.json")
    with open(ref_path) as f:
        ref = json.load(f)
    if key_tree(res) != key_tree(ref):
        raise AssertionError(f"multihost: keys {key_tree(res)}, expected "
                             f"{key_tree(ref)}")
    rates = [res[k]["rays_per_s"] for k in ("one_host", "two_host",
                                            "indep_two_proc")]
    if not (all(r > 0 for r in rates) and res["value"] > 0):
        raise AssertionError(f"multihost: rates {rates}, value "
                             f"{res['value']}")
    say("multihost", efficiency=res["value"],
        indep_efficiency=res["rig_gap_decomposition"][
            "indep_2proc_efficiency"],
        backend=f'"{res["backend"]}"',
        seconds=f"{time.perf_counter() - t0:.1f}")


def ptxas_report(info):
    """{kernel: "N registers, S B stack, spills"} from nvcc's -Xptxas -v
    report: each 'Compiling entry function' line names the kernel that the
    next 'Used ... registers' line and spill line describe."""
    out, name = {}, None
    for ln in info.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            for key in ("first_hits_kernel", "shade_scatter_kernel",
                        "bounce_bwd_kernel", "bounce_bwd_reduce",
                        "traverse_roots", "traverse_walk", "shadow_setup",
                        "shadow_walk", "fold_", "rs_"):
                if key in name:
                    variant = ("<shared>" if "ILb1E" in name else "<L2>"
                               if "ILb0E" in name else "")
                    name = key + variant
                    break
        elif name and "bytes stack frame" in ln:
            out[name] = ln.split(":")[-1].strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out[name] = f"{regs}; {out.get(name, '')}"
    return out


def main(dist_only=False, bench_only=False, graph_only=False):
    t_start = time.perf_counter()
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
    say("build", seconds=f"{build_s:.2f}",
        nvcc_seconds=_build.BUILD_SECONDS)
    for k, v in ptxas_report(_build.PTXAS_INFO).items():
        say("ptxas", kernel=k, use=v)
    if dist_only or bench_only or graph_only:
        if dist_only:
            dist_phases(zoo.setup_cornell_box(W / H))
            multihost_phase()
        elif bench_only:
            bench_phase()
        else:
            flat_sb = zoo.setup_cornell_box(W / H)
            pair_sb = fill_cornell_textures(zoo.setup_cornell_box(W / H),
                                            FULL)
            graph_phase(flat_sb, pair_sb)
            graph_keys_phase(flat_sb, pair_sb)
            graph_general_phase(flat_sb, rt_weekend_standin(zoo),
                                flamingo_standin(zoo))
            dist_world1_phase(flat_sb, SPP)
        say("total", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return

    stats = {k: [] for k in (*KERNEL_MODULES, "first_hits_uv",
                             "shade_scatter_sky")}
    launches = {}
    flat_sb = zoo.setup_cornell_box(W / H)
    pair_sb = fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL)
    flat_scene = compile_scene(flat_sb, device=DEV)
    pair_scene = compile_scene(pair_sb, device=DEV)
    if not pair_scene.pair_mode or pair_scene.pair_pack.shape[0] <= 1:
        raise AssertionError("textured Cornell did not build a pair atlas")
    kernel_phase("cornell", flat_scene, stats, range(BOUNCES))
    kernel_phase("cornell_textured", pair_scene, stats, range(BOUNCES))
    cornell = render_phase("cornell", flat_sb, SPP)
    launches.update(finish=cornell["finish"], camera=cornell["camera"])
    render_phase("cornell_textured", pair_sb, PAIR_SPP)
    finish_phase(flat_sb, stats)
    camera_phase(stats)

    tf32_phase()
    record_phase(pair_scene, stats)
    bwd_phase("cornell", flat_scene, stats)
    bwd_phase("cornell_textured", pair_scene, stats)
    fold_phase(pair_scene, stats)
    launches.update(protocol_phase("cornell", flat_sb, SPP))
    launches_tex = protocol_phase("cornell_textured", pair_sb, SPP)
    protocol_phase("cornell_textured", pair_sb, SPP,
                   trainable=("mat_diffuse", "sph_center"))
    launches["sorted_fold"] = launches_tex["sorted_fold"]
    profile_phase("cornell", flat_sb, trainable=())
    profile_phase("cornell", flat_sb)
    profile_phase("cornell_textured", pair_sb)

    graphs.CACHE.clear()    # the graphs of the boxes' phases and their pools
    t0 = time.perf_counter()
    flam_sb = flamingo_standin(zoo)
    flam = compile_scene(flam_sb, device=DEV)
    pond = compile_scene(flamingo_pond_standin(zoo), device=DEV)
    rs_sb = zoo.setup_random_spheres()
    rsph = compile_scene(rs_sb, device=DEV)
    say("mesh_scenes", build_s=f"{time.perf_counter() - t0:.2f}",
        flamingo_standin=f"{flam.tri_a.shape[0] - 1} tris, "
        f"{flam.bvh_lo.shape[0]} nodes",
        flamingo_pond_standin=f"{pond.tri_a.shape[0] - 1} tris, "
        f"{pond.bvh_lo.shape[0]} nodes, {len(pond.mesh_root)} meshes")
    walk_phase("flamingo_standin", flam, stats)
    walk_phase("flamingo_pond_standin", pond, stats)
    shadow_phase("random_spheres", rsph, stats)
    shadow_phase("flamingo_standin", flam, stats)
    shadow_phase("flamingo_pond_standin", pond, stats)
    # a half-transparent mesh: the shadow kernel skips the walk of a
    # sample whose draw for the mesh is at most its transparency
    transp = flam.mat_transparency.clone()
    transp[flam.mesh_mat.long()] = 0.5
    shadow_phase("flamingo_standin_transparent_mesh",
                 dataclasses.replace(flam, mat_transparency=transp), stats)
    kernel_phase("flamingo_standin", flam, stats)
    kernel_phase("flamingo_pond_standin", pond, stats)
    mesh_launches = render_phase("flamingo_standin", flam_sb, SPP,
                                 plain_frame=False)
    render_phase("random_spheres", rs_sb, 4, plain_frame=False)
    launches.update(traverse=mesh_launches["traverse"],
                    shadow=mesh_launches["shadow"])
    profile_phase("flamingo_standin", flam_sb, trainable=())
    # the repaired limits: walls of quads whose tables outgrow a block's
    # 227 KB of shared memory kernel by kernel (B1 at ~1,200 quads, B2 at
    # ~2,000: tiled_wall gives each quad a material row; B6 at ~2,900), so
    # that each kernel's L2 instance runs; 17 meshes, one more than B5
    # keeps roots of in shared memory
    sh, l2 = "shared", "global"
    for n_quads, expect in ((700, (sh, sh, sh)), (1300, (l2, sh, sh)),
                            (3000, (l2, l2, l2))):
        limits_phase(f"tiled_wall_{n_quads}",
                     tiled_wall(zoo.SceneBuilder(), n_quads), expect)
    limits_phase("mesh_grid_17", mesh_grid(zoo.SceneBuilder(), 17, 1_000),
                 (sh, sh, sh))

    # every zoo scene and its gradient: the image sky in B2, the
    # sphere-UV index in B1, the exact atlas (the general route) and the
    # general backward
    rtw_sb = rt_weekend_standin(zoo)
    rtw = compile_scene(rtw_sb, device=DEV)
    sky_uv_phase("rt_weekend_standin", rtw, stats)
    render_phase("rt_weekend_standin", rtw_sb, SPP, plain_frame=False)
    render_phase("raccoon_standin", raccoon_standin(zoo), SPP,
                 plain_frame=False)
    render_phase("cornell_textured_exact_atlas", pair_sb, PAIR_SPP,
                 packed_atlas="off")
    rtw_train = ("mat_diffuse", "sph_center", "tex_data")
    flam_train = ("mesh_verts", "mat_diffuse", "sph_center")
    general_protocol_phase("rt_weekend_standin", rtw_sb, SPP, rtw_train)
    profile_phase("rt_weekend_standin", rtw_sb, trainable=rtw_train)
    general_protocol_phase("flamingo_standin", flam_sb, SPP, flam_train)
    # the replay's row sums: every atomic or scattered sum left in the
    # general and the plain autodiff steps, then the row-sum kernel on the
    # row sums those steps make, at each table shape
    atomics_phase("rt_weekend_standin", rtw_sb, 4, rtw_train)
    atomics_phase("flamingo_standin", flam_sb, 4, flam_train,
                  custom_vjp="off")
    rowsum_phase([
        ("rt_weekend_standin", rtw_sb, rtw_train, "on"),
        ("flamingo_standin", flam_sb, flam_train, "on"),
        ("tiled_wall_3000", tiled_wall(zoo.SceneBuilder(), 3000),
         ("quad_v0", "mat_diffuse"), "on"),
        ("cornell_textured_lit_plain_ad", lit_textured_cornell(),
         ("tex_data", "nm_data", "quad_v0", "sph_center", "mat_mb"),
         "off")], stats)

    graphs.CACHE.clear()
    entry_point_phases(flat_sb, pair_sb, rtw_sb)
    graph_phase(flat_sb, pair_sb)
    graph_keys_phase(flat_sb, pair_sb)
    # the row sums' launches: a replay of the rt_weekend_standin 16-spp
    # general step's graph, the main path since the general step compiles
    launches["row_sum"] = graph_general_phase(flat_sb, rtw_sb,
                                              flam_sb)["row_sum"]
    dist_phases(flat_sb)
    plain_ad_phase("cornell", flat_sb, SPP, ("mat_diffuse", "sph_center"))
    plain_ad_phase("flamingo_standin", flam_sb, 4,
                   ("mesh_verts", "mat_diffuse", "sph_center"))
    graphs.CACHE.clear()
    bench_phase()
    graphs.CACHE.clear()
    multihost_phase()

    # representative calls: B1 cornell bounce 1, B2 cornell bounce 1
    # reference, B3 cornell reference bounce 0, B4 the textured stream,
    # B5 flamingo_standin bounce 1, B6 flamingo_standin bounce 0
    # reference. Launch counts: the flat box's 16-spp protocol run (B4:
    # the textured box's, the flat box has no atlas to fold onto; B5 and
    # B6: the 16-spp flamingo_standin render; the row sums: a replay of
    # the rt_weekend_standin 16-spp general step's graph)
    rows = []
    for kname, src, tpu, pick in (
            ("first_hits", "tracer_torch/kernels/csrc/first_hits.cu",
             "tracer/kernels/intersect.py:382", 1),
            ("shade_scatter", "tracer_torch/kernels/csrc/shade_scatter.cu",
             "tracer/kernels/shade.py:382", 3),
            ("bounce_bwd", "tracer_torch/kernels/csrc/bounce_bwd.cu",
             "tracer/kernels/shade_bwd.py:97", 1),
            ("sorted_fold", "tracer_torch/kernels/csrc/sorted_fold.cu",
             "tracer/kernels/fold.py:120", 0),
            ("traverse", "tracer_torch/kernels/csrc/traverse.cu",
             "tracer/kernels/traverse.py:209", 1),
            ("shadow", "tracer_torch/kernels/csrc/shadow.cu",
             "tracer/kernels/shadow.py:466", 4)):
        recs = stats[kname]
        rec = recs[pick]
        # the sphere-UV and image-sky variants are held the same way
        recs = recs + stats.get(dict(first_hits="first_hits_uv",
                                     shade_scatter="shade_scatter_sky"
                                     ).get(kname, ""), [])
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[kname],
                     "max_abs_err": max(r.err for r in recs), "ms": rec.ms,
                     "plain_ms": rec.plain_ms, "bound_ms": rec.bound_ms,
                     "bound_by": rec.bound_by,
                     "library_ms": rec.library_ms})
    # the row sums: rt_weekend_standin's material rows (matf) in the
    # 16-spp general step's backward, every table shape's error
    named = stats["row_sum"]
    rec = next(r for k, r in named
               if k.startswith("rt_weekend_standin") and k.endswith("x18"))
    rows.append({"name": "row_sum", "route": "cuda",
                 "source": "tracer_torch/kernels/csrc/row_sum.cu",
                 "replaces": "tracer/render/integrator.py:154 (_rows, a "
                             "one-hot product outside Pallas)",
                 "launches": launches["row_sum"],
                 "max_abs_err": max(r.err for _, r in named), "ms": rec.ms,
                 "plain_ms": rec.plain_ms, "bound_ms": rec.bound_ms,
                 "bound_by": rec.bound_by, "library_ms": rec.library_ms})
    # the finish: the Cornell frame's film, 1 launch a `render` frame
    rec = stats["finish"][0]
    rows.append({"name": "finish", "route": "cuda",
                 "source": "tracer_torch/kernels/csrc/finish.cu",
                 "replaces": "tracer_torch/render/film.py::to_image (numpy "
                             "on the host; no Pallas kernel)",
                 "launches": launches["finish"], "max_abs_err": rec.err,
                 "ms": rec.ms, "plain_ms": rec.plain_ms,
                 "bound_ms": rec.bound_ms, "bound_by": rec.bound_by,
                 "library_ms": rec.library_ms})
    # the camera: 850x480 rays, 1 launch a sample of a `render` frame
    rec = stats["camera"][0]
    rows.append({"name": "camera", "route": "cuda",
                 "source": "tracer_torch/kernels/csrc/camera.cu",
                 "replaces": "tracer_torch/render/renderer.py::camera_batch "
                             "(its torch chain; no Pallas kernel)",
                 "launches": launches["camera"], "max_abs_err": rec.err,
                 "ms": rec.ms, "plain_ms": rec.plain_ms,
                 "bound_ms": rec.bound_ms, "bound_by": rec.bound_by,
                 "library_ms": rec.library_ms})
    say("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(dist_only="--dist" in sys.argv[1:],
         bench_only="--bench" in sys.argv[1:],
         graph_only="--graph" in sys.argv[1:])
    sys.stdout.flush()
