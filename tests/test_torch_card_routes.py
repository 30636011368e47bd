"""The port's entry points on the card, each against its plain path or its
eager body, at 850x480 and 6 bounces.

- `renderer.render` of every zoo family (the Cornell boxes, the exact
  atlas, the mesh and asset stand-ins): the formula's launches, a finite
  image, the 1-spp radiance of the kernels against kernels="off".
- The bench.py protocol step (`render_pixels` + `loss.backward()`) on the
  hand-written backward (B3, B4), on the general backward (the replay's
  vjp) and on the plain autodiff route (custom_vjp="off"): launches,
  finite and non-zero gradients, the same bits every run, 1-spp gradients
  against the plain path; no GEMM a bounce and no atomic row sum left.
- `train.fit` and its resume, the tiled checkpointed render, the CLI and
  `tracer_torch.bench`'s JSON line.
- The compiled entry points (`render/graphs.py`): each replay bit-equal to
  its eager body with the same launches and no host synchronisation; the
  keys by shape; a body that reads the card fails at its capture.

Tolerances: `tests/card.py`.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.card import (  # noqa: F401  (fixtures)
    ATOL, BOUNCES, BUILDERS, FIT_OFFSETS, FIT_TRAIN, H, KERNELS, PAIR_SPP,
    SPP, TRAINABLE, W, all_bit_equal, assert_grads_close, bit_equal,
    call_launches, card, ckpt_leaves, fit_check, fresh_graphs,
    general_launches, graph_check, launched, leaves_equal, protocol_grads,
    reset_launches, rowsum_launches, scene, train_start, train_target)
from tracer_torch import bench, cli
from tracer_torch import train as T
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import fold as kfold
from tracer_torch.render import graphs, integrator, renderer, replay_bwd
from tracer_torch.render.camera import default_camera, look_at_quaternion
from tracer_torch.render.film import TileManifest
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo

pytestmark = pytest.mark.card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTW_TRAIN = ("mat_diffuse", "sph_center", "tex_data")
FLAM_TRAIN = ("mesh_verts", "mat_diffuse", "sph_center")


def setup(card, **kw):
    """(camera, config, pixel ids) at W x H, 6 bounces."""
    cfg = RenderConfig(width=W, height=H, max_bounces=BOUNCES, **kw)
    return (default_camera(W / H, device=card), cfg,
            torch.arange(W * H, dtype=torch.int32, device=card))


def profiled_kernels(fn):
    """The names and launch counts of the CUDA kernels of one call of
    `fn`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


# --- renders -----------------------------------------------------------------

RENDERS = [
    pytest.param("cornell", SPP, {}, id="cornell"),
    pytest.param("cornell_textured", PAIR_SPP, {}, id="cornell_textured"),
    # the general route: B1, then torch ops; B2 does not run there
    pytest.param("cornell_textured", PAIR_SPP, dict(packed_atlas="off"),
                 id="cornell_textured_exact_atlas"),
    pytest.param("flamingo_standin", SPP, {}, id="flamingo_standin"),
    pytest.param("random_spheres", 4, {}, id="random_spheres"),
    pytest.param("rt_weekend_standin", SPP, {}, id="rt_weekend_standin"),
    pytest.param("raccoon_standin", SPP, {}, id="raccoon_standin"),
]


@pytest.mark.parametrize("name,spp,kw", RENDERS)
def test_render(card, scene, fresh_graphs, name, spp, kw):
    """The frame through `render` (its graph replayed: the warm-up call
    captured it) launches each kernel of its route once a bounce, the
    camera once a sample and the finish once; its 1-spp radiance equals
    the plain path's within ATOL."""
    sc = scene(name)
    cam, cfg, pid = setup(card, nsamples=spp, **kw)
    renderer.render(sc, cam, cfg)
    torch.cuda.synchronize()
    reset_launches()
    img = renderer.render(sc, cam, cfg)
    torch.cuda.synchronize()
    assert launched() == call_launches(sc, cfg, spp, frames=1)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    rk = renderer.render_pixels(sc, cam, cfg, W, H, pid, 1, cfg.seed)
    rp = renderer.render_pixels(sc, cam, dataclasses.replace(
        cfg, kernels="off"), W, H, pid, 1, cfg.seed)
    assert float((rk - rp).abs().max()) <= ATOL


# --- protocol steps ----------------------------------------------------------

@pytest.mark.parametrize("name,trainable", [
    ("cornell", TRAINABLE), ("cornell_textured", TRAINABLE),
    ("cornell_textured", ("mat_diffuse", "sph_center"))])
def test_protocol_step(card, scene, fresh_graphs, name, trainable):
    """The 16-spp step on the hand-written backward (its graph replayed)
    launches B3 once a bounce and B4 once a sample where texels train;
    its gradients are finite, mat_diffuse's not zero; the 1-spp gradients
    equal the plain path's within GRAD_RTOL."""
    sc = scene(name)
    cam, cfg, _ = setup(card)
    protocol_grads(sc, cam, cfg, SPP, trainable)
    reset_launches()
    _, grads = protocol_grads(sc, cam, cfg, SPP, trainable)
    assert launched() == call_launches(sc, cfg, SPP, trainable)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["mat_diffuse"].abs().max()) > 0.0
    _, gk = protocol_grads(sc, cam, cfg, 1, trainable)
    _, gp = protocol_grads(sc, cam, dataclasses.replace(cfg, kernels="off"),
                           1, trainable)
    assert_grads_close(gk, gp, trainable)


@pytest.mark.parametrize("name,trainable", [
    ("cornell", TRAINABLE), ("cornell_textured", TRAINABLE),
    ("rt_weekend_standin", RTW_TRAIN)])
def test_step_has_no_gemm_a_bounce(card, scene, name, trainable):
    """The sweep adds the row cotangents inside B3 and the general
    backward gathers rows by the row-sum kernel: the only matmuls left in
    an eager 16-spp step are at most two a sample."""
    sc = scene(name)
    cam, cfg, _ = setup(card)
    with graphs.CACHE.disabled():
        names = profiled_kernels(
            lambda: protocol_grads(sc, cam, cfg, SPP, trainable))
    gemms = sum(n for k, n in names.items() if "gemm" in k.lower())
    assert gemms <= 2 * SPP, gemms


@pytest.mark.parametrize("name,trainable", [
    ("rt_weekend_standin", RTW_TRAIN), ("flamingo_standin", FLAM_TRAIN)])
def test_general_step(card, scene, name, trainable, monkeypatch):
    """The step outside the hand-written class, eager: the record forward
    on the kernels, the replay's vjp, the fold of every bounce (the last
    one too on a lit scene or an emissive texture), the row sums: the
    formula's launches, the same bits in three runs, finite non-zero
    gradients, 1-spp gradients equal to the plain path's within
    GRAD_RTOL."""
    sc = scene(name)
    assert not replay_bwd.hand_bwd_ok(sc, RenderConfig())
    cam, cfg, _ = setup(card)
    segs = []
    fold = kfold.fold_updates

    def spy(data_g, idxs, gs, kernels="auto"):
        segs.append(len(idxs))
        return fold(data_g, idxs, gs, kernels)

    monkeypatch.setattr(kfold, "fold_updates", spy)
    with graphs.CACHE.disabled():
        protocol_grads(sc, cam, cfg, SPP, trainable)
        reset_launches()
        segs.clear()
        runs = [protocol_grads(sc, cam, cfg, SPP, trainable)[1]]
        launches, fold_segs = launched(), sorted(set(segs))
        runs += [protocol_grads(sc, cam, cfg, SPP, trainable)[1]
                 for _ in range(2)]
        _, gk = protocol_grads(sc, cam, cfg, 1, trainable)
        _, gp = protocol_grads(sc, cam, dataclasses.replace(
            cfg, kernels="off"), 1, trainable)
    assert all(all_bit_equal(runs[0], g) for g in runs[1:])
    assert launches == general_launches(sc, cfg, SPP, trainable)
    if "tex_data" in trainable and sc.tex_data.shape[0] > 1:
        lit = sc.light_pos.shape[0] > 0
        assert fold_segs == [BOUNCES if (lit or sc.emissive_tex_image)
                             else BOUNCES - 1]
    for g in runs[0].values():
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert_grads_close(gk, gp, trainable)


@pytest.mark.parametrize("name,trainable,custom_vjp", [
    ("rt_weekend_standin", RTW_TRAIN, "on"),
    ("flamingo_standin", FLAM_TRAIN, "off")])
def test_no_atomic_row_sums(card, scene, name, trainable, custom_vjp):
    """No kernel of a 4-spp general or plain autodiff step sums by
    atomics or scatter (`index_add_`'s `indexFunc*`, `scatter_add`)."""
    sc = scene(name)
    cam, cfg, _ = setup(card, custom_vjp=custom_vjp)
    with graphs.CACHE.disabled():
        names = profiled_kernels(
            lambda: protocol_grads(sc, cam, cfg, 4, trainable))
    atomic = ("index_add", "indexfunc", "scatter_add")
    assert not [k for k in names if any(a in k.lower() for a in atomic)]


@pytest.mark.parametrize("name,spp,trainable", [
    ("cornell", SPP, ("mat_diffuse", "sph_center")),
    ("flamingo_standin", 4, FLAM_TRAIN)])
def test_plain_ad_step(card, scene, name, spp, trainable):
    """custom_vjp="off", eager: B1, B5, B6 once a bounce and the row sums
    (no B2, B3 or B4), the same bits in every run, finite gradients,
    mat_diffuse's not zero, 1-spp gradients within GRAD_RTOL of the plain
    path's and of custom_vjp="on"."""
    sc = scene(name)
    cam, cfg, _ = setup(card, custom_vjp="off")
    with graphs.CACHE.disabled():
        runs = [protocol_grads(sc, cam, cfg, spp, trainable)[1]]
        reset_launches()
        runs.append(protocol_grads(sc, cam, cfg, spp, trainable)[1])
        launches = launched()
        runs += [protocol_grads(sc, cam, cfg, spp, trainable)[1]
                 for _ in range(2)]
        _, gk = protocol_grads(sc, cam, cfg, 1, trainable)
        refs = [protocol_grads(sc, cam, dataclasses.replace(cfg, **c), 1,
                               trainable)[1]
                for c in (dict(kernels="off"), dict(custom_vjp="on"))]
    assert all(all_bit_equal(runs[0], g) for g in runs[1:])
    assert launches == general_launches(sc, cfg, spp, trainable)
    assert all(bool(torch.isfinite(g).all()) for g in runs[0].values())
    assert float(runs[0]["mat_diffuse"].abs().max()) > 0.0
    for gp in refs:
        assert_grads_close(gk, gp, trainable)


# --- training ----------------------------------------------------------------

class FirstGradsAdam(torch.optim.Adam):
    """`train.fit`'s default Adam that keeps the gradients of its first
    update."""

    def __init__(self, leaves, lr):
        super().__init__(leaves, lr=lr, betas=T.ADAM_BETAS, eps=T.ADAM_EPS)
        self.first_grads = None

    def step(self, closure=None):
        if self.first_grads is None:
            self.first_grads = [p.grad.clone() for g in self.param_groups
                                for p in g["params"]]
        return super().step(closure)


def step_counts(**kw):
    """Launches a step: every kernel not named launches none."""
    return dict(dict(first_hits=0, shade_scatter=0, bounce_bwd=0,
                     sorted_fold=0, traverse=0, shadow=0, row_sum=0), **kw)


N6 = SPP * BOUNCES
TRAIN = [
    pytest.param("cornell", SPP, FIT_TRAIN, FIT_OFFSETS, 5, 2e-3,
                 step_counts(first_hits=N6, shade_scatter=N6, bounce_bwd=N6),
                 True, id="cornell"),
    # texels train: guard_config renders the exact atlas (general route,
    # no B2), the hand-written sweep (B3) and the fold (B4) stay
    pytest.param("cornell_textured", SPP, ("tex_data", "mat_diffuse"),
                 dict(tex_data=0.05, mat_diffuse=0.05), 3, 1e-2,
                 step_counts(first_hits=N6, bounce_bwd=N6, sorted_fold=SPP),
                 True, id="cornell_textured"),
    # the general backward: its row sums run in a fixed order, so the
    # resume is bit-equal. Its loss need not fall: each sphere sits under
    # a light, and Adam's first steps (about lr a component) move the
    # spheres' shadows, whose visibility the gradient does not see
    pytest.param("rt_weekend_standin", 4, RTW_TRAIN,
                 dict(mat_diffuse=0.05, sph_center=0.02, tex_data=0.05), 3,
                 1e-2, None, False, id="rt_weekend_standin"),
]


@pytest.mark.parametrize(
    "name,spp,trainable,offsets,steps,lr,expect,must_fall", TRAIN)
def test_fit_and_resume(card, scene, fresh_graphs, tmp_path, name, spp,
                        trainable, offsets, steps, lr, expect, must_fall):
    """`train.fit` from a seeded start: the launches a step, finite grad
    norms and (where the loss must fall) a falling loss; then `steps` - 2
    steps into a checkpoint and a fresh `fit` from it to `steps`, whose
    params and Adam state equal the uninterrupted run's bit for bit, and
    the checkpoint loaded and saved again unchanged. On the textured box
    the first step's gradients equal the plain path's within GRAD_RTOL,
    and the returned scene's packs are invalidated."""
    sc = scene(name)
    cam, cfg, pid = setup(card, nsamples=spp)
    if expect is None:
        expect = step_counts(first_hits=spp * BOUNCES,
                             shadow=spp * BOUNCES, sorted_fold=spp,
                             row_sum=rowsum_launches(sc, trainable, spp))
    target = train_target(sc, cam, cfg, trainable, spp)
    s0, c0 = train_start(sc, cam, trainable, offsets, seed=1)
    kw = dict(trainable=trainable, lr=lr, width=W, height=H, nsamples=spp,
              ckpt_every=steps)
    opts = []

    def adam(leaves):
        opts.append(FirstGradsAdam(leaves, lr))
        return opts[-1]

    reset_launches()
    sa, ca, hist = T.fit(s0, c0, cfg, target, steps=steps, optimizer=adam,
                         ckpt_dir=str(tmp_path / "a"), **kw)
    torch.cuda.synchronize()
    assert {k: KERNELS[k].LAUNCHES / steps for k in expect} == expect
    losses = [h["loss"] for h in hist]
    assert np.isfinite([h["grad_norm"] for h in hist]).all()
    assert losses[-1] < losses[0] or not must_fall, losses
    if name == "cornell_textured":
        first_grads_equal_plain(opts[0].first_grads, s0, c0, cfg, trainable,
                                target, pid, spp)
        stale_packs_render_plain(sa, ca, cfg, sc, pid)

    b = str(tmp_path / "b")
    T.fit(s0, c0, cfg, target, steps=steps - 2, ckpt_dir=b, **kw)
    sb, cb, hist_b = T.fit(s0, c0, cfg, target, steps=steps, ckpt_dir=b,
                           **kw)
    assert [h["step"] for h in hist_b] == [steps - 1, steps]
    pa, pb = (T.split_params(s, c, trainable) for s, c in ((sa, ca),
                                                           (sb, cb)))
    assert all(bit_equal(pa[k].detach(), pb[k].detach()) for k in trainable)
    path = os.path.join(b, "train.npz")
    assert leaves_equal(ckpt_leaves(str(tmp_path / "a" / "train.npz")),
                        ckpt_leaves(path))
    # the checkpoint loaded into fresh leaves and Adam, and saved again
    params = T.split_params(s0, c0, trainable)
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=lr,
                           betas=T.ADAM_BETAS, eps=T.ADAM_EPS)
    T._load_ckpt(path, params, opt)
    T._save_ckpt(path + ".again.npz", int(ckpt_leaves(path)["step"]),
                 params, opt)
    assert leaves_equal(ckpt_leaves(path), ckpt_leaves(path + ".again.npz"))


def first_grads_equal_plain(first, s0, c0, cfg, trainable, target, pid,
                            spp):
    """The first step's gradients (by sorted name, as `fit` took them with
    the kernels) against the same loss's gradients on the plain path."""
    cfg = dataclasses.replace(T.guard_config(cfg, trainable), kernels="off")
    params = T.split_params(s0, c0, trainable)
    s, cm = T.apply_params(s0, c0, params)
    img = renderer.render_pixels(s, cm, cfg, W, H, pid, spp, cfg.seed) / spp
    torch.mean((img - target) ** 2).backward()
    assert_grads_close(dict(zip(sorted(trainable), first)),
                       {k: params[k].grad for k in trainable}, trainable)


def stale_packs_render_plain(s1, c1, cfg, pristine, pid):
    """The trained scene's packs are invalidated, so its 1-spp radiance
    with the kernels equals kernels="off"; the texels left the u8 grid."""
    assert not s1.pair_mode and s1.pair_pack.shape[0] == 1
    with torch.no_grad():
        rk, rp = (renderer.render_pixels(s1, c1, c, W, H, pid, 1, cfg.seed)
                  for c in (cfg, dataclasses.replace(cfg, kernels="off")))
    assert float((rk - rp).abs().max()) <= ATOL
    assert float((s1.tex_data - pristine.tex_data).abs().max()) > 1e-4


# --- the tiled render --------------------------------------------------------

def test_tiled_render_and_resume(card, scene, fresh_graphs, tmp_path):
    """`render(ckpt_dir=..., tile=128)`: 28 tiles, each launching B1 and
    B2 once a bounce a sample, the image equal to the direct render's;
    with every other tile file deleted only those are rendered again (the
    kept files untouched), a third call renders nothing, and host 1 of 2
    writes its tiles alone, equal to the first store's."""
    sc = scene("cornell")
    cam, cfg, _ = setup(card, nsamples=SPP)
    tile = 128
    direct = renderer.render(sc, cam, cfg)
    d = str(tmp_path / "tiles")
    man = TileManifest(W, H, tile, d)
    reset_launches()
    img = renderer.render(sc, cam, cfg, ckpt_dir=d, tile=tile)
    n = man.n_tiles
    assert {k: KERNELS[k].LAUNCHES for k in ("first_hits", "shade_scatter")
            } == dict(first_hits=n * SPP * BOUNCES,
                      shade_scatter=n * SPP * BOUNCES)
    np.testing.assert_array_equal(img, direct)
    files = sorted(os.listdir(d))
    assert len(files) == n
    for f in files[::2]:
        os.remove(os.path.join(d, f))
    kept = {f: os.path.getmtime(os.path.join(d, f)) for f in files[1::2]}
    img2 = renderer.render(sc, cam, cfg, ckpt_dir=d, tile=tile)
    every = {f: os.path.getmtime(os.path.join(d, f)) for f in files}
    reset_launches()
    img3 = renderer.render(sc, cam, cfg, ckpt_dir=d, tile=tile)
    assert KERNELS["first_hits"].LAUNCHES == 0
    assert every == {f: os.path.getmtime(os.path.join(d, f)) for f in files}
    assert all(every[f] == t for f, t in kept.items())
    np.testing.assert_array_equal(img2, direct)
    np.testing.assert_array_equal(img3, direct)
    d2 = str(tmp_path / "host1")
    renderer.render(sc, cam, cfg, ckpt_dir=d2, tile=tile, host=1, n_hosts=2)
    assert sorted(os.listdir(d2)) == files[1::2]
    other = TileManifest(W, H, tile, d2)
    for t in range(1, n, 2):
        np.testing.assert_array_equal(man.load_tile(t)[0],
                                      other.load_tile(t)[0])


# --- the CLI -----------------------------------------------------------------

CLI = dict(
    render=["render", "--spp", "16", "--out", "{tmp}/cornell_box.ppm"],
    render_ckpt=["render", "--spp", "16", "--ckpt-dir", "{tmp}/tiles",
                 "--out", "{tmp}/cornell_tiled.png"],
    probe=["probe", "--x", "240", "--y", "70"],
    occupancy=["benchmark", "--occupancy"],
    compile=["benchmark", "--compile"],
    profile=["benchmark", "--profile", "{tmp}/profile"],
    benchmark=["benchmark"],
    grad_check=["grad-check"],
    train=["train", "--steps", "3", "--spp", "4"],
    scenes=["scenes"])


@pytest.mark.parametrize("name", list(CLI))
def test_cli(card, fresh_graphs, tmp_path, name):
    """`tracer_torch.cli.main([...])` in-process at the CLI's default
    850x480, 6 bounces (it raises on failure): the direct render is one
    chunk of 16 spp, the tiled one 28 tiles; `benchmark --compile` splits
    the first call (in a cache without the frame's graph) into warm-up,
    capture, instantiation and first replay; every grad-check passes."""
    argv = [a.format(tmp=tmp_path) for a in CLI[name]]
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    text = buf.getvalue().strip()
    if name.startswith("render"):
        calls = 16 * BOUNCES * (1 if name == "render" else 28)
        assert {k: KERNELS[k].LAUNCHES
                for k in ("first_hits", "shade_scatter")} == dict(
                    first_hits=calls, shade_scatter=calls)
    if name == "compile":
        res = json.loads(text.splitlines()[-1])
        for k in ("warmup_s", "capture_s", "instantiate_s",
                  "first_replay_s"):
            assert res[k] is not None, k
    if name == "grad_check":
        res = json.loads(text)
        assert all(r["ok"] for r in res.values()), res


def test_cli_module_entry(card):
    res = subprocess.run([sys.executable, "-m", "tracer_torch.cli",
                          "scenes"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-500:]
    assert len(res.stdout.splitlines()) == 11


# --- tracer_torch.bench ------------------------------------------------------

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "total_rays_per_s",
              "fwdbwd_primary_rays_per_s", "fwdbwd_no_texgrad_rays_per_s",
              "config", "device", "per_scene_fwd_rays_per_s")


def test_bench_main(card, fresh_graphs, monkeypatch):
    """`tracer_torch.bench.main()` at 850x480, 16 spp, 6 bounces, 3 reps,
    with the zoo's scenes: one JSON line, its keys and scenes, every rate
    finite and positive, its config, and the launches of what it runs:
    the Cornell frame and both protocol steps, then each scene's 1-spp
    frame, 1 + reps calls each."""
    reps = 3
    for k, v in dict(BENCH_WIDTH=W, BENCH_HEIGHT=H, BENCH_SPP=SPP,
                     BENCH_REPS=reps, BENCH_SCENES=1).items():
        monkeypatch.setenv(k, str(v))
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        ret = bench.main()
    launches = launched()
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == ret
    assert sorted(ret) == sorted(BENCH_KEYS)
    assert list(ret["per_scene_fwd_rays_per_s"]) == list(bench.SCENES)
    rates = [ret[k] for k in ("value", "total_rays_per_s",
                              "fwdbwd_primary_rays_per_s",
                              "fwdbwd_no_texgrad_rays_per_s")]
    rates += list(ret["per_scene_fwd_rays_per_s"].values())
    assert all(np.isfinite(r) and r > 0 for r in rates), rates
    assert ret["config"] == f"{W}x{H}@{SPP}spp b{BOUNCES}"
    b = bench.inputs(zoo.setup_cornell_box(W / H), W, H, SPP, card)
    expect = {}
    bodies = [call_launches(b.scene, b.cfg, SPP, t)
              for t in ((), bench.TRAINABLE, bench.NO_TEXGRAD)]
    for name in bench.SCENES:
        s = bench.inputs(zoo.BY_NAME[name](), W, H, 1, card, camera=b.camera)
        bodies.append(call_launches(s.scene, s.cfg, 1))
    for counts in bodies:
        for k, v in counts.items():
            expect[k] = expect.get(k, 0) + v * (1 + reps)
    assert launches == expect


@pytest.mark.parametrize("body", ["frame", "fwdbwd", "fwdbwd_no_texgrad"])
def test_bench_bodies(card, fresh_graphs, body):
    """Each timed body of `tracer_torch.bench`, one call after a warm-up:
    the launches of its route and a finite scalar."""
    b = bench.inputs(zoo.setup_cornell_box(W / H), W, H, SPP, card)
    fn, trainable = dict(
        frame=(lambda: bench.frame_scalar(b), ()),
        fwdbwd=(lambda: bench.grad_sum(b), bench.TRAINABLE),
        fwdbwd_no_texgrad=(lambda: bench.grad_sum(b, bench.NO_TEXGRAD),
                           bench.NO_TEXGRAD))[body]
    fn()
    reset_launches()
    v = float(fn())
    assert launched() == call_launches(b.scene, b.cfg, SPP, trainable)
    assert np.isfinite(v)


def test_bench_frame_scalar_equals_plain(card, fresh_graphs):
    b = bench.inputs(zoo.setup_cornell_box(W / H), W, H, 1, card)
    got = float(bench.frame_scalar(b))
    want = float(bench.frame_scalar(
        b._replace(cfg=dataclasses.replace(b.cfg, kernels="off"))))
    assert abs(got - want) <= ATOL


# --- the compiled entry points -----------------------------------------------

def frame(sc, cam, cfg, pid, spp):
    return lambda: renderer.render_frame(sc, cam, cfg, W, H, pid, spp,
                                         cfg.seed)


GRAPH_FRAMES = [
    pytest.param("flamingo_standin", {}, id="flamingo_standin"),
    pytest.param("rt_weekend_standin", {}, id="rt_weekend_standin"),
    pytest.param("rt_weekend_standin", dict(packed_atlas="off"),
                 id="rt_weekend_standin_general"),
    pytest.param("random_spheres", {}, id="random_spheres")]
GRAPH_STEPS = ("cornell", "cornell_textured")


def test_graph_cornell_frame(card, scene, fresh_graphs):
    sc = scene("cornell")
    cam, cfg, pid = setup(card, nsamples=SPP)
    f = frame(sc, cam, cfg, pid, SPP)
    graph_check(f, f, call_launches(sc, cfg, SPP))


def test_graph_bench_frame_scalar(card, scene, fresh_graphs):
    """The bench's frame replays the frame's graph: no capture of its
    own."""
    sc = scene("cornell")
    cam, cfg, pid = setup(card, nsamples=SPP)
    frame(sc, cam, cfg, pid, SPP)()
    bf = bench.Inputs(sc, cam, cfg, W, H, pid, SPP)
    graph_check(lambda: bench.frame_scalar(bf),
                lambda: bench.frame_scalar(bf),
                call_launches(sc, cfg, SPP), captures=0)


@pytest.mark.parametrize("name", GRAPH_STEPS)
def test_graph_protocol_step(card, scene, fresh_graphs, name):
    """A replayed 16-spp step syncs the host never, the eager one at most
    once."""
    sc = scene(name)
    cam, cfg, pid = setup(card, nsamples=SPP)
    b = bench.Inputs(sc, cam, cfg, W, H, pid, SPP)
    _, eager_syncs = graph_check(
        lambda: bench.protocol_step(b, TRAINABLE),
        lambda: bench.protocol_step(b, TRAINABLE),
        call_launches(sc, cfg, SPP, TRAINABLE))
    assert eager_syncs <= 1


@pytest.mark.parametrize("name,kw", GRAPH_FRAMES)
def test_graph_frame(card, scene, fresh_graphs, name, kw):
    sc = scene(name)
    cam, cfg, pid = setup(card, nsamples=4, **kw)
    f = frame(sc, cam, cfg, pid, 4)
    graph_check(f, f, call_launches(sc, cfg, 4))


def test_graph_cases_replay_every_kernel(card, scene):
    """The graph cases above replay, between them, every kernel of the
    forward and the hand-written backward."""
    _, cfg, _ = setup(card, nsamples=SPP)
    total = set(call_launches(scene("cornell"), cfg, SPP))
    for name in GRAPH_STEPS:
        total |= set(call_launches(scene(name), cfg, SPP, TRAINABLE))
    for p in GRAPH_FRAMES:
        name, kw = p.values
        c = dataclasses.replace(cfg, nsamples=4, **kw)
        total |= set(call_launches(scene(name), c, 4))
    assert total == {"first_hits", "shade_scatter", "bounce_bwd",
                     "sorted_fold", "traverse", "shadow", "camera"}


def test_graph_cornell_fit(card, scene, fresh_graphs, tmp_path):
    sc = scene("cornell")
    cam, cfg, _ = setup(card, nsamples=SPP)
    fit_check(str(tmp_path), sc, cam, cfg, FIT_TRAIN, FIT_OFFSETS, 2e-3,
              call_launches(sc, cfg, SPP, FIT_TRAIN))


def test_graph_tiled_render(card, scene, fresh_graphs, tmp_path):
    """The second direct render replays the first's frame graph and
    equals it; the 28-tile render (a graph a tile shape: 4 captures)
    replays each tile's kernels and the finish once, equal to the direct
    frame."""
    sc = scene("cornell")
    cam, cfg, _ = setup(card, nsamples=SPP)
    cache = fresh_graphs
    direct = renderer.render(sc, cam, cfg)
    g = cache.last
    assert g.key[0] == "frame" and g.replays == 0
    np.testing.assert_array_equal(renderer.render(sc, cam, cfg), direct)
    assert g.replays == 1
    n0 = cache.captures
    renderer.render(sc, cam, cfg, ckpt_dir=str(tmp_path / "a"))
    reset_launches()
    img = renderer.render(sc, cam, cfg, ckpt_dir=str(tmp_path / "b"))
    n_tiles = TileManifest(W, H, 128, str(tmp_path / "c")).n_tiles
    assert launched() == dict(
        {k: v * n_tiles for k, v in call_launches(sc, cfg, SPP).items()},
        finish=1)
    np.testing.assert_array_equal(img, direct)
    assert cache.captures - n0 == 4


def test_graph_capture_of_a_read_fails(card, scene, fresh_graphs):
    """A body that reads the card raises at its capture: nothing is
    cached, no eager result stands in (only the warm-up launched), and the
    frames after it equal their eager bodies."""
    sc = scene("cornell")
    cam, cfg, pid = setup(card, nsamples=SPP)
    cache = fresh_graphs

    def reads(p):
        acc = renderer.render_pixels(sc, cam, cfg, W, H, p, 1, 0)
        if float(acc.sum()) < 0.0:
            acc = -acc
        return acc

    reset_launches()
    with pytest.raises(RuntimeError):
        cache.call(("must_fail",), reads, (pid,))
    torch.cuda.synchronize()
    assert ("must_fail",) not in cache
    assert launched() == call_launches(sc, cfg, 1)
    again = renderer.render_frame(sc, cam, cfg, W, H, pid, 1, 0)
    with cache.disabled():
        ref = renderer.render_frame(sc, cam, cfg, W, H, pid, 1, 0)
    assert bit_equal(again, ref)


# --- the keys by shape -------------------------------------------------------

def orbit_camera(card, k, n):
    """Camera k of a path of n around the Cornell box: an arc of 40
    degrees at the default camera's distance (6.1), rising 0.1 a camera,
    each looking at the box's centre."""
    a = np.radians(-20.0 + 40.0 * k / max(n - 1, 1))
    pos = (6.1 * np.sin(a), 0.1 * k - 0.35, 6.1 * np.cos(a))
    return dataclasses.replace(
        default_camera(W / H, device=card),
        position=torch.tensor(pos, dtype=torch.float32, device=card),
        quaternion=look_at_quaternion(pos, (0.0, 0.0, 0.0), device=card))


def frame_calls(sc, cfg, calls, pid):
    """Compiled frames against their eager bodies: `calls` is a list of
    (camera, seed, first sample, spp); each compiled `render_frame` and
    its eager body are bit-equal with the formula's launches. Returns the
    captures over the compiled calls."""
    cache = graphs.CACHE
    captures = 0
    for cam, seed, first, spp in calls:
        outs, counts = [], []
        for route in ("compiled", "eager"):
            with contextlib.ExitStack() as st:
                if route == "eager":
                    st.enter_context(cache.disabled())
                n0 = cache.captures
                reset_launches()
                outs.append(renderer.render_frame(sc, cam, cfg, W, H, pid,
                                                  spp, seed, first))
                torch.cuda.synchronize()
                counts.append(launched())
                captures += cache.captures - n0
        want = call_launches(sc, cfg, spp)
        assert bit_equal(*outs), (seed, first, spp)
        assert counts == [want, want], (seed, first, spp)
    return captures


def test_graph_camera_path(card, scene, fresh_graphs):
    """8 cameras around the box at 16 spp: one capture, the sample graph
    run 8 * 16 - 1 times."""
    sc = scene("cornell")
    _, cfg, pid = setup(card, nsamples=SPP)
    cams = [orbit_camera(card, k, 8) for k in range(8)]
    captures = frame_calls(sc, cfg, [(c, cfg.seed, 0, SPP) for c in cams],
                           pid)
    (g,) = fresh_graphs.graphs()
    assert captures == 1 and g.runs == 8 * SPP - 1


def test_graph_frames_reuse_their_tables(card, scene, fresh_graphs):
    """`integrator.prepare`'s memo on the card: three graphed Cornell
    frames, `mat_diffuse` written in place before the third, build the
    tables 1, 0 and 1 times, each bit-equal to the eager frame of a copy
    of the scene as it stands (tables built afresh); a graphed flamingo
    loop reuses its tables from its second frame on."""
    sc = compile_scene(BUILDERS["cornell"](), device=card)   # written below
    _, cfg, pid = setup(card, nsamples=4)
    c0, builds = fresh_graphs.captures, []
    for k in range(3):
        if k == 2:
            sc.mat_diffuse.mul_(0.5)
        cam = orbit_camera(card, k, 3)
        n0 = integrator.TABLE_BUILDS
        got = renderer.render_frame(sc, cam, cfg, W, H, pid, 4, cfg.seed)
        builds.append(integrator.TABLE_BUILDS - n0)
        copy = graphs.tree_map(torch.clone, sc)
        with fresh_graphs.disabled():
            want = renderer.render_frame(copy, cam, cfg, W, H, pid, 4,
                                         cfg.seed)
        assert bit_equal(got, want), k
    assert builds == [1, 0, 1]
    assert fresh_graphs.captures - c0 == 1
    fl = scene("flamingo_standin")
    cam, cfg, pid = setup(card, nsamples=4)
    grew = []
    for k in range(4):
        n0 = (integrator.TABLE_BUILDS, integrator.TABLE_REUSES)
        renderer.render_frame(fl, cam, cfg, W, H, pid, 4, k)
        grew.append((integrator.TABLE_BUILDS - n0[0],
                     integrator.TABLE_REUSES - n0[1]))
    assert sum(grew[0]) == 1 and grew[1:] == [(0, 1)] * 3


@pytest.mark.parametrize("sweep", ["seed", "first_sample", "spp"])
def test_graph_sweeps_take_no_capture(card, scene, fresh_graphs, sweep):
    """Seeds, first samples and sample counts replay the one sample
    graph."""
    sc = scene("cornell")
    _, cfg, pid = setup(card, nsamples=SPP)
    cam = orbit_camera(card, 0, 8)
    frame_calls(sc, cfg, [(cam, cfg.seed, 0, SPP)], pid)
    calls = dict(seed=[(cam, sd, 0, SPP) for sd in (0, 1, 2)],
                 first_sample=[(cam, cfg.seed, f, SPP) for f in (0, 16)],
                 spp=[(cam, cfg.seed, 0, n) for n in (1, 4, 16, 64)])[sweep]
    assert frame_calls(sc, cfg, calls, pid) == 0
    assert len(fresh_graphs) == 1


class KeepLeaves:
    """An optimizer that updates nothing: `train.make_step`'s body alone."""

    def zero_grad(self, set_to_none=True):
        pass

    def step(self):
        pass


def test_graph_same_shape_step(card, fresh_graphs):
    """The textured 16-spp training step: 2 Adam steps, then new leaves on
    a second `compile_scene` of the same builder with a new camera and
    seed, compiled (1 capture) against eager: losses, grad norms and
    gradients bit-equal, the formula's launches a step; 8 more calls on
    new leaves take no capture."""
    cache = fresh_graphs
    _, cfg, pid = setup(card, nsamples=SPP)
    cams = [orbit_camera(card, k, 8) for k in range(8)]
    trainable = ("tex_data", "mat_diffuse")
    tcfg = T.guard_config(cfg, trainable)
    sb = BUILDERS["cornell_textured"]()
    pair_a = compile_scene(sb, device=card)
    pair_b = compile_scene(sb, device=card)   # the same builder again
    target = torch.zeros((W * H, 3), dtype=torch.float32, device=card)
    want = call_launches(pair_a, tcfg, SPP, trainable)
    runs = {}
    for route in ("compiled", "eager"):
        with contextlib.ExitStack() as st:
            if route == "eager":
                st.enter_context(cache.disabled())
            n0 = cache.captures
            out = []
            for sc, cam, seeds in ((pair_a, cams[0], (0, 1)),
                                   (pair_b, cams[1], (5,))):
                params = T.split_params(sc, cam, trainable)
                leaves = [params[k] for k in sorted(params)]
                step = T.make_step(T._adam_default(1e-2)(leaves), tcfg,
                                   target, W, H, SPP)
                for seed in seeds:
                    reset_launches()
                    loss, gnorm = step(params, sc, cam, pid, seed)
                    torch.cuda.synchronize()
                    assert launched() == want, route
                    out.append([loss, gnorm] + [p.grad.clone()
                                                for p in leaves])
            runs[route] = (out, cache.captures - n0)
    assert (runs["compiled"][1], runs["eager"][1]) == (1, 0)
    for a, b in zip(runs["compiled"][0], runs["eager"][0]):
        assert all(bit_equal(x, y) for x, y in zip(a, b))
    n0 = cache.captures
    for i in range(8):   # 8 more calls, each on new leaves
        sc = (pair_a, pair_b)[i % 2]
        params = T.split_params(sc, cams[i], trainable)
        T.make_step(KeepLeaves(), tcfg, target, W, H, SPP)(
            params, sc, cams[i], pid, i)
    torch.cuda.synchronize()
    assert cache.captures == n0 and len(cache) == 1


# --- the compiled routes beyond the Cornell family ---------------------------

@pytest.mark.parametrize("name,spp,trainable,custom_vjp", [
    pytest.param("rt_weekend_standin", SPP, RTW_TRAIN, "on",
                 id="rt_weekend_standin_general"),
    pytest.param("flamingo_standin", SPP, FLAM_TRAIN, "on",
                 id="flamingo_standin_general"),
    pytest.param("cornell", SPP, ("mat_diffuse", "sph_center"), "off",
                 id="cornell_plain_ad"),
    pytest.param("flamingo_standin", 4, FLAM_TRAIN, "off",
                 id="flamingo_standin_plain_ad")])
def test_graph_general_step(card, scene, fresh_graphs, name, spp, trainable,
                            custom_vjp):
    sc = scene(name)
    cam, cfg, pid = setup(card, nsamples=SPP, custom_vjp=custom_vjp)
    if custom_vjp == "on":
        assert not replay_bwd.hand_bwd_ok(sc, cfg)
    b = bench.Inputs(sc, cam, cfg, W, H, pid, spp)
    graph_check(lambda: bench.protocol_step(b, trainable),
                lambda: bench.protocol_step(b, trainable),
                general_launches(sc, cfg, spp, trainable))


def test_graph_general_fit(card, scene, fresh_graphs, tmp_path):
    sc = scene("rt_weekend_standin")
    cam, cfg, _ = setup(card, nsamples=4)
    fit_check(str(tmp_path), sc, cam, cfg, RTW_TRAIN,
              dict(mat_diffuse=0.05, sph_center=0.02, tex_data=0.05), 1e-2,
              general_launches(sc, T.guard_config(cfg, RTW_TRAIN), 4,
                               RTW_TRAIN))


def test_graph_occupancy_frame(card, scene, fresh_graphs):
    """`benchmark --occupancy`'s frame: the rays and tables made once, as
    the CLI does, so its graph runs no camera kernel."""
    sc = scene("cornell")
    cam, cfg, pid = setup(card, nsamples=SPP)
    rays = cli.benchmark_rays(cam, cfg, W, H, pid)
    tables = integrator.prepare(sc)
    want = call_launches(sc, cfg, 1)
    del want["camera"]
    graph_check(lambda: cli.occupancy_frame(sc, cfg, *rays, tables),
                lambda: cli.occupancy_frame(sc, cfg, *rays, tables), want)
