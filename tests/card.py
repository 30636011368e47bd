"""What the card cases share: the `card` fixture, the flagship sizes and
tolerances, the comparisons, the kernel launches each route must make and
the check of a compiled entry point against its eager body.

The card cases need a CUDA card and import no JAX, so on the card's
machine

    python3 -m pytest --noconftest -m card tests/test_torch_card_*.py \
        tests/test_torch_camera.py tests/test_torch_finish.py

runs them; without a card each skips. Whether there is a card is decided
in the `card` fixture, never while a module is imported.

Tolerances: discrete outputs (winning primitive, material, texel indices,
active flags) match exactly; forward float outputs within ATOL = 2e-5, the
tolerance the JAX package holds its own kernels to (tests/test_kernels.py).
The bounce adjoint: 0 mismatches on pass-through lanes and BWD_RTOL *
max(1, |plain|) elsewhere (the same expressions, built with --fmad=false;
cosf/sinf may differ by an ulp). Its tables and the fold: f32 summation
order (FOLD_RTOL). The 1-spp gradients against the plain path: max
relative error GRAD_RTOL.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import pytest
import torch

from tracer_torch import bench
from tracer_torch import train as T
from tracer_torch.kernels import finish as kfinish
from tracer_torch.render import graphs, integrator, renderer
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo
from tracer_torch.testing import (
    FULL, fill_cornell_textures, flamingo_pond_standin, flamingo_standin,
    mesh_grid, raccoon_standin, rt_weekend_standin, tiled_wall)

W, H, SPP, BOUNCES = 850, 480, 16, 6
PAIR_SPP = 2
ATOL = 2e-5
BWD_RTOL = 2e-5     # bounce adjoint vs plain, relative to max(1, |plain|)
FOLD_RTOL = 1e-5    # fold and B3's tables vs plain (f32 summation order)
GRAD_RTOL = 1e-4    # 1-spp protocol gradients vs the plain path
DISCRETE = ("j", "tid", "mid", "row", "sub", "idx_t", "idx_n", "active")
TRAINABLE = ("mat_diffuse", "sph_center", "tex_data")
# the Cornell training cell's trainables and their seeded start's offsets
FIT_TRAIN = ("mat_diffuse", "sph_center", "cam_quaternion")
FIT_OFFSETS = dict(mat_diffuse=0.05, sph_center=0.02, cam_quaternion=0.002)
# every kernel module's launch counter (a replay adds to those it stands for)
KERNELS = dict(graphs.COUNTED, finish=kfinish)


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)


def lit_textured_cornell():
    """The textured Cornell box with a small light under its ceiling: a
    scene whose geometry and normal maps get a gradient (in the unlit box
    the radiance is constant in them between discrete changes)."""
    sb = fill_cornell_textures(zoo.setup_cornell_box(W / H), FULL)
    sb.add_light((0.0, 1.5, 0.5), radius=0.3, color=(1.0, 1.0, 1.0))
    return sb


# the scene builders of the card cases: the Cornell box, the same box with
# seeded 1024x1024 textures and normal maps (the pair atlas), the
# stand-ins of the zoo's mesh and asset scenes (`tracer_torch.testing`),
# and the scenes the first port's fixed limits refused
BUILDERS = dict(
    cornell=lambda: zoo.setup_cornell_box(W / H),
    cornell_textured=lambda: fill_cornell_textures(
        zoo.setup_cornell_box(W / H), FULL),
    cornell_textured_lit=lit_textured_cornell,
    flamingo_standin=lambda: flamingo_standin(zoo),
    flamingo_pond_standin=lambda: flamingo_pond_standin(zoo),
    random_spheres=zoo.setup_random_spheres,
    rt_weekend_standin=lambda: rt_weekend_standin(zoo),
    raccoon_standin=lambda: raccoon_standin(zoo),
    tiled_wall_700=lambda: tiled_wall(zoo.SceneBuilder(), 700),
    tiled_wall_1300=lambda: tiled_wall(zoo.SceneBuilder(), 1300),
    tiled_wall_3000=lambda: tiled_wall(zoo.SceneBuilder(), 3000),
    mesh_grid_17=lambda: mesh_grid(zoo.SceneBuilder(), 17, 1_000))


@pytest.fixture(scope="module")
def scene(card):
    """scene(name): BUILDERS[name] compiled on the card, once a module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = compile_scene(BUILDERS[name](), device=card)
        return made[name]
    return get


@pytest.fixture(scope="module")
def memo(card):
    """memo(key, make): make() once a module (inputs that several cases of
    a module share)."""
    made = {}

    def get(key, make):
        if key not in made:
            made[key] = make()
        return made[key]
    return get


@pytest.fixture
def fresh_graphs():
    """An empty graph cache before and after the test (the pools freed)."""
    graphs.CACHE.clear()
    yield graphs.CACHE
    graphs.CACHE.clear()


def bits(t) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return np.ascontiguousarray(a, np.float32).reshape(-1).view(np.int32)


def bit_equal(x, y) -> bool:
    """Same bits (NaN included), or both None."""
    if x is None or y is None:
        return x is None and y is None
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def all_bit_equal(a, b) -> bool:
    """Two pytrees of tensors with the same bits."""
    if isinstance(a, torch.Tensor):
        return bit_equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(all_bit_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(all_bit_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def flat(rec) -> dict:
    """A first-hit record or a bounce state as {name: tensor}."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, tuple):
            for a, t in zip("xyz", v):
                out[f"{k}.{a}"] = t
        else:
            out[k] = v
    return out


def compare(got, want, mask=None):
    """(discrete mismatches, max |float error|) between two records; the
    kernel's float outputs must be finite."""
    got, want = flat(got), flat(want)
    mism, err = 0, 0.0
    for k, w in want.items():
        g = got[k]
        if mask is not None:
            g, w = g[mask], w[mask]
        if k in DISCRETE or not torch.is_floating_point(w):
            mism += int((g != w).sum())
        else:
            assert bool(torch.isfinite(g).all()), f"{k}: non-finite output"
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    return mism, err


def assert_same_record(got, want, mask=None):
    mism, err = compare(got, want, mask)
    assert mism == 0 and err <= ATOL, (mism, err)


def reset_launches():
    for m in KERNELS.values():
        m.LAUNCHES = 0


def launched() -> dict:
    """Every kernel's launches since `reset_launches`, those not 0."""
    return {k: m.LAUNCHES for k, m in KERNELS.items() if m.LAUNCHES}


def camera_launches(spp, trainable):
    """One camera kernel a sample, none where a camera field trains (the
    torch chain makes those rays)."""
    return 0 if any(t.startswith("cam_") for t in trainable) else spp


def call_launches(scene, cfg, spp, trainable=(), frames=0) -> dict:
    """Kernel launches of one frame of `spp` samples on the hand-written
    route (with `trainable`, of one protocol step): each sample runs every
    kernel of its route once a bounce, B3 once a bounce in the backward,
    B4 once a sample where tex_data trains and the atlas has texel rows;
    the finish once for each of `frames` images made (`renderer.render`);
    the camera once a sample. Kernels not launched are left out."""
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


def rowsum_launches(scene, trainable, spp) -> int:
    """Row sums of one step on the general backward or the plain autodiff
    route: mat_mb twice in `_geo_packs`, the sphere, quad and material rows
    once each, the mesh vertices of the three corners, where they require
    grad. The geometry's rows reach the loss on the last bounce only
    through the direct light of a lit scene, the material rows on every
    bounce (emission)."""
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


def general_launches(scene, cfg, spp, trainable) -> dict:
    """Kernel launches of one step of `spp` samples on the general backward
    (custom_vjp="on" outside the hand-written class) or the plain autodiff
    route (custom_vjp="off"): B1, B5 on mesh scenes and B6 on lit ones once
    a bounce; B2 once a bounce on the fused record forward (not on the
    plain autodiff route); no B3; B4 once a sample where tex_data trains
    (not on the plain autodiff route); the row sums; the camera once a
    sample. Kernels not launched are left out."""
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


def host_syncs(fn):
    """(count, {file:line: count}) of the host synchronisations one call of
    `fn` makes, from torch's sync debug mode."""
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


def protocol_grads(scene, cam, cfg, spp, trainable):
    """The bench.py protocol loss and its gradients at W x H, by
    `bench.protocol_step` (seed 0): a graph on the card where the route
    compiles, replayed from the second call with the same inputs."""
    pid = torch.arange(W * H, dtype=torch.int32, device=cam.position.device)
    _, loss, grads = bench.protocol_step(
        bench.Inputs(scene, cam, cfg, W, H, pid, spp), tuple(trainable))
    return loss, grads


def assert_grads_close(got, want, trainable):
    """Each field's max |got - want| within GRAD_RTOL of max |want|."""
    for k in trainable:
        scale = float(want[k].abs().max())
        diff = float((got[k] - want[k]).abs().max())
        rel = diff / scale if scale > 0 else diff
        assert rel <= GRAD_RTOL, (k, rel)


def graph_check(compiled, eager, want_launches=None, captures=1):
    """One compiled entry point against its eager body: the first call
    (with `captures=0` a replay of a graph of the same shapes already
    cached), a replay and the eager body all bit-equal; the launches of
    the replay and of the eager call equal (and `want_launches`, where
    given), the path's kernels having run; no host synchronisation in the
    replay. Returns (host syncs of the replay, of the eager call)."""
    cache = graphs.CACHE
    n0 = cache.captures
    first = compiled()
    g = cache.graphs()[-1]   # the graph last captured or replayed
    assert cache.captures == n0 + captures
    replays0 = g.replays
    out = {}

    def run(name, fn):
        def call():
            out[name] = fn()
        reset_launches()
        syncs, where = host_syncs(call)
        return launched(), syncs, where

    launches, syncs, where = run("replay", compiled)
    assert g.replays == replays0 + 1 and cache.captures == n0 + captures
    with cache.disabled():
        eager_launches, syncs_eager, _ = run("eager", eager)
    assert launches and launches == eager_launches, (launches,
                                                     eager_launches)
    if want_launches is not None:
        assert launches == want_launches, (launches, want_launches)
    assert all_bit_equal(first, out["eager"])
    assert all_bit_equal(out["replay"], out["eager"])
    assert syncs == 0, where
    return syncs, syncs_eager


def train_start(scene, cam, trainable, offsets, seed):
    """(scene, camera) with each trainable field moved by a seeded normal
    offset of scale offsets[name]."""
    gen = torch.Generator().manual_seed(seed)
    pert = {}
    for k, v in sorted(T.split_params(scene, cam, trainable).items()):
        noise = torch.randn(tuple(v.shape), generator=gen).to(v.device)
        pert[k] = v.detach() + offsets[k] * noise
    return T.apply_params(scene, cam, pert)


def train_target(scene, cam, cfg, trainable, spp):
    pid = torch.arange(W * H, dtype=torch.int32, device=cam.position.device)
    with torch.no_grad():
        return renderer.render_pixels(scene, cam, T.guard_config(
            cfg, trainable), W, H, pid, spp, cfg.seed) / spp


def ckpt_leaves(path) -> dict:
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def leaves_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]) for f in a)


def fit_check(tmp, scene, cam, cfg, trainable, offsets, lr, want, mesh=None,
              steps=4):
    """`train.fit` for `steps` steps from a seeded start, compiled (a graph
    captured at the first step, replayed from the second) against eager,
    and a compiled run of `steps` - 2 steps resumed to `steps`; with
    `mesh`, also the unsharded `fit()` compiled. Every run's losses, grad
    norms, params and checkpointed Adam state bit-equal to the compiled
    one's; one capture a compiled run, none eager; the launches of the
    compiled run equal to the eager run's and to `want` a step. Then a
    kept compiled step (`make_step`) on new leaves of the same shapes
    replays with no capture and no host synchronisation."""
    cache = graphs.CACHE
    target = train_target(scene, cam, cfg, trainable, cfg.nsamples)
    s0, c0 = train_start(scene, cam, trainable, offsets, seed=1)
    kw = dict(trainable=trainable, lr=lr, width=W, height=H,
              nsamples=cfg.nsamples, ckpt_every=steps, seed=cfg.seed)
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
                      ckpt_leaves(os.path.join(d, "train.npz")), launched(),
                      cache.captures - n0)
    pa, ha, la, na, capa = runs["compiled"]
    assert na == runs["eager"][3] == {k: v * steps for k, v in want.items()}
    assert (capa, runs["eager"][4]) == (1, 0)
    for name in names[1:]:
        pb, hb, lb, _, _ = runs[name]
        assert [(h["loss"], h["grad_norm"]) for h in hb] == [
            (h["loss"], h["grad_norm"]) for h in ha][-len(hb):], name
        assert all(bit_equal(pa[k].detach(), pb[k].detach())
                   for k in trainable), name
        assert leaves_equal(la, lb), name
    params = T.split_params(s0, c0, trainable)
    step = T.make_step(
        T._adam_default(lr)([params[k] for k in sorted(params)]),
        T.guard_config(cfg, trainable), target, W, H, cfg.nsamples, mesh)
    pid = torch.arange(W * H, dtype=torch.int32, device=cam.position.device)

    def call():
        return step(params, s0, c0, pid, cfg.seed)

    n0 = cache.captures
    call()
    g = cache.graphs()[-1]   # the graph the kept step replayed
    replays0 = g.replays
    call()
    syncs, where = host_syncs(call)
    assert syncs == 0, where
    assert g.replays == replays0 + 2 and cache.captures == n0
