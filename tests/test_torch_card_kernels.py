"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the flagship shapes (850x480 lanes), each on its own inputs.

- B1 (`first_hits`) and B2 (`shade_scatter`) bounce by bounce: camera
  rays, then the rays the plain path scatters from them, all six bounces
  of both Cornell boxes, bounces 0 and 1 of the mesh scenes (B1 with the
  meshes' hits, B2 with mesh and light inputs), B2 under both compat modes
  and on the last bounce; the record variants of the backward's forward
  (B1 `tex_out=2`, B2 `rec_out`).
- B3 (`bounce_bwd`): the adjoint per lane, its row-cotangent tables per
  entry and two runs' bits, at the last bounce and bounce 0, both compat
  modes; on the flat box also with the tables in global scratch.
- The one-hot accumulation runs in full f32 under a caller's TF32.
- B4 (`sorted_fold`) on the real update stream of a textured sample and on
  the streams that bound its contract.
- B5 (`traverse`) and B6 (`shadow`): results exact on every lane.
- The scenes the first port's fixed limits refused: each kernel's tables
  in the place the case is there to exercise.
- B1's sphere-UV index and B2's image sky: 0 discrete mismatches, but for
  ties where B1's texture coordinates differ by at most an ulp.
- The row-sum kernel against `index_add_` and float64 sums, on the row
  sums the general and plain autodiff steps make, at each table shape.
- The finish kernel on the Cornell frame's film (`test_torch_finish.py`
  holds it on a film of special values; `test_torch_camera.py` holds the
  camera kernel).

Tolerances: `tests/card.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.card import (  # noqa: F401  (fixtures)
    ATOL, BOUNCES, BWD_RTOL, FOLD_RTOL, H, SPP, W, assert_same_record,
    bit_equal, bits, card, compare, memo, protocol_grads, scene)
from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import finish as kfinish
from tracer_torch.kernels import fold as kfold
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import rowsum as krowsum
from tracer_torch.kernels import shade as kshade
from tracer_torch.kernels import shade_bwd as kbwd
from tracer_torch.kernels import shadow as kshadow
from tracer_torch.kernels import traverse as ktraverse
from tracer_torch.render import graphs, integrator, renderer, replay_bwd
from tracer_torch.render.camera import default_camera
from tracer_torch.render.film import to_image

pytestmark = pytest.mark.card

LARGE_M = 400       # unused material rows that push B3's tables to global


def camera_rays(device):
    """Sample 0's camera rays of the default camera at W x H, and their
    keys."""
    cam = default_camera(W / H, device=device)
    pid = torch.arange(W * H, dtype=torch.int32, device=device)
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
    return integrator._init_state(o, d, tm), keys


def test_textured_box_builds_a_pair_atlas(scene):
    s = scene("cornell_textured")
    assert s.pair_mode and s.pair_pack.shape[0] > 1


# --- B1 and B2, bounce by bounce ---------------------------------------------

def b12_chain(sc, n):
    """The inputs of bounces 0..n-1: for each, the state, the bounce's
    keys, the meshes' raw hits (B5) and the plain first hits; the next
    state is the plain B2's (reference compat)."""
    tables = integrator.prepare(sc)
    state, keys = camera_rays(sc.sph_center.device)
    use_pair = sc.pair_pack.shape[0] > 1
    cfg = RenderConfig(compat="reference")
    out = []
    for b in range(n):
        bkeys = rng.salted(keys, b)
        mesh_in = {}
        if sc.mesh_mat.shape[0] > 0:
            t_raw, tri_raw = ktraverse.mesh_closest_hits(
                sc, state["o"], state["d"], state["active"],
                tables=tables.tree)
            mesh_in = dict(t_mesh=t_raw, tri_mesh=tri_raw, mesh=tables.mesh)
        args = (sc, state["o"], state["d"], state["time"], state["active"],
                1e-5, int(use_pair))
        k1p = kintersect.first_hits(*args, kernels="off",
                                    tables=tables.intersect, **mesh_in)
        out.append(dict(tables=tables, state=state, bkeys=bkeys, args=args,
                        mesh_in=mesh_in, k1p=k1p, use_pair=use_pair))
        state = b2(sc, cfg, out[-1], b, False, "off",
                   b12_shadows(sc, cfg, out[-1]))
    return out


def b12_shadows(sc, cfg, x):
    live = x["state"]["active"]
    return integrator._shadow_factors_all(
        sc, cfg, x["k1p"]["p"], x["state"]["time"], x["bkeys"],
        live & (x["k1p"]["j"] >= 0), x["tables"])


def b2(sc, cfg, x, b, last, mode, shadows):
    tables = x["tables"]
    return kshade.shade_scatter(
        sc, cfg, integrator.copy_state(x["state"]), x["bkeys"], x["k1p"],
        BOUNCES - b, shadows=shadows, use_pair=x["use_pair"], last=last,
        kernels=mode, tables=tables.shade, mesh=tables.mesh,
        quad=tables.intersect[1])


B12 = ([("cornell", b) for b in range(BOUNCES)]
       + [("cornell_textured", b) for b in range(BOUNCES)]
       + [(n, b) for n in ("flamingo_standin", "flamingo_pond_standin")
          for b in (0, 1)])


def b12_inputs(scene, memo, name, b):
    n = BOUNCES if name.startswith("cornell") else 2
    return memo(("b12", name), lambda: b12_chain(scene(name), n))[b]


@pytest.mark.parametrize("name,b", B12)
def test_b1_bounce(scene, memo, name, b):
    x = b12_inputs(scene, memo, name, b)
    got = kintersect.first_hits(*x["args"], kernels="auto",
                                tables=x["tables"].intersect, **x["mesh_in"])
    assert_same_record(got, x["k1p"], x["state"]["active"])


@pytest.mark.parametrize("compat,last", [("reference", False),
                                         ("reference", True),
                                         ("physical", False)])
@pytest.mark.parametrize("name,b", B12)
def test_b2_bounce(scene, memo, name, b, compat, last):
    sc = scene(name)
    x = b12_inputs(scene, memo, name, b)
    cfg = RenderConfig(compat=compat)
    shadows = b12_shadows(sc, cfg, x)
    got, want = (b2(sc, cfg, x, b, last, m, shadows) for m in ("auto", "off"))
    if last:
        got, want = dict(acc=got), dict(acc=want)
    # physical draws cos/sin, which may differ by an ulp
    assert_same_record(got, want)


# --- the record forward: B1 tex_out=2, B2 rec_out ----------------------------

def record_chain(sc):
    tables = integrator.prepare(sc)
    state, keys = camera_rays(sc.sph_center.device)
    out = []
    for b in (0, 1):
        x = dict(tables=tables, state=state, bkeys=rng.salted(keys, b))
        x["k1p"] = record_b1(sc, x, "off")
        out.append(x)
        state, _ = record_b2(sc, x, b, "off")
    return out


def record_b1(sc, x, mode):
    st = x["state"]
    return kintersect.first_hits(sc, st["o"], st["d"], st["time"],
                                 st["active"], 1e-5, 2, kernels=mode,
                                 tables=x["tables"].intersect)


def record_b2(sc, x, b, mode):
    return kshade.shade_scatter(
        sc, RenderConfig(), integrator.copy_state(x["state"]), x["bkeys"],
        x["k1p"], BOUNCES - b, use_pair=True, kernels=mode,
        tables=x["tables"].shade, rec_out=True,
        quad=x["tables"].intersect[1])


@pytest.mark.parametrize("b", [0, 1])
def test_b1_record_bounce(scene, memo, b):
    sc = scene("cornell_textured")
    x = memo("record", lambda: record_chain(sc))[b]
    live = x["state"]["active"]
    assert_same_record(record_b1(sc, x, "auto"), x["k1p"], live)
    assert int((x["k1p"]["idx_t"][live] > 0).sum()) > 0, "no atlas reads"


@pytest.mark.parametrize("b", [0, 1])
def test_b2_record_bounce(scene, memo, b):
    sc = scene("cornell_textured")
    x = memo("record", lambda: record_chain(sc))[b]
    (got, grec), (want, wrec) = (record_b2(sc, x, b, m)
                                 for m in ("auto", "off"))
    assert_same_record(dict(got, rec=grec), dict(want, rec=wrec))


# --- B3, the bounce adjoint --------------------------------------------------

def record_sample(sc, cfg):
    """One recorded 850x480 sample (kernels on): the backward's inputs."""
    cam = default_camera(W / H, device=sc.sph_center.device)
    pid = torch.arange(W * H, dtype=torch.int32, device=sc.sph_center.device)
    with torch.no_grad():
        o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 0, 0)
        _, rec, states = integrator._trace_loop(
            sc, cfg, o, d, tm, keys, integrator.prepare(sc), with_rec=True)
    return tm, keys, rec, states


B3 = ([("cornell", c, k) for c in ("reference", "physical")
       for k in ("last", "first")] + [("cornell", "reference", "large")]
      + [("cornell_textured", c, k) for c in ("reference", "physical")
         for k in ("last", "first")])


@pytest.mark.parametrize("name,compat,case", B3)
def test_b3_against_plain(card, scene, memo, name, compat, case):
    """Seeded next-state cotangents and running table; `large` pads the
    material table with LARGE_M unused rows, so that the warp tables no
    longer fit in shared memory and live in global scratch."""
    sc = scene(name)
    cfg = RenderConfig(compat=compat, max_bounces=BOUNCES)
    tm, keys, rec, states = memo(("record_sample", name, compat),
                                 lambda: record_sample(sc, cfg))
    tabs = kbwd.bwd_tables(sc)
    if case == "large":
        tabs = (tabs[0], tabs[1], torch.cat(
            [tabs[2], tabs[2][-1:].expand(LARGE_M, -1)]))
    S, Q = sc.sph_center.shape[0], sc.quad_v0.shape[0]
    has_pair = sc.pair_pack.shape[0] > 1
    b = BOUNCES - 1 if case == "last" else 0
    last = b == BOUNCES - 1
    N = W * H
    gen = torch.Generator(device=card).manual_seed(5)
    gnext = None if last else torch.randn((10, N), generator=gen,
                                          device=card)
    gpix = torch.randn((3, N), generator=gen, device=card)
    acc = torch.randn((kbwd.table_size(S, Q, tabs[2].shape[0]),),
                      generator=gen, device=card)
    st10 = states[b]
    args = (st10, rec[b][0][0], rec[b][1], tabs, rng.salted(keys, b), tm,
            gnext, gpix, acc, float(BOUNCES - b), float(sc.dark_sky))
    kw = dict(S=S, Q=Q, ref=compat == "reference", eps=cfg.epsilon,
              has_pair=has_pair, last=last)

    def run(mode):
        return kbwd.bounce_bwd_tiles(*args, kernels=mode, **kw)

    got, want = run("auto"), run("off")
    assert all(bit_equal(g, h) for g, h in zip(got, run("auto"))), \
        "two runs differ"
    dead = st10[9] < 0.5
    for g, w in zip(got[:2], want[:2]):
        if w is None:
            continue
        assert bool(torch.isfinite(g).all())
        assert int((g[:, dead] != w[:, dead]).sum()) == 0, "pass-through"
        rel = (g - w).abs() / torch.clamp_min(w.abs(), 1.0)
        assert float(rel.max()) <= BWD_RTOL
    scale = float(want[2].abs().max())
    assert float((got[2] - want[2]).abs().max()) <= FOLD_RTOL * scale


def test_onehot_accumulation_ignores_a_callers_tf32(card):
    """Rows of 1 + 2**-13 (exact in f32, 1 in TF32) summed 256 to a column
    give 256 + 2**-5, exact in f32 in any summation order; the caller's
    setting is left as it was."""
    rows = torch.full((45, 4096), 1.0 + 2.0 ** -13, device=card)
    idx = torch.arange(4096, device=card) % 16
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = replay_bwd._onehot_accum(torch.zeros((45, 16), device=card),
                                       idx, rows)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert float((got - (256.0 + 2.0 ** -5)).abs().max()) == 0.0


# --- B4, the texel fold ------------------------------------------------------

def fold_streams(card, sc):
    """The real update stream of one textured sample (bounces 0..4 of
    850x480: 2.04M updates, one row per bounce, as the backward passes
    them) and the streams that bound the fold's contract: all zeros,
    skewed, one NaN and one inf, empty, a texel and update count that is a
    multiple of no tile or chunk, atlases small enough for one and two
    radix passes, and more rows than the kernel reads in place."""
    cfg = RenderConfig(max_bounces=BOUNCES)
    tm, keys, rec, states = record_sample(sc, cfg)
    N = W * H
    g = torch.full((N, 3), 1.0 / (3 * N * SPP), device=card)
    with torch.no_grad():
        _, _, _, _, gtex = replay_bwd.replay_backward(
            sc, cfg, tm, keys, rec, states, g,
            integrator.host_constants(sc).dark_sky)
    idxs = [r[0][2] for r in rec[:-1]]
    gs = [tuple(t[0:3]) for t in gtex]
    data = torch.zeros_like(sc.tex_data)
    idx = torch.cat(idxs)
    M = idx.numel()
    gen = torch.Generator(device=card).manual_seed(1)
    hot = idx.clone()
    hot[: M // 2] = torch.randint(0, 5, (M // 2,), device=card,
                                  generator=gen, dtype=hot.dtype)
    bad_g = [tuple(c.clone() for c in t) for t in gs]
    bad_g[1][0][N // 3] = float("nan")
    bad_g[3][2][N // 5] = float("inf")
    zero_g = [tuple(torch.zeros_like(c) for c in t) for t in gs]
    Po, Mo = 1_000_003, 1_234_567           # prime, and no tile's multiple
    odd = dict(
        ix=[torch.randint(0, Po, (Mo,), device=card, generator=gen,
                          dtype=torch.int32)],
        gg=[tuple(torch.randn((Mo,), device=card, generator=gen)
                  for _ in range(3))],
        d=torch.randn((Po, 3), device=card, generator=gen))
    cases = dict(real={}, all_zero=dict(gg=zero_g),
                 skewed=dict(ix=list(hot.split(N))), nan_inf=dict(gg=bad_g),
                 empty=dict(
                     ix=[torch.zeros((0,), dtype=torch.int32, device=card)],
                     gg=[tuple(torch.zeros((0,), device=card)
                               for _ in range(3))]),
                 odd_sizes=odd)
    # ids below 2^8 and 2^16 sort in fewer radix passes, and more segments
    # than the kernel reads in place are joined first
    for name, Ps, ns, rows in (("one_pass", 200, 50_000, 1),
                               ("two_passes", 40_000, 300_000, 2),
                               ("many_segments", 5_000, 1_000, 20)):
        cases[name] = dict(
            ix=[torch.randint(0, Ps, (ns,), device=card, generator=gen,
                              dtype=torch.int32) for _ in range(rows)],
            gg=[tuple(torch.randn((ns,), device=card, generator=gen)
                      for _ in range(3)) for _ in range(rows)],
            d=torch.randn((Ps, 3), device=card, generator=gen))
    return {k: dict(dict(ix=idxs, gg=gs, d=data), **v)
            for k, v in cases.items()}


FOLD_CASES = ("real", "all_zero", "skewed", "nan_inf", "empty", "odd_sizes",
              "one_pass", "two_passes", "many_segments")


@pytest.mark.parametrize("case", FOLD_CASES)
def test_b4_against_plain(card, scene, memo, case):
    """NaN and inf where the plain fold has them, the rest within
    FOLD_RTOL (summation order); two runs give the same bits."""
    kw = memo("fold", lambda: fold_streams(
        card, scene("cornell_textured")))[case]

    def run(mode):
        return kfold.fold_updates(kw["d"], kw["ix"], kw["gg"], kernels=mode)

    got, want = run("auto"), run("off")
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[want.isinf()], want[want.isinf()])
    fin = torch.isfinite(want)
    g, w = got[fin], want[fin]
    scale = float(w.abs().max()) if w.numel() else 0.0
    bad = (g - w).abs() > FOLD_RTOL * w.abs() + FOLD_RTOL * scale
    assert not bool(bad.any()), int(bad.sum())
    assert bit_equal(got, run("auto")), "two runs differ"
    if case == "real":
        assert scale != 0.0, "the real stream is all zero"
    if case in ("all_zero", "empty"):
        assert torch.equal(got, kw["d"])


# --- B5 and B6 on every lane -------------------------------------------------

def lanes(sc):
    """The inputs of B5 and B6: the camera rays of one sample (bounce 0)
    and the rays the kernel path scatters from them (bounce 1), each with
    its first-hit record and keys."""
    tables = integrator.prepare(sc)
    state, keys = camera_rays(sc.sph_center.device)
    cfg = RenderConfig()
    out = []
    for b in (0, 1):
        t_raw = tri_raw = None
        if sc.mesh_mat.shape[0] > 0:
            t_raw, tri_raw = ktraverse.mesh_closest_hits(
                sc, state["o"], state["d"], state["active"],
                tables=tables.tree)
        k1 = kintersect.first_hits(
            sc, state["o"], state["d"], state["time"], state["active"],
            tables=tables.intersect, t_mesh=t_raw, tri_mesh=tri_raw,
            mesh=tables.mesh)
        # the bounce updates its state in place: keep a copy of its input
        out.append((tables, integrator.copy_state(state), k1,
                    rng.salted(keys, b)))
        state, _ = integrator._bounce_core(sc, cfg, keys, state, b,
                                           tables=tables)
    return out


@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("name", ["flamingo_standin",
                                  "flamingo_pond_standin"])
def test_b5_against_plain(scene, memo, name, b):
    sc = scene(name)
    tables, state, _, _ = memo(("lanes", name), lambda: lanes(sc))[b]

    def run(mode):
        return ktraverse.mesh_closest_hits(sc, state["o"], state["d"],
                                           state["active"], kernels=mode,
                                           tables=tables.tree)

    (t_k, tri_k), (t_p, tri_p) = run("auto"), run("off")
    assert int(((t_k != t_p) | (tri_k != tri_p)).sum()) == 0


def transparent_flamingo(sc):
    """flamingo_standin with a half-transparent mesh: the shadow kernel
    skips the walk of a sample whose draw for the mesh is at most its
    transparency."""
    transp = sc.mat_transparency.clone()
    transp[sc.mesh_mat.long()] = 0.5
    return dataclasses.replace(sc, mat_transparency=transp)


@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("name", [
    "random_spheres", "flamingo_standin", "flamingo_pond_standin",
    "flamingo_standin_transparent_mesh"])
def test_b6_against_plain(scene, memo, name, b, compat):
    if name == "flamingo_standin_transparent_mesh":
        sc = memo(name, lambda: transparent_flamingo(
            scene("flamingo_standin")))
    else:
        sc = scene(name)
    tables, state, k1, bkeys = memo(("lanes", name), lambda: lanes(sc))[b]
    live = state["active"] & (k1["j"] >= 0)
    cfg = RenderConfig(compat=compat)
    got, want = (kshadow.shadow_factors(
        sc, cfg, k1["p"], state["time"], bkeys, cfg.epsilon, live,
        kernels=m, tables=tables.shadow, tree=tables.tree)
        for m in ("auto", "off"))
    assert int((got != want).sum()) == 0


# --- the scenes the fixed limits refused -------------------------------------

SH, L2 = "shared", "global"
# where (B1, B6, B2) put their tables: walls of quads whose tables outgrow
# a block's 227 KB of shared memory kernel by kernel (B1 at ~1,200 quads,
# B2 at ~2,000: tiled_wall gives each quad a material row; B6 at ~2,900);
# 17 meshes, one more than B5 keeps roots of in shared memory
LIMITS = dict(tiled_wall_700=(SH, SH, SH), tiled_wall_1300=(L2, SH, SH),
              tiled_wall_3000=(L2, L2, L2), mesh_grid_17=(SH, SH, SH))


def limits_chain(sc):
    """Bounces 0 and 1 of one sample on the plain path: each bounce's
    state, keys, B5, B1, B6 and B2 results."""
    tables = integrator.prepare(sc)
    state, keys = camera_rays(sc.sph_center.device)
    cfg = RenderConfig()
    out = []
    for b in (0, 1):
        x = dict(tables=tables, state=state, bkeys=rng.salted(keys, b),
                 cfg=cfg, b=b, mesh_in={})
        if sc.mesh_mat.shape[0] > 0:
            x["walk"] = limits_walk(sc, x, "off")
            x["mesh_in"] = dict(t_mesh=x["walk"][0], tri_mesh=x["walk"][1],
                                mesh=tables.mesh)
        x["k1p"] = limits_b1(sc, x, "off")
        x["hit"] = state["active"] & (x["k1p"]["j"] >= 0)
        x["shadow"] = limits_b6(sc, x, "off")
        x["next"] = limits_b2(sc, x, "off")
        out.append(x)
        state = x["next"]
    return out


def limits_walk(sc, x, mode):
    st = x["state"]
    return ktraverse.mesh_closest_hits(sc, st["o"], st["d"], st["active"],
                                       kernels=mode, tables=x["tables"].tree)


def limits_b1(sc, x, mode):
    st = x["state"]
    return kintersect.first_hits(sc, st["o"], st["d"], st["time"],
                                 st["active"], kernels=mode,
                                 tables=x["tables"].intersect, **x["mesh_in"])


def limits_b6(sc, x, mode):
    cfg = x["cfg"]
    return kshadow.shadow_factors(
        sc, cfg, x["k1p"]["p"], x["state"]["time"], x["bkeys"], cfg.epsilon,
        x["hit"], kernels=mode, tables=x["tables"].shadow,
        tree=x["tables"].tree)


def limits_b2(sc, x, mode):
    t = x["tables"]
    return kshade.shade_scatter(
        sc, x["cfg"], integrator.copy_state(x["state"]), x["bkeys"], x["k1p"],
        BOUNCES - x["b"], shadows=x["shadow"], kernels=mode, tables=t.shade,
        mesh=t.mesh, quad=t.intersect[1])


@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("name", list(LIMITS))
def test_limits_against_plain(scene, memo, name, b):
    """B5 (mesh scenes), B1, B6 and B2 against their plain versions, and
    the place each kernel's tables took: dynamic shared memory or, beyond
    a block's 227 KB, L2."""
    sc = scene(name)
    x = memo(("limits", name), lambda: limits_chain(sc))[b]
    live = x["state"]["active"]
    Nm = sc.mesh_mat.shape[0]
    if Nm > 0:
        t_k, tri_k = limits_walk(sc, x, "auto")
        t_p, tri_p = x["walk"]
        assert int(((t_k != t_p) | (tri_k != tri_p)).sum()) == 0
    assert_same_record(limits_b1(sc, x, "auto"), x["k1p"], live)
    b1_tables = kintersect.TABLES
    if Nm > ktraverse.ROOT_CACHE:
        # lanes won by a mesh whose root B5 reads through L1
        S, Q = sc.sph_center.shape[0], sc.quad_v0.shape[0]
        assert int((x["k1p"]["j"][live] >= S + Q + ktraverse.ROOT_CACHE)
                   .sum()) > 0
    assert int((limits_b6(sc, x, "auto") != x["shadow"]).sum()) == 0
    b6_tables = kshadow.TABLES
    assert_same_record(limits_b2(sc, x, "auto"), x["next"])
    assert (b1_tables, b6_tables, kshade.TABLES) == LIMITS[name]


# --- B1's sphere-UV index and B2's image sky ---------------------------------

def sky_chain(sc):
    tables = integrator.prepare(sc)
    state, keys = camera_rays(sc.sph_center.device)
    out = []
    for b in (0, 1):
        x = dict(tables=tables, state=state, bkeys=rng.salted(keys, b))
        x["k1p"] = sky_b1(sc, x, 2, "off")
        out.append(x)
        cfg = RenderConfig(compat="reference")
        state = sky_b2(sc, x, b, cfg, sky_shadows(sc, x, cfg), False, "off")
    return out


def sky_b1(sc, x, tex_out, mode):
    st, t = x["state"], x["tables"]
    return kintersect.first_hits(
        sc, st["o"], st["d"], st["time"], st["active"], 1e-5, tex_out,
        kernels=mode, tables=t.intersect, slim=True, sphere_tex=t.sphere_tex)


def sky_shadows(sc, x, cfg):
    return integrator._shadow_factors_all(
        sc, cfg, x["k1p"]["p"], x["state"]["time"], x["bkeys"],
        x["state"]["active"] & (x["k1p"]["j"] >= 0), x["tables"])


def sky_b2(sc, x, b, cfg, shadows, rec_out, mode):
    t = x["tables"]
    return kshade.shade_scatter(
        sc, cfg, integrator.copy_state(x["state"]), x["bkeys"], x["k1p"],
        BOUNCES - b, shadows=shadows, use_pair=True, kernels=mode,
        tables=t.shade, quad=t.intersect[1], rec_out=rec_out,
        mat_pair=t.mat_pair)


def sky_inputs(scene, memo, b):
    sc = scene("rt_weekend_standin")
    t = integrator.prepare(sc)
    assert t.sphere_tex is not None and t.mat_pair is not None
    assert sc.has_sky_image
    return sc, memo("sky", lambda: sky_chain(sc))[b]


@pytest.mark.parametrize("tex_out", [1, 2])
@pytest.mark.parametrize("b", [0, 1])
def test_b1_sphere_uv(scene, memo, b, tex_out):
    """The plain version takes acos and atan2 from torch's CUDA math, the
    kernel from the same library built with --fmad=false: a discrete
    mismatch stands only where both of B1's texture coordinates are
    within an ulp of the plain version's."""
    sc, x = sky_inputs(scene, memo, b)
    live = x["state"]["active"]
    k1, k1p = sky_b1(sc, x, tex_out, "auto"), sky_b1(sc, x, tex_out, "off")
    mism, err = compare(k1, k1p, live)
    if mism:
        eps = torch.finfo(torch.float32).eps
        moved = (k1["u"] != k1p["u"]) | (k1["v"] != k1p["v"])
        one = (((k1["u"] - k1p["u"]).abs() <= eps * k1p["u"].abs())
               & ((k1["v"] - k1p["v"]).abs() <= eps * k1p["v"].abs()))
        bad = torch.zeros_like(live)
        for key in ("j", "tid", "mid", "row", "sub", "idx_t", "idx_n"):
            if key in k1:
                bad |= live & (k1[key] != k1p[key])
        assert not bool((bad & ~(moved & one)).any()), \
            f"{mism} discrete mismatches not explained by an ulp of u, v"
    assert err <= ATOL


@pytest.mark.parametrize("rec_out", [False, True])
@pytest.mark.parametrize("compat", ["reference", "physical"])
@pytest.mark.parametrize("b", [0, 1])
def test_b2_image_sky(scene, memo, b, compat, rec_out):
    sc, x = sky_inputs(scene, memo, b)
    cfg = RenderConfig(compat=compat)
    shadows = sky_shadows(sc, x, cfg)
    got, want = (sky_b2(sc, x, b, cfg, shadows, rec_out, m)
                 for m in ("auto", "off"))
    if rec_out:
        got, want = dict(got[0], rec=got[1]), dict(want[0], rec=want[1])
    assert_same_record(got, want)


# --- the row sums ------------------------------------------------------------

def captured_row_sums(sc, cfg, trainable, monkeypatch):
    """The row sums of one 1-spp protocol step, as its backward made them:
    {(rows, columns): (idx, g)}, of each table shape the call with the
    largest cotangent (then the most lanes)."""
    cam = default_camera(W / H, device=sc.sph_center.device)
    calls, score = {}, {}
    real = krowsum.row_sum

    def spy(idx, g, rows, kernels="auto"):
        key = (rows, g.shape[1])
        sc_ = (float(g.abs().max()) if g.numel() else 0.0, idx.numel())
        if key not in calls or sc_ > score[key]:
            calls[key], score[key] = (idx.clone(), g.clone()), sc_
        return real(idx, g, rows, kernels)

    with monkeypatch.context() as m, graphs.CACHE.disabled():
        m.setattr(krowsum, "row_sum", spy)
        protocol_grads(sc, cam, cfg, 1, trainable)
    return calls


def assert_row_sums_bounded(got, want, idx, g):
    """The kernel's sums against the float64 sums of the same cotangents,
    each within its f32 summation error bound, depth * 2^-24 * (the sum
    of |g| over the row's lanes), depth a bound on the chain of f32
    additions a lane's cotangent passes through in the kernel
    (csrc/row_sum.cu: in each of its three scans PER in a thread, 5 in a
    warp's scan and the 8 warps before it; and the chunks' carries, one a
    chunk); the plain version's (`index_add_`, any order) within
    (lanes - 1) * 2^-24 * that sum."""
    li = idx.reshape(-1).long()
    g64 = g.double()
    exact = torch.zeros(want.shape, dtype=torch.float64,
                        device=g.device).index_add_(0, li, g64)
    absum = torch.zeros_like(exact).index_add_(0, li, g64.abs())
    lanes_ = torch.bincount(li, minlength=want.shape[0]).double()[:, None]
    nf = -(-idx.numel() // krowsum.CHUNK)
    depth = 3 * (krowsum.CHUNK // 256 + 5 + 8) + nf
    u = 2.0 ** -24
    bad_k = (got.double() - exact).abs() > depth * u * absum
    bad_p = (want.double() - exact).abs() > torch.clamp_min(
        lanes_ - 1, 0) * u * absum
    assert not bool(bad_k.any()), int(bad_k.sum())
    assert not bool(bad_p.any()), int(bad_p.sum())


ROWSUM_CASES = dict(
    rt_weekend_standin=(("mat_diffuse", "sph_center", "tex_data"), "on"),
    flamingo_standin=(("mesh_verts", "mat_diffuse", "sph_center"), "on"),
    tiled_wall_3000=(("quad_v0", "mat_diffuse"), "on"),
    # the plain autodiff route: the geometry's rows, the quads' normal
    # maps and the 1024^2 atlases get a gradient
    cornell_textured_lit=(("tex_data", "nm_data", "quad_v0", "sph_center",
                           "mat_mb"), "off"))


@pytest.mark.parametrize("name", list(ROWSUM_CASES))
def test_row_sums_against_plain(scene, name, monkeypatch):
    """Every table shape of the step's row sums: the kernel and
    `index_add_` within their f32 bounds of the float64 sums, and two
    kernel calls with the same bits."""
    trainable, custom_vjp = ROWSUM_CASES[name]
    cfg = RenderConfig(max_bounces=BOUNCES, custom_vjp=custom_vjp)
    calls = captured_row_sums(scene(name), cfg, trainable, monkeypatch)
    assert calls, "no row sum in the step"
    for (rows, cols), (idx, g) in sorted(calls.items()):
        got = krowsum.row_sum(idx, g, rows, kernels="auto")
        want = krowsum.row_sum(idx, g, rows, kernels="off")
        assert_row_sums_bounded(got, want, idx, g)
        assert bit_equal(got, krowsum.row_sum(idx, g, rows,
                                              kernels="auto")), (rows, cols)


# --- the finish on a rendered film -------------------------------------------

@pytest.mark.parametrize("gamma", [True, False])
def test_finish_on_the_cornell_film(scene, gamma):
    """The Cornell frame's 16-spp film: NaN exactly where numpy has NaN;
    elsewhere (zeros compared without their sign) within 2 ulp of numpy
    with gamma (CUDA's powf against numpy's float32 power), equal without
    it."""
    sc = scene("cornell")
    cam = default_camera(W / H, device=sc.sph_center.device)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=BOUNCES)
    pid = torch.arange(W * H, dtype=torch.int32, device=sc.sph_center.device)
    with torch.no_grad():
        film = renderer.render_frame(sc, cam, cfg, W, H, pid, SPP, cfg.seed)
    assert float((film == 0).float().mean()) > 0.0, "no zeros in the film"
    want = to_image(film.cpu().numpy() / np.float32(SPP), W * H, 1,
                    gamma).reshape(-1)
    got = kfinish.finish(film, SPP, gamma).cpu().numpy().reshape(-1)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    gap = np.abs(bits(got[~nan] + np.float32(0)).astype(np.int64)
                 - bits(want[~nan] + np.float32(0)).astype(np.int64))
    assert gap.max() <= (2 if gamma else 0), gap.max()
