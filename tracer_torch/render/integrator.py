"""The wavefront path-tracing integrator (the port of
`tracer/render/integrator.py`) and its record-replay gradient.

Two routes through a bounce, chosen as the JAX package chooses them
(`_fused`, after `tracer/render/integrator.py:774-777`):

- the fused bounce, for scenes without an atlas and for pair-atlas
  scenes under `packed_atlas != "off"`: up to four kernels, in this
  order: on mesh scenes the BVH walk `traverse.mesh_closest_hits`
  (closest raw hit per ray and mesh); `first_hits` (closest hit over
  spheres, quads and those mesh hits + winner detail + pair-atlas texel
  index, with the sphere-UV index on scenes with textured spheres); on
  lit scenes `shadow.shadow_factors` (the soft-shadow factor of every
  light at each live hit point); and `shade_scatter` (image or procedural
  sky, texels, emission, lighting, BSDF scatter, state update, in place:
  `trace` owns the bounce state's buffers, `_init_state` copies the
  caller's rays into them);
- the general bounce (`_bounce_general`: the JAX package's non-fused
  branch of `_bounce_core` with `_gather_hit_p`, `_mesh_detail_p`,
  `_direct_lighting_p` and `_scatter_p`) for the exact [P, 3] atlas
  (`packed_atlas="off"`, or an atlas without `pair_mode`): the BVH walk,
  `first_hits` (`tex_out=0`) and the shadow kernel, then the rest of the
  bounce in torch ops, as the JAX package does it in XLA. The shade
  kernel does not run there, in the JAX package either. With a record
  (`saved`) the same function is the differentiable replay.

Rays and hit points go to the walk and the shadow kernels in ray order:
the JAX package's sorted queues (`cfg.ray_sort`) let a TPU packet share
one walk, but each GPU thread walks its own ray, and on the H100 the
sorted dispatch cost more than it saved (PERF.md, section 6), so
`ray_sort` has no effect in the port.
`lax.scan` over bounces becomes a Python loop with the final bounce
specialised the same way: it writes only `acc`, and it skips the texture
fetch when the scene has no lights and no emissive TEX_IMAGE material
(then the fetched texel provably reaches no output).

Gradients: when an input of `trace` requires grad, `trace` runs the
record forward (`_trace_loop(with_rec=True)`: each bounce's discrete
selections, texels and shadow factors, and for the hand-written class
its input state) inside `_TraceRecordReplay`, a `torch.autograd.Function`.
Its backward is the hand-written reverse sweep of `render/replay_bwd.py`
on the bounce-adjoint kernel for the Cornell class (`hand_bwd_ok`), and
for every other scene the vector-Jacobian product of the replay
(`_trace_replay`) by `torch.autograd.grad`, as `jax.vjp` gives it in the
JAX package; both end in the texel fold (`kernels/fold.py`) onto
`tex_data` / `nm_data`. Without grad it keeps the plain forward, which
records nothing.

The plain autodiff backward (`_trace_scan`, the JAX package's path for
`custom_vjp="off"` and for `with_aux=True` under grad): every bounce is
the general bounce under autograd, with the kernels (B5, B1, B6) supplying
only the discrete selections (`_Picks`: the winner, the triangle, the
shadow factors), the hit re-derived in torch ops and the atlases read
exactly; each bounce but the last is rematerialized in the backward
(`torch.utils.checkpoint`, as `jax.checkpoint` in the JAX package), with
the selections kept, so the kernels run once a bounce. Its gradient is
the exact one: the JAX package's kernel route truncates there at its
stop-gradient'ed Pallas inputs.

Every reference quirk of compat="reference" is replicated (see the JAX
module's docstring); compat="physical" fixes them.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from tracer_torch.core import rng
from tracer_torch.core import vec3p as vp
from tracer_torch.core.config import RenderConfig
from tracer_torch.core.mathutils import schlick_reflectance
from tracer_torch.geometry import primitives as prim
from tracer_torch.kernels import fold as kfold
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import rowsum as krowsum
from tracer_torch.kernels import shade as kshade
from tracer_torch.kernels import shadow as kshadow
from tracer_torch.kernels import traverse as ktraverse
from tracer_torch.render import replay_bwd
from tracer_torch.render import shading

DIFFUSE, GLASS, MIRROR = 0, 1, 2


def _no_atlas(scene) -> bool:
    return scene.tex_data.shape[0] <= 1 and scene.nm_data.shape[0] <= 1


def _fused(scene, cfg: RenderConfig) -> bool:
    """Whether a forward bounce takes the fused route: the JAX package's
    `fused = kernels_on and ((pair_mode and packed_on) or no_atlas)`, with
    the port's kernels always on the route (a CPU tensor takes their plain
    versions, `RenderConfig.kernels`). A pair atlas of one row (at most 16
    texel pairs) takes the general route: the fused bounce fetches pair
    texels only from packs of more than one row (one row is the sentinel
    of `train.invalidate_packs`), so there it would drop the texels. (The
    JAX package's kernel route has that fault; its CPU path, with the
    kernels off, takes the general route.)"""
    packed_on = cfg.packed_atlas != "off"
    pair_ok = scene.pair_mode and scene.pair_pack.shape[0] > 1
    return (pair_ok and packed_on) or _no_atlas(scene)


class HostConstants(NamedTuple):
    """What a frame reads from the card to the host: `dark_sky` (the shade
    kernel's and the sweep's `dark` argument) and an image sky's (W, H).
    `host_constants` reads them once, before a frame or a capture, into
    the frame's tables (`prepare`); a captured frame bakes them into its
    kernels' arguments, so they enter the graph's key by value
    (`render/graphs.py`)."""
    dark_sky: float
    sky_wh: Optional[tuple]


# the memos of `host_constants` and `prepare`: (the stamps of the tensors a
# value was made from, the value) by key, for the last _MEMO_SCENES
# scenes, least recently used first out; a scene whose tensors were not
# written since keeps its values, also where a few scenes take turns
_HOST_MEMO: "collections.OrderedDict" = collections.OrderedDict()
_TABLE_MEMO: "collections.OrderedDict" = collections.OrderedDict()
_MEMO_SCENES = 8
TABLE_BUILDS = 0   # `prepare` calls that built the frame's tables
TABLE_REUSES = 0   # `prepare` calls that returned the tables last built


def _memoised(memo, key, ts, make):
    """(`make()` memoised in `memo` under `key`, whether it was a hit): a
    hit while each tensor of `ts` is the tensor it was made from (a weak
    reference, so a freed tensor's id taken again misses) at the version it
    had then (`_version`, which every in-place op bumps)."""
    hit = memo.get(key)
    if hit is not None and all(r() is t and v == t._version
                               for (r, v), t in zip(hit[0], ts)):
        memo.move_to_end(key)
        return hit[1], True
    stamps = tuple((weakref.ref(t), t._version) for t in ts)
    out = make()
    memo[key] = (stamps, out)
    memo.move_to_end(key)
    while len(memo) > _MEMO_SCENES:
        memo.popitem(last=False)
    return out, False


def host_constants(scene) -> HostConstants:
    """The frame's host reads (`HostConstants`), memoised per scene (the
    last 8, by the dark_sky tensor): a read of the card happens only for
    scalars that are new or were written in place since the last read."""
    ts = (scene.dark_sky, scene.sky_w, scene.sky_h)
    return _memoised(_HOST_MEMO, id(ts[0]), ts, lambda: HostConstants(
        float(scene.dark_sky), _sky_wh(scene)))[0]


class FrameTables(NamedTuple):
    """The per-frame scene tables the kernels read (`prepare`)."""
    intersect: tuple             # first_hits: (sph, quad)
    shade: tuple                 # shade_scatter: (mat, light, dark)
    mesh: Optional[tuple]        # mesh scenes: (midf, pack), B1 and B2
    tree: Optional[tuple]        # mesh scenes: the BVH walk's tables
    shadow: Optional[tuple]      # lit scenes: the shadow kernel's tables
    sphere_tex: Optional[torch.Tensor]  # textured spheres: B1's [S, 15]
    mat_pair: Optional[torch.Tensor]    # textured spheres: B2's [M, 2]
    sky: Optional[tuple]         # image skies: (W, H) as host ints


def prepare(scene):
    """The per-frame scene tables the kernels read: the frame's host reads
    (`host_constants`) and the tables built on the scene's device. A
    compiled entry point builds them from the caller's scene before its
    graph and passes them in (`render/graphs.py`), so a read of the card
    happens before a capture, never inside it.

    Memoised per scene (the last 8): the tables are a function of the
    scene's tensors and fields alone, so while every tensor of the scene
    is the tensor last built from at the same version and every other
    field is equal, the call returns the same table tensors (which nothing
    writes), and a graph's copy-in skips them. An edit in place, a
    `dataclasses.replace` or a new scene builds them again; so does every
    training step, whose optimizer writes the leaves in place. Each call
    adds one to `TABLE_BUILDS` or to `TABLE_REUSES`."""
    global TABLE_BUILDS, TABLE_REUSES
    key, ts = [], []
    for f in dataclasses.fields(scene):
        x = getattr(scene, f.name)
        if isinstance(x, torch.Tensor):
            key.append(id(x))
            ts.append(x)
        else:
            key.append(x)
    tables, hit = _memoised(_TABLE_MEMO, tuple(key), ts,
                            lambda: _build_tables(scene))
    if hit:
        TABLE_REUSES += 1
    else:
        TABLE_BUILDS += 1
    return tables


@torch.no_grad()
def _build_tables(scene) -> FrameTables:
    host = host_constants(scene)
    meshes = scene.mesh_mat.shape[0] > 0
    uv = scene.sphere_uv_needed and not _no_atlas(scene)
    return FrameTables(
        kintersect.intersect_tables(scene),
        kshade.shade_tables(scene, dark=host.dark_sky),
        kintersect.mesh_tables(scene) if meshes else None,
        ktraverse.traverse_tables(scene) if meshes else None,
        (kshadow.shadow_tables(scene) if scene.light_pos.shape[0] > 0
         else None),
        kintersect.sphere_tex_table(scene) if uv else None,
        kshade.mat_pair_table(scene) if uv else None, host.sky_wh)


def _sky_wh(scene):
    """The image sky's (W, H) as host ints (one read of the card per
    frame, not one per bounce), or None."""
    if not scene.has_sky_image:
        return None
    return int(scene.sky_w), int(scene.sky_h)


def _shadow_factors_all(scene, cfg: RenderConfig, p, time, keys, live,
                        tables: FrameTables, salt=None):
    """Per-light soft-shadow factors [L, N] of the hit points p (None
    without lights); `keys` and `salt` as `shadow.shadow_factors` takes
    them."""
    if scene.light_pos.shape[0] == 0:
        return None
    return kshadow.shadow_factors(scene, cfg, p, time, keys, cfg.epsilon,
                                  live, kernels=cfg.kernels,
                                  tables=tables.shadow, tree=tables.tree,
                                  salt=salt)


def _init_state(o, d, time):
    """The bounce state of a ray batch in buffers of its own: one [12, N]
    f32 block whose rows are o(3), d(3), throughput(3), acc(3), and the
    active flags. The shade kernel updates them in place, so the caller's
    o and d are copied (they may be a camera's tensors that carry grad);
    `time` is read only."""
    N = time.shape[0]
    buf = torch.empty((12, N), dtype=torch.float32, device=time.device)
    for k, c in enumerate((*o, *d)):
        buf[k].copy_(c)
    buf[6:9].fill_(1.0)
    buf[9:12].zero_()
    return dict(
        o=tuple(buf[0:3]), d=tuple(buf[3:6]), time=time,
        throughput=tuple(buf[6:9]),
        active=torch.ones_like(time, dtype=torch.bool),
        acc=tuple(buf[9:12]),
    )


def copy_state(state):
    """A copy of a bounce state in buffers of its own (`_init_state`'s
    layout), for a caller that keeps the state it hands to the in-place
    shade pass."""
    c = _init_state(state["o"], state["d"], state["time"])
    for key in ("throughput", "acc"):
        for t, x in zip(c[key], state[key]):
            t.copy_(x)
    c["active"].copy_(state["active"])
    return c


def _bounce_core(scene, cfg: RenderConfig, keys, state, b: int,
                 last=False, tables=None, with_rec=False):
    """One forward bounce (Scene::rayTraceRecursive body, Scene.h:258-342)
    by the route `_fused` picks. Returns (`state`: the next state, or with
    only `acc` updated when `last`; the bounce's record when `with_rec`,
    else None). The record is (reci [4, N] i32 = j, tid, idx_t, idx_n;
    recf [8, N] f32 = img(3), rnm(3), ptex, pnm, zero where the bounce
    fetches no texel; shadows [L, N] f32, B6's factors)."""
    if not _fused(scene, cfg):
        return _bounce_general(scene, cfg, keys, state, b, last=last,
                               tables=tables, with_rec=with_rec)
    L = scene.light_pos.shape[0]
    n_rem = cfg.max_bounces - b  # NRemainingBounces at this depth
    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    use_pair = (fetch_tex and not _no_atlas(scene)
                and scene.pair_pack.shape[0] > 1)
    rec_tex = with_rec and use_pair
    o, d, active = state["o"], state["d"], state["active"]
    t_raw = tri_raw = None
    if scene.mesh_mat.shape[0] > 0:
        t_raw, tri_raw = ktraverse.mesh_closest_hits(
            scene, o, d, live=active, kernels=cfg.kernels,
            tables=tables.tree)
    k1 = kintersect.first_hits(
        scene, o, d, state["time"], active,
        eps=cfg.epsilon, tex_out=(2 if rec_tex else int(use_pair)),
        kernels=cfg.kernels, tables=tables.intersect, t_mesh=t_raw,
        tri_mesh=tri_raw, mesh=tables.mesh, slim=True,
        sphere_tex=tables.sphere_tex if use_pair else None)
    # B6 and B2 take the sample's keys and salt them by the bounce
    shadows = None
    if L > 0:
        shadows = _shadow_factors_all(scene, cfg, k1["p"], state["time"],
                                      keys, active & (k1["j"] >= 0), tables,
                                      salt=b)
    out = kshade.shade_scatter(
        scene, cfg, state, keys, k1, n_rem, shadows=shadows,
        use_pair=use_pair, last=last, kernels=cfg.kernels,
        tables=tables.shade, rec_out=rec_tex, mesh=tables.mesh,
        quad=tables.intersect[1],
        mat_pair=tables.mat_pair if use_pair else None, sky_wh=tables.sky,
        salt=b)
    if not with_rec:
        return state, None
    j = k1["j"]
    if rec_tex:
        reci = torch.stack([j, k1["tid"], k1["idx_t"], k1["idx_n"]])
        recf = out[1]
    else:
        zi = torch.zeros_like(j)
        reci = torch.stack([j, k1["tid"], zi, zi])
        recf = torch.zeros((8,) + tuple(j.shape), dtype=torch.float32,
                           device=j.device)
    return state, (reci, recf, _shadow_rec(shadows, j))


def _shadow_rec(shadows, j):
    if shadows is not None:
        return shadows
    return torch.zeros((0,) + tuple(j.shape), dtype=torch.float32,
                       device=j.device)


# ---------------------------------------------------------------------------
# The general bounce (the exact atlas forward and the differentiable replay)
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """`index_select` of a table's rows, whose backward sums each row's
    lane cotangents in one fixed order (`kernels/rowsum.py`, a CUDA kernel
    on the card): two backward passes give the same bits, which
    `index_select`'s own gradient, `index_add_` with float atomics on the
    card, does not. (Indexing `table[idx]` has the gradient
    `index_put_(accumulate=True)`, which on the card sorts the indices and
    sums each run of one row in one warp: with ~400,000 lanes on a dozen
    rows that was the slowest op of the replay by far.)"""

    @staticmethod
    def forward(ctx, table, idx, kernels):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.kernels = table.shape, kernels
        return torch.index_select(table, 0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rows, cols = ctx.shape[0], math.prod(ctx.shape[1:])
        gt = krowsum.row_sum(idx, g.reshape(g.shape[0], cols), rows,
                             kernels=ctx.kernels)
        return gt.reshape(ctx.shape), None, None


def _take(table, idx, kernels="auto"):
    """Rows `idx` (int32 or int64) of `table`, an exact gather; where the
    table requires grad, its gradient sums onto the table in a fixed
    order (`_GatherRows`, on the row sums `kernels` picks)."""
    flat = idx.reshape(-1)
    if torch.is_grad_enabled() and table.requires_grad:
        out = _GatherRows.apply(table, flat, kernels)
    else:
        out = torch.index_select(table, 0, flat)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def _rows(table, idx, kernels="auto"):
    """Row `idx` (clipped) of a small table: the JAX package's one-hot
    `_rows`, an exact gather here, whose gradient adds onto the table. A
    table with no rows gives zero rows, as the one-hot product does."""
    if table.shape[0] == 0:
        return table.new_zeros((idx.shape[0], table.shape[1]))
    return _take(table, torch.clamp(idx, 0, table.shape[0] - 1), kernels)


def _geo_packs(scene, kernels="auto"):
    """The scene-constant packed row tables of `_gather_hit_p`, built from
    the scene's (possibly trainable) tensors inside the autograd graph:
    sph [S, 8] (c, r, mb, mid), quad [Q, 19] (v0, er, eu, mb, tan, bitan,
    mid), matf [M, 18] and mati [M, 16] int (the JAX `_geo_packs`
    columns)."""
    def f(a):
        return a.to(torch.float32)[:, None]

    sph = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                     _take(scene.mat_mb, scene.sph_mat, kernels),
                     f(scene.sph_mat)], dim=1)
    quad = torch.cat([scene.quad_v0, scene.quad_er, scene.quad_eu,
                      _take(scene.mat_mb, scene.quad_mat, kernels),
                      scene.quad_tan, scene.quad_bitan, f(scene.quad_mat)],
                     dim=1)
    matf = torch.cat([
        scene.mat_texscale, scene.mat_check1, scene.mat_check2,
        scene.mat_diffuse, scene.mat_light_color,
        scene.mat_light_intensity[:, None], scene.mat_emissive[:, None],
        scene.mat_transparency[:, None], scene.mat_ior[:, None]], dim=1)
    tex, nm = scene.mat_tex.long(), scene.mat_nm.long()
    mati = torch.stack([
        scene.mat_textype, scene.tex_off[tex], scene.tex_w[tex],
        scene.tex_h[tex], scene.nm_off[nm], scene.nm_w[nm], scene.nm_h[nm],
        scene.mat_type, scene.mat_nm], dim=1).to(torch.int32)
    return sph, quad, matf, mati


def _mesh_detail_p(scene, o, d, tid, kernels="auto"):
    """Differentiable mesh-hit detail on triangle `tid` (clipped): the
    barycentric position and normal from the SHARED vertex table, so that
    vertex cotangents add onto `mesh_verts`, and the corner colors
    interpolated at the hit (Scene.h:291-298). Returns planar (p_m, n_m,
    col_m, has_col); lanes that are not mesh hits get values that an
    is_mesh select must mask. The JAX package gathers the lane's row of a
    [T, 24] pack built from `mesh_verts`; this gathers the same vertices
    and colors by the triangle's indices (the same values)."""
    t = torch.clamp(tid, 0, scene.tri_va.shape[0] - 1).long()
    a, b, c = (vp.splat(_take(scene.mesh_verts, v[t], kernels))
               for v in (scene.tri_va, scene.tri_vb, scene.tri_vc))
    p_m, n_m, w0, w1, w2 = prim.triangle_hit_detail(o, d, a, b, c)
    ca, cb, cc = (scene.tri_col_a[t], scene.tri_col_b[t],
                  scene.tri_col_c[t])
    col_m = tuple(w0 * ca[:, i] + w1 * cb[:, i] + w2 * cc[:, i]
                  for i in range(3))
    return p_m, n_m, col_m, scene.tri_has_col[t]


def _gather_hit_p(scene, o, d, a2, time, j, tid, packed_on, k1=None,
                  fetch_tex=True, tex_saved=None, kernels="auto"):
    """The selected hit's shading inputs, differentiably (the JAX
    package's `_gather_hit_p` without its pair-atlas branch, which the
    general route never takes).

    j: [N] winner index into (spheres | quads | meshes), clipped to >= 0;
    tid: [N] the winning triangle (any value off meshes). `k1`: the
    first-hit record (forward: p, n, u, v, tan, bitan and mid from it);
    without it (the replay) the sphere and quad detail are re-derived from
    the scene's tensors. `tex_saved`: the record's texels (img, rnm, idx_t,
    idx_n, ptex, pnm), which the replay takes instead of fetching; else
    the texels come from the exact atlases (or, with `packed_on`, their
    packed twins: the same bits). `fetch_tex=False` skips the fetch where
    no texel can reach an output. `kernels` (`RenderConfig.kernels`)
    picks how the row gathers' gradients sum (`_take`). Returns a dict of
    planar fields, with `tex_rec` (img, rnm, idx_t, idx_n, present,
    npresent) for the record."""
    N = j.shape[0]
    S = scene.sph_center.shape[0]
    Q = scene.quad_v0.shape[0]
    is_sph = j < S
    is_quad = (j >= S) & (j < S + Q)
    is_mesh = j >= S + Q
    sph_pack, quad_pack, matf, mati = _geo_packs(scene, kernels)

    if k1 is not None:
        p_sq, n_sq = k1["p"], k1["n"]
        u_q, v_q = k1["u"], k1["v"]
        tan_q, bitan_q = k1["tan"], k1["bitan"]
        mid_sq = k1["mid"]
        theta, phi = prim.sphere_angles(n_sq)
    else:
        srow = _rows(sph_pack, j, kernels)
        mid_s = srow[:, 7].to(torch.int32)
        p_s, n_s = prim.sphere_hit_detail(
            o, d, a2, time, (srow[:, 0], srow[:, 1], srow[:, 2]),
            srow[:, 3], (srow[:, 4], srow[:, 5], srow[:, 6]))
        theta, phi = prim.sphere_angles(n_s)
        qrow = _rows(quad_pack, j - S, kernels)
        mid_q = qrow[:, 18].to(torch.int32)
        p_q, n_q, u_q, v_q = prim.quad_hit_detail(
            o, d, time, (qrow[:, 0], qrow[:, 1], qrow[:, 2]),
            (qrow[:, 3], qrow[:, 4], qrow[:, 5]),
            (qrow[:, 6], qrow[:, 7], qrow[:, 8]),
            (qrow[:, 9], qrow[:, 10], qrow[:, 11]))
        p_sq = vp.where(is_quad, p_q, p_s)
        n_sq = vp.where(is_quad, n_q, n_s)
        mid_sq = torch.where(is_sph, mid_s, mid_q)
        tan_q = (qrow[:, 12], qrow[:, 13], qrow[:, 14])
        bitan_q = (qrow[:, 15], qrow[:, 16], qrow[:, 17])

    # mesh branch: shared-vertex gathers (Mesh.h:111-124)
    Nm = scene.mesh_mat.shape[0]
    if Nm > 0:
        p_m, n_m, col_m, has_col = _mesh_detail_p(scene, o, d, tid,
                                                  kernels)
        mid_m = scene.mesh_mat[torch.clamp(j - S - Q, 0, Nm - 1).long()]
    else:
        p_m = n_m = col_m = vp.full_like(o, 0.0)
        mid_m = torch.zeros_like(j)
        has_col = torch.zeros_like(o[0])

    mid = torch.where(is_mesh, mid_m.to(torch.int32), mid_sq.to(torch.int32))
    p = vp.where(is_mesh, p_m, p_sq)
    n = vp.where(is_mesh, n_m, n_sq)
    # spheres use (phi/2pi, theta/pi) for texture and emission
    # (Scene.h:275-277); squares use (u, v)
    u_tex = torch.where(is_sph, phi * shading.INV_2PI, u_q)
    v_tex = torch.where(is_sph, theta * shading.INV_PI, v_q)

    mrf = _rows(matf, mid, kernels)
    mri = _rows(mati, mid)
    sx, sy = mrf[:, 0], mrf[:, 1]
    textype = mri[:, 0]

    has_tex = fetch_tex and scene.tex_data.shape[0] > 1
    has_nm = fetch_tex and scene.nm_data.shape[0] > 1
    packs_ok = ((scene.tex_pack.shape[0] > 1 or not has_tex)
                and (scene.nm_pack.shape[0] > 1 or not has_nm))
    fused = packed_on and packs_ok and has_tex and has_nm
    raw_nm = npresent = None
    rec_idx_t = rec_idx_n = None
    zb = torch.zeros(N, dtype=torch.bool, device=j.device)
    if tex_saved is not None:
        # REPLAY: the texels re-enter as differentiable inputs, whose
        # cotangents `_TraceRecordReplay.backward` folds onto the atlases
        simg, srnm, _, _, spres, snpres = tex_saved
        if has_tex or has_nm:
            img, present = simg, spres > 0.5
        else:
            img, present = vp.full_like(o, 0.0), zb
        if has_nm:
            raw_nm, npresent = srnm, snpres > 0.5
    else:
        if has_nm:
            nm_idx, npresent = shading._texel_index(
                scene.nm_data.shape[0], mri[:, 4], mri[:, 5], mri[:, 6],
                u_tex, v_tex, sx, sy)
            rec_idx_n = nm_idx
        if has_tex:
            tex_idx, present = shading._texel_index(
                scene.tex_data.shape[0], mri[:, 1], mri[:, 2], mri[:, 3],
                u_tex, v_tex, sx, sy)
            rec_idx_t = tex_idx
            if fused:
                img, raw_nm = shading.packed_fetch2(
                    scene.tex_pack, scene.nm_pack, tex_idx, nm_idx)
            elif packed_on and scene.tex_pack.shape[0] > 1:
                img = shading.packed_fetch(scene.tex_pack, tex_idx)
            else:
                img = vp.splat(_take(scene.tex_data, tex_idx, kernels))
        else:
            img, present = vp.full_like(o, 0.0), zb
    same = (shading.cpp_trunc_mod2(u_tex * sx)
            == shading.cpp_trunc_mod2(v_tex * sy))
    checker = vp.where(same, (mrf[:, 2], mrf[:, 3], mrf[:, 4]),
                       (mrf[:, 5], mrf[:, 6], mrf[:, 7]))
    img_fb = vp.where(present, img, shading._magenta_checker_p(u_tex, v_tex))

    # diffuse after texturing (Scene.h:275/283); meshes use their
    # interpolated vertex colors where they have them (Scene.h:291-298)
    base = (mrf[:, 8], mrf[:, 9], mrf[:, 10])
    textured = vp.where(textype == shading.TEX_CHECKERBOARD, checker, base)
    textured = vp.where(textype == shading.TEX_IMAGE, img_fb, textured)
    diffuse = vp.where(is_mesh, vp.where(has_col > 0.5, col_m, base),
                       textured)

    # normal mapping: squares only (Scene.h:284)
    raw_for_rec = None
    if has_nm:
        if raw_nm is not None:
            raw = raw_nm
        elif packed_on and scene.nm_pack.shape[0] > 1:
            raw = shading.packed_fetch(scene.nm_pack, nm_idx)
        else:
            raw = vp.splat(_take(scene.nm_data, nm_idx, kernels))
        raw_for_rec = raw
        nm = tuple(2.0 * c - 1.0 for c in raw)
        n2 = vp.normalize(tuple(
            nm[0] * tan_q[a] + nm[1] * bitan_q[a] + nm[2] * n[a]
            for a in range(3)))
        use = npresent & (mri[:, 8] > 0)
        n = vp.where(is_quad, vp.where(use, n2, n), n)

    # emission: spheres and squares only (Scene.h:277,285)
    lc = (mrf[:, 11], mrf[:, 12], mrf[:, 13])
    etex = vp.where(textype == shading.TEX_CHECKERBOARD, checker, lc)
    etex = vp.where(textype == shading.TEX_IMAGE, img_fb, etex)
    ecol = vp.where(textype == shading.TEX_NONE, lc, etex)
    emis = vp.scale(mrf[:, 14] * mrf[:, 15], ecol)
    emis = vp.where(is_mesh, vp.full_like(emis, 0.0), emis)

    if tex_saved is not None:
        tex_rec = tex_saved
    else:
        zi = torch.zeros_like(j)
        tex_rec = (img, raw_for_rec if raw_for_rec is not None
                   else vp.full_like(o, 0.0),
                   rec_idx_t if rec_idx_t is not None else zi,
                   rec_idx_n if rec_idx_n is not None else zi,
                   present, npresent if npresent is not None else zb)
    return dict(mid=mid, p=p, n=n, diffuse=diffuse, emission=emis,
                u=u_tex, v=v_tex, transp=mrf[:, 16], ior=mrf[:, 17],
                mtype=mri[:, 7], tex_rec=tex_rec)


def _direct_lighting_p(scene, cfg: RenderConfig, p, n, transp, diffuse,
                       shadows):
    """Per-light Lambert combined with the given soft-shadow factors
    (Scene.h:305-334); shadows [L, N] are constants (the record's)."""
    ref = cfg.compat == "reference"
    color = vp.full_like(p, 0.0)
    for i in range(scene.light_pos.shape[0]):
        lpos = tuple(scene.light_pos[i, a] for a in range(3))
        ldir = vp.normalize(vp.sub(lpos, p))
        lcol = scene.light_color[0] if ref else scene.light_color[i]
        lam = torch.clamp_min(vp.dot(ldir, n), 0.0) * (1.0 - transp)
        contrib = tuple(lcol[a] * diffuse[a] * lam for a in range(3))
        sh = shadows[i]
        if ref:   # quirk: multiplies everything accumulated (Scene.h:333)
            color = vp.scale(sh, vp.add(color, contrib))
        else:
            color = vp.add(color, vp.mul(contrib, (sh,) * 3))
    return color


def _scatter_p(cfg: RenderConfig, d, n, p, mtype, ior, keys):
    """Material::scatter (Material.cpp:26-60), branchless planar, on the
    shade kernel's PCG streams (SCATTER_GLASS, SCATTER_DIR): the replay
    draws what the forward drew."""
    ref = cfg.compat == "reference"
    ddn = vp.dot(d, n)
    going_out = ddn > 0.0
    # non-glass materials carry ior = 0: a safe denominator keeps the
    # discarded glass lobe's gradient finite
    ior_inv = 1.0 / torch.where(ior > 1e-12, ior, 1.0)
    if ref:   # inverted-eta quirk
        ri = torch.where(going_out, ior_inv, ior)
    else:
        ri = torch.where(going_out, ior, ior_inv)
    cos_t = torch.clamp_max(-ddn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    if ref:
        cannot = (ri * sin_t - 0.6) > 1.0           # -0.6 fudge quirk
    else:
        cannot = (ri * sin_t) > 1.0
    u_glass = rng.uniform(rng.salted(keys, rng.SCATTER_GLASS))
    use_reflect = cannot | (schlick_reflectance(cos_t, ri) > u_glass)
    refl = vp.reflect(d, n)
    d_glass = vp.where(use_reflect, refl, vp.refract(d, n, ri))
    skey = rng.salted(keys, rng.SCATTER_DIR)
    ruv = (rng.cube_unit_vector_lane_p(skey, 0) if ref
           else rng.sphere_unit_vector_lane_p(skey, 0))
    d_diff = vp.add(n, ruv)
    d_diff = vp.where(vp.norm(d_diff) <= cfg.epsilon, n, d_diff)
    d_out = vp.where(mtype == GLASS, d_glass,
                     vp.where(mtype == MIRROR, refl, d_diff))
    d_out = vp.normalize(d_out)
    return vp.axpy(cfg.epsilon, d_out, p), d_out


class _Picks:
    """A plain-autodiff bounce's discrete selections (`_trace_scan`): the
    winner `j` (-1 on a miss), the triangle `tid` and the shadow factors,
    taken by the kernels on the bounce's first run and reused when the
    backward rematerializes it, so that the kernels run once a bounce."""

    def __init__(self):
        self.j = self.tid = self.shadows = None
        self.done = False


def _bounce_general(scene, cfg: RenderConfig, keys, state, b: int,
                    saved=None, last=False, tables=None, with_rec=False,
                    sky_wh=None, picks: Optional[_Picks] = None):
    """The general bounce (the JAX package's non-fused `_bounce_core`).

    saved=None: the exact-atlas forward: the BVH walk, `first_hits`
    (tex_out=0) and the shadow kernel, the rest in torch ops; with
    `with_rec` it also returns the record (see `_bounce_core`).
    saved=(reci, recf, shadows): the REPLAY, differentiable in the scene's
    tensors, the state and the recorded texels: no candidate pass, no
    walk and no shadow search; the winners, triangles, texels and shadow
    factors come from the record. `picks`: the plain autodiff bounce,
    differentiable in the scene's tensors and the state: the kernels give
    only the discrete selections, kept in `picks` (`_Picks`), the hit is
    re-derived from the scene's tensors (no B1 float output reaches it)
    and the atlases are read exactly (no packed twin). `sky_wh`: the image
    sky's (W, H) as host ints (the replay's, from the forward's
    `tables.sky`; the forward takes them from `tables`). Returns (next
    state, a new dict; record or None)."""
    eps = cfg.epsilon
    ref = cfg.compat == "reference"
    L = scene.light_pos.shape[0]
    n_rem = cfg.max_bounces - b
    packed_on = cfg.packed_atlas != "off" and picks is None
    o, d, time = state["o"], state["d"], state["time"]
    active, throughput, acc = (state["active"], state["throughput"],
                               state["acc"])
    bkeys = rng.salted(keys, b)
    a2 = vp.dot(d, d)
    k1 = tex_saved = None
    if saved is not None:
        reci, recf, shadows = saved
        j_enc, tid = reci[0], reci[1]
        tex_saved = (tuple(recf[0:3]), tuple(recf[3:6]), reci[2], reci[3],
                     recf[6], recf[7])
    elif picks is not None and picks.done:   # rematerialized
        j_enc, tid = picks.j, picks.tid
    else:
        with torch.no_grad():
            t_raw = tri_raw = None
            if scene.mesh_mat.shape[0] > 0:
                t_raw, tri_raw = ktraverse.mesh_closest_hits(
                    scene, o, d, live=active, kernels=cfg.kernels,
                    tables=tables.tree)
            k1 = kintersect.first_hits(
                scene, o, d, time, active, eps=eps, tex_out=0,
                kernels=cfg.kernels, tables=tables.intersect, t_mesh=t_raw,
                tri_mesh=tri_raw, mesh=tables.mesh)
        j_enc, tid = k1["j"], k1["tid"]
        if picks is not None:
            picks.j, picks.tid, k1 = j_enc, tid, None
    miss = j_enc < 0
    j = torch.clamp_min(j_enc, 0)

    # sky on miss (Scene.h:300-303); a select, so that a NaN on a lane
    # that is not active never reaches acc
    if tables is not None:
        sky_wh = tables.sky
    sky = shading.skybox_color_p(scene, d, n_rem, ref, packed=packed_on,
                                 sky_wh=sky_wh)
    acc = tuple(acc[a] + torch.where(active & miss, throughput[a] * sky[a],
                                     0.0) for a in range(3))

    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    hit = _gather_hit_p(scene, o, d, a2, time, j, tid, packed_on, k1=k1,
                        fetch_tex=fetch_tex, tex_saved=tex_saved,
                        kernels=cfg.kernels)
    live = active & ~miss
    if picks is not None and picks.done:
        shadows = picks.shadows
    elif saved is None:
        with torch.no_grad():
            shadows = _shadow_factors_all(scene, cfg, hit["p"], time, bkeys,
                                          live, tables)
        if picks is not None:
            picks.shadows, picks.done = shadows, True
    direct = _direct_lighting_p(scene, cfg, hit["p"], hit["n"],
                                hit["transp"], hit["diffuse"], shadows)
    acc = tuple(acc[a] + torch.where(
        live, throughput[a] * (direct[a] + hit["emission"][a]), 0.0)
        for a in range(3))
    if last:
        nxt = dict(state, acc=acc)
    else:
        o2, d2 = _scatter_p(cfg, d, hit["n"], hit["p"], hit["mtype"],
                            hit["ior"], bkeys)
        nxt = dict(
            o=vp.where(live, o2, o), d=vp.where(live, d2, d), time=time,
            throughput=vp.where(live, vp.mul(throughput, hit["diffuse"]),
                                throughput),
            active=live, acc=acc)
    if saved is not None or not with_rec:
        return nxt, None
    img, rnm, it, inn, pres, npres = hit["tex_rec"]
    reci = torch.stack([j_enc, tid, it, inn])
    recf = torch.stack([*img, *rnm, pres.to(torch.float32),
                        npres.to(torch.float32)])
    return nxt, (reci, recf, _shadow_rec(shadows, j_enc))


def _finish(state, cfg: RenderConfig):
    out = torch.stack(state["acc"], dim=-1)
    if cfg.compat == "reference":
        # Scene.h:347-349 quirk; the JAX trace divides by a compile-time
        # constant, which XLA turns into this f32 reciprocal multiply
        out = out * float(np.float32(1.0) / np.float32(cfg.max_bounces))
    return out


def _st10(state):
    """A copy of a bounce's input state as one [10, N] stack: o(3), d(3),
    throughput(3), active (as 0/1)."""
    return torch.stack(list(state["o"]) + list(state["d"])
                       + list(state["throughput"])
                       + [state["active"].to(torch.float32)])


def _trace_loop(scene, cfg: RenderConfig, o, d, time, keys, tables,
                with_rec=False, with_states=None, occupancy=None):
    """The bounce loop (`lax.scan` in the JAX package), the last bounce
    specialised: (radiance [N, 3], recs, states). With `with_rec` it is the
    record forward, the port of
    `tracer/render/integrator.py::_trace_record`: recs holds each bounce's
    record (`_bounce_core(with_rec=True)`) and, with `with_states`
    (default: `with_rec` and the hand-written class), states each bounce's
    input state [10, N], the residuals of the hand-written backward
    (`replay_bwd.replay_backward`); else the lists are empty. A list given
    as `occupancy` receives each bounce's share of lanes active at its
    start, as a device scalar (no read of the card per bounce)."""
    B = cfg.max_bounces
    if with_states is None:
        with_states = with_rec and replay_bwd.hand_bwd_ok(scene, cfg)
    state = _init_state(o, d, time)
    recs, states = [], []
    for b in range(B):
        if with_states:
            states.append(_st10(state))
        if occupancy is not None:
            occupancy.append(state["active"].to(torch.float32).mean())
        state, rec = _bounce_core(scene, cfg, keys, state, b,
                                  last=b == B - 1, tables=tables,
                                  with_rec=with_rec)
        if with_rec:
            recs.append(rec)
    return _finish(state, cfg), recs, states


def _plain_state(o, d, time):
    """The first bounce's state as plain tensors (no buffers of its own:
    the differentiable routes never run the in-place shade kernel)."""
    zero = d[0] * 0.0
    return dict(o=o, d=d, time=time,
                throughput=(zero + 1.0, zero + 1.0, zero + 1.0),
                active=torch.ones_like(time, dtype=torch.bool),
                acc=(zero, zero, zero))


def _trace_replay(scene, cfg: RenderConfig, o, d, time, keys, rec,
                  sky_wh):
    """The differentiable replay conditioned on the record
    (`tracer/render/integrator.py::_trace_replay`): every bounce by
    `_bounce_general(saved=rec[b])`, in torch ops. Its vector-Jacobian
    product is the general backward. `sky_wh`: the image sky's (W, H) as
    the forward's `prepare` read them (`FrameTables.sky`), so that the
    replay reads nothing from the card."""
    B = cfg.max_bounces
    state = _plain_state(o, d, time)
    for b in range(B):
        state, _ = _bounce_general(scene, cfg, keys, state, b, saved=rec[b],
                                   last=b == B - 1, sky_wh=sky_wh)
    return _finish(state, cfg)


def _trace_scan(scene, cfg: RenderConfig, o, d, time, keys, tables,
                occupancy=None):
    """The plain autodiff path (`tracer/render/integrator.py::_trace_scan`,
    which runs with the kernels off as the reference here): every bounce
    by `_bounce_general(picks=...)` under autograd, each but the last
    rematerialized in the backward by `torch.utils.checkpoint` (the JAX
    package's `jax.checkpoint` of its scan body) with its selections kept
    (`_Picks`). The keys are explicit, so the recompute is exact. A list
    given as `occupancy` receives each bounce's share of lanes active at
    its start."""
    B = cfg.max_bounces
    state = _plain_state(o, d, time)
    for b in range(B):
        if occupancy is not None:
            occupancy.append(state["active"].to(torch.float32).mean())
        bounce = functools.partial(_bounce_general, scene, cfg, keys, b=b,
                                   last=b == B - 1, tables=tables,
                                   picks=_Picks())
        if b < B - 1:
            # no draw comes from torch's generator (every draw is a PCG
            # stream of the explicit keys), so its state need not be kept;
            # keeping it queries the CUDA generator, which a capture refuses
            state, _ = torch.utils.checkpoint.checkpoint(
                bounce, state, use_reentrant=False, preserve_rng_state=False)
        else:
            state, _ = bounce(state)
    return _finish(state, cfg)


def _general_backward(scene, cfg, keys, rec, o, d, time, g, needs,
                      sky_wh):
    """The vjp of the replay (`tracer/render/integrator.py::_trace_cv_bwd`
    outside the hand-written class): the replay runs again under autograd
    on detached leaves (the scene fields and rays whose gradient is asked
    for, and each bounce's recorded texel values), and
    `torch.autograd.grad` gives their cotangents. `sky_wh`: the forward's
    (`_TraceRecordReplay`'s ctx). The replay's scene `s2` holds detached
    copies, which `host_constants` has never seen: nothing here calls it
    or `prepare`, so the backward reads nothing from the card and can be
    captured. Returns (gscene dict, go, gd, gtime, gtex) with gtex the
    per-bounce texel cotangents [8, N] (None where not asked for)."""
    nf = len(replay_bwd.GRAD_FIELDS)
    leaves, repl = {}, {}
    for name, need in zip(replay_bwd.GRAD_FIELDS, needs[:nf]):
        t = getattr(scene, name).detach()
        if need and name not in ("tex_data", "nm_data"):
            t = t.requires_grad_(True)
            leaves[name] = t
        repl[name] = t
    s2 = dataclasses.replace(scene, **repl)
    rays = [t.detach().requires_grad_(bool(need))
            for t, need in zip((*o, *d, time), needs[nf:])]
    want_tex = any(need for name, need in zip(replay_bwd.GRAD_FIELDS, needs)
                   if name in ("tex_data", "nm_data"))
    texvals = [r[1].detach().requires_grad_(want_tex) for r in rec]
    rec2 = [(r[0], tv, r[2]) for r, tv in zip(rec, texvals)]
    inputs = (list(leaves.values()) + [r for r in rays if r.requires_grad]
              + (texvals if want_tex else []))
    with torch.enable_grad():
        out = _trace_replay(s2, cfg, tuple(rays[0:3]), tuple(rays[3:6]),
                            rays[6], keys, rec2, sky_wh)
        grads = (torch.autograd.grad(out, inputs, g, allow_unused=True)
                 if inputs else [])
    grads = [torch.zeros_like(x) if gx is None else gx
             for x, gx in zip(inputs, grads)]
    it = iter(grads)
    gscene = {name: next(it) for name in leaves}
    gray = [next(it) if r.requires_grad else None for r in rays]
    gtex = [next(it) for _ in texvals] if want_tex else None
    return gscene, gray[0:3], gray[3:6], gray[6], gtex


class _TraceRecordReplay(torch.autograd.Function):
    """`trace` with the record-replay gradient (the counterpart of
    `tracer/render/integrator.py::_trace_cv`).

    Inputs: the scene fields of `replay_bwd.GRAD_FIELDS`, then o, d
    (planar) and time. The forward runs the record forward and keeps the
    record (and, for the hand-written class, the per-bounce states); the
    backward runs the hand-written sweep inside `hand_bwd_ok` and the
    replay's vjp outside it (`_general_backward`), folds the texel
    cotangents onto `tex_data` and `nm_data` only where their gradient is
    asked for (every bounce but the last, and the last too when the scene
    has lights or an emissive TEX_IMAGE material, whose last bounce
    fetches texels), and returns the cotangents of o, d and time too, so
    camera gradients reach `generate_rays`.

    The fused forward reads the texels from `pair_pack`, the pristine u8
    atlas, while `tex_data` / `nm_data` receive the gradient: that is
    exact only while those tensors still hold the pristine texels.
    Training that moves the texels renders with `packed_atlas="off"`, the
    exact-atlas route (ROADMAP.md Queue A, training)."""

    @staticmethod
    def forward(ctx, scene, cfg, keys, tables, *inputs):
        nf = len(replay_bwd.GRAD_FIELDS)
        o, d, time = inputs[nf:nf + 3], inputs[nf + 3:nf + 6], inputs[-1]
        out, rec, states = _trace_loop(scene, cfg, o, d, time, keys,
                                       tables, with_rec=True)
        # dark_sky and the sky's (W, H) as the host values `prepare`
        # read: neither backward reads a scalar from the card
        ctx.scene, ctx.cfg, ctx.keys, ctx.dark = scene, cfg, keys, \
            tables.shade[2]
        ctx.sky_wh = tables.sky
        ctx.rec, ctx.states, ctx.time = rec, states, time
        ctx.o, ctx.d = o, d
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        scene, cfg, rec = ctx.scene, ctx.cfg, ctx.rec
        needs = ctx.needs_input_grad[4:]
        nf = len(replay_bwd.GRAD_FIELDS)
        if ctx.states:
            gscene, go, gd, gtime, gtex = replay_bwd.replay_backward(
                scene, cfg, ctx.time, ctx.keys, rec, ctx.states,
                g.contiguous(), dark=ctx.dark)
        else:
            gscene, go, gd, gtime, gtex = _general_backward(
                scene, cfg, ctx.keys, rec, ctx.o, ctx.d, ctx.time,
                g.contiguous(), needs, ctx.sky_wh)
        # the last bounce fetches texels only where something consumes
        # them there (`_bounce_core` fetch_tex)
        n_fold = len(rec) - 1
        if scene.light_pos.shape[0] > 0 or scene.emissive_tex_image:
            n_fold = len(rec)
        grads = []
        for name, need in zip(replay_bwd.GRAD_FIELDS, needs):
            if not need:
                grads.append(None)
            elif name in ("tex_data", "nm_data"):
                data = getattr(scene, name)
                k = 0 if name == "tex_data" else 1
                gdata = torch.zeros_like(data)
                if data.shape[0] > 1 and gtex and n_fold > 0:
                    gdata = kfold.fold_updates(
                        gdata, [r[0][2 + k] for r in rec[:n_fold]],
                        [tuple(t[3 * k:3 * k + 3]) for t in gtex[:n_fold]],
                        kernels=cfg.kernels)
                grads.append(gdata)
            elif name in gscene:
                grads.append(gscene[name])
            else:   # a field the hand-written class never reads
                grads.append(torch.zeros_like(getattr(scene, name)))
        ray = [*go, *gd, gtime]
        ray = [r if need else None for r, need in zip(ray, needs[nf:])]
        ctx.rec = ctx.states = ctx.o = ctx.d = None
        return (None, None, None, None, *grads, *ray)


def trace(scene, cfg: RenderConfig, o, d, time, keys, tables=None,
          with_aux=False):
    """Trace a ray batch to radiance [N, 3].

    o, d: planar (x, y, z) of [N] f32; time: [N] f32; keys: [N] per-ray
    keys (int64 holding uint32, pixel and sample folded in). Equivalent of
    Scene::rayTrace (Scene.h:345-350) over a batch. Differentiable when
    grad mode is on and an input requires grad: o, d, time, or a scene
    field of `replay_bwd.GRAD_FIELDS`; by the record-replay gradient, or,
    with `cfg.custom_vjp="off"` or `with_aux`, by the plain autodiff path
    (`_trace_scan`), as in the JAX package.
    `with_aux=True` returns (radiance, {"occupancy": [B] f32}), the share
    of lanes active at the start of each bounce."""
    if tables is None:
        tables = prepare(scene)
    inputs = (*(getattr(scene, f) for f in replay_bwd.GRAD_FIELDS),
              *o, *d, time)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    occ = [] if with_aux else None
    if grad and (with_aux or cfg.custom_vjp == "off"):
        out = _trace_scan(scene, cfg, o, d, time, keys, tables, occ)
    elif grad:
        return _TraceRecordReplay.apply(scene, cfg, keys, tables, *inputs)
    else:
        with torch.no_grad():
            out = _trace_loop(scene, cfg, o, d, time, keys, tables,
                              occupancy=occ)[0]
    if with_aux:
        return out, {"occupancy": torch.stack(occ)}
    return out
