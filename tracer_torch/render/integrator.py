"""The wavefront path-tracing integrator (the port of the fused bounce of
`tracer/render/integrator.py`) and its record-replay gradient.

Each bounce is up to four kernels, in this order: on mesh scenes the BVH
walk `traverse.mesh_closest_hits` (closest raw hit per ray and mesh);
`first_hits` (closest hit over spheres, quads and those mesh hits +
winner detail + pair-atlas texel index); on lit scenes
`shadow.shadow_factors` (the soft-shadow factor of every light at each
live hit point); and `shade_scatter` (texels, emission, lighting, BSDF
scatter, state update, in place: `trace` owns the bounce state's
buffers, `_init_state` copies the caller's rays into them). Rays and hit
points go to the walk and the shadow kernels in ray order: the JAX
package's sorted queues (`cfg.ray_sort`) let a TPU packet share one
walk, but each GPU thread walks its own ray, and on the H100 the sorted
dispatch cost more than it saved (PERF.md, section 6), so `ray_sort` has
no effect in the port.
`lax.scan` over bounces becomes a Python loop with the final bounce
specialised the same way: it writes only `acc`, and it skips the texture
fetch when the scene has no lights and no emissive TEX_IMAGE material
(then the fetched texel provably reaches no output).

Gradients: when an input of `trace` requires grad, `trace` runs the
record forward (`_trace_loop(with_rec=True)`: each bounce's discrete
selections, texels and input state) inside `_TraceRecordReplay`, a
`torch.autograd.Function`
whose backward is the hand-written reverse sweep of
`render/replay_bwd.py` on the bounce-adjoint kernel, plus the texel fold
(`kernels/fold.py`) onto `tex_data` / `nm_data`. Without grad it keeps the
plain forward, which records nothing.

Every reference quirk of compat="reference" is replicated (see the JAX
module's docstring); compat="physical" fixes them.

Outside the slice (each raises NotImplementedError naming its ROADMAP
item): image skies, textured spheres (`sphere_uv_needed`), an atlas
without `pair_mode`, and gradients outside the hand-written backward's
scene class (which holds no mesh and no light) or with
`custom_vjp="off"`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import fold as kfold
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import shade as kshade
from tracer_torch.kernels import shadow as kshadow
from tracer_torch.kernels import traverse as ktraverse
from tracer_torch.render import replay_bwd


def check_scene(scene, cfg: RenderConfig):
    """Raise NotImplementedError for what the forward slice cannot trace."""
    def todo(what, item):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue A, '{item}')")

    if scene.has_sky_image:
        todo("the image skybox", "Sky image, sphere UV and exact atlas")
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    if not no_atlas:
        if not scene.pair_mode or cfg.packed_atlas == "off":
            todo("an atlas without the pair-packed fast path",
                 "Sky image, sphere UV and exact atlas")
        if scene.sphere_uv_needed:
            todo("textured spheres", "Sky image, sphere UV and exact atlas")


class FrameTables(NamedTuple):
    """The per-frame scene tables the kernels read (`prepare`)."""
    intersect: tuple             # first_hits: (sph, quad)
    shade: tuple                 # shade_scatter: (mat, light, dark)
    mesh: Optional[tuple]        # mesh scenes: (midf, pack), B1 and B2
    tree: Optional[tuple]        # mesh scenes: the BVH walk's tables
    shadow: Optional[tuple]      # lit scenes: the shadow kernel's tables


@torch.no_grad()
def prepare(scene):
    """The per-frame scene tables the kernels read (built once)."""
    meshes = scene.mesh_mat.shape[0] > 0
    return FrameTables(
        kintersect.intersect_tables(scene), kshade.shade_tables(scene),
        kintersect.mesh_tables(scene) if meshes else None,
        ktraverse.traverse_tables(scene) if meshes else None,
        (kshadow.shadow_tables(scene) if scene.light_pos.shape[0] > 0
         else None))


def _shadow_factors_all(scene, cfg: RenderConfig, p, time, keys, live,
                        tables: FrameTables):
    """Per-light soft-shadow factors [L, N] of the hit points p (None
    without lights)."""
    if scene.light_pos.shape[0] == 0:
        return None
    return kshadow.shadow_factors(scene, cfg, p, time, keys, cfg.epsilon,
                                  live, kernels=cfg.kernels,
                                  tables=tables.shadow, tree=tables.tree)


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
    """One bounce of the fused wavefront loop (Scene::rayTraceRecursive
    body, Scene.h:258-342): the BVH walk (mesh scenes), the first-hit
    kernel, the shadow kernel at the live hit points (lit scenes), then the
    shade+scatter kernel.
    Returns (`state`, updated in place to the next state, or with only
    `acc` updated when `last`; the bounce's record for the backward when
    `with_rec`, else None). The record is (reci [4, N] i32 = j, tid,
    idx_t, idx_n; recf [8, N] f32 = img(3), rnm(3), ptex, pnm: the shade
    kernel's `rec_out`), zero where the bounce fetches no texel."""
    L = scene.light_pos.shape[0]
    n_rem = cfg.max_bounces - b  # NRemainingBounces at this depth
    bkeys = rng.salted(keys, b)
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    use_pair = (fetch_tex and not no_atlas
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
        tri_mesh=tri_raw, mesh=tables.mesh, slim=True)
    shadows = _shadow_factors_all(scene, cfg, k1["p"], state["time"], bkeys,
                                  active & (k1["j"] >= 0), tables)
    out = kshade.shade_scatter(
        scene, cfg, state, bkeys, k1, n_rem, shadows=shadows,
        use_pair=use_pair, last=last, kernels=cfg.kernels,
        tables=tables.shade, rec_out=rec_tex, mesh=tables.mesh,
        quad=tables.intersect[1])
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
    return state, (reci, recf)


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
                with_rec=False):
    """The bounce loop (`lax.scan` in the JAX package), the last bounce
    specialised: (radiance [N, 3], recs, states). With `with_rec` it is the
    record forward, the port of
    `tracer/render/integrator.py::_trace_record(with_states=True)`: recs
    holds each bounce's record (`_bounce_core(with_rec=True)`) and states
    each bounce's input state [10, N], the residuals of the hand-written
    backward (`replay_bwd.replay_backward`); else both lists are empty."""
    B = cfg.max_bounces
    state = _init_state(o, d, time)
    recs, states = [], []
    for b in range(B):
        if with_rec:
            states.append(_st10(state))
        state, rec = _bounce_core(scene, cfg, keys, state, b,
                                  last=b == B - 1, tables=tables,
                                  with_rec=with_rec)
        if with_rec:
            recs.append(rec)
    return _finish(state, cfg), recs, states


class _TraceRecordReplay(torch.autograd.Function):
    """`trace` with the record-replay gradient (the counterpart of
    `tracer/render/integrator.py::_trace_cv`).

    Inputs: the scene fields of `replay_bwd.GRAD_FIELDS`, then o, d
    (planar) and time. The forward runs the record forward and keeps the
    record and the per-bounce states; the backward runs the hand-written
    sweep, folds the texel cotangents of bounces 0..B-2 onto `tex_data`
    and `nm_data` only where their gradient is asked for, and returns the
    cotangents of o, d and time too, so camera gradients reach
    `generate_rays`.

    The forward reads the texels from `pair_pack`, the pristine u8 atlas,
    while `tex_data` / `nm_data` receive the gradient: that is exact only
    while those tensors still hold the pristine texels. Training that moves
    the texels needs the exact-atlas path (ROADMAP.md Queue A, items 3
    and 4)."""

    @staticmethod
    def forward(ctx, scene, cfg, keys, tables, *inputs):
        nf = len(replay_bwd.GRAD_FIELDS)
        o, d, time = inputs[nf:nf + 3], inputs[nf + 3:nf + 6], inputs[-1]
        out, rec, states = _trace_loop(scene, cfg, o, d, time, keys,
                                       tables, with_rec=True)
        ctx.scene, ctx.cfg, ctx.keys = scene, cfg, keys
        ctx.rec, ctx.states, ctx.time = rec, states, time
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        scene, cfg, rec = ctx.scene, ctx.cfg, ctx.rec
        gscene, go, gd, gtime, gtex = replay_bwd.replay_backward(
            scene, cfg, ctx.time, ctx.keys, rec, ctx.states,
            g.contiguous())
        needs = ctx.needs_input_grad[4:]
        grads = []
        for name, need in zip(replay_bwd.GRAD_FIELDS, needs):
            if not need:
                grads.append(None)
            elif name in ("tex_data", "nm_data"):
                # texel cotangents of bounces 0..B-2: the last bounce
                # fetches no texel in this scene class
                data = getattr(scene, name)
                k = 0 if name == "tex_data" else 1
                gdata = torch.zeros_like(data)
                if data.shape[0] > 1 and gtex:
                    gdata = kfold.fold_updates(
                        gdata, [r[0][2 + k] for r in rec[:-1]],
                        [tuple(t[3 * k:3 * k + 3]) for t in gtex],
                        kernels=cfg.kernels)
                grads.append(gdata)
            else:
                grads.append(gscene[name])
        nf = len(replay_bwd.GRAD_FIELDS)
        ray = [*go, *gd, gtime]
        ray = [r if need else None for r, need in zip(ray, needs[nf:])]
        ctx.rec = ctx.states = None
        return (None, None, None, None, *grads, *ray)


def _check_grad(scene, cfg: RenderConfig):
    def todo(what):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue A, 'General "
            "autodiff-replay backward')")

    if cfg.custom_vjp == "off":
        todo("the plain autodiff backward (custom_vjp='off')")
    if not replay_bwd.hand_bwd_ok(scene, cfg):
        what = [w for w, c in (
            ("meshes", scene.mesh_mat.shape[0] > 0),
            ("scene lights", scene.light_pos.shape[0] > 0),
            ("an emissive TEX_IMAGE material", scene.emissive_tex_image))
            if c]
        todo("the gradient of scenes outside the hand-written backward's "
             f"class (here: {', '.join(what) or 'the scene'})")


def trace(scene, cfg: RenderConfig, o, d, time, keys, tables=None):
    """Trace a ray batch to radiance [N, 3].

    o, d: planar (x, y, z) of [N] f32; time: [N] f32; keys: [N] per-ray
    keys (int64 holding uint32, pixel and sample folded in). Equivalent of
    Scene::rayTrace (Scene.h:345-350) over a batch. Differentiable (see the
    module docstring) when grad mode is on and an input requires grad:
    o, d, time, or one of the scene fields of `replay_bwd.GRAD_FIELDS`."""
    check_scene(scene, cfg)
    if tables is None:
        tables = prepare(scene)
    inputs = (*(getattr(scene, f) for f in replay_bwd.GRAD_FIELDS),
              *o, *d, time)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        _check_grad(scene, cfg)
        return _TraceRecordReplay.apply(scene, cfg, keys, tables, *inputs)
    with torch.no_grad():
        return _trace_loop(scene, cfg, o, d, time, keys, tables)[0]
