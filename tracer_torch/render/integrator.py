"""The wavefront path-tracing integrator, forward (the port of the fused
bounce of `tracer/render/integrator.py`).

Each bounce is two kernels: `first_hits` (closest hit + winner detail +
pair-atlas texel index) and `shade_scatter` (texels, emission, lighting,
BSDF scatter, state update). `lax.scan` over bounces becomes a Python loop
with the final bounce specialised the same way: it writes only `acc`, and
it skips the texture fetch when the scene has no lights and no emissive
TEX_IMAGE material (then the fetched texel provably reaches no output).

Every reference quirk of compat="reference" is replicated (see the JAX
module's docstring); compat="physical" fixes them.

Outside the slice (each raises NotImplementedError naming its ROADMAP
item): meshes, scene lights (their shadow factors need the shadow kernel),
image skies, textured spheres (`sphere_uv_needed`), an atlas without
`pair_mode`, and the record outputs of the backward.
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import shade as kshade


def check_scene(scene, cfg: RenderConfig):
    """Raise NotImplementedError for what the forward slice cannot trace."""
    def todo(what, item):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue A, '{item}')")

    if scene.mesh_mat.shape[0] > 0:
        todo("mesh scenes", "Mesh scenes")
    if scene.light_pos.shape[0] > 0:
        todo("scene lights (the soft-shadow kernel)", "Lit scenes")
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


def prepare(scene):
    """The per-frame scene tables both kernels read (built once)."""
    return kintersect.intersect_tables(scene), kshade.shade_tables(scene)


def _init_state(o, d, time):
    zero = torch.zeros_like(time)
    return dict(
        o=tuple(c + zero for c in o), d=tuple(d), time=time,
        throughput=(zero + 1.0, zero + 1.0, zero + 1.0),
        active=torch.ones_like(time, dtype=torch.bool),
        acc=(zero, zero, zero),
    )


def _bounce_core(scene, cfg: RenderConfig, keys, state, b: int,
                 last=False, tables=None):
    """One bounce of the fused wavefront loop (Scene::rayTraceRecursive
    body, Scene.h:258-342): first-hit kernel, then shade+scatter kernel.
    Returns the next state, or the state with only `acc` updated when
    `last`."""
    L = scene.light_pos.shape[0]
    n_rem = cfg.max_bounces - b  # NRemainingBounces at this depth
    bkeys = rng.salted(keys, b)
    no_atlas = (scene.tex_data.shape[0] <= 1
                and scene.nm_data.shape[0] <= 1)
    fetch_tex = not (last and L == 0 and not scene.emissive_tex_image)
    use_pair = (fetch_tex and not no_atlas
                and scene.pair_pack.shape[0] > 1)
    itab, stab = tables
    k1 = kintersect.first_hits(
        scene, state["o"], state["d"], state["time"], state["active"],
        eps=cfg.epsilon, tex_out=1 if use_pair else 0, kernels=cfg.kernels,
        tables=itab)
    out = kshade.shade_scatter(
        scene, cfg, state, bkeys, k1, n_rem, use_pair=use_pair, last=last,
        kernels=cfg.kernels, tables=stab)
    if last:
        return dict(state, acc=out)
    return out


def _finish(state, cfg: RenderConfig):
    out = torch.stack(state["acc"], dim=-1)
    if cfg.compat == "reference":
        # Scene.h:347-349 quirk; the JAX trace divides by a compile-time
        # constant, which XLA turns into this f32 reciprocal multiply
        out = out * float(np.float32(1.0) / np.float32(cfg.max_bounces))
    return out


@torch.no_grad()
def trace(scene, cfg: RenderConfig, o, d, time, keys, tables=None):
    """Trace a ray batch to radiance [N, 3].

    o, d: planar (x, y, z) of [N] f32; time: [N] f32; keys: [N] per-ray
    keys (int64 holding uint32, pixel and sample folded in). Equivalent of
    Scene::rayTrace (Scene.h:345-350) over a batch."""
    check_scene(scene, cfg)
    if tables is None:
        tables = prepare(scene)
    B = cfg.max_bounces
    state = _init_state(o, d, time)
    for b in range(B - 1):
        state = _bounce_core(scene, cfg, keys, state, b, tables=tables)
    state = _bounce_core(scene, cfg, keys, state, B - 1, last=True,
                         tables=tables)
    return _finish(state, cfg)
