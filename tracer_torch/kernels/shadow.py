"""Soft-shadow kernel: per light, K jittered shadow rays from each hit point
and, per ray, one stochastic-transparency Bernoulli test against every
occluder (spheres, quads and meshes); the factor is 1 - mean_k(blocked).

Replaces the TPU kernel `tracer/kernels/shadow.py::shadow_factors`
(Pallas, `pl.pallas_call` at shadow.py:533) with the CUDA kernel
`csrc/shadow.cu`: one work item per (hit point, light, sample), in two
CUDA kernels per call: a pass that draws every sample's ray, tests the
sphere and quad tables and the meshes' root boxes and ends most samples,
then persistent threads that take the remaining samples from a work
counter and walk them; each sample is counted exactly in an int32 word
per (light, hit point). The semantics are those of the
JAX package's jnp path (`integrator._shadow_factor_jnp` and
`_shadow_blocked_p`), which `shadow_factors_plain` ports as a [K*N]
megabatch per light, with the same expressions in the same order.

The RNG streams (PCG): light jitter on purpose 4 (SHADOW_LIGHT_POS), light
i, lanes k*3+a+2 (cube, compat="reference") or k*2+a+2 (sphere); the
Bernoulli draws on purpose 5, light i, lane k+2, then occluder row o+2
with spheres first (padded rows included), then quads, then meshes. Every
occluder's draw has its own key, so the blocked OR does not depend on the
order of the tests.

A mesh blocks when its closest raw hit lies in [eps, t_light) and its draw
exceeds its transparency. The TPU kernel shares one packet walk among the
K samples of a light (its K-amortised union walk, whose unguarded
reciprocals are ROADMAP Queue C's); here each sample's ray walks on its
own (`bvh.cuh`), starting with its best t at t_light (the TPU walk's
per-lane `tmax`: a hit at or beyond the light never blocks), and the
kernel skips a mesh's walk where it cannot change the result: the sample
is already blocked, or the mesh's draw is at most its transparency. The
closest hit still decides, so the walk has no any-hit exit: a hit in
[0, eps) unblocks the sample (the reference's eps quirk).

What bounds it on an H100: the walks' chains of dependent L2 loads, not
bytes. A hit point reads 24 B and writes 4 B per light; per light it
traces K rays, each tested against every sphere and quad (from dynamic
shared memory, or through L2 when the tables exceed a block's 227 KB:
`TABLES`) and walked through every mesh's BVH (the plain version counts
the tests, and the visits and triangle tests of each shadow ray, into
its `stats`). The meshes'
node ranges come as a device array (`traverse.mesh_ranges`): any number
of meshes.

Lanes with `live` false return 1.0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.geometry import primitives as prim
from tracer_torch.kernels import common as kc
from tracer_torch.kernels import traverse as ktraverse

GLASS = 1
LAUNCHES = 0   # launches of the CUDA kernel (not of the plain version)
TABLES = None  # "shared" or "global": where the last launch's tables sat


def shadow_tables(scene):
    """(light [L, 4], sph [S, 9], quad [Q, 20], mesh [Nm] f32), the TPU
    kernel's tables (`tracer/kernels/shadow.py::shadow_tables`) plus the
    meshes' transparency.

    light: pos(3), radius / 2; sph: c(3), r^2, mb(3), valid, transparency;
    quad: n(3), er(3), eu(3), v0.n, mb.n, v0.er, mb.er, v0.eu, mb.eu,
    er.er, eu.eu, glass, valid, transparency."""
    def f(a):
        return a.to(torch.float32)[:, None]

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]
                + a[:, 2] * b[:, 2])[:, None]

    light = torch.cat([scene.light_pos, (scene.light_radius / 2.0)[:, None]],
                      dim=1)
    sm = scene.sph_mat
    sph = torch.cat([
        scene.sph_center, (scene.sph_radius * scene.sph_radius)[:, None],
        scene.mat_mb[sm], scene.sph_valid[:, None],
        scene.mat_transparency[sm][:, None]], dim=1)
    n, er, eu, v0 = (scene.quad_normal, scene.quad_er, scene.quad_eu,
                     scene.quad_v0)
    qm = scene.quad_mat
    mbq = scene.mat_mb[qm]
    quad = torch.cat([
        n, er, eu, dot(v0, n), dot(mbq, n), dot(v0, er), dot(mbq, er),
        dot(v0, eu), dot(mbq, eu), dot(er, er), dot(eu, eu),
        f(scene.mat_type[qm] == GLASS), scene.quad_valid[:, None],
        scene.mat_transparency[qm][:, None]], dim=1)
    mesh = scene.mat_transparency[scene.mesh_mat]
    return (light.contiguous(), sph.contiguous(), quad.contiguous(),
            mesh.contiguous())


def shadow_factors(scene, cfg, p, time, keys, eps, live=None,
                   kernels="auto", tables=None, tree=None, salt=None):
    """Soft-shadow factors [L, N] f32 for planar hit points p ([N] f32
    each), ray times [N] and this bounce's keys [N] (int64 holding uint32)
    or, with `salt` (the bounce index), the sample's keys, which the pass
    salts itself (`rng.salted(keys, salt)`); 1.0 on lanes with `live`
    false. `tables`: a precomputed `shadow_tables`; `tree`: the scene's
    `traverse.traverse_tables` (mesh scenes)."""
    if tables is None:
        tables = shadow_tables(scene)
    if tree is None and scene.mesh_mat.shape[0] > 0:
        tree = ktraverse.traverse_tables(scene)
    if live is None:
        live = torch.ones_like(p[0], dtype=torch.bool)
    if kc.use_kernel(kernels, p[0]):
        return _shadow_factors_cuda(scene, cfg, p, time, keys, eps, live,
                                    tables, tree, salt)
    if salt is not None:
        keys = rng.salted(keys, salt)
    return shadow_factors_plain(scene, cfg, p, time, keys, eps, live,
                                tables, tree)


def _sample_rays(cfg, light_row, p, skeys, k: int):
    """Shadow sample k toward a light (`integrator._shadow_factor_jnp`):
    (origin, unit direction, distance to the jittered light point)."""
    ruv = (rng.cube_unit_vector_lane_p(skeys, k)
           if cfg.compat == "reference"
           else rng.sphere_unit_vector_lane_p(skeys, k))
    delta = light_row[3]
    off = tuple((delta * ruv[a] + light_row[a]) - p[a] for a in range(3))
    t_light = torch.sqrt(off[0] * off[0] + off[1] * off[1]
                         + off[2] * off[2])
    inv = 1.0 / torch.clamp_min(t_light, 1e-20)
    sd = tuple(inv * c for c in off)
    so = tuple(cfg.epsilon * sd[a] + p[a] for a in range(3))
    return so, sd, t_light


def shadow_factors_plain(scene, cfg, p, time, keys, eps, live, tables,
                         tree=None, stats=None):
    """The plain PyTorch version: per light, the K samples of every live
    lane as one megabatch, the table candidates, the meshes' closest hits
    below t_light (`traverse.mesh_walk_plain` bounded by each sample's
    t_light, for the samples whose result a walk can change, as the kernel
    does), the Bernoulli draws, and 1 - mean_k(blocked). `stats`, a dict,
    gains the shadow rays ("rays"), the sphere and quad tests a sample
    needs before it is blocked ("table_tests"), the walks' counts
    (`primitives.skip_walk`) and "lane_counts": [2, rays] int64, each
    shadow ray's node visits and real triangle tests over the meshes."""
    light, sph, quad, mesh = tables
    L, K = light.shape[0], cfg.shadow_rays
    S, Q = sph.shape[0], quad.shape[0]
    S_real, Q_real = min(scene.n_sph_real, S), min(scene.n_quad_real, Q)
    N = p[0].shape[0]
    out = torch.ones((L, N), dtype=torch.float32, device=p[0].device)
    idx = torch.nonzero(live)[:, 0]
    n = idx.numel()
    if n == 0:
        return out
    pl = tuple(c[idx] for c in p)
    tm = time[idx].repeat(K)
    kl = keys[idx]
    per_light = [torch.zeros((2, 0), dtype=torch.int64, device=p[0].device)]
    for i in range(L):
        skeys = rng.salted(kl, rng.SHADOW_LIGHT_POS, i)
        bkey = rng.salted(kl, rng.SHADOW_BERNOULLI, i)
        rays = [_sample_rays(cfg, light[i], pl, skeys, k) for k in range(K)]
        so = tuple(torch.cat([r[0][a] for r in rays]) for a in range(3))
        sd = tuple(torch.cat([r[1][a] for r in rays]) for a in range(3))
        tl = torch.cat([r[2] for r in rays])
        bk = torch.cat([rng.uniform_lane_key_p(bkey, k) for k in range(K)])

        a2 = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]
        blocked = torch.zeros_like(tl, dtype=torch.bool)

        def count_test():
            # the tests a sample needs: those up to the first that blocks
            if stats is not None:
                stats["table_tests"] = (stats.get("table_tests", 0)
                                        + int((~blocked).sum()))

        for s in range(S_real):
            r = sph[s]
            t, ok = prim.sphere_t(so, sd, a2, tm, (r[0], r[1], r[2]), r[3],
                                  (r[4], r[5], r[6]), r[7], eps)
            count_test()
            blocked |= ok & (t < tl) & (rng.lane_uniform(bk, s) > r[8])
        for q in range(Q_real):
            t, ok = prim.quad_t(so, sd, tm, quad[q], eps,
                                cols=prim.QUAD_COLS_SHADOW)
            count_test()
            blocked |= ok & (t < tl) & (rng.lane_uniform(bk, S + q)
                                        > quad[q, 19])
        counts = (torch.zeros((2, K * n), dtype=torch.int64, device=tl.device)
                  if stats is not None else None)
        for m in range(mesh.shape[0]):
            # a walk changes only samples not yet blocked whose draw
            # exceeds the mesh's transparency: the others skip it. A hit
            # at or beyond t_light never blocks, so the walk starts there
            draw = rng.lane_uniform(bk, S + Q + m) > mesh[m]
            t_raw, _ = ktraverse.mesh_walk_plain(scene, so, sd, m,
                                                 draw & ~blocked, tree, stats,
                                                 tmax=tl, lane_counts=counts)
            blocked |= (t_raw >= eps) & (t_raw < tl) & draw
        if stats is not None:
            stats["rays"] = stats.get("rays", 0) + K * n
            per_light.append(counts)
        # 1 - mean_k: jnp.mean compiles to the sum times f32(1/K) (XLA
        # turns a division by a constant into a reciprocal multiply)
        inv_k = float(np.float32(1.0) / np.float32(K))
        out[i, idx] = 1.0 - blocked.to(torch.float32).reshape(K, n).sum(0) \
            * inv_k
    if stats is not None:
        stats["lane_counts"] = torch.cat(per_light, dim=1)
    return out


class _Args(ctypes.Structure):
    """Mirror of `ShadowArgs` in csrc/shadow.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "px", "py", "pz", "tm", "key", "live", "light", "sph", "quad",
        "mesh", "nodes_f", "nodes_i", "leaf", "out", "counts", "tasks",
        "work", "ranges")] + [
        (name, ctypes.c_int) for name in (
            "n", "n_meshes", "leaf_width", "blocks", "shared_tables")] + [
        ("L", ctypes.c_int), ("S", ctypes.c_int), ("S_real", ctypes.c_int),
        ("Q", ctypes.c_int), ("Q_real", ctypes.c_int), ("K", ctypes.c_int),
        ("ref", ctypes.c_int), ("eps", ctypes.c_float),
        ("offset_eps", ctypes.c_float), ("salt", ctypes.c_int)]


def _shadow_factors_cuda(scene, cfg, p, time, keys, eps, live, tables, tree,
                         salt=None):
    from tracer_torch.kernels import _build
    global LAUNCHES, TABLES
    light, sph, quad, mesh = tables
    dev = p[0].device
    N = p[0].shape[0]
    L, S, Q, Nm = light.shape[0], sph.shape[0], quad.shape[0], mesh.shape[0]
    S_real, Q_real = min(scene.n_sph_real, S), min(scene.n_quad_real, Q)
    K = cfg.shadow_rays
    if not 0 < K < 2 ** 16:
        raise ValueError("shadow_factors: the kernel counts 1 to 65535 "
                         f"samples per light, got shadow_rays={K}")
    ktraverse.check_items("shadow", L * N * K)
    f32 = torch.float32
    a = _Args()
    for name, t in zip(("px", "py", "pz"), p):
        setattr(a, name, kc.check(name, t, f32, (N,), dev))
    a.tm = kc.check("time", time, f32, (N,), dev)
    a.key = kc.check("keys", keys, torch.int64, (N,), dev)
    a.live = kc.check("live", live, torch.bool, (N,), dev)
    a.light = kc.check("light", light, f32, (L, 4), dev)
    a.sph = kc.check("sph", sph, f32, (S, 9), dev)
    a.quad = kc.check("quad", quad, f32, (Q, 20), dev)
    if Nm > 0:
        a.mesh = kc.check("mesh", mesh, f32, (Nm,), dev)
        ktraverse.fill_tree_args(a, scene, tree, dev)
    out = torch.empty((L, N), dtype=f32, device=dev)
    # the (light, lane) sample counts, then the task count and the walk's
    # work counter, all zeroed in one fill; the samples to walk (at most
    # all of them)
    counts = torch.zeros((L * N + 2,), dtype=torch.int32, device=dev)
    tasks = torch.empty((L * N * K if Nm > 0 else 1, 2), dtype=torch.int32,
                        device=dev)
    a.out, a.counts = out.data_ptr(), counts.data_ptr()
    a.tasks, a.work = tasks.data_ptr(), counts[L * N:].data_ptr()
    a.n, a.n_meshes = N, Nm
    a.L, a.S, a.S_real, a.Q, a.Q_real = L, S, S_real, Q, Q_real
    a.K, a.ref = K, int(cfg.compat == "reference")
    a.eps, a.offset_eps = float(eps), float(cfg.epsilon)
    a.salt = -1 if salt is None else salt
    if N > 0 and L > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_shadow(ctypes.addressof(a), stream)
        kc.raise_on_error("shadow", err)
        LAUNCHES += 1
        TABLES = "shared" if a.shared_tables else "global"
    return out
