"""Differentiable-rendering optimization loop (the port of
`tracer/train.py`): given a target image, recover trainable scene
parameters (sphere geometry, material albedos, texture and normal-map
texels, mesh vertices, camera pose) by gradient descent through the
renderer.

- Adam (`torch.optim.Adam` with optax.adam's defaults) on an L2 image loss;
- per-step metrics (loss, global grad norm, step time);
- (params, Adam state, step) checkpoints with EXACT resume, in the JAX
  package's layout: `train.npz` holds `step` and `leaf_i` in the order of
  `jax.tree_util.tree_leaves((params, optax.adam(lr).init(params)))`
  (the params by sorted name, Adam's int32 count, the first moments, the
  second moments), so a checkpoint written by `tracer.train.fit` resumes
  here and the reverse;
- the sharded step (`fit(mesh=)`, `make_step(mesh=)`): the render over a
  (dp, sp) mesh of ranks (`tracer_torch/dist/`), the gradients summed
  over the mesh, rank 0 writing the checkpoints;
- stale-pack safety: while atlas texels (tex_data / nm_data) train, the
  render takes `packed_atlas="off"` (the exact-atlas route), and the
  returned scene's packed twins are replaced by sentinels, since they
  encode the pristine u8 atlases.

Gradients flow through the shading of the selected hits; hit selection
is detached by design, so parameters whose loss signal is dominated by
coverage changes (large object offsets) are out of reach.

CLI: `python -m tracer_torch.cli train ...` (tracer_torch/cli.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed

from tracer_torch.core.config import RenderConfig
from tracer_torch.render.camera import Camera

# Scene fields that may be optimized (the JAX package's set)
SCENE_FIELDS = ("sph_center", "sph_radius", "mat_diffuse", "mat_ior",
                "mat_transparency", "mat_check1", "mat_check2",
                "mat_light_color", "mat_light_intensity",
                "tex_data", "nm_data", "mesh_verts",
                "quad_v0", "quad_er", "quad_eu")
ATLAS_FIELDS = ("tex_data", "nm_data")
CAM_FIELD = "cam_position"
CAM_QUAT_FIELD = "cam_quaternion"
CAM_FIELDS = (CAM_FIELD, CAM_QUAT_FIELD)
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8   # optax.adam's defaults


def split_params(scene, camera: Camera, trainable: Sequence[str]):
    """{name: leaf}: detached clones of the trainable tensors that require
    grad."""
    params = {}
    for k in trainable:
        if k == CAM_FIELD:
            v = camera.position
        elif k == CAM_QUAT_FIELD:
            # raw 4-vector; generate_rays normalizes, so the optimizer can
            # move it freely and the effective pose stays on SO(3)
            v = camera.quaternion
        elif k in SCENE_FIELDS:
            v = getattr(scene, k)
        else:
            raise ValueError(
                f"unknown trainable {k!r}; scene fields: {SCENE_FIELDS} "
                f"or camera fields: {CAM_FIELDS}")
        params[k] = v.detach().clone().requires_grad_(True)
    return params


def apply_params(scene, camera: Camera, params: Dict):
    """(scene, camera) with `params` substituted."""
    sfields = {k: v for k, v in params.items() if k not in CAM_FIELDS}
    scene = dataclasses.replace(scene, **sfields)
    if CAM_FIELD in params:
        camera = dataclasses.replace(camera, position=params[CAM_FIELD])
    if CAM_QUAT_FIELD in params:
        camera = dataclasses.replace(camera,
                                     quaternion=params[CAM_QUAT_FIELD])
    return scene, camera


def guard_config(cfg: RenderConfig, trainable: Sequence[str]):
    """Disable the packed-atlas fast paths when atlas texels are live
    optimization parameters (the stale-pack trap, module docstring)."""
    if any(k in ATLAS_FIELDS for k in trainable):
        return dataclasses.replace(cfg, packed_atlas="off")
    return cfg


def invalidate_packs(scene):
    """The scene with its packed-atlas twins replaced by 1-row sentinels
    on its device: every later render then takes the exact-atlas route,
    whatever the config (the routes need pack rows > 1)."""
    z = torch.zeros((1, 16), dtype=torch.int32, device=scene.device)
    return dataclasses.replace(
        scene, pair_mode=False,
        pair_pack=torch.zeros((1, 32), dtype=torch.int32,
                              device=scene.device),
        tex_pack=z, nm_pack=z.clone(), sky_pack=z.clone())


def _as_tensor(x) -> torch.Tensor:
    """A float32 tensor of an image given as a tensor or an array."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def _adam_default(lr: float):
    return lambda leaves: torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS,
                                           eps=ADAM_EPS)


def _ckpt_leaves(params: Dict, opt) -> list:
    """The checkpoint's leaves as numpy arrays, in the JAX package's
    layout for optax.adam: the params by sorted name, the int32 count, the
    first moments, the second moments (zeros before the first step)."""
    if not isinstance(opt, torch.optim.Adam):
        raise NotImplementedError(
            "checkpoints hold Adam's state only (torch.optim.Adam)")
    ps = [params[k] for k in sorted(params)]
    st = [opt.state.get(p, {}) for p in ps]
    count = int(st[0]["step"]) if st and "step" in st[0] else 0
    out = [p.detach().cpu().numpy() for p in ps]
    out.append(np.asarray(count, np.int32))
    for key in ("exp_avg", "exp_avg_sq"):
        out += [s[key].detach().cpu().numpy() if key in s
                else np.zeros(p.shape, np.float32) for s, p in zip(st, ps)]
    return out


def _save_ckpt(path: str, step: int, params: Dict, opt):
    arrays = {f"leaf_{i}": a for i, a in enumerate(_ckpt_leaves(params, opt))}
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.int64(step), **arrays)
    os.replace(tmp, path)  # atomic (render/film.py tile-ckpt discipline)


def _load_ckpt(path: str, params: Dict, opt) -> int:
    """Restore the params (in place) and Adam's state from `path`; returns
    the step. Every leaf's shape and dtype is checked against this run's.
    Adam's count becomes each param's `step`, which sets the bias
    corrections of the next update."""
    tmpl = _ckpt_leaves(params, opt)
    with np.load(path) as z:
        step = int(z["step"])
        leaves = []
        for i, t in enumerate(tmpl):
            a = z[f"leaf_{i}"]
            if a.shape != tuple(t.shape) or a.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: {a.shape}/{a.dtype} vs "
                    f"{t.shape}/{t.dtype} — trainable set or scene changed?")
            leaves.append(a)
    ps = [params[k] for k in sorted(params)]
    n = len(ps)
    with torch.no_grad():
        for p, a in zip(ps, leaves):
            p.copy_(torch.from_numpy(a))
    count = float(leaves[n])
    # load_state_dict moves the moments onto each param's device and
    # leaves `step` where this Adam keeps it
    state = {i: {"step": torch.tensor(count, dtype=torch.float32),
                 "exp_avg": torch.from_numpy(leaves[n + 1 + i]),
                 "exp_avg_sq": torch.from_numpy(leaves[2 * n + 1 + i])}
             for i in range(n)}
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    return step


def make_step(opt, cfg: RenderConfig, target, width: int, height: int,
              nsamples: int, mesh=None, cache=None):
    """The optimization step of `fit`: L2 image loss, its gradients by
    `loss.backward()`, one update of `opt` (which holds the params).

    With `mesh` (`dist.sharding.make_ray_mesh`) the render is sharded:
    each rank's loss is its dp block's share of the mean over all N * 3
    values (the block's mean over n_dp), the parameter gradients are
    all-reduced over the whole mesh after `backward()` (JAX's autodiff
    psums) and the loss over dp, so every rank takes the same update.

    Where the graph rule holds (`cache.active(pixel_ids, cfg, mesh)`: CUDA
    tensors, the kernels on, outside `disabled()`, not over a gloo mesh;
    every scene, the hand-written, the general and the plain autodiff
    backward), the step's body (the render, the loss, `loss.backward()`,
    on a mesh the collectives, and the grad norm) is one graph of `cache`
    (default `graphs.CACHE`, the counterpart of the JAX package's jitted
    step), captured at the first call and replayed from the second. Its
    key holds the config, width, height, samples and on a mesh its shape
    and this rank's (dp, sp) by value, and its arguments by shape: the
    scene and camera with the leaves in them, the leaves, the target, the
    pixel ids, the seed word and the frame's tables (`graphs.key_of`). So
    new leaves, a new scene of the same shapes or a new seed replay the
    graph; the leaves, which the update writes in place, are copied in
    at every step. The first call's warm-up runs the collectives before
    the capture, so NCCL's communicator exists before a captured
    collective. The gradients land in the graph's static buffers and each
    leaf's `.grad` is set to a copy of its own. The update stays eager:
    `opt.step()` after the replay, so the parameters, the Adam state and
    the checkpoints are those of the eager step, bit for bit.

    Returns step_fn(params, scene, camera, pixel_ids, seed) ->
    (loss, grad_norm), both 0-d tensors on the scene's device; grad_norm
    is the global norm of the (reduced) gradients (optax.global_norm)."""
    from tracer_torch.core import rng
    from tracer_torch.dist import sharding
    from tracer_torch.render import graphs, integrator
    from tracer_torch.render.renderer import render_pixels

    target = _as_tensor(target).reshape(-1, 3)
    cache = graphs.CACHE if cache is None else cache

    def body(s, c, leaves, tgt, pixel_ids, word, tables):
        """The loss, the grad norm and each leaf's gradient, from leaves
        whose `.grad` is None (inside a capture: allocated in the
        graph's pool)."""
        for p in leaves:
            p.grad = None
        with torch.enable_grad():
            if mesh is None:
                img = render_pixels(s, c, cfg, width, height, pixel_ids,
                                    nsamples, word, tables=tables) / nsamples
                loss = torch.mean((img - tgt) ** 2)
            else:
                img = sharding.render_pixels_sharded(
                    s, c, cfg, width, height, pixel_ids, nsamples, word,
                    mesh, tables=tables)
                nb = img.shape[0]
                blk = tgt[mesh.dp_rank * nb:(mesh.dp_rank + 1) * nb]
                loss = torch.mean((img - blk) ** 2) / mesh.shape["dp"]
            loss.backward()
        loss = loss.detach()
        if mesh is not None:
            sharding.all_reduce_grads(mesh, leaves)
            loss = sharding.sum_over_dp(mesh, loss)
        gnorm = torch.sqrt(torch.stack([
            torch.sum(p.grad * p.grad) if p.grad is not None
            else p.new_zeros(()) for p in leaves]).sum())
        return loss, gnorm, [p.grad for p in leaves]

    def step_fn(params, scene, camera, pixel_ids, seed):
        nonlocal target
        target = tgt = target.to(pixel_ids.device)   # moved once
        leaves = [params[k] for k in sorted(params)]
        opt.zero_grad(set_to_none=True)
        s, c = apply_params(scene, camera, params)
        args = (s, c, leaves, tgt, pixel_ids,
                rng.seed_tensor(seed, pixel_ids.device),
                integrator.prepare(s))
        if cache.active(pixel_ids, cfg, mesh):
            loss, gnorm, grads = cache.call(
                ("step", cfg, width, height, nsamples)
                + sharding.mesh_key(mesh), body, args)
            for p, g in zip(leaves, grads):
                p.grad = g
        else:
            loss, gnorm, _ = body(*args)
        opt.step()
        return loss, gnorm

    return step_fn


def fit(scene, camera: Camera, cfg: RenderConfig, target,
        trainable: Sequence[str], steps: int, lr: float = 1e-2,
        width: Optional[int] = None, height: Optional[int] = None,
        nsamples: Optional[int] = None, seed: Optional[int] = None,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
        log: Optional[Callable[[str], None]] = None, mesh=None,
        optimizer: Optional[Callable] = None):
    """Optimize `trainable` so the render matches `target` [H, W, 3].

    Returns (scene, camera, history); history holds one metric dict a
    step (step, loss, grad_norm, step_s). `seed` (default cfg.seed) is the
    JAX package's `jax.random.key(seed)`. `optimizer` takes the list of
    leaves and returns a torch.optim.Optimizer (default Adam with lr and
    optax.adam's betas and eps). With `ckpt_dir`, resumes from
    `ckpt_dir/train.npz` if present (a checkpoint of either package) and
    checkpoints every `ckpt_every` steps and at the last (exact resume).
    With `mesh` (`dist.sharding.make_ray_mesh`) every rank runs the
    sharded step (`make_step`); rank 0 alone writes the checkpoints and
    every rank loads them, in the same format, so a sharded run resumes
    unsharded and the reverse.
    """
    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    cfg = guard_config(cfg, trainable)
    seed = cfg.seed if seed is None else seed
    pixel_ids = torch.arange(width * height, dtype=torch.int32,
                             device=scene.device)
    target = _as_tensor(target).to(scene.device)

    params = split_params(scene, camera, trainable)
    leaves = [params[k] for k in sorted(params)]
    opt = (optimizer or _adam_default(lr))(leaves)
    step_fn = make_step(opt, cfg, target, width, height, nsamples, mesh)

    start = 0
    ckpt_path = None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt_path = os.path.join(ckpt_dir, "train.npz")
        if os.path.exists(ckpt_path):
            start = _load_ckpt(ckpt_path, params, opt)

    history = []
    for s in range(start, steps):
        t0 = time.perf_counter()
        loss, gnorm = step_fn(params, scene, camera, pixel_ids, seed)
        rec = {"step": s + 1, "loss": float(loss),
               "grad_norm": float(gnorm),
               "step_s": round(time.perf_counter() - t0, 4)}
        history.append(rec)
        if log:
            log(json.dumps(rec))
        if ckpt_path and ((s + 1) % ckpt_every == 0 or s + 1 == steps):
            if mesh is None or mesh.rank == 0:
                _save_ckpt(ckpt_path, s + 1, params, opt)
            if mesh is not None and mesh.group is not None:
                torch.distributed.barrier(group=mesh.group)

    final = {k: v.detach() for k, v in params.items()}
    scene, camera = apply_params(scene, camera, final)
    if any(k in ATLAS_FIELDS for k in trainable):
        scene = invalidate_packs(scene)
    return scene, camera, history
