"""Distribution over ranks (the port of `tracer/dist/sharding.py`).

The JAX package runs one process over many devices and shards with
`shard_map`; torch.distributed runs one process per device (a rank), so
the same (dp, sp) mesh is a grid of ranks:

- **dp**: each rank traces a contiguous block of the pixel ids (the
  analog of the reference's scanline threads, `main.cpp:229-238`);
- **sp**: each rank traces a contiguous block of the samples; the
  partial sums are all-reduced over the sp group.

Scene and camera are replicated: every rank builds or loads the same
tensors (the scene build is deterministic). Only the parameter gradients
cross ranks: `train.make_step` all-reduces them over the whole mesh after
`backward()`, the sum JAX's autodiff psums give. The sp reduction's
backward is the identity (`_SumOverGroup`): an all-reduce there would
multiply every parameter gradient by n_sp.

A pixel's rank is a pure function of its position in `pixel_ids` and the
mesh's shape, and a sample's random streams depend only on its global
index, so a sharded render traces the same rays as an unsharded one.

Compiled: on the card the sharded frame (`sharded_sum` without grad, as
`render_image_multihost` calls it: the JAX package's
`jax.jit(render_pixels_sharded)`) replays the frame's graph of one sample
(`renderer.render_frame`) and all-reduces the sp sum after it, and the
sharded step (`train.make_step(mesh=)`) is a CUDA graph
(`render/graphs.py`) that holds the render and the NCCL collectives; a
gloo mesh stays eager (`RayMesh.capturable`). `collective_spans` times
collectives on the eager route only: a captured collective cannot be
synchronised around.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from tracer_torch.core.config import RenderConfig
from tracer_torch.render.camera import Camera
from tracer_torch.render import graphs
from tracer_torch.render.renderer import render_frame, render_pixels


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A (dp, sp) grid of ranks (`make_ray_mesh`). `shape` is
    {"dp": n_dp, "sp": n_sp} like a JAX mesh's; `dp_rank`, `sp_rank` this
    rank's coordinate; `dp_group` / `sp_group` the process groups along
    each axis and `group` the whole mesh's (all None for the one-rank
    mesh of a process without a process group)."""
    shape: dict
    dp_rank: int = 0
    sp_rank: int = 0
    dp_group: Optional[object] = None
    sp_group: Optional[object] = None
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (row-major over (dp, sp))."""
        return self.dp_rank * self.shape["sp"] + self.sp_rank

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold a route's collectives over this
        mesh (`graphs.GraphCache.active`): no process group (no
        collective runs), or NCCL's, which a capture records as kernels on
        its stream. Gloo's collectives run on the host (a CUDA tensor goes
        through host memory), so a route over a gloo mesh stays eager."""
        return self.group is None or dist.get_backend(self.group) == "nccl"


def make_ray_mesh(n_dp: Optional[int] = None, n_sp: int = 1) -> RayMesh:
    """A (dp, sp) mesh over every rank of the initialized process group
    (`torch.distributed.device_mesh.init_device_mesh`, dims named "dp" and
    "sp"); rank r sits at (r // n_sp, r % n_sp), the order of JAX's
    `devices.reshape(n_dp, n_sp)`. `n_dp` defaults to world // n_sp.
    Without a process group only the (1, 1) mesh exists: one process
    renders everything and no collective runs. The DeviceMesh's device is
    "cuda" under NCCL, else "cpu" (gloo ranks may still hold CUDA
    tensors)."""
    if not dist.is_initialized():
        if (n_dp or 1) != 1 or n_sp != 1:
            raise RuntimeError(
                f"a ({n_dp}, {n_sp}) mesh needs an initialized process "
                "group (tracer_torch.dist.multihost.initialize)")
        return RayMesh({"dp": 1, "sp": 1})
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(f"a ({n_dp}, {n_sp}) mesh needs {n_dp * n_sp} "
                         f"ranks; the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (n_dp, n_sp),
                          mesh_dim_names=("dp", "sp"))
    i, j = dm.get_coordinate()
    return RayMesh({"dp": n_dp, "sp": n_sp}, i, j, dm.get_group("dp"),
                   dm.get_group("sp"), dist.group.WORLD)


_SPANS: Optional[list] = None   # set by `collective_spans`


@contextlib.contextmanager
def collective_spans():
    """Record each collective this process runs inside the block as
    (name, seconds) in the list it yields. A CUDA tensor's card is
    synchronised before and after each collective, so a span is the
    collective's own time and the run loses its overlap: for measurement
    only. Outside the block a collective costs one test of a global."""
    global _SPANS
    prev, _SPANS = _SPANS, []
    try:
        yield _SPANS
    finally:
        _SPANS = prev


def collective(op, tensor, *args, **kwargs):
    """`op(tensor, *args, **kwargs)` (a torch.distributed collective),
    timed into `collective_spans`' list when one is open. A span
    synchronises the card, which a capture refuses: time collectives on
    the eager route (`graphs.CACHE.disabled()`)."""
    if _SPANS is None:
        return op(tensor, *args, **kwargs)
    cuda = (tensor[0] if isinstance(tensor, list) else tensor).is_cuda
    if cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("collective_spans: a captured collective cannot "
                           "be timed; run the route inside "
                           "graphs.CACHE.disabled()")
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = op(tensor, *args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
    _SPANS.append((op.__name__, time.perf_counter() - t0))
    return out


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(SUM) over `group`, with the identity as its backward.
    Every rank of the group holds the same sum of the ranks' partials, so
    the cotangent of a rank's partial is the sum's cotangent on that rank;
    the parameter gradients are summed over the mesh once, after
    `backward()` (`all_reduce_grads`)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        collective(dist.all_reduce, y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _check(mesh: RayMesh, n_pix: int, nsamples: int):
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    if n_pix % n_dp:
        raise ValueError(f"{n_pix} pixel ids do not split over dp={n_dp}")
    if nsamples % n_sp:
        raise ValueError(f"nsamples={nsamples} does not split over "
                         f"sp={n_sp}")


def mesh_key(mesh: Optional[RayMesh]) -> tuple:
    """A sharded route's part of a graph's key: the mesh's shape and this
    rank's (dp, sp); () without a mesh."""
    if mesh is None:
        return ()
    return ("mesh", mesh.shape["dp"], mesh.shape["sp"], mesh.dp_rank,
            mesh.sp_rank)


def sharded_sum(scene, camera: Camera, cfg: RenderConfig, width: int,
                height: int, pixel_ids, nsamples: int, seed,
                mesh: RayMesh, tables=None):
    """This rank's dp block of the SUM over the `nsamples` samples
    ([N / n_dp, 3], summed over the sp group); see
    `render_pixels_sharded`. Without grad it is the sharded frame: where
    the rule holds (`graphs.CACHE.active(pids, cfg, mesh)`: not over
    gloo) this rank's pixels and samples go through
    `renderer.render_frame`'s graph (one sample, replayed once a sample
    from the rank's first sample; the frame's key, by shape), and the sp
    sum's all-reduce follows the samples. With grad mode on it runs
    eagerly (`train.make_step(mesh=)` captures the whole step around it,
    with `seed` as the step's seed word and `tables` its tables)."""
    _check(mesh, pixel_ids.shape[0], nsamples)
    nb = pixel_ids.shape[0] // mesh.shape["dp"]
    k = nsamples // mesh.shape["sp"]
    first = mesh.sp_rank * k
    pids = pixel_ids[mesh.dp_rank * nb:(mesh.dp_rank + 1) * nb]
    if torch.is_grad_enabled() or not graphs.CACHE.active(pids, cfg, mesh):
        rad = render_pixels(scene, camera, cfg, width, height, pids, k, seed,
                            first_sample=first, tables=tables)
    else:
        rad = render_frame(scene, camera, cfg, width, height, pids, k, seed,
                           first_sample=first)
    if mesh.shape["sp"] > 1:
        rad = _SumOverGroup.apply(rad, mesh.sp_group)
    return rad


def render_pixels_sharded(scene, camera: Camera, cfg: RenderConfig,
                          width: int, height: int, pixel_ids, nsamples: int,
                          seed, mesh: RayMesh, tables=None):
    """Mean radiance of this rank's pixels: the dp block `i` of the full
    `pixel_ids` [N] (every rank passes the same ids, as JAX's global
    array), over the samples of sp block `j` (global sample ids, so the
    rays are the unsharded render's) summed over the sp group and divided
    by `nsamples`. Returns [N / n_dp, 3], the local shard of JAX's
    dp-sharded [N, 3]. N must split over dp and `nsamples` over sp.
    Differentiable with respect to the scene's and the camera's tensors;
    sum the parameter gradients over the mesh (`all_reduce_grads`) for
    those of the whole image's loss. `seed` and `tables` as
    `renderer.render_pixels` takes them."""
    return sharded_sum(scene, camera, cfg, width, height, pixel_ids,
                       nsamples, seed, mesh, tables) / nsamples


def all_reduce_grads(mesh: RayMesh, leaves):
    """Sum the gradients of `leaves` over every rank of the mesh, in one
    collective (a leaf without a gradient takes zeros, as JAX's); nothing
    to do on a mesh without a process group."""
    if mesh.group is None:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective(dist.all_reduce, flat, group=mesh.group)
    for p, g in zip(leaves, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def sum_over_dp(mesh: RayMesh, x):
    """`x` summed over the dp group (the blocks' shares of a loss)."""
    if mesh.shape["dp"] == 1:
        return x
    x = x.clone()
    collective(dist.all_reduce, x, group=mesh.dp_group)
    return x


def train_step(scene, camera: Camera, cfg: RenderConfig, width: int,
               height: int, pixel_ids, target, nsamples: int, seed: int,
               mesh: RayMesh, lr: float = 1e-2):
    """One differentiable-rendering step over the mesh, by SGD (optax.sgd
    in the JAX package): a thin delegation to `train.make_step`, the step
    `fit()` runs, with the JAX package's trainables (sph_center,
    sph_radius, mat_diffuse, tex_data, mesh_verts, cam_position) and its
    stale-pack guard. Returns (loss, new_scene, new_camera); the loss is
    the whole image's. A one-shot step (its optimizer and leaves are made
    for the one call): it runs eagerly, inside `graphs.CACHE.disabled()`
    (`fit(mesh=)` and a kept `make_step(mesh=)` replay theirs)."""
    from tracer_torch import train as T

    trainable = ["sph_center", "sph_radius", "mat_diffuse", "tex_data",
                 "mesh_verts", "cam_position"]
    cfg = T.guard_config(cfg, trainable)
    params = T.split_params(scene, camera, trainable)
    opt = torch.optim.SGD([params[k] for k in sorted(params)], lr=lr)
    step_fn = T.make_step(opt, cfg, target, width, height, nsamples, mesh)
    with graphs.CACHE.disabled():
        loss, _ = step_fn(params, scene, camera, pixel_ids, seed)
    new_scene, new_camera = T.apply_params(
        scene, camera, {k: v.detach() for k, v in params.items()})
    return loss, new_scene, new_camera
