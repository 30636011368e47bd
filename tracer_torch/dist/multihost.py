"""Multi-host execution (the port of `tracer/dist/multihost.py`): process
groups, host-major pod meshes and the cross-host film gather.

One process per card (a rank), on one host or many:

    from tracer_torch.dist import multihost as mh
    mh.initialize()                  # from JAX_COORDINATOR, ... (below)
    mesh = mh.make_pod_mesh()        # sp = the ranks of a host
    img = mh.render_image_multihost(scene, cam, cfg, mesh)  # every rank

The same environment variables as the JAX package's (`JAX_COORDINATOR`
host:port, `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`) start either package, so
one launch script drives both. `launch.run` starts a group of local ranks
(the tests' gloo groups on the CPU, and two ranks sharing one card).

The JAX package's `global_pixel_array` and `replicate` have no
counterpart: JAX places one global array over many devices, while each
torch rank holds its own tensors. `render_pixels_sharded` takes the full
pixel ids on every rank and slices its own block, and every rank builds
the same scene and camera (the build is deterministic), so nothing is
placed or broadcast.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tracer_torch.core.config import RenderConfig
from tracer_torch.core.spans import span
from tracer_torch.dist.sharding import (RayMesh, collective, make_ray_mesh,
                                        sharded_sum)
from tracer_torch.render.camera import Camera
from tracer_torch.render.renderer import finish_frame


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               backend: Optional[str] = None) -> None:
    """`torch.distributed.init_process_group` at tcp://`coordinator`
    (host:port), with the JAX package's env-var fallbacks
    (JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID). A no-op for a
    single process given no coordinator. `backend` defaults to NCCL for
    device="cuda" and gloo for "cpu"; a CUDA rank takes card LOCAL_RANK
    (the launcher's) or process_id modulo the card count. Gloo with
    device="cuda" is the two-ranks-on-one-card case (NCCL refuses it).
    Nothing falls back: a missing card or backend raises. End the group
    with `shutdown()`, not `dist.destroy_process_group()`: a graph that
    holds a captured NCCL collective (a compiled sharded frame or step)
    must go before its communicator, or the teardown hangs."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator is None:
        return
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "host:port (JAX_COORDINATOR)")
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Destroy the process group, if one was initialized, after dropping
    every cached graph (`graphs.CACHE.clear()`): a graph that holds a
    captured NCCL collective goes before its communicator."""
    from tracer_torch.render import graphs
    graphs.CACHE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def ranks_per_host() -> int:
    """The ranks on this rank's host: LOCAL_WORLD_SIZE (set by torchrun
    and by `launch.run`), else the card count under NCCL (one rank a
    card), else 1."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return int(local)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.cuda.device_count()
    return 1


def make_pod_mesh(n_sp: Optional[int] = None) -> RayMesh:
    """Host-major (dp, sp) mesh over every rank: sp (the sample sum, the
    collective-heavy axis) spans ranks WITHIN one host (`ranks_per_host`;
    default all of them), dp the hosts times the rest. Ranks are numbered
    host-major (rank = host * per_host + local), so each sp group is
    consecutive ranks of one host. Without a process group: (1, 1)."""
    if not dist.is_initialized():
        return make_ray_mesh(1, 1)
    world = dist.get_world_size()
    per_host = ranks_per_host()
    if n_sp is None:
        n_sp = per_host
    if world % per_host or per_host % n_sp:
        raise ValueError(f"world {world}, {per_host} ranks a host and "
                         f"n_sp={n_sp} make no host-major mesh")
    return make_ray_mesh(n_dp=world // n_sp, n_sp=n_sp)


def gather_film(rad, mesh: RayMesh) -> torch.Tensor:
    """The full [N, 3] film on EVERY rank, from each rank's dp block (an
    all_gather over the dp group; the blocks come in dp order), on
    `rad`'s device. Gloo gathers host copies, and its film goes back to
    that device, so a CUDA scene's film is finished on the card whatever
    the backend."""
    x = rad.detach()
    if mesh.shape["dp"] == 1:
        return x
    if dist.get_backend(mesh.dp_group) == "gloo":
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape["dp"])]
    collective(dist.all_gather, parts, x, group=mesh.dp_group)
    return torch.cat(parts).to(rad.device)


@torch.no_grad()
def render_image_multihost(scene, camera: Camera, cfg: RenderConfig,
                           mesh: RayMesh, width: Optional[int] = None,
                           height: Optional[int] = None,
                           nsamples: Optional[int] = None) -> np.ndarray:
    """Full-frame render over the mesh -> gamma-corrected [H, W, 3] on
    every rank. The pixels are padded to a multiple of dp (the pad
    re-renders pixels 0, 1, ... and is dropped), and the film, the sum
    over the samples, is finished as `render` finishes it
    (`renderer.finish_frame`): a CUDA scene's on the card before it
    leaves the card (the sharded sum itself at dp = 1, else its
    all-gather), then one copy of the image to the host; a CPU scene's
    by `film.to_image`. Under `render`'s spans: `render.launch`
    (the sharded sum), `render.copy_out` around the gather where dp > 1,
    then the finish's `render.to_image` and `render.copy_out`."""
    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    n_dp = mesh.shape["dp"]
    n_pix = width * height
    n_pad = ((n_pix + n_dp - 1) // n_dp) * n_dp
    with span("render.launch"):
        pids = torch.from_numpy(np.arange(n_pad, dtype=np.int32) % n_pix)
        rad = sharded_sum(scene, camera, cfg, width, height,
                          pids.to(scene.device), nsamples, cfg.seed, mesh)
    film = rad
    if n_dp > 1:
        with span("render.copy_out"):
            film = gather_film(rad, mesh)
    return finish_frame(film[:n_pix], nsamples, width, height, cfg.kernels)
