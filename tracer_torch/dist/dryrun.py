"""The twin of the JAX package's `dryrun_multichip` (`__graft_entry__.py`):
`dryrun_multichip(n)` spawns n ranks (`launch.run`) and runs ONE sharded
training step (`sharding.train_step`, the product's step) on
`zoo.setup_rt_in_a_weekend()` at 96x48, 3 bounces, 2 shadow rays, on a
(n / n_sp, n_sp) mesh with n_sp = 2 where n is even. The scene's three
finite-radius lights put the soft-shadow path in the step.

    python -m tracer_torch.dist.dryrun 2            # two ranks
    python -m tracer_torch.dist.dryrun 2 --device cpu

Without N, the process is one rank of a group started by the caller, from
the JAX package's variables (`multihost.initialize`), e.g. one a card:

    for r in 0 1 2 3; do
      JAX_COORDINATOR=localhost:29500 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=$r \
        LOCAL_RANK=$r LOCAL_WORLD_SIZE=4 python -m tracer_torch.dist.dryrun &
    done; wait
"""

from __future__ import annotations

import argparse
import math

import torch

WIDTH, HEIGHT = 96, 48


def _rank_step(device: str) -> dict:
    """One rank's step (runs inside the process group)."""
    import torch.distributed as dist

    from tracer_torch.core.config import RenderConfig
    from tracer_torch.dist.sharding import make_ray_mesh, train_step
    from tracer_torch.render.camera import default_camera
    from tracer_torch.scene.device import compile_scene
    from tracer_torch.scenes import zoo

    n = dist.get_world_size()
    n_sp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_ray_mesh(n_dp=n // n_sp, n_sp=n_sp)
    scene = compile_scene(zoo.setup_rt_in_a_weekend(), device=device)
    camera = default_camera(WIDTH / HEIGHT, device=device)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_bounces=3,
                       shadow_rays=2)
    if scene.light_pos.shape[0] < 1:
        raise RuntimeError("the dry-run scene must have lights")
    n_pix = WIDTH * HEIGHT
    n_pix -= n_pix % mesh.shape["dp"]
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=scene.device)
    target = torch.zeros((n_pix, 3), dtype=torch.float32)
    loss, new_scene, new_camera = train_step(
        scene, camera, cfg, WIDTH, HEIGHT, pixel_ids, target, 2 * n_sp, 0,
        mesh)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    return dict(mesh=dict(mesh.shape), loss=loss,
                sph_center=new_scene.sph_center.cpu().numpy(),
                cam_position=new_camera.position.cpu().numpy())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the sharded step on `n_devices` ranks; returns rank 0's result
    (mesh shape, loss, updated sphere centres and camera position) after
    checking that every rank took the same update. The ranks talk over
    NCCL when there is a card for each, else over gloo (ranks sharing a
    card, or the CPU); the printed line names the backend."""
    from tracer_torch.dist import launch

    backend = ("nccl" if device == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    res = launch.run(_rank_step, n_devices, (device,), device=device,
                     backend=backend)
    for r in res[1:]:
        if (r["loss"] != res[0]["loss"]
                or not (r["sph_center"] == res[0]["sph_center"]).all()):
            raise RuntimeError("the ranks' updates differ")
    print(f"dryrun_multichip({n_devices}): mesh={res[0]['mesh']} "
          f"backend={backend} device={device} loss={res[0]['loss']:.6f} OK")
    return res[0]


def _env_rank(device: str) -> None:
    """One rank of a caller-started group (the env vars); prints the
    rank's step."""
    import torch.distributed as dist

    from tracer_torch.dist import multihost

    multihost.initialize(device=device)
    if not dist.is_initialized():
        raise SystemExit("no N and no group: set JAX_COORDINATOR, "
                         "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
    try:
        rank = dist.get_rank()
        res = _rank_step(device)
    finally:
        multihost.shutdown()
    print(f"dryrun rank {rank}: mesh={res['mesh']} device={device} "
          f"loss={res['loss']:.6f} OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?",
                    help="ranks to spawn (default: this process is one "
                    "rank, from the env vars)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    if a.n is None:
        _env_rank(a.device)
    else:
        dryrun_multichip(a.n, a.device)
