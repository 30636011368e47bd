"""Start a group of local ranks: `run(fn, n)` spawns n processes
(`torch.multiprocessing.start_processes`, start method spawn, safe after
CUDA is initialized), joins them into one process group at a free
localhost port (`multihost.initialize`), calls `fn(*args)` on each and
returns the ranks' results in rank order.

`fn` is pickled by its import path, so a rank imports only `fn`'s module:
the tests keep their rank bodies in `tracer_torch.testing`, whose imports
are the port's (no `jax`). A rank's exception is re-raised in the caller
with its traceback, and the other ranks are stopped.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Optional, Sequence

TIMEOUT_S = 600.0   # a group that has not finished by then is stopped


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, fn, args, device, backend, local_world_size,
               out):
    import torch

    from tracer_torch.dist import multihost

    if local_world_size is not None:
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    if device == "cpu":   # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        multihost.initialize(f"localhost:{port}", n, rank, device=device,
                             backend=backend)
        out.put((rank, fn(*args)))
    finally:
        multihost.shutdown()


def run(fn: Callable, n: int, args: Sequence = (), device: str = "cuda",
        backend: Optional[str] = None,
        local_world_size: Optional[int] = None) -> list:
    """Run `fn(*args)` on `n` spawned ranks of one process group (see the
    module docstring); returns [result of rank 0, ..., rank n-1]. `device`
    and `backend` go to `multihost.initialize` (for "cuda", one card a
    rank over NCCL by default, and the kernel library is built here first
    so that the ranks only load it); `local_world_size` sets
    LOCAL_WORLD_SIZE (the ranks a host, `multihost.make_pod_mesh`); CPU
    ranks split this host's cores between them. Raises if a rank fails
    (torch's ProcessRaisedException, with its traceback) or RuntimeError
    if the group exceeds TIMEOUT_S seconds."""
    import torch.multiprocessing as mp

    if device == "cuda":   # built once here, not raced by the ranks
        from tracer_torch.kernels import _build
        _build.library()
    out = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, (n, free_port(), fn, tuple(args), device, backend,
                     local_world_size, out),
        nprocs=n, join=False, start_method="spawn")
    results = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        # drain the results while joining: a rank blocks in put() until
        # its (possibly large) result is read
        while not ctx.join(timeout=1.0):
            while not out.empty():
                rank, res = out.get()
                results[rank] = res
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{n} ranks of {fn.__name__} exceeded {TIMEOUT_S} s")
        while not out.empty():
            rank, res = out.get()
            results[rank] = res
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
        out.close()
    return [results[r] for r in range(n)]
