"""The sharded viewer: a closed loop of
`tracer_torch.dist.multihost.render_image_multihost` on
`multihost.make_pod_mesh()`, one process a card (the ranks of one host:
(dp, sp) = (1, cards)), each frame the next pose of the camera path at
the traffic's samples, the image on the host of every rank. Rank 0's
latencies, images and trace are the cell's; every rank's busy time
enters `device.busy_s`, and every rank's NCCL kernels the collective's
reading.

The run's own process starts one rank a card (spawned), joins them over
NCCL at a free localhost port, and keeps no CUDA context of its own
until they have ended; then it runs the check on card 0 (`render.finish`).
Rank 0 decides after each frame whether the window goes on and tells the
others over a gloo group of the harness's, on the host, so that every
rank renders the same frames."""

from __future__ import annotations

import os
import time

from portbench import core, trace
from portbench.drivers import render

RANK_TIMEOUT_S = 330.0
NCCL = ("nccl", "NCCL")      # the collectives' kernels in a trace


def rank_main(rank, n, port, cell, seed, seconds, traced, t0_wall, out,
              device, size, hook):
    """One rank: the program's scene, the warm-up, the window, the trace;
    puts (rank, readings) on `out`. `hook`, where given, runs first (the
    tests break the program underneath with it)."""
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    from tracer_torch.dist import multihost

    try:
        if hook is not None:
            hook()
        if device == "cpu":   # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        multihost.initialize(f"localhost:{port}", n, rank, device=device)
        ctl = dist.new_group(backend="gloo")
        mesh = multihost.make_pod_mesh()
        spans = core.Spans()
        frames = render.Frames(cell, seed, spans, device, size)
        pix = render.check.pixels(frames.width, frames.height,
                                  cell.limits["check_pixels"], seed)

        def frame(i):
            return multihost.render_image_multihost(
                frames.scene, frames.camera(i), frames.cfg, mesh)

        with spans("warmup"):
            for i in range(2):
                frame(i)
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier(group=ctl)
        setup_s = time.time() - t0_wall
        flag = torch.zeros(1, dtype=torch.int32)
        lat, kept = [], []
        tr = None
        i = 2

        def one():
            nonlocal i
            t = time.perf_counter()
            with spans("frame"):
                img = frame(i)
            lat.append(time.perf_counter() - t)
            if rank == 0:
                kept.append(img.reshape(-1, 3)[pix].copy())
            i += 1

        start = time.perf_counter()
        if traced:
            for _ in range(2):
                one()
            tr = trace.record(lambda: [one() for _ in range(
                render.TRACED_FRAMES)], spans, "frames")
        while True:
            one()
            if rank == 0:
                flag[0] = int(time.perf_counter() - start >= seconds)
            with spans("control"):
                dist.broadcast(flag, src=0, group=ctl)
            if flag[0]:
                break
        win_s = time.perf_counter() - start
        res = dict(lat=lat, win_s=win_s, setup_s=setup_s,
                   peak=(int(torch.cuda.max_memory_allocated())
                         if device == "cuda" else 0),
                   banned=core.banned_modules(),
                   busy=None if tr is None else trace.busy_us(tr) * 1e-6,
                   nccl_us=None if tr is None else [
                       o.dur for o in sorted(tr.ops, key=lambda o: o.start)
                       if any(k in o.name for k in NCCL)])
        if rank == 0:
            res.update(kept=kept, spans=spans, trace=tr)
        frames.release()
        dist.destroy_process_group(ctl)
        out.put((rank, res))
    finally:
        multihost.shutdown()


def spawn(cell, seed, seconds, traced, t0_wall, device="cuda",
          size=None, hook=None) -> list:
    """Run one rank a card; returns the ranks' readings in rank order."""
    import torch.multiprocessing as mp
    from tracer_torch.dist.launch import free_port
    from tracer_torch.kernels import _build

    if device == "cuda":
        _build.library()      # built once here, loaded by the ranks
    n = cell.chips
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    pc = mp.start_processes(
        rank_main, (n, free_port(), cell, seed, seconds, traced, t0_wall,
                    out, device, size, hook), nprocs=n, join=False,
        start_method="spawn")
    got = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1.0):
            while not out.empty():
                r, v = out.get()
                got[r] = v
            if time.monotonic() > deadline:
                raise RuntimeError(f"{n} ranks exceeded {RANK_TIMEOUT_S} s")
        while not out.empty():
            r, v = out.get()
            got[r] = v
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.terminate()
            p.join()
        out.close()
    return [got[r] for r in range(n)]


def run(cell: core.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", size=None, control=False,
        hook=None):
    import torch
    t0_wall = time.time() - (time.perf_counter() - t_start)
    ranks = spawn(cell, seed, seconds, traced, t0_wall, device, size, hook)
    banned = sorted({m for r in ranks for m in r["banned"]})
    if banned:
        raise RuntimeError(f"a rank loaded {banned}")
    r0 = ranks[0]
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": max(r["peak"] for r in ranks)}
    busy = (None if r0["trace"] is None
            else sum(r["busy"] for r in ranks) / len(ranks))
    nccl = None if r0["trace"] is None else [r["nccl_us"] for r in ranks]
    plan = render.Plan(cell, seed, size)
    pix = render.check.pixels(plan.width, plan.height,
                              cell.limits["check_pixels"], seed)
    return render.finish(cell, seed, r0["spans"], r0["lat"], r0["kept"],
                         r0["win_s"], r0["trace"],
                         max(r["setup_s"] for r in ranks), dev, pix, plan,
                         device, control, busy=busy, nccl_us=nccl)
