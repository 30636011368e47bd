"""Multi-host weak-scaling harness (the port of
`benchmarks/bench_multihost.py`; BASELINE.md's north star: >= 85% rays/s
efficiency at >= 2 hosts).

Weak scaling: every host renders the SAME amount of work (PIX_PER_DP
pixels a dp shard of the standard Cornell load, 850x480, 6 bounces, SPP
samples), so efficiency(N) = rays_per_s(N hosts) / (N * rays_per_s(1
host)). The forward is embarrassingly parallel over dp (pixel blocks):
what the efficiency loses is the sp group's sample sum, the process
group's dispatch and the hosts' launch overhead.

    python -m tracer_torch.bench_multihost
        The driver: spawns a 1-host group, a 2-host group and an `indep`
        control (two 1-host groups at the same time, with no process group
        between them), one process a rank, and prints ONE JSON line with
        the keys of MULTIHOST_SCALING.json. A "host" is a few ranks
        (LOCAL_WORLD_SIZE), numbered host-major, and sp spans a host's
        ranks (`multihost.make_pod_mesh`): 2 ranks a host on 4 or more
        cards, as the JAX rig's `make_pod_mesh(n_sp=2)`, else 1. With a
        card a rank (4 cards; 2 or 3 at one rank a host), NCCL, each group
        on its own cards (CUDA_VISIBLE_DEVICES: 1 host cards 0-1, 2 hosts
        0-3, indep 0-1 and 2-3); on one card, gloo ranks sharing it: a
        plumbing run of the multi-process path, not a measure of scaling
        (`backend` and `caveat` say which ran). `driver(device="cpu")`
        runs gloo ranks (2 a host) on this machine's cores; without a
        card, nothing falls back: the default device="cuda" raises.
    python -m tracer_torch.bench_multihost --real
        One process a card on real hosts, started by any launcher with
        JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID (and
        LOCAL_RANK / LOCAL_WORLD_SIZE) set, as README's recipe: each rank
        measures its shard and rank 0 prints `measure`'s JSON. Record the
        1-host run first for the denominator.
    python -m tracer_torch.bench_multihost --worker OUT LABEL DEVICE BACKEND
        Internal: one rank of a driver's group.

Sizes: BENCH_MH_WIDTH (850), BENCH_MH_HEIGHT (480) and BENCH_MH_PIX_PER_DP
(4096) shrink a run for tests; the defaults are the JAX harness's.

Timing (`measure`): one untimed call, then REPS calls, each ending in a
host read of the rank's sum; `wall_s` is the slowest rank's mean wall a
call. `compile_s` is the first call's wall: the port has no jit, and the
driver builds the kernel library before the ranks start
(`dist/launch.py` does the same), so it holds the first frame's set-up
(allocator growth, NCCL's first collective), not a compile.

A worker that fails or outlives TIMEOUT_S makes the driver raise with
the worker's output; nothing is printed then.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tracer_torch import bench
from tracer_torch.core.config import RenderConfig
from tracer_torch.dist import launch, multihost
from tracer_torch.dist.sharding import render_pixels_sharded
from tracer_torch.render.camera import default_camera
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo

PIX_PER_DP = 4096     # weak-scaling work unit (pixels per dp shard)
SPP = 4
REPS = 3
SEED = 0
TIMEOUT_S = 900.0     # a group that has not finished by then is stopped
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sizes():
    """(width, height, pixels a dp shard), from the BENCH_MH_* env vars."""
    return (int(os.environ.get("BENCH_MH_WIDTH", 850)),
            int(os.environ.get("BENCH_MH_HEIGHT", 480)),
            int(os.environ.get("BENCH_MH_PIX_PER_DP", PIX_PER_DP)))


def frame(mesh, device="cuda"):
    """The harness's work on this rank: (run, n). `run()` renders this
    rank's block of `render_pixels_sharded` on Cornell (n_dp *
    PIX_PER_DP pixel ids `(arange(n) * 977) % (W * H)`, SPP samples,
    seed 0) and returns its sum, read to the host; `n` is the pixel count
    over every rank."""
    width, height, per_dp = sizes()
    cfg = RenderConfig(width=width, height=height, nsamples=SPP,
                       max_bounces=6)
    scene = compile_scene(zoo.setup_cornell_box(width / height),
                          device=device)
    cam = default_camera(aspect=width / height, device=device)
    n = mesh.shape["dp"] * per_dp
    pids = torch.from_numpy((np.arange(n, dtype=np.int32) * 977)
                            % (width * height)).to(device)

    def run():
        with torch.no_grad():
            rad = render_pixels_sharded(scene, cam, cfg, width, height,
                                        pids, SPP, SEED, mesh)
        return float(rad.sum())

    return run, n


def _slowest(x: float) -> float:
    """The largest `x` over every rank (x itself without a group)."""
    if not dist.is_initialized():
        return x
    dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def measure(mesh, label: str, device: str = "cuda") -> dict:
    """rays/s of `render_pixels_sharded` on Cornell with PIX_PER_DP pixels
    per dp shard, inside an initialized process group (or on the (1, 1)
    mesh of a process without one). Returns the keys of
    `benchmarks/bench_multihost.py`'s `measure`."""
    run, n = frame(mesh, device)
    t0 = time.perf_counter()
    run()                                   # the first call
    t_first = _slowest(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(REPS):
        run()
    dt = _slowest((time.perf_counter() - t0) / REPS)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"label": label, "hosts": world // multihost.ranks_per_host(),
            "devices": world, "pixels": int(n), "spp": SPP,
            "rays_per_s": round(n * SPP / dt), "wall_s": round(dt, 4),
            "compile_s": round(t_first, 2)}


def worker(out_path: str, label: str, device: str, backend: str):
    """One rank of a driver's group, from the env vars the driver sets;
    rank 0 writes `measure`'s result to `out_path`."""
    if device == "cpu":   # the group's ranks share this machine's cores
        n = int(os.environ.get("BENCH_MH_PROCS", "1"))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    multihost.initialize(device=device, backend=backend)
    try:
        res = measure(multihost.make_pod_mesh(), label, device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def plan(device: str) -> dict:
    """How the driver's groups run on `device`: ranks a host, the
    process-group backend, each group's cards (CUDA_VISIBLE_DEVICES, or
    None), `backend` and `caveat` for the JSON."""
    if device == "cpu":
        rph = 2
        return dict(rph=rph, backend="gloo", cards=None,
                    what=f"cpu; gloo, {rph} ranks a host",
                    caveat="both rig 'hosts' share this machine's CPU "
                           "cores, so the rig ceiling is set by core "
                           "oversubscription, not 1.0: the number "
                           "validates the code path, not a device")
    if device != "cuda":
        raise ValueError(f"unknown device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_multihost: no CUDA device (pass "
                           "device='cpu' for gloo on this machine)")
    cards = torch.cuda.device_count()
    rph = 2 if cards >= 4 else 1
    label = bench.device_label("cuda:0")
    if cards >= 2 * rph:
        ids = [str(i) for i in range(2 * rph)]
        return dict(rph=rph, backend="nccl",
                    cards=dict(one=",".join(ids[:rph]),
                               two=",".join(ids),
                               indep=(",".join(ids[:rph]),
                                      ",".join(ids[rph:]))),
                    what=f"{label}; nccl, {rph} rank{'s' * (rph > 1)} a "
                         f"host, one card a rank",
                    caveat="the 'hosts' are groups of cards of one "
                           "machine, joined by NVLink: the number measures "
                           "the process group's and the launches' "
                           "overhead, not a network between hosts; real "
                           "hosts measure with --real")
    return dict(rph=rph, backend="gloo",      # one card
                cards=dict(one="0", two="0", indep=("0", "0")),
                what=f"{label}; gloo, 1 rank a host, every rank on card 0",
                caveat="one card: the 'hosts' are gloo ranks sharing it, a "
                       "plumbing run of the multi-process path and not a "
                       "measure of scaling")


def _spawn(n, label, out, device, backend, rph, cards, procs_total, logs):
    """Start one group of `n` ranks; returns the Popen objects."""
    port = launch.free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, JAX_COORDINATOR=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r),
                   LOCAL_WORLD_SIZE=str(rph),
                   BENCH_MH_PROCS=str(procs_total))
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [x for x in [env.get("PYTHONPATH")] if x])
        env.pop("LOCAL_RANK", None)
        if cards is not None:
            env["CUDA_VISIBLE_DEVICES"] = cards
        log = open(os.path.join(logs, f"{label}.{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tracer_torch.bench_multihost",
             "--worker", out, label, device, backend],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout):
    """Wait for every worker; when one fails or the timeout passes, stop
    them all and raise with their output."""
    deadline = time.monotonic() + timeout
    why = None
    try:
        while why is None and any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs):
                break
            if time.monotonic() > deadline:
                why = f"a worker exceeded {timeout} s"
            time.sleep(0.2)
        bad = [p.returncode for p, _ in procs if p.poll() not in (None, 0)]
        if bad and why is None:
            why = f"worker exit codes {bad}"
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for _, log in procs:
        log.seek(0)
        outs.append(log.read()[-4000:])
        log.close()
    if why:
        raise RuntimeError(f"bench_multihost: {why}\n" + "\n---\n".join(
            outs))


def driver(device: str = "cuda", timeout: float = TIMEOUT_S) -> dict:
    """Run the 1-host, 2-host and indep groups (see the module docstring),
    print the JSON line with MULTIHOST_SCALING.json's keys and return
    it."""
    pl = plan(device)
    rph, backend, cards = pl["rph"], pl["backend"], pl["cards"]
    if device == "cuda":   # built once here, not raced by the ranks
        from tracer_torch.kernels import _build
        _build.library()
    kind = f"{device}-{backend}"
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for hosts in (1, 2):
            label = f"{kind}-{hosts}host"
            out = os.path.join(tmp, label + ".json")
            procs = _spawn(hosts * rph, label, out, device, backend, rph,
                           cards and cards["one" if hosts == 1 else "two"],
                           hosts * rph, tmp)
            _wait(procs, timeout)
            with open(out) as f:
                results[hosts] = json.load(f)
        # the control: the same work a host, two groups at once, no
        # process group between them
        label = f"{kind}-2host-indep"
        outs = [os.path.join(tmp, f"{label}.{g}.json") for g in range(2)]
        procs = []
        for g in range(2):
            procs += _spawn(rph, f"{label}.{g}", outs[g], device, backend,
                            rph, cards and cards["indep"][g], 2 * rph, tmp)
        _wait(procs, timeout)
        rs = []
        for o in outs:
            with open(o) as f:
                rs.append(json.load(f))
    # same total work, the slowest group bounds the wall
    wall = max(r["wall_s"] for r in rs)
    indep = {"label": label, "wall_s": wall,
             "rays_per_s": round(sum(r["pixels"] * r["spp"] for r in rs)
                                 / wall)}
    r1, r2 = results[1], results[2]
    eff = r2["rays_per_s"] / (2.0 * r1["rays_per_s"])
    eff_indep = indep["rays_per_s"] / (2.0 * r1["rays_per_s"])
    out = {
        "metric": "multihost_weak_scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction (1.0 = linear)",
        "backend": pl["what"],
        "rig_gap_decomposition": {
            "indep_2proc_efficiency": round(eff_indep, 4),
            "note": "indep = same work, no process group between the two "
                    "'hosts': the indep-vs-1.0 gap is what sharing the "
                    "machine (cores, or the card) costs; the dist-vs-indep "
                    "gap is what the process group (the sp sample sum, "
                    "group barriers, cross-process dispatch) costs",
        },
        "caveat": pl["caveat"],
        "one_host": r1, "two_host": r2, "indep_two_proc": indep,
        "target": ">= 0.85 on real >= 2-host deployments (BASELINE.md)",
    }
    print(json.dumps(out), flush=True)
    return out


def real():
    """One rank of a real multi-host run (see the module docstring)."""
    multihost.initialize()
    try:
        mesh = multihost.make_pod_mesh()
        world = dist.get_world_size() if dist.is_initialized() else 1
        res = measure(mesh, f"real-{world // multihost.ranks_per_host()}"
                            "host")
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps(res), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:6])
    elif len(sys.argv) > 1 and sys.argv[1] == "--real":
        real()
    else:
        driver()
