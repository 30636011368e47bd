"""Distribution (`tracer_torch/dist/`) on the card, at 850x480, 16 spp,
6 bounces on the Cornell box.

- One NCCL rank: the (1, 1) mesh's sharded frame compiled, bit-equal to
  its eager body and to `render_pixels / spp`; `fit(mesh=)` compiled with
  its all-reduce in the graph, equal to its eager run, its resume and the
  unsharded `fit()` bit for bit.
- Two gloo ranks sharing the card (NCCL refuses two ranks on one card),
  and with two or four cards, two and four NCCL ranks: the gathered frame
  against the unsharded render (bit-equal where sp is 1, else within
  1e-5), `train_step`'s loss and params within rtol 1e-4 of the unsharded
  step's, its gradients and grad norm against the unsharded step's, each
  rank's compiled frame and step against its eager ones (graphs on NCCL,
  eager on gloo by the rule), and `render_image_multihost` on the pod mesh
  against `render`.
- `dryrun_multichip`, README's four-card recipe (processes joined by the
  env vars) and the multi-host weak-scaling harness.

Cases that need more cards than the machine has skip.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.card import (  # noqa: F401  (fixtures)
    BOUNCES, FIT_OFFSETS, FIT_TRAIN, H, SPP, W, bit_equal, call_launches, card,
    fit_check, fresh_graphs, graph_check, host_syncs, launched, memo,
    reset_launches)
from tracer_torch import train as T
from tracer_torch.core.config import RenderConfig
from tracer_torch.render import graphs, renderer
from tracer_torch.render.camera import default_camera
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo

pytestmark = pytest.mark.card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_FIELDS = ("sph_center", "sph_radius", "mat_diffuse")
# sharding.train_step's trainables
STEP_TRAINABLE = ["sph_center", "sph_radius", "mat_diffuse", "tex_data",
                  "mesh_verts", "cam_position"]
REPS = 3


def needs_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, the machine has "
                    f"{torch.cuda.device_count()}")


def setup(dev, spp=SPP):
    scene = compile_scene(zoo.setup_cornell_box(W / H), device=dev)
    cfg = RenderConfig(nsamples=spp, width=W, height=H, max_bounces=BOUNCES)
    return (scene, default_camera(W / H, device=dev), cfg,
            torch.arange(W * H, dtype=torch.int32, device=dev))


def sharded_frame(scene, cam, cfg, pid, mesh):
    from tracer_torch.dist import sharding
    with torch.no_grad():
        return sharding.render_pixels_sharded(scene, cam, cfg, W, H, pid,
                                              cfg.nsamples, cfg.seed, mesh)


# --- one NCCL rank -----------------------------------------------------------

@pytest.fixture(scope="class")
def world1(card):
    from tracer_torch.dist import launch, multihost, sharding
    multihost.initialize(f"localhost:{launch.free_port()}", 1, 0,
                         device="cuda")
    try:
        yield sharding.make_ray_mesh(1, 1)
    finally:
        multihost.shutdown()


class TestNcclWorld1:
    def test_sharded_frame(self, card, world1, fresh_graphs):
        import torch.distributed as dist
        assert dist.get_backend() == "nccl"
        scene, cam, cfg, pid = setup(card)

        def frame():
            return sharded_frame(scene, cam, cfg, pid, world1)

        graph_check(frame, frame, call_launches(scene, cfg, SPP))
        with torch.no_grad():
            want = renderer.render_pixels(scene, cam, cfg, W, H, pid, SPP,
                                          cfg.seed) / SPP
        assert bit_equal(frame(), want)

    def test_fit_mesh(self, card, world1, fresh_graphs, tmp_path):
        scene, cam, cfg, _ = setup(card)
        fit_check(str(tmp_path), scene, cam, cfg, FIT_TRAIN, FIT_OFFSETS,
                  2e-3, call_launches(scene, cfg, SPP, FIT_TRAIN), mesh=world1)


# --- ranks of one group ------------------------------------------------------

def step_result(loss, s1, c1):
    return dict(loss=float(loss), cam_position=c1.position.cpu().numpy(),
                **{k: getattr(s1, k).cpu().numpy() for k in STEP_FIELDS})


def step_grads(scene, cam, cfg, pid, target, mesh):
    """(grad norm, {leaf: gradient}) of `train_step`'s step on `mesh`:
    `train.make_step` with its trainables and SGD, run once and eagerly;
    the gradients as the update reads them, after the mesh's reduction (a
    leaf without one: zeros)."""
    params = T.split_params(scene, cam, STEP_TRAINABLE)
    opt = torch.optim.SGD([params[k] for k in sorted(params)], lr=1e-2)
    step = T.make_step(opt, T.guard_config(cfg, STEP_TRAINABLE), target, W,
                       H, cfg.nsamples, mesh)
    with graphs.CACHE.disabled():
        _, gnorm = step(params, scene, cam, pid, 0)
    return float(gnorm), {
        k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.cpu().numpy()) for k, p in params.items()}


def compiled_against_eager(scene, cam, cfg, pid, target, mesh, blk):
    """This rank's compiled sharded frame and step against the eager ones:
    the frame bit-equal to `blk` (the eager frame) after REPS calls; a
    kept `make_step(mesh=)` (SGD on `train_step`'s trainables) compiled
    and eager, REPS + 2 steps each from the same start, every step's loss
    and the final params bit-equal, a replay's launches equal to the eager
    step's; one capture a route and no host synchronisation where the
    mesh's collectives are NCCL's, no capture on gloo (eager by the
    rule)."""
    cache = graphs.CACHE
    n0 = cache.captures

    def frame():
        return sharded_frame(scene, cam, cfg, pid, mesh)

    for _ in range(REPS):
        got = frame()
    assert bit_equal(got, blk)
    fsyncs, _ = host_syncs(frame)
    runs = {}
    for name in ("eager", "compiled"):
        params = T.split_params(scene, cam, STEP_TRAINABLE)
        opt = torch.optim.SGD([params[k] for k in sorted(params)], lr=1e-2)
        fn = T.make_step(opt, T.guard_config(cfg, STEP_TRAINABLE), target,
                         W, H, cfg.nsamples, mesh)
        losses = []

        def call(fn=fn, params=params, losses=losses):
            losses.append(fn(params, scene, cam, pid, 0)[0])

        with cache.disabled() if name == "eager" else \
                contextlib.nullcontext():
            call()
            reset_launches()
            call()
            launches = launched()
            for _ in range(REPS - 1):
                call()
            syncs, _ = host_syncs(call)
        runs[name] = (torch.stack(losses), params, launches, syncs)
    (le, pe, ne, _), (lc, pc, nc, ssyncs) = runs["eager"], runs["compiled"]
    assert bit_equal(le, lc) and ne == nc
    assert all(bit_equal(pe[k].detach(), pc[k].detach()) for k in pe)
    graphed = mesh.capturable
    assert cache.captures - n0 == (2 if graphed else 0)
    if graphed:
        assert (fsyncs, ssyncs) == (0, 0)
    cache.clear()


def dist_rank(shapes, pod):
    """One rank: for each mesh shape, the sharded Cornell frame (eager) and
    `train_step`, the gathered film on rank 0, the step's result, its
    gradients and grad norm, and the compiled frame and step against the
    eager ones; with `pod`, rank 0's `render_image_multihost` frame on the
    host-major mesh (`make_pod_mesh()`)."""
    import torch.distributed as dist

    from tracer_torch.dist import multihost, sharding

    dev = torch.device("cuda", torch.cuda.current_device())   # this rank's
    scene, cam, cfg, pid = setup(dev)
    target = torch.zeros((W * H, 3), dtype=torch.float32)
    out = dict(rank=dist.get_rank())
    for shape in shapes:
        mesh = sharding.make_ray_mesh(*shape)
        with graphs.CACHE.disabled():
            blk = sharded_frame(scene, cam, cfg, pid, mesh)
        film = multihost.gather_film(blk, mesh).cpu().numpy()
        res = sharding.train_step(scene, cam, cfg, W, H, pid, target,
                                  cfg.nsamples, 0, mesh)
        out[shape] = dict(
            step=step_result(*res),
            grads=step_grads(scene, cam, cfg, pid, target, mesh),
            film=film if dist.get_rank() == 0 else None)
        compiled_against_eager(scene, cam, cfg, pid, target, mesh, blk)
    if pod:
        pmesh = multihost.make_pod_mesh()
        img = multihost.render_image_multihost(scene, cam, cfg, pmesh)
        graphs.CACHE.clear()
        out["pod"] = dict(shape=dict(pmesh.shape),
                          img=img if dist.get_rank() == 0 else None)
    return out


def unsharded(card):
    """The unsharded references: the frame, `train_step`'s result on the
    (1, 1) mesh, its gradients and grad norm, and `render`'s image."""
    from tracer_torch.dist import sharding
    scene, cam, cfg, pid = setup(card)
    target = torch.zeros((W * H, 3))
    one = sharding.make_ray_mesh(1, 1)
    with torch.no_grad():
        film = renderer.render_pixels(scene, cam, cfg, W, H, pid, SPP,
                                      cfg.seed) / SPP
    res = sharding.train_step(scene, cam, cfg, W, H, pid, target, SPP, 0, one)
    return dict(film=film.cpu().numpy(), step=step_result(*res),
                grads=step_grads(scene, cam, cfg, pid, target, one),
                image=renderer.render(scene, cam, cfg))


@pytest.mark.parametrize("backend,n,shapes,local_world_size,pod_shape", [
    pytest.param("gloo", 2, [(2, 1), (1, 2)], 1, {"dp": 2, "sp": 1},
                 id="gloo-2"),
    pytest.param("nccl", 2, [(2, 1), (1, 2)], 1, {"dp": 2, "sp": 1},
                 id="nccl-2"),
    pytest.param("nccl", 4, [(2, 2), (4, 1)], None, {"dp": 1, "sp": 4},
                 id="nccl-4")])
def test_ranks_against_unsharded(card, memo, fresh_graphs, backend, n,
                                 shapes, local_world_size, pod_shape):
    """gloo's ranks share the card; NCCL's take one card each. The pod
    mesh's image is bit-equal to `render`'s where its sp is 1, else within
    1e-5 once the gamma is undone (image ** 2.2): the sample sums' order
    differs."""
    from tracer_torch.dist import launch
    if backend == "nccl":
        needs_cards(n)
    want = memo("unsharded", lambda: unsharded(card))
    ranks = launch.run(dist_rank, n, (shapes, True), device="cuda",
                       backend=backend, local_world_size=local_world_size)
    for shape in shapes:
        err = float(np.abs(ranks[0][shape]["film"] - want["film"]).max())
        assert err <= (0.0 if shape[1] == 1 else 1e-5), (shape, err)
        gnorm0, grads0 = want["grads"]
        for r in ranks:
            got = r[shape]["step"]
            for k, w in want["step"].items():
                assert np.allclose(got[k], w, rtol=1e-4, atol=1e-7), \
                    (shape, r["rank"], k)
            gnorm, grads = r[shape]["grads"]
            assert abs(gnorm - gnorm0) <= 1e-4 * gnorm0, (shape, r["rank"])
            for k, w in grads0.items():
                scale = float(np.abs(w).max()) if w.size else 0.0
                assert np.allclose(grads[k], w, rtol=1e-4,
                                   atol=1e-5 * scale), (shape, r["rank"], k)
    pod = ranks[0]["pod"]
    assert pod["shape"] == pod_shape
    if pod_shape["sp"] == 1:
        np.testing.assert_array_equal(pod["img"], want["image"])
    else:
        assert float(np.abs(pod["img"] ** 2.2
                            - want["image"] ** 2.2).max()) <= 1e-5


# --- the dry run, README's recipe, the multi-host harness --------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(card, n):
    from tracer_torch.dist.dryrun import dryrun_multichip
    if n > 2:
        needs_cards(n)
    res = dryrun_multichip(n, device="cuda")
    assert np.isfinite(res["loss"])


def test_readme_four_card_recipe(card):
    """README's four-card recipe as written there: four shell-started
    processes, one a card, joined by JAX_COORDINATOR / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID / LOCAL_RANK / LOCAL_WORLD_SIZE, each running one rank
    of the dry-run step; every rank ends with the same loss."""
    from tracer_torch.dist import launch
    n = 4
    needs_cards(n)
    port = launch.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tracer_torch.dist.dryrun"], cwd=ROOT,
        env=dict(os.environ, JAX_COORDINATOR=f"localhost:{port}",
                 JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not any(p.returncode for p in procs), "\n".join(outs)
    lines = [o.strip().splitlines()[-1] for o in outs]
    assert len({ln.split("loss=")[1].split()[0] for ln in lines}) == 1, lines


def key_tree(d):
    """The keys of a JSON object and of the objects in it."""
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_multihost_harness(card, fresh_graphs):
    """`tracer_torch.bench_multihost.driver()` as `python -m
    tracer_torch.bench_multihost` runs it (gloo ranks sharing the card on
    one card; NCCL at 2 ranks a host on four): the keys of its JSON, and
    of the objects in it, are MULTIHOST_SCALING.json's, and every rate is
    positive."""
    from tracer_torch import bench_multihost
    res = bench_multihost.driver()
    with open(os.path.join(ROOT, "MULTIHOST_SCALING.json")) as f:
        assert key_tree(res) == key_tree(json.load(f))
    rates = [res[k]["rays_per_s"] for k in ("one_host", "two_host",
                                            "indep_two_proc")]
    assert all(r > 0 for r in rates) and res["value"] > 0, rates
