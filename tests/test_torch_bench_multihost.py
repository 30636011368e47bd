"""The multi-host weak-scaling harness (`tracer_torch/bench_multihost.py`,
the port of `benchmarks/bench_multihost.py`) on the CPU, at tiny sizes
(BENCH_MH_*), with gloo ranks:

- `driver(device="cpu")` (a 1-host group of 2 ranks, a 2-host group of 4,
  then the indep control: two 2-rank groups at once) prints one JSON line
  whose keys, and those of the objects in it, are MULTIHOST_SCALING.json's;
- on a 2-host x 2-rank group, the blocks that `measure` renders sum, over
  dp, to the unsharded `render_pixels` sum on the same pixel ids within
  1e-5 relative, and `measure` counts the group's pixels and hosts;
- a worker that fails or outlives the timeout makes the driver raise with
  the worker's output, and no JSON line is printed.

The spawned groups run one after another.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from tracer_torch import bench_multihost as bm
from tracer_torch import testing as tt
from tracer_torch.core.config import RenderConfig
from tracer_torch.dist import launch
from tracer_torch.render.camera import default_camera
from tracer_torch.render.renderer import render_pixels
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, PIX = 16, 8, 32


@pytest.fixture
def tiny(monkeypatch):
    for k, v in (("BENCH_MH_WIDTH", W), ("BENCH_MH_HEIGHT", H),
                 ("BENCH_MH_PIX_PER_DP", PIX)):
        monkeypatch.setenv(k, str(v))


def key_tree(d):
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_driver_prints_the_jax_harness_keys(tiny, capsys):
    res = bm.driver(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res
    ref = json.loads((ROOT / "MULTIHOST_SCALING.json").read_text())
    assert key_tree(res) == key_tree(ref)
    assert res["backend"].startswith("cpu")
    one, two = res["one_host"], res["two_host"]
    assert (one["hosts"], one["devices"], one["pixels"]) == (1, 2, PIX)
    assert (two["hosts"], two["devices"], two["pixels"]) == (2, 4, 2 * PIX)
    assert one["spp"] == two["spp"] == bm.SPP
    assert all(r["rays_per_s"] > 0 for r in (one, two,
                                              res["indep_two_proc"]))
    assert res["value"] == round(two["rays_per_s"]
                                 / (2.0 * one["rays_per_s"]), 4)


def test_sharded_sum_equals_the_unsharded_render(tiny):
    ranks = launch.run(tt.multihost_rank, 4, device="cpu",
                       local_world_size=2)
    assert {r["shape"] for r in ranks} == {(2, 2)}
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    n = 2 * PIX
    assert all(r["n"] == n for r in ranks)
    got = sum(r["sum"] for r in ranks if r["coord"][1] == 0)
    cfg = RenderConfig(width=W, height=H, nsamples=bm.SPP, max_bounces=6)
    scene = compile_scene(zoo.setup_cornell_box(W / H), device="cpu")
    cam = default_camera(aspect=W / H, device="cpu")
    pids = torch.from_numpy((np.arange(n, dtype=np.int32) * 977) % (W * H))
    with torch.no_grad():
        want = float((render_pixels(scene, cam, cfg, W, H, pids, bm.SPP,
                                    bm.SEED) / bm.SPP).sum())
    assert want > 0
    assert abs(got - want) <= 1e-5 * abs(want)
    m = ranks[0]["measured"]
    assert (m["hosts"], m["devices"], m["pixels"], m["spp"]) == (2, 4, n,
                                                                 bm.SPP)
    assert m["rays_per_s"] > 0 and m["wall_s"] > 0


def test_a_failed_worker_raises_and_prints_nothing(tiny, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("BENCH_MH_WIDTH", "not-a-width")
    with pytest.raises(RuntimeError, match="worker exit codes") as e:
        bm.driver(device="cpu")
    assert "not-a-width" in str(e.value)
    assert capsys.readouterr().out == ""


def test_a_worker_past_the_timeout_raises(tiny, capsys):
    with pytest.raises(RuntimeError, match="exceeded"):
        bm.driver(device="cpu", timeout=0.5)
    assert capsys.readouterr().out == ""


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bm.driver()
