"""The port's CLI (`python -m tracer_torch.cli`) with `--device cpu`,
against the JAX package's (`tracer/cli.py`) where both print the same
thing.

- `probe`: the radiance within 2e-5 of `tracer.cli`'s, origin and
  direction within 1e-6.
- `scenes`: the same listing, in-process and through `python -m`.
- `render` (with and without `--ckpt-dir`), `benchmark --occupancy /
  --compile / --profile`, `train --steps 2` and `grad-check` run to the
  end (grad-check's four checks hold); the bare `benchmark` prints
  `bench.py`'s keys (`tracer_torch/bench.py`, at tiny BENCH_* sizes).
- `benchmark --occupancy`: the per-bounce occupancy equals the JAX CLI's
  on Cornell and single_sphere.
- The pose flags: the reference app's startup pose spelled out equals the
  default camera; `--cam-quat` and `--look-at` are exclusive.
- A pair atlas of one row (the grad-check's 4x4 texture): the fused route
  took it for `train.invalidate_packs`' sentinel and dropped its texels;
  the port now routes it to the general bounce, and its render equals the
  JAX package's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tracer import cli as jcli
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.builder import Material, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer_torch import cli as tcli
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.io.ppm import load_ppm
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene import device as tdevice

SMALL = ["--device", "cpu", "--width", "48", "--height", "32",
         "--bounces", "2"]


def run(capsys, argv):
    tcli.main(argv)
    return capsys.readouterr().out


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("scene,x,y", [("cornell_box", 240, 70),
                                       ("single_square", 425, 240)])
def test_probe_matches_jax(scene, x, y, capsys):
    argv = ["probe", "--scene", scene, "--x", str(x), "--y", str(y)]
    jcli.main(argv)
    want = last_json(capsys.readouterr().out)
    got = last_json(run(capsys, argv + ["--device", "cpu"]))
    assert got["pixel"] == want["pixel"]
    np.testing.assert_allclose(got["origin"], want["origin"], atol=1e-6)
    np.testing.assert_allclose(got["direction"], want["direction"],
                               atol=1e-6)
    np.testing.assert_allclose(got["radiance"], want["radiance"], atol=2e-5)
    assert max(got["radiance"]) > 0.0


def test_scenes_listing(capsys):
    jcli.main(["scenes"])
    want = capsys.readouterr().out
    assert run(capsys, ["scenes"]) == want
    res = subprocess.run([sys.executable, "-m", "tracer_torch.cli",
                          "scenes"], capture_output=True, text=True,
                         timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert res.stdout == want


@pytest.mark.parametrize("tiled", [False, True])
def test_render(tiled, capsys, tmp_path):
    out = str(tmp_path / "rendu.ppm")
    argv = ["render", *SMALL, "--spp", "2", "--out", out]
    if tiled:
        argv += ["--ckpt-dir", str(tmp_path / "tiles"), "--tile", "16"]
    text = run(capsys, argv)
    assert "rendered cornell_box 48x32@2spp" in text
    img = load_ppm(out)
    assert img.shape == (32, 48, 3) and img.max() > 0
    if tiled:
        assert len(os.listdir(tmp_path / "tiles")) == 6
        # the tiled image is the direct one
        direct = str(tmp_path / "direct.ppm")
        run(capsys, ["render", *SMALL, "--spp", "2", "--out", direct])
        np.testing.assert_array_equal(load_ppm(direct), img)


def test_benchmark_modes(capsys, tmp_path, monkeypatch):
    got = last_json(run(capsys, ["benchmark", *SMALL, "--occupancy"]))
    assert got["device"] == "cpu" and got["primary_rays_per_s"] > 0
    assert len(got["occupancy_per_bounce"]) == 2
    assert got["occupancy_per_bounce"][0] == 1.0
    got = last_json(run(capsys, ["benchmark", *SMALL, "--compile",
                                 "--spp", "1"]))
    assert got["build_s"] == 0.0 and got["first_run_s"] > 0
    assert np.isfinite(got["mean_radiance"])
    prof = str(tmp_path / "prof")
    run(capsys, ["benchmark", *SMALL, "--profile", prof])
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    # the bare benchmark: tracer_torch.bench at the BENCH_* sizes, which
    # the CLI's --width/--height/--spp do not change (as in tracer/cli.py)
    for k, v in dict(BENCH_WIDTH=12, BENCH_HEIGHT=8, BENCH_SPP=1,
                     BENCH_REPS=1).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv("BENCH_SCENES", raising=False)
    got = last_json(run(capsys, ["benchmark", *SMALL]))
    # bench.py:129-139
    assert sorted(got) == sorted([
        "metric", "value", "unit", "vs_baseline", "total_rays_per_s",
        "fwdbwd_primary_rays_per_s", "fwdbwd_no_texgrad_rays_per_s",
        "config", "device"])
    assert got["config"] == "12x8@1spp b6" and got["device"] == "cpu"
    assert got["value"] > 0 and got["fwdbwd_primary_rays_per_s"] > 0


@pytest.mark.parametrize("scene", ["cornell_box", "single_sphere"])
def test_benchmark_occupancy_matches_jax(scene, capsys):
    """`benchmark --occupancy`'s per-bounce occupancy against the JAX
    CLI's (`trace(with_aux=True)` on the same rays). Both CLIs divide the
    jittered pixel coordinate by the width outside a jit, which rounds as
    torch's division does (not as the renderer's reciprocal multiply);
    single_sphere's rays leave the scene at its silhouette."""
    argv = ["benchmark", "--occupancy", "--scene", scene, *SMALL[2:]]
    jcli.main(argv)
    want = last_json(capsys.readouterr().out)["occupancy_per_bounce"]
    got = last_json(run(capsys, argv + ["--device", "cpu"]))
    assert got["occupancy_per_bounce"] == want
    assert len(want) == 2 and want[0] == 1.0


def test_train(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["train", *SMALL, "--steps", "2", "--spp", "2",
            "--train", "mat_diffuse,sph_center", "--ckpt-dir", ck]
    lines = [json.loads(ln) for ln in run(capsys, argv).splitlines()]
    assert lines[0]["event"] == "start" and lines[-1]["event"] == "done"
    assert [ln["step"] for ln in lines[1:-1]] == [1, 2]
    assert all(np.isfinite(ln["grad_norm"]) for ln in lines[1:-1])
    assert os.path.exists(os.path.join(ck, "train.npz"))
    # re-running resumes: nothing left to do
    lines = [json.loads(ln) for ln in run(capsys, argv).splitlines()]
    assert [ln["event"] for ln in lines] == ["start", "done"]


def test_grad_check(capsys):
    res = json.loads(run(capsys, ["grad-check", "--device", "cpu"]))
    assert sorted(res) == ["albedo", "mesh_vertex", "sphere_center",
                           "sphere_radius", "texels"]
    assert all(r["ok"] for r in res.values()), res


def _args(**kw):
    base = dict(width=160, height=90, cam_pos=None, cam_quat=None,
                look_at=None, fov=None, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_pose_flags():
    flags = tcli._camera(_args(cam_pos="0,0,6.1", cam_quat="1,0,0,0",
                               fov=45.0))
    default = tcli._camera(_args())
    for f in ("position", "quaternion", "fov_deg", "aspect"):
        torch.testing.assert_close(getattr(flags, f), getattr(default, f),
                                   rtol=0, atol=0)
    with pytest.raises(SystemExit):
        tcli._camera(_args(cam_quat="1,0,0,0", look_at="0,0,0"))
    cam = tcli._camera(_args(cam_pos="3,1,5", look_at="0.6,0,0"))
    want = jcli._camera(_args(cam_pos="3,1,5", look_at="0.6,0,0"))
    np.testing.assert_allclose(cam.quaternion.numpy(),
                               np.asarray(want.quaternion), atol=1e-6)


def test_one_row_pair_atlas_renders_its_texels():
    sb = SceneBuilder()
    sb.add_light((0., 0., 5.), radius=0.0)
    img = (np.arange(4 * 4 * 3).reshape(4, 4, 3) * 5 + 16).astype(np.uint8)
    mt = Material(diffuse=(1.0, 1.0, 1.0))
    mt.texture_type = 2
    mt.texture_id = sb.add_texture(img)
    sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 4., 4., mt)
    js = jcompile(sb)
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    ts = tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")
    assert ts.pair_mode and ts.pair_pack.shape[0] == 1
    cfg = TConfig(nsamples=2, width=16, height=16, max_bounces=2)
    assert not tintegrator._fused(ts, cfg)
    got = trenderer.render(ts, tcam.default_camera(1.0, device="cpu"), cfg)
    want = jrenderer.render(js, jcam.default_camera(1.0), JConfig(
        nsamples=2, width=16, height=16, max_bounces=2, kernels="off"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the texels reach the image: not the material's plain white
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 4
