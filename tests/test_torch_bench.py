"""The port's benchmark (`tracer_torch/bench.py`) against the JAX
package's (`bench.py`), on the CPU.

At 12x8 px, 2 spp, 6 bounces, on Cornell and on the Cornell whose
textures and normal maps are seeded arrays (`testing.fill_cornell_textures`),
each package building its scene from its own zoo, with the same pixel ids
and seed 0:

- the frame scalar (the mean of `render_pixels(...) / spp`) within 1e-6 of
  JAX's jitted `render_pixels` (kernels="off");
- both gradient sums (mat_diffuse, sph_center and tex_data; without
  tex_data) within 1e-4 relative of the sums of JAX's protocol gradients,
  taken as `tests/test_torch_grad.py::jax_grads` takes them (the sum over
  samples run eagerly: `jax.grad` of the jitted `render_pixels` takes
  minutes to compile on the CPU). The two packages sum the per-table and
  per-texel gradients in different orders (f32 summation order);
- `per_primary` equal to `bench.py`'s expression on Cornell (no lights)
  and random_spheres (one light);
- `main(device="cpu")` at 12x8, 1 spp, 1 rep prints one JSON line with
  exactly `bench.py`'s keys, `per_scene_fwd_rays_per_s` over its five
  scenes included.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch import bench
from tracer_torch.scenes import zoo as tzoo
from tracer_torch.testing import fill_cornell_textures

W, H, SPP = 12, 8, 2
# bench.py:129-139, the keys of its JSON line
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "total_rays_per_s",
              "fwdbwd_primary_rays_per_s", "fwdbwd_no_texgrad_rays_per_s",
              "config", "device"]
# bench.py:148-149, BENCH_SCENES' scenes
BENCH_SCENES = ["flamingo", "raccoon", "backrooms_pool", "rt_in_a_weekend",
                "random_spheres"]


def cornell(zoo, textured):
    sb = zoo.setup_cornell_box(W / H)
    return fill_cornell_textures(sb) if textured else sb


def jax_reference(js):
    """(frame scalar, {field: gradient}) of bench.py's protocol on `js`."""
    cfg = JConfig(kernels="off")
    cam = jcam.default_camera(W / H)
    pid = jnp.arange(W * H, dtype=jnp.int32)
    key = jax.random.key(0)
    acc = jrenderer.render_pixels(js, cam, cfg, W, H, pid, SPP, key)
    frame = float(jnp.mean(acc / SPP))

    def loss(*params):
        s2 = dataclasses.replace(js, **dict(zip(bench.TRAINABLE, params)))
        acc = sum(jrenderer._render_batch(s2, cam, cfg, W, H, pid,
                                          jnp.int32(s), key)
                  for s in range(SPP))
        return jnp.mean(acc / SPP)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        *(getattr(js, k) for k in bench.TRAINABLE))
    return frame, dict(zip(bench.TRAINABLE, (np.asarray(x) for x in g)))


@pytest.mark.parametrize("textured", [False, True])
def test_frame_and_gradient_sums_match_jax(textured):
    want_frame, grads = jax_reference(jcompile(cornell(jzoo, textured)))
    b = bench.inputs(cornell(tzoo, textured), W, H, SPP, device="cpu")
    assert b.pixel_ids.tolist() == list(range(W * H))
    got_frame = float(bench.frame_scalar(b))
    assert abs(got_frame - want_frame) <= 1e-6, (got_frame, want_frame)
    assert got_frame > 0.0
    sums = {}
    for trainable in (bench.TRAINABLE, bench.NO_TEXGRAD):
        want = sum(float(grads[k].astype(np.float64).sum())
                   for k in trainable)
        got = float(bench.grad_sum(b, trainable))
        assert abs(got - want) <= 1e-4 * abs(want), (trainable, got, want)
        sums[trainable] = got
    # the flat box's walls read mat_diffuse; the textured box's read the
    # atlas, so without tex_data its sum is 0 in both packages. At 12x8
    # no ray meets a sphere, so sph_center's gradient is 0 in both
    assert sums[bench.TRAINABLE] != 0.0
    assert (sums[bench.NO_TEXGRAD] == 0.0) == textured


@pytest.mark.parametrize("name", ["cornell_box", "random_spheres"])
def test_per_primary_matches_jax(name):
    cfg = JConfig()
    js = jcompile(jzoo.BY_NAME[name]())
    # bench.py:85-86
    n_lights = int(np.asarray(js.light_pos).shape[0])
    want = cfg.max_bounces * (1 + n_lights * cfg.shadow_rays)
    b = bench.inputs(tzoo.BY_NAME[name](), W, H, 1, device="cpu")
    assert bench.per_primary(b.scene, b.cfg) == want
    assert want == (6 if name == "cornell_box" else 66)


def test_main_prints_bench_keys(monkeypatch, capsys):
    for k, v in dict(BENCH_WIDTH=12, BENCH_HEIGHT=8, BENCH_SPP=1,
                     BENCH_REPS=1, BENCH_SCENES=1).items():
        monkeypatch.setenv(k, str(v))
    ret = bench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == ret
    assert sorted(got) == sorted(BENCH_KEYS + ["per_scene_fwd_rays_per_s"])
    assert list(got["per_scene_fwd_rays_per_s"]) == BENCH_SCENES
    assert got["metric"] == "primary_rays_per_s_fwd_cornell"
    assert got["unit"] == "rays/s" and got["device"] == "cpu"
    assert got["config"] == "12x8@1spp b6"
    assert got["total_rays_per_s"] == pytest.approx(6 * got["value"],
                                                    rel=1e-6, abs=6)
    for k in ("value", "fwdbwd_primary_rays_per_s",
              "fwdbwd_no_texgrad_rays_per_s"):
        assert got[k] > 0, k
    assert all(v > 0 for v in got["per_scene_fwd_rays_per_s"].values())
