"""The frame's finish (`tracer_torch/kernels/finish.py`, `csrc/finish.cu`,
and `renderer.finish_frame`, which chooses between the kernel and its
plain version, `film.to_image` on the host).

On the CPU:
- a CPU film takes the plain version, with the kernels on or off: the
  image is `to_image`'s bits after `film / np.float32(nsamples)`, on films
  with zeros of both signs, negatives, values above 1, infinities, NaN and
  denormals, and nothing launches; with `kernels="on"` it raises;
- the kernel's wrapper refuses no samples and a host film;
- `renderer.render` of a CPU scene, in one chunk or in several, returns
  `to_image`'s bits of the frame's sum.
(`test_torch_core.py::test_finish_is_the_jax_finish` holds the plain
version to the JAX package's finish.)

On a CUDA card (skipped without one; this file imports no JAX, so on the
card's machine `python -m pytest --noconftest tests/test_torch_finish.py`
runs it):
- the kernel equals the plain version bit for bit without gamma, and
  within 2 ulp with it (zeros compared without their sign), NaN exactly
  where numpy has NaN;
- a `render` call launches the kernel once, one-rank
  `render_image_multihost` too, and `kernels="off"` never;
- the tiled and the direct render are equal bit for bit;
- two frames in a row are two arrays, and the second leaves the first as
  it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.card import card  # noqa: F401  (the fixture)
from tracer_torch.core.config import RenderConfig
from tracer_torch.dist import multihost, sharding
from tracer_torch.kernels import finish
from tracer_torch.render import renderer
from tracer_torch.render.camera import default_camera
from tracer_torch.render.film import to_image
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo
from tracer_torch.testing import finish_film

W, H, SPP = 40, 24, 2
ULP = 2          # CUDA's powf against numpy's float32 power


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).reshape(-1).view(np.int32)


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("nsamples", [1, 20])
def test_plain_gives_to_image_bits(kernels, nsamples):
    s = finish_film(1001)
    want = to_image(s / np.float32(nsamples), 77, 13)
    before = finish.LAUNCHES
    img = renderer.finish_frame(torch.from_numpy(s), nsamples, 77, 13,
                                kernels)
    assert finish.LAUNCHES == before
    assert img.shape == (13, 77, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(bits(img), bits(want))


def test_a_host_film_refuses_kernels_on():
    with pytest.raises(RuntimeError, match="needs CUDA"):
        renderer.finish_frame(torch.zeros(6, 3), 1, 3, 2, "on")


def test_the_finish_refuses_no_samples():
    with pytest.raises(ValueError, match="nsamples"):
        finish.finish(torch.zeros(4, 3), 0)
    with pytest.raises(ValueError, match="to_image"):
        finish.finish(torch.zeros(4, 3), 1)


@pytest.fixture(scope="module")
def cornell_cpu():
    scene = compile_scene(zoo.setup_cornell_box(W / H), device="cpu")
    return scene, default_camera(W / H, device="cpu")


@pytest.mark.parametrize("rays_per_batch", [W * H, 7 * W])
def test_cpu_render_returns_to_image_bits(cornell_cpu, rays_per_batch):
    scene, cam = cornell_cpu
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=2,
                       rays_per_batch=rays_per_batch)
    pid = torch.arange(W * H, dtype=torch.int32)
    s = renderer.render_frame(scene, cam, cfg, W, H, pid, SPP, cfg.seed)
    want = to_image(s.numpy() / np.float32(SPP), W, H)
    before = finish.LAUNCHES
    img = renderer.render(scene, cam, cfg)
    assert finish.LAUNCHES == before
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(bits(img), bits(want))


# --- on the card -------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("gamma", [True, False])
@pytest.mark.parametrize("nsamples", [1, 20])
def test_kernel_against_to_image(card, gamma, nsamples):
    n = 850 * 480
    s = finish_film(n, seed=nsamples)
    want = to_image(s / np.float32(nsamples), n, 1, gamma).reshape(-1)
    before = finish.LAUNCHES
    got = finish.finish(torch.from_numpy(s).to(card), nsamples, gamma)
    assert finish.LAUNCHES == before + 1
    assert got.device == card and tuple(got.shape) == (n, 3)
    got = got.cpu().numpy().reshape(-1)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    # + 0 makes a -0 +0: numpy's clip keeps -0 in some versions (2.3) and
    # not in others (2.0); with gamma every zero is +0 on both sides
    gap = np.abs(bits(got[~nan] + np.float32(0)).astype(np.int64)
                 - bits(want[~nan] + np.float32(0)).astype(np.int64))
    assert gap.max() <= (ULP if gamma else 0), gap.max()


@pytest.fixture(scope="module")
def cornell_card(card):
    scene = compile_scene(zoo.setup_cornell_box(W / H), device=card)
    cfg = RenderConfig(nsamples=SPP, width=W, height=H, max_bounces=2)
    return scene, default_camera(W / H, device=card), cfg


@pytest.mark.card
def test_a_frame_launches_the_finish_once(cornell_card):
    scene, cam, cfg = cornell_card
    mesh = sharding.make_ray_mesh(1, 1)
    calls = [lambda: renderer.render(scene, cam, cfg),
             lambda: multihost.render_image_multihost(scene, cam, cfg, mesh)]
    for frame in calls:
        for _ in range(2):          # the graph's capture, then a replay
            before = finish.LAUNCHES
            frame()
            assert finish.LAUNCHES == before + 1
    before = finish.LAUNCHES
    renderer.render(scene, cam, dataclasses.replace(cfg, kernels="off"))
    assert finish.LAUNCHES == before


@pytest.mark.card
def test_card_tiled_equals_direct(cornell_card, tmp_path):
    scene, cam, cfg = cornell_card
    direct = renderer.render(scene, cam, cfg)
    tiled = renderer.render(scene, cam, cfg, ckpt_dir=str(tmp_path), tile=16)
    np.testing.assert_array_equal(bits(tiled), bits(direct))


@pytest.mark.card
def test_card_frames_are_their_own_arrays(cornell_card):
    scene, cam, cfg = cornell_card
    first = renderer.render(scene, cam, cfg)
    kept = first.copy()
    other = dataclasses.replace(cam, fov_deg=cam.fov_deg * 0.8)
    second = renderer.render(scene, other, cfg)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(bits(first), bits(kept))
