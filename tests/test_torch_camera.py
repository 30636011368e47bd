"""The camera kernel (`tracer_torch/kernels/camera.py`, `csrc/camera.cu`),
`renderer.camera_batch`, which chooses between it and its plain version
(the torch chain), and the bounce salt that B2 and B6 apply themselves.

On the CPU:
- `renderer.camera_kernel_ok` takes the kernel for the pixel ids of a
  card (kernels "auto" or "on") and a camera without gradient, and the
  torch chain on the CPU, with `kernels="off"` and for a camera tensor
  that requires grad while grad is enabled (decided on a stand-in for a
  card's tensor: the rule reads only `is_cuda`);
- on the CPU `camera_batch` launches nothing, and a trainable camera's
  position and quaternion get finite, non-zero gradients through
  `render_pixels`;
- the ctypes mirrors of the kernels' argument structs list the fields of
  the `.cu` structs in order, each with the type of its C field;
- B2 and B6 with the bounce as `salt` equal their plain versions on keys
  salted before the call.

On a CUDA card (skipped without one; this file imports no JAX, so on the
card's machine `python -m pytest --noconftest tests/test_torch_camera.py`
runs it):
- the kernel's keys, jitter, time, o and d equal the torch chain's bit
  for bit, over seeds given as ints and as words on the card, sample
  indices as ints and 0-d tensors, a tile's pixel ids and widths that are
  not a power of two;
- B2 and B6 give the same bits with the salt as with pre-salted keys;
- a compiled Cornell and flamingo_standin frame equal the frame made with
  the torch chain's camera rays, bit for bit, and launch the kernel once
  a sample;
- a frame launches the camera kernel once a sample per chunk, counted
  through `graphs.COUNTED` on replays;
- the captured one-sample graph of the fused route computes no int64
  elementwise op over the rays.
"""

import ctypes
import dataclasses
import pathlib
import re
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.card import card  # noqa: F401  (the fixture)
from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.kernels import camera as kcamera
from tracer_torch.kernels import finish as kfinish
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import rowsum as krowsum
from tracer_torch.kernels import shade as kshade
from tracer_torch.kernels import shade_bwd as kbwd
from tracer_torch.kernels import shadow as kshadow
from tracer_torch.kernels import traverse as ktraverse
from tracer_torch.render import graphs, integrator, renderer
from tracer_torch.render.camera import Camera, default_camera
from tracer_torch.scene.device import compile_scene
from tracer_torch.scenes import zoo
from tracer_torch.testing import flamingo_standin

CSRC = pathlib.Path(kcamera.__file__).resolve().parent / "csrc"
W, H = 37, 23
FIELDS = ("position", "quaternion", "fov_deg", "aspect")
CARD_LIKE = types.SimpleNamespace(is_cuda=True)


def bits(t) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return np.ascontiguousarray(a, np.float32).reshape(-1).view(np.int32)


def turned_camera(device, aspect=W / H):
    """A camera off the default pose: a quaternion that is not of unit
    length and not the identity, and a fov other than 45 degrees."""
    f = dict(dtype=torch.float32, device=device)
    return Camera(position=torch.tensor([0.31, -0.22, 5.87], **f),
                  quaternion=torch.tensor([0.93, 0.11, -0.27, 0.06], **f),
                  fov_deg=torch.tensor(38.5, **f),
                  aspect=torch.tensor(aspect, **f))


# --- the choice, on the CPU --------------------------------------------------

@pytest.mark.parametrize("kernels,want", [("auto", True), ("on", True),
                                          ("off", False)])
def test_the_kernel_takes_a_cards_ids(kernels, want):
    cam = default_camera(device="cpu")
    assert renderer.camera_kernel_ok(cam, CARD_LIKE, kernels) is want


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_cpu_ids_take_the_chain(kernels):
    pid = torch.arange(4, dtype=torch.int32)
    assert not renderer.camera_kernel_ok(default_camera(device="cpu"), pid,
                                         kernels)


def test_cpu_ids_refuse_kernels_on():
    with pytest.raises(RuntimeError, match="needs CUDA"):
        renderer.camera_kernel_ok(default_camera(device="cpu"),
                                  torch.arange(4), "on")


@pytest.mark.parametrize("field", FIELDS)
def test_a_trainable_camera_takes_the_chain(field):
    cam = default_camera(device="cpu")
    t = getattr(cam, field).clone().requires_grad_(True)
    cam = dataclasses.replace(cam, **{field: t})
    assert not renderer.camera_kernel_ok(cam, CARD_LIKE, "auto")
    with torch.no_grad():   # no gradient to carry: the kernel again
        assert renderer.camera_kernel_ok(cam, CARD_LIKE, "auto")


def test_cpu_camera_batch_launches_nothing():
    cam = turned_camera("cpu")
    pid = torch.arange(W * H, dtype=torch.int32)
    before = kcamera.LAUNCHES
    o, d, tm, keys = renderer.camera_batch(cam, W, H, pid, 3, 11)
    assert kcamera.LAUNCHES == before
    assert keys.dtype == torch.int64 and tm.shape == (W * H,)
    assert all(c.shape == (W * H,) for c in (*o, *d))
    with pytest.raises(ValueError, match="torch chain"):
        kcamera.camera_rays(cam, W, H, pid, 3, 11)


def test_trainable_camera_gets_its_gradients():
    # under a light: the flat box's radiance is constant in the pose
    # between the discrete selections, so its camera gradient is 0
    scene = compile_scene(zoo.setup_random_spheres(), device="cpu")
    cam = turned_camera("cpu")
    pos = cam.position.clone().requires_grad_(True)
    quat = cam.quaternion.clone().requires_grad_(True)
    cam = dataclasses.replace(cam, position=pos, quaternion=quat)
    pid = torch.arange(W * H, dtype=torch.int32)
    cfg = RenderConfig(max_bounces=3)
    renderer.render_pixels(scene, cam, cfg, W, H, pid, 2, 5).mean().backward()
    for g in (pos.grad, quat.grad):
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0.0


# --- the ctypes mirrors ------------------------------------------------------

_CTYPE = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
          "float": ctypes.c_float}


def c_fields(source: str, struct: str):
    """[(name, ctypes type)] of `struct` in a .cu file, in order: a
    pointer of any type is a c_void_p."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"((?:const )?[A-Za-z_][A-Za-z0-9_ ]*?)\s*(\*?\s*"
                     r"[A-Za-z_]\w*(?:\s*,\s*\*?\s*[A-Za-z_]\w*)*)$", decl)
        base = m.group(1).replace("const ", "").strip()
        for name in m.group(2).split(","):
            name = name.strip()
            if name.startswith("*"):
                out.append((name.lstrip("* "), ctypes.c_void_p))
            else:
                out.append((name, _CTYPE[base]))
    return out


@pytest.mark.parametrize("mirror,source,struct", [
    (kcamera._Args, "camera.cu", "CameraArgs"),
    (kshade._Params, "shade_scatter.cu", "ShadeParams"),
    (kshade._IO, "shade_scatter.cu", "ShadeIO"),
    (kshadow._Args, "shadow.cu", "ShadowArgs"),
    (kfinish._Args, "finish.cu", "FinishArgs"),
    (kintersect._Args, "first_hits.cu", "FirstHitsArgs"),
    (ktraverse._Args, "traverse.cu", "TraverseArgs"),
    (kbwd._IO, "bounce_bwd.cu", "BwdIO"),
    (kbwd._Params, "bounce_bwd.cu", "BwdParams"),
    (krowsum._Args, "row_sum.cu", "RowSumArgs"),
])
def test_ctypes_mirror_lists_the_struct(mirror, source, struct):
    assert [(n, t) for n, t in mirror._fields_] == c_fields(source, struct)


# --- B2 and B6 salt the keys themselves: the plain versions -----------------

def bounce_inputs(sb, device, w=W, h=H):
    """A scene's camera rays of one sample, their bounce state, tables and
    first hits (bounce 0, no texels)."""
    scene = compile_scene(sb, device=device)
    cam = turned_camera(device, w / h)
    pid = torch.arange(w * h, dtype=torch.int32, device=device)
    o, d, tm, keys = renderer.camera_batch(cam, w, h, pid, 2, 9)
    state = integrator._init_state(o, d, tm)
    tables = integrator.prepare(scene)
    t_raw = tri_raw = None
    if scene.mesh_mat.shape[0] > 0:
        t_raw, tri_raw = ktraverse.mesh_closest_hits(
            scene, o, d, live=state["active"], tables=tables.tree)
    k1 = kintersect.first_hits(scene, o, d, tm, state["active"],
                               eps=RenderConfig().epsilon,
                               tables=tables.intersect, t_mesh=t_raw,
                               tri_mesh=tri_raw, mesh=tables.mesh, slim=True)
    return scene, state, tables, k1, keys


def salted_pair(scene, state, tables, k1, keys, b, kernels):
    """B6's factors and B2's updated state, once with the bounce as the
    salt, once on keys salted before the call."""
    cfg = RenderConfig(kernels=kernels)
    live = state["active"] & (k1["j"] >= 0)
    out = []
    for ks, salt in ((keys, b), (rng.salted(keys, b), None)):
        sh = None
        if scene.light_pos.shape[0] > 0:
            sh = kshadow.shadow_factors(scene, cfg, k1["p"], state["time"],
                                        ks, cfg.epsilon, live,
                                        kernels=kernels, tables=tables.shadow,
                                        tree=tables.tree, salt=salt)
        st = integrator.copy_state(state)
        kshade.shade_scatter(scene, cfg, st, ks, k1, cfg.max_bounces - b,
                             shadows=sh, kernels=kernels, tables=tables.shade,
                             mesh=tables.mesh, quad=tables.intersect[1],
                             salt=salt)
        out.append((sh, st))
    return out


def assert_same_bits(pair):
    (sh0, st0), (sh1, st1) = pair
    if sh0 is not None:
        np.testing.assert_array_equal(bits(sh0), bits(sh1))
    for k in ("o", "d", "throughput", "acc"):
        for a, b in zip(st0[k], st1[k]):
            np.testing.assert_array_equal(bits(a), bits(b))
    assert torch.equal(st0["active"], st1["active"])


@pytest.mark.parametrize("b", [0, 4])
def test_plain_salt_equals_presalted_keys(b):
    sb = zoo.setup_random_spheres()
    assert_same_bits(salted_pair(*bounce_inputs(sb, "cpu", 16, 9), b, "off"))


# --- on the card -------------------------------------------------------------

def chain_rays(cam, w, h, pid, sample, seed):
    """The torch chain's rays, keys and jitter on the card."""
    keys = rng.salted(rng.ray_keys(seed, pid), sample)
    jit = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER), (2,))
    with torch.no_grad():
        o, d, tm, k = renderer.camera_batch(cam, w, h, pid, sample, seed,
                                            "off")
    assert torch.equal(k, keys)
    return o, d, tm, keys, jit.T


@pytest.mark.card
@pytest.mark.parametrize("w,h", [(850, 480), (W, H)])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12_345])
@pytest.mark.parametrize("sample", [0, 5, "tensor"])
def test_kernel_is_the_chain_bit_for_bit(card, w, h, seed, sample):
    cams = (default_camera(w / h, device=card), turned_camera(card, w / h))
    full = torch.arange(w * h, dtype=torch.int32, device=card)
    x, y = torch.meshgrid(torch.arange(3, w // 2 + 3), torch.arange(2, h - 1),
                          indexing="xy")
    tile = (y * w + x).reshape(-1).to(device=card, dtype=torch.int64)
    s = torch.full((), 19, dtype=torch.int64, device=card) \
        if sample == "tensor" else sample
    for cam in cams:
        for pid in (full, tile):
            for sd in (seed, rng.seed_tensor(seed, card)):
                got = kcamera.camera_rays(cam, w, h, pid, s, sd, jitter=True)
                want = chain_rays(cam, w, h, pid, s, seed)
                assert torch.equal(got[3], want[3])
                assert torch.equal(
                    rng.as_int32_bits(got[3]),
                    got[3].view(torch.int32)[0::2])   # the word B2 reads
                np.testing.assert_array_equal(bits(got[4]), bits(want[4]))
                np.testing.assert_array_equal(bits(got[2]), bits(want[2]))
                for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
                    np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.card
@pytest.mark.parametrize("case", range(8))
def test_kernel_turns_rays_as_the_chain(card, case):
    # seeded poses whose quaternions, of lengths 0.5-2, are summed
    # differently by each order of adding four squares
    g = np.random.default_rng(case)
    q = g.normal(size=4)
    q *= g.uniform(0.5, 2.0) / np.linalg.norm(q)
    f = dict(dtype=torch.float32, device=card)
    cam = Camera(position=torch.tensor(g.normal(size=3), **f),
                 quaternion=torch.tensor(q, **f),
                 fov_deg=torch.tensor(g.uniform(20.0, 90.0), **f),
                 aspect=torch.tensor(W / H, **f))
    pid = torch.arange(W * H, dtype=torch.int32, device=card)
    got = kcamera.camera_rays(cam, W, H, pid, 1, 2)
    want = chain_rays(cam, W, H, pid, 1, 2)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.card
@pytest.mark.parametrize("b", [0, 3])
@pytest.mark.parametrize("name", ["cornell_box", "random_spheres"])
def test_card_salt_equals_presalted_keys(card, name, b):
    sb = zoo.BY_NAME[name]()
    assert_same_bits(salted_pair(*bounce_inputs(sb, card, 850, 480), b,
                                 "auto"))


@pytest.mark.card
@pytest.mark.parametrize("name", ["cornell", "flamingo_standin"])
def test_card_frame_equals_the_chains_frame(card, name, monkeypatch):
    w, h, spp = 160, 90, 3
    sb = (zoo.setup_cornell_box(w / h) if name == "cornell"
          else flamingo_standin(zoo))
    scene = compile_scene(sb, device=card)
    cam = turned_camera(card, w / h)
    cfg = RenderConfig(nsamples=spp, width=w, height=h, max_bounces=6)
    pid = torch.arange(w * h, dtype=torch.int32, device=card)
    assert integrator._fused(scene, cfg)
    before = kcamera.LAUNCHES
    for _ in range(2):          # the capture, then a replay
        got = renderer.render_frame(scene, cam, cfg, w, h, pid, spp, 21, 3)
    assert kcamera.LAUNCHES == before + 2 * spp
    # the same frame with the torch chain's camera rays, eager
    monkeypatch.setattr(renderer, "camera_kernel_ok", lambda *a: False)
    with graphs.CACHE.disabled(), torch.no_grad():
        want = renderer.render_pixels(scene, cam, cfg, w, h, pid, spp, 21, 3)
    assert kcamera.LAUNCHES == before + 2 * spp
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.card
def test_card_frame_launches_once_a_sample_a_chunk(card):
    scene = compile_scene(zoo.setup_cornell_box(W / H), device=card)
    cam = default_camera(W / H, device=card)
    cfg = RenderConfig(nsamples=4, width=W, height=H, max_bounces=2,
                       rays_per_batch=W * H // 2 + 7)    # two chunks
    for _ in range(2):          # the graphs' capture, then their replays
        before = graphs.launch_counts()["camera"]
        renderer.render(scene, cam, cfg)
        assert graphs.launch_counts()["camera"] == before + 2 * 4
    before = kcamera.LAUNCHES
    renderer.render(scene, cam, dataclasses.replace(cfg, kernels="off"))
    assert kcamera.LAUNCHES == before


class Int64Ops(TorchDispatchMode):
    """The aten ops that make an int64 tensor of more than one element."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.int64 \
                    and t.numel() > 1:
                self.ops.append(str(func))
        return out


@pytest.mark.card
def test_captured_sample_has_no_int64_glue(card, monkeypatch):
    scene = compile_scene(zoo.setup_cornell_box(W / H), device=card)
    cam = default_camera(W / H, device=card)
    cfg = RenderConfig(nsamples=2, width=W, height=H)
    pid = torch.arange(W * H, dtype=torch.int32, device=card)
    mode, batch, ran = Int64Ops(), renderer._render_batch, []

    def watched(*args, **kw):
        ran.append(torch.cuda.is_current_stream_capturing())
        with mode:
            return batch(*args, **kw)

    # the sample's rays and bounces, in the warm-up and in the capture
    monkeypatch.setattr(renderer, "_render_batch", watched)
    graphs.CACHE.clear()
    renderer.render_frame(scene, cam, cfg, W, H, pid, 2, 4)
    assert ran == [False, True]
    # the keys' allocation; no int64 op computes over the rays
    assert mode.ops == ["aten.empty.memory_format"] * 2, mode.ops
