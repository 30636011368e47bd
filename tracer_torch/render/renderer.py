"""Top-level renderer (the port of `tracer/render/renderer.py`): the
pixels × samples grid is a flat ray stream traced in device batches;
samples are summed into a float film, then per-pixel mean, gamma 1/2.2 and
clamp reproduce the reference's main.cpp:193-196 / 258-261.

Recovery: with `ckpt_dir`, `render` goes tile by tile through a
`film.TileManifest`: each tile's (film_sum, samples_done) is saved
atomically, and a restarted render re-renders only the missing tiles. A
pixel's random streams depend only on its id and the sample, so a tile's
radiance equals the same pixels' radiance in a direct render, and the
store's format is the JAX package's, so either package resumes the other's.

Compiled frames: `render` and the tiled render trace each chunk or tile
through `render_frame`, the no-grad `render_pixels` replayed from a CUDA
graph on the card (`render/graphs.py`, the counterpart of the JAX
package's jitted `render_pixels` and its `lax.scan` over samples): the
graph holds one sample and is replayed once a sample, keyed by the
arguments' shapes, so a new camera, seed, spp, first sample or scene of
the same shapes replays it. A frame has at most two chunk shapes and a
tiled render at most four tile shapes, each one graph. On the CPU, and
with `kernels="off"`, `render_frame` is the eager body. `render_pixels`
stays the eager, differentiable function.

The finish (`finish_frame`): each chunk's sum lands in one film on the
scene's device. On the card the finish kernel (`kernels/finish.py`) makes
the image there, and only the image is copied to the host, once a frame,
into pinned memory of its own (an image a caller keeps is never
overwritten by the next frame). A CPU film, or the card's with
`kernels="off"`, is finished on the host by `film.to_image`.

Spans (`core/spans.py`, ranges in a `torch.profiler` trace): each chunk's
`render.launch` (its pixel ids and `render_frame`, with the frame's
tables and carry in `render.prepare`), then the frame's finish. On the
card: `render.to_image` (the finish kernel's launch), then
`render.copy_out` (the image's copy to the host, with the wait for the
samples and the finish). On the host: `render.copy_out` (the film as
numpy), then `render.to_image` (`film.to_image`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.core.spans import span
from tracer_torch.kernels import camera as kcamera
from tracer_torch.kernels import common as kc
from tracer_torch.kernels import finish as kfinish
from tracer_torch.render import graphs, integrator
from tracer_torch.render.camera import Camera, generate_rays
from tracer_torch.render.film import TileManifest, to_image


def camera_kernel_ok(camera: Camera, pixel_ids, kernels="auto") -> bool:
    """Whether `camera_batch` takes the camera kernel: the kernels' rule
    (`kernels/common.py`) takes the pixel ids, and no camera tensor
    requires grad while grad is enabled (the kernel's rays carry none)."""
    if not kc.use_kernel(kernels, pixel_ids):
        return False
    return not (torch.is_grad_enabled() and any(
        getattr(camera, f.name).requires_grad
        for f in dataclasses.fields(camera)))


def camera_batch(camera: Camera, width: int, height: int, pixel_ids,
                 sample_idx, seed, kernels="auto"):
    """One sample's camera rays for a batch of pixels: pixel jitter and ray
    time from the PCG streams. pixel_ids: [N] int (flat y*width + x);
    `sample_idx` a python int or a 0-d int tensor, `seed` as
    `rng.ray_keys` takes it (an int, or its word in a 0-d tensor).
    Returns (o, d, time, keys) with o, d planar. On the card one kernel
    makes them (`kernels/camera.py`, where `camera_kernel_ok`); else the
    torch chain below, its plain version."""
    if camera_kernel_ok(camera, pixel_ids, kernels):
        return kcamera.camera_rays(camera, width, height, pixel_ids,
                                   sample_idx, seed)
    keys = rng.ray_keys(seed, pixel_ids)
    keys = rng.salted(keys, sample_idx)
    jit_uv = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER), (2,))
    pid = pixel_ids.to(torch.int64)
    x = (pid % width).to(torch.float32)
    y = (pid // width).to(torch.float32)
    # the JAX renderer divides by the static width/height, which XLA turns
    # into a multiply by the f32 reciprocal
    u = (x + jit_uv[:, 0]) * float(np.float32(1.0) / np.float32(width))
    v = (y + jit_uv[:, 1]) * float(np.float32(1.0) / np.float32(height))
    time = rng.uniform(rng.salted(keys, rng.RAY_TIME))
    o, d = generate_rays(camera, u, v)
    return o, d, time, keys


def _render_batch(scene, camera: Camera, cfg: RenderConfig, width: int,
                  height: int, pixel_ids, sample_idx, seed, tables=None):
    """Radiance [N, 3] for one sample of a batch of pixels."""
    o, d, time, keys = camera_batch(camera, width, height, pixel_ids,
                                    sample_idx, seed, cfg.kernels)
    return integrator.trace(scene, cfg, o, d, time, keys, tables=tables)


def render_pixels(scene, camera: Camera, cfg: RenderConfig, width: int,
                  height: int, pixel_ids, nsamples: int, seed,
                  first_sample: int = 0, tables=None):
    """SUM of `nsamples` sample passes for `pixel_ids` [N] (divide by
    nsamples for the mean radiance): samples first_sample,
    first_sample + 1, ... (a sample's random streams depend on its index).
    `seed`: an int, or its word in a 0-d tensor (`rng.seed_tensor`, as a
    compiled body takes it). `tables`: `integrator.prepare(scene)` where
    the caller made them (a compiled body: the graph's static copies, so
    that nothing reads the card inside it). Returns [N, 3] f32,
    differentiable with respect to the scene's and the camera's tensors
    that require grad (`integrator.trace`)."""
    if tables is None:
        tables = integrator.prepare(scene)
    acc = torch.zeros(tuple(pixel_ids.shape) + (3,), dtype=torch.float32,
                      device=pixel_ids.device)
    for s in range(first_sample, first_sample + nsamples):
        acc = acc + _render_batch(scene, camera, cfg, width, height,
                                  pixel_ids, s, seed, tables)
    return acc


def _frame_args(scene, camera: Camera, pixel_ids, seed):
    """A compiled frame's arguments (`render_frame`): the scene, camera,
    pixel ids, the seed word in a 0-d tensor on their device (`seed` an
    int, or its word already in one) and the frame's tables, made from
    the caller's scene before the graph."""
    if not isinstance(seed, torch.Tensor):
        seed = rng.seed_tensor(seed, pixel_ids.device)
    return scene, camera, pixel_ids, seed, integrator.prepare(scene)


def _frame_carry(pixel_ids, first_sample: int):
    """A compiled frame's carry: the sum (zeros [N, 3] f32) and the sample
    index (0-d int64, `first_sample`), on the pixel ids' device."""
    dev = pixel_ids.device
    return (torch.zeros(tuple(pixel_ids.shape) + (3,), dtype=torch.float32,
                        device=dev),
            torch.full((), first_sample, dtype=torch.int64, device=dev))


def _frame_static(cfg: RenderConfig, width: int, height: int):
    """What a compiled frame's key holds by value besides its arguments'
    signature: no seed, spp or first sample (`lax.scan` traces them)."""
    return ("frame", cfg, width, height)


def render_frame(scene, camera: Camera, cfg: RenderConfig, width: int,
                 height: int, pixel_ids, nsamples: int, seed,
                 first_sample: int = 0, cache=None):
    """`render_pixels` without grad (the SUM of `nsamples` samples, [N, 3]
    f32; `seed` as `render_pixels` takes it), by a graph of `cache` (default `graphs.CACHE`) where it is
    active (CUDA tensors, the kernels on): the counterpart of
    `lax.scan`'s body, one sample (`acc += trace(sample idx)`, then
    `idx += 1`) captured at the first call with a new key (`frame_key`)
    and replayed `nsamples` times a call after `acc` is zeroed and `idx`
    set to `first_sample`; samples add up in `render_pixels`' order, so
    the frame is the eager one bit for bit. The seed, spp and first
    sample are not in the key. Every scene and route is graphed: the
    fused and the general bounce, meshes and lights."""
    cache = graphs.CACHE if cache is None else cache
    with torch.no_grad():
        if not cache.active(pixel_ids, cfg):
            with span("render.prepare"):
                tables = integrator.prepare(scene)
            return render_pixels(scene, camera, cfg, width, height,
                                 pixel_ids, nsamples, seed, first_sample,
                                 tables=tables)

        def sample(scene, camera, pid, word, tables, acc, idx):
            acc += _render_batch(scene, camera, cfg, width, height, pid,
                                 idx, word, tables)
            idx += 1
            return acc

        with span("render.prepare"):
            args = _frame_args(scene, camera, pixel_ids, seed)
            carry = _frame_carry(pixel_ids, first_sample)
        return cache.call(_frame_static(cfg, width, height), sample, args,
                          carry=carry, steps=nsamples)


def frame_key(scene, camera: Camera, cfg: RenderConfig, width: int,
              height: int, pixel_ids):
    """The key of `render_frame`'s graph (`graphs.key_of`): the config,
    width and height by value; the scene's, camera's and pixel ids'
    signature (shapes, not addresses); the host constants by value, in
    the tables' signature. No seed, spp or first sample."""
    return graphs.key_of(_frame_static(cfg, width, height),
                         _frame_args(scene, camera, pixel_ids, 0),
                         _frame_carry(pixel_ids, 0))[0]


@torch.no_grad()
def render(scene, camera: Camera, cfg: RenderConfig, width=None,
           height=None, nsamples=None, progress=False, ckpt_dir=None,
           tile=128, host=0, n_hosts=1):
    """Full-frame render -> float32 numpy [H, W, 3] gamma-corrected image,
    traced on the scene's device in chunks of `cfg.rays_per_batch` pixels
    (`render_frame`: a graph replay per chunk on the card) and finished by
    `finish_frame`: on the card, the image is a view of pinned host memory
    of its own (see there for what keeping many frames costs).

    With `ckpt_dir`, renders tile by tile (`tile` x `tile` pixels) with
    atomic per-tile checkpoints and resumes exactly: tiles already done
    (>= nsamples accumulated) are skipped, and the image is assembled from
    the tile store. This host renders the tiles t with
    t % n_hosts == host.
    """
    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    if ckpt_dir is not None:
        return _render_tiled(scene, camera, cfg, width, height, nsamples,
                             ckpt_dir, tile, host, n_hosts, progress)
    dev = scene.device
    n_pix = width * height
    chunk = min(cfg.rays_per_batch, n_pix)
    sums = []
    for lo in range(0, n_pix, chunk):
        hi = min(lo + chunk, n_pix)
        with span("render.launch"):
            pid = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            sums.append(render_frame(scene, camera, cfg, width, height, pid,
                                     nsamples, cfg.seed))
        if progress:
            print(f"  pixels {hi}/{n_pix}", flush=True)
    film = sums[0] if len(sums) == 1 else torch.cat(sums)
    return finish_frame(film, nsamples, width, height, cfg.kernels)


def finish_frame(film, nsamples: int, width: int, height: int,
                 kernels="auto") -> np.ndarray:
    """A frame's film, the sum of `nsamples` samples a pixel [H*W, 3] f32
    on any device -> the gamma-corrected image, float32 numpy [H, W, 3].
    Where the finish kernel takes the film (`kernels/common.py`'s rule: a
    CUDA film, `kernels` not "off"), the image is made on the card and
    copied once into pinned host memory of its own, and the call waits
    for that copy; else the film goes to the host and `film.to_image`
    finishes it.

    A pinned image is page-locked host memory from PyTorch's caching host
    allocator: 4.9 MB a 850x480 frame, 24.9 MB at 1920x1080. A caller that
    keeps frames (a sequence, a video writer, a viewer's history) holds
    that much page-locked memory a frame kept, and the allocator keeps the
    blocks cached for later frames once they are dropped. `np.array(img)`
    keeps a frame in pageable memory instead. The pinned copy is what
    makes the finish fast: on an H100 a pageable `.cpu()` of the 850x480
    image takes 0.48 ms against 0.15 ms."""
    if not kc.use_kernel(kernels, film):
        with span("render.copy_out"):
            film = film.cpu().numpy()
        with span("render.to_image"):
            return to_image(film / np.float32(nsamples), width, height)
    with span("render.to_image"):
        img = kfinish.finish(film, nsamples)
    with span("render.copy_out"):
        host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host.copy_(img, non_blocking=True)
        torch.cuda.current_stream(img.device).synchronize()
    return host.numpy().reshape(height, width, 3)


def _render_tiled(scene, camera, cfg, width, height, nsamples, ckpt_dir,
                  tile, host, n_hosts, progress):
    """The tiled, checkpointed render (`render(ckpt_dir=...)`). The JAX
    package pads each edge tile to tile*tile ids for one jit cache entry;
    the port traces a tile's own ids, one graph a tile shape
    (`render_frame`). The tiles' assembled mean is finished as a film of
    one sample on the scene's device (`finish_frame`): a division by 1
    is exact and each tile's sum / its samples rounds as the direct
    render's does, so the two images are equal bit for bit, on the card
    as on the host."""
    man = TileManifest(width, height, tile, ckpt_dir)
    for t in man.tiles_for_host(host, n_hosts):
        if man.done(t, nsamples):
            if progress:
                print(f"  tile {t}: already done, skipping", flush=True)
            continue
        pids = torch.from_numpy(man.tile_pixels(t)).to(scene.device)
        rad = render_frame(scene, camera, cfg, width, height, pids,
                           nsamples, cfg.seed)
        man.save_tile(t, rad.cpu().numpy(), nsamples)
        if progress:
            print(f"  tile {t}: rendered {pids.shape[0]} px", flush=True)
    mean = torch.from_numpy(man.mean()).to(scene.device)
    return finish_frame(mean, 1, width, height, cfg.kernels)


def render_image(scene, camera, cfg, path, **kw):
    """Render and write a PPM (or PNG by extension) like main.cpp:251-262."""
    from tracer_torch.io.ppm import write_ppm, write_png
    img = render(scene, camera, cfg, **kw)
    if path.endswith(".png"):
        write_png(path, img)
    else:
        write_ppm(path, img)
    return img
