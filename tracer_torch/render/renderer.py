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

Spans (`core/spans.py`, ranges in a `torch.profiler` trace): each chunk's
`render.launch` (its pixel ids and `render_frame`, with the frame's
tables and carry in `render.prepare`), `render.copy_out` (the sum to the
host, with the wait for its samples) and the frame's `render.to_image`.
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.core.config import RenderConfig
from tracer_torch.core.spans import span
from tracer_torch.render import graphs, integrator
from tracer_torch.render.camera import Camera, generate_rays
from tracer_torch.render.film import TileManifest, to_image


def camera_batch(camera: Camera, width: int, height: int, pixel_ids,
                 sample_idx, seed):
    """One sample's camera rays for a batch of pixels: pixel jitter and ray
    time from the PCG streams. pixel_ids: [N] int (flat y*width + x);
    `sample_idx` a python int or a 0-d int tensor, `seed` as
    `rng.ray_keys` takes it (an int, or its word in a 0-d tensor).
    Returns (o, d, time, keys) with o, d planar."""
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
                                    sample_idx, seed)
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
    (`render_frame`: a graph replay per chunk on the card).

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
    film = np.zeros((n_pix, 3), np.float32)
    for lo in range(0, n_pix, chunk):
        hi = min(lo + chunk, n_pix)
        with span("render.launch"):
            pid = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            rad = render_frame(scene, camera, cfg, width, height, pid,
                               nsamples, cfg.seed)
        with span("render.copy_out"):
            film[lo:hi] = rad.cpu().numpy()
        if progress:
            print(f"  pixels {hi}/{n_pix}", flush=True)
    with span("render.to_image"):
        return to_image(film / np.float32(nsamples), width, height)


def _render_tiled(scene, camera, cfg, width, height, nsamples, ckpt_dir,
                  tile, host, n_hosts, progress):
    """The tiled, checkpointed render (`render(ckpt_dir=...)`). The JAX
    package pads each edge tile to tile*tile ids for one jit cache entry;
    the port traces a tile's own ids, one graph a tile shape
    (`render_frame`)."""
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
    return man.assemble(nsamples)


def render_image(scene, camera, cfg, path, **kw):
    """Render and write a PPM (or PNG by extension) like main.cpp:251-262."""
    from tracer_torch.io.ppm import write_ppm, write_png
    img = render(scene, camera, cfg, **kw)
    if path.endswith(".png"):
        write_png(path, img)
    else:
        write_ppm(path, img)
    return img
