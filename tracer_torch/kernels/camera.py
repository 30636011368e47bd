"""One sample's camera rays on the card: the per-ray keys, the pixel
jitter, the ray time and the pinhole rays of `renderer.camera_batch` in
one pass of the CUDA kernel of `csrc/camera.cu`.

It replaces no Pallas kernel: the JAX package makes its camera rays with
jnp ops inside its jitted frame. The port's torch chain for them (the
plain version, `renderer.camera_batch` on the CPU, with `kernels="off"`
and for a camera that carries a gradient) is ~220 launches a sample,
mostly int64 elementwise ops of the PCG hash over the batch;
`renderer.camera_batch` is the one place that chooses between the two.
The kernel reproduces the chain on the card bit for bit: the same integer
hashes, and the same float operations in the same order, each rounded on
its own.

The seed word and the sample index may be python ints (passed as
arguments) or 0-d tensors on the card (read there by the kernel), so a
compiled frame's graph, which takes them as an argument and a carry,
replays with a new seed or first sample without a read from the host.

What bounds it on an H100: memory, ~40 B a ray (the id in, the key and
seven floats out), 16.3 MB for an 850x480 sample, ~4.9 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracer_torch.core import rng
from tracer_torch.kernels import common as kc

LAUNCHES = 0  # calls that launched the CUDA kernel


class _Args(ctypes.Structure):
    """Mirror of `CameraArgs` in csrc/camera.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ids", "word", "sample", "position", "quaternion", "fov_deg",
        "aspect", "keys", "rays", "jitter")] + [
        (name, ctypes.c_int) for name in ("n", "width", "ids64")] + [
        (name, ctypes.c_uint) for name in ("word_value", "sample_value")] + [
        (name, ctypes.c_float) for name in ("inv_w", "inv_h")]


def _scalar_arg(name, x, dev):
    """(pointer, value) of a uint32 the kernel reads: a 0-d int64 tensor
    on the card by its pointer, a python int by its value."""
    if isinstance(x, torch.Tensor):
        return kc.check(name, x, torch.int64, (), dev), 0
    return None, int(x) & 0xFFFFFFFF


def camera_rays(camera, width: int, height: int, pixel_ids, sample_idx,
                seed, jitter: bool = False):
    """`renderer.camera_batch` on the card: (o, d, time, keys) for the
    CUDA pixel ids [N] (int32 or int64, y * width + x), o and d planar
    views of one [7, N] f32 block, keys [N] int64 holding uint32. The
    camera's tensors lie on the ids' card. `sample_idx`: an int or a 0-d
    int64 tensor; `seed`: an int, or its word in a 0-d int64 tensor
    (`rng.seed_tensor`). With `jitter`, the pixel jitter [2, N] f32 comes
    fifth."""
    from tracer_torch.kernels import _build
    global LAUNCHES
    if not pixel_ids.is_cuda:
        raise ValueError(f"camera_rays: the pixel ids are on "
                         f"{pixel_ids.device}; the torch chain of "
                         "renderer.camera_batch makes rays off the card")
    if pixel_ids.dtype not in (torch.int32, torch.int64) or \
            pixel_ids.dim() != 1:
        raise ValueError(f"camera_rays: pixel ids must be [N] int32 or "
                         f"int64, got {pixel_ids.dtype} "
                         f"{tuple(pixel_ids.shape)}")
    dev = pixel_ids.device
    ids = pixel_ids.contiguous()
    n = ids.shape[0]
    if 7 * n >= 2 ** 31:
        raise ValueError(f"camera_rays: {n} rays exceed the kernel's int32 "
                         "positions")
    f32 = torch.float32
    a = _Args()
    a.ids, a.n, a.ids64 = ids.data_ptr(), n, int(ids.dtype == torch.int64)
    word = seed if isinstance(seed, torch.Tensor) else rng.seed_word(seed)
    a.word, a.word_value = _scalar_arg("seed", word, dev)
    a.sample, a.sample_value = _scalar_arg("sample_idx", sample_idx, dev)
    for name, t, shape in (("position", camera.position, (3,)),
                           ("quaternion", camera.quaternion, (4,)),
                           ("fov_deg", camera.fov_deg, (1,)),
                           ("aspect", camera.aspect, (1,))):
        setattr(a, name, kc.check(f"camera.{name}", t.reshape(shape), f32,
                                  shape, dev))
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    rays = torch.empty((7, n), dtype=f32, device=dev)
    jit = torch.empty((2, n), dtype=f32, device=dev) if jitter else None
    a.keys, a.rays = keys.data_ptr(), rays.data_ptr()
    a.jitter = jit.data_ptr() if jitter else None
    a.width = width
    a.inv_w = float(np.float32(1.0) / np.float32(width))
    a.inv_h = float(np.float32(1.0) / np.float32(height))
    if n > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_camera(ctypes.addressof(a), stream)
        kc.raise_on_error("camera", err)
        LAUNCHES += 1
    out = (tuple(rays[0:3]), tuple(rays[3:6]), rays[6], keys)
    return out + (jit,) if jitter else out
