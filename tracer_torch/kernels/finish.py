"""The frame's finish: the film's sum over `nsamples` samples [N, 3] f32 ->
the image [N, 3] f32, the mean with gamma 1/2.2 and a clamp to [0, 1], as
`render/film.py::to_image` computes it after `film / np.float32(nsamples)`
(main.cpp:193-196 / 258-261).

The CUDA kernel of `csrc/finish.cu` finishes a film that lies on the card
in one pass, so that `renderer.render` and `render_image_multihost` copy
only the finished image to the host. It replaces no Pallas kernel (the JAX
package finishes with jnp ops after its jitted frame).

The plain version is `film.to_image(film / np.float32(nsamples))` on the
host, the finish every CPU render keeps; `renderer.finish_frame` is the
one place that chooses between the two (`kernels/common.py`'s rule). No
chain of torch ops stands in for it: `torch.pow` does not reproduce
numpy's float32 power bit for bit (it differs by an ulp in about a fifth
of random inputs on an x86 host), so it would not hold the CPU renders'
images. The kernel agrees with the plain version to powf's rounding: the
division and the clamps are numpy's, NaN where numpy has NaN.

What bounds it on an H100: memory, 4 B read and 4 B written a float
(9.8 MB for an 850x480 film, ~2.9 us at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracer_torch.kernels import common as kc

LAUNCHES = 0  # calls that launched the CUDA kernel


class _Args(ctypes.Structure):
    """Mirror of `FinishArgs` in csrc/finish.cu (same order)."""
    _fields_ = [("sum", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("count", ctypes.c_float), ("n", ctypes.c_int),
                ("gamma", ctypes.c_int)]


def finish(film, nsamples: int, gamma: bool = True):
    """The image [N, 3] f32 on the card: `film` [N, 3] f32, a CUDA tensor,
    is the sum of `nsamples` samples a pixel."""
    if nsamples < 1:
        raise ValueError(f"finish: nsamples={nsamples}, at least 1")
    if not film.is_cuda:
        raise ValueError(f"finish: the film is on {film.device}; a host "
                         "film finishes in film.to_image")
    from tracer_torch.kernels import _build
    global LAUNCHES
    dev = film.device
    film = film.detach().contiguous()
    n = film.shape[0]
    if 3 * n >= 2 ** 31:
        raise ValueError(f"finish: {n} pixels exceed the kernel's int32 "
                         "positions")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    a = _Args()
    a.sum = kc.check("film", film, torch.float32, (n, 3), dev)
    a.out = out.data_ptr()
    a.count = float(np.float32(nsamples))
    a.n = 3 * n
    a.gamma = int(bool(gamma))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().tt_finish(ctypes.addressof(a), stream)
    kc.raise_on_error("finish", err)
    LAUNCHES += 1
    return out
