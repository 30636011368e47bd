"""The reference's camera, ray generation, sample sum and image finish,
frozen from the port's `render/camera.py`, `render/renderer.py` and
`render/film.py`: a pixel's random streams depend only on the seed, its
id and the sample, so the reference traces the rays the port traces.

`render_views` sums the samples of several views at once (a view: a
camera and the pixel ids drawn from it), many samples a ray batch, so
that a check of many frames pays few bounce loops, not one a frame and
sample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import integrator, rng
from portbench.reference.config import RenderConfig


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor        # [3]
    quaternion: torch.Tensor      # [4] (w, x, y, z) camera->world rotation
    fov_deg: torch.Tensor         # scalar
    aspect: torch.Tensor          # scalar


def camera(pose, fov_deg: float, aspect: float, device) -> Camera:
    """A camera from a pose [7] (position, quaternion w x y z)."""
    f = dict(dtype=torch.float32, device=device)
    pose = np.asarray(pose, np.float32)
    return Camera(torch.tensor(pose[:3], **f), torch.tensor(pose[3:], **f),
                  torch.tensor(fov_deg, **f), torch.tensor(aspect, **f))


def quat_to_matrix(q):
    """Unit quaternion (w,x,y,z) -> rotation rows ((r00, r01, r02), ...)."""
    q = q / torch.clamp_min(torch.sqrt(torch.sum(q * q)), 1e-20)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def generate_rays(cam: Camera, u, v):
    """Screen (u, v) in [0,1]^2 (v down) -> planar world rays (o, d): the
    pinhole dir ((2u-1)·aspect·tan(fov/2), (1-2v)·tan(fov/2), -1) rotated
    by the pose, as explicit f32 multiply-adds."""
    deg2rad = float(np.float32(np.pi / 180.0))
    th = torch.tan(cam.fov_deg * deg2rad * 0.5)
    x = (2.0 * u - 1.0) * cam.aspect * th
    y = (1.0 - 2.0 * v) * th
    z = -torch.ones_like(x)
    R = quat_to_matrix(cam.quaternion)
    dw = tuple(x * R[i][0] + y * R[i][1] + z * R[i][2] for i in range(3))
    n = torch.clamp_min(torch.sqrt(dw[0] * dw[0] + dw[1] * dw[1]
                                   + dw[2] * dw[2]), 1e-20)
    d = tuple(c / n for c in dw)
    o = tuple(cam.position[i].expand_as(x).contiguous() for i in range(3))
    return o, d


def camera_batch(cam: Camera, width: int, height: int, pixel_ids,
                 sample_idx: int, seed: int):
    """One sample's camera rays for pixel ids [N] (y*width + x): pixel
    jitter and ray time from the PCG streams. Returns (o, d, time, keys)."""
    keys = rng.salted(rng.ray_keys(seed, pixel_ids), sample_idx)
    jit_uv = rng.uniform(rng.salted(keys, rng.PIXEL_JITTER), (2,))
    pid = pixel_ids.to(torch.int64)
    x = (pid % width).to(torch.float32)
    y = (pid // width).to(torch.float32)
    u = (x + jit_uv[:, 0]) * float(np.float32(1.0) / np.float32(width))
    v = (y + jit_uv[:, 1]) * float(np.float32(1.0) / np.float32(height))
    time = rng.uniform(rng.salted(keys, rng.RAY_TIME))
    o, d = generate_rays(cam, u, v)
    return o, d, time, keys


def render_views(scene, views, cfg: RenderConfig, width: int, height: int,
                 nsamples: int, seed: int, first_sample: int = 0,
                 tables=None, lower=None, counts=None, max_lanes=1 << 21):
    """The SUM over samples first_sample ... of the radiance of every view
    (cam, pixel_ids [n]) -> [sum of n, 3] f32, the views' pixels in
    order, summed sample after sample as the port sums them. Samples are
    traced together, up to `max_lanes` rays a batch (fewer launches for
    the plain versions' loops). `lower` and `counts`: as
    `integrator.trace` takes them."""
    if tables is None:
        tables = integrator.prepare(scene)
    n = sum(int(pid.shape[0]) for _, pid in views)
    per = max(1, min(nsamples, max_lanes // max(n, 1)))
    acc = None
    samples = list(range(first_sample, first_sample + nsamples))
    for lo in range(0, nsamples, per):
        parts = [camera_batch(c, width, height, pid, s, seed)
                 for s in samples[lo:lo + per] for c, pid in views]
        o = tuple(torch.cat([p[0][a] for p in parts]) for a in range(3))
        d = tuple(torch.cat([p[1][a] for p in parts]) for a in range(3))
        tm = torch.cat([p[2] for p in parts])
        keys = torch.cat([p[3] for p in parts])
        rad = integrator.trace(scene, cfg, o, d, tm, keys, tables, lower,
                               counts)
        for r in rad.reshape(-1, n, 3):
            acc = r if acc is None else acc + r
    return acc


def to_image(mean: np.ndarray) -> np.ndarray:
    """Mean linear radiance [..., 3] -> gamma 1/2.2 and a clamp to [0, 1]
    (main.cpp:193-196 / 258-261)."""
    mean = np.power(np.clip(mean, 0.0, None), 1.0 / 2.2)
    return np.clip(mean, 0.0, 1.0)
