"""Pinhole camera (the port of `tracer/render/camera.py`).

dir_cam ∝ ((2u-1)·aspect·tan(fov/2), (1-2v)·tan(fov/2), -1), rotated by
the pose quaternion; origin = camera position. The default pose is the
reference app's startup framing: eye at (0, 0, 6.1), identity rotation.

Precision: the 3×3 rotation is applied as explicit float32 multiply-adds,
never through a matmul, so TF32 (the GPU counterpart of the TPU's bf16
matmul passes) cannot move the rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor        # [3]
    quaternion: torch.Tensor      # [4] (w, x, y, z) camera->world rotation
    fov_deg: torch.Tensor         # scalar
    aspect: torch.Tensor          # scalar


def default_camera(aspect: float = 850.0 / 480.0, device="cuda") -> Camera:
    """The reference app's startup camera, on the card unless the caller
    asks for the CPU."""
    f = dict(dtype=torch.float32, device=device)
    return Camera(
        position=torch.tensor([0.0, 0.0, 6.1], **f),
        quaternion=torch.tensor([1.0, 0.0, 0.0, 0.0], **f),
        fov_deg=torch.tensor(45.0, **f),
        aspect=torch.tensor(aspect, **f),
    )


def quat_to_matrix(q):
    """Unit quaternion (w,x,y,z) -> rotation rows ((r00, r01, r02), ...)."""
    q = q / torch.clamp_min(torch.sqrt(torch.sum(q * q)), 1e-20)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def generate_rays(camera: Camera, u, v):
    """Screen (u, v) in [0,1]^2 (v down) -> planar world rays (o, d), each
    a tuple of three [N] tensors."""
    deg2rad = float(np.float32(np.pi / 180.0))
    th = torch.tan(camera.fov_deg * deg2rad * 0.5)
    x = (2.0 * u - 1.0) * camera.aspect * th
    y = (1.0 - 2.0 * v) * th
    z = -torch.ones_like(x)
    R = quat_to_matrix(camera.quaternion)
    dw = tuple(x * R[i][0] + y * R[i][1] + z * R[i][2] for i in range(3))
    n = torch.clamp_min(torch.sqrt(dw[0] * dw[0] + dw[1] * dw[1]
                                   + dw[2] * dw[2]), 1e-20)
    d = tuple(c / n for c in dw)
    o = tuple(camera.position[i].expand_as(x).contiguous() for i in range(3))
    return o, d


def matrix_to_quat(R):
    """Rotation matrix [3, 3] -> unit quaternion (w, x, y, z), w >= 0.

    Shepperd's form with branch selection: the quaternion component of
    largest magnitude is taken from the largest of the trace and the three
    diagonal entries, and the others from off-diagonal sums over it. The
    JAX package's trace-only form divides by w, so it returns the identity
    for a half turn (w = 0); this form does not."""
    R = torch.as_tensor(R, dtype=torch.float32)
    r = [[R[i, j] for j in range(3)] for i in range(3)]
    t = r[0][0] + r[1][1] + r[2][2]
    k = int(torch.argmax(torch.stack([t, r[0][0], r[1][1], r[2][2]])))
    if k == 0:
        w = 0.5 * torch.sqrt(torch.clamp_min(1.0 + t, 1e-12))
        s = 0.25 / w
        q = [w, s * (r[2][1] - r[1][2]), s * (r[0][2] - r[2][0]),
             s * (r[1][0] - r[0][1])]
    else:
        i = k - 1
        j, l = (i + 1) % 3, (i + 2) % 3
        c = 0.5 * torch.sqrt(torch.clamp_min(
            1.0 + r[i][i] - r[j][j] - r[l][l], 1e-12))
        s = 0.25 / c
        v = [None, None, None]
        v[i] = c
        v[j] = s * (r[j][i] + r[i][j])
        v[l] = s * (r[l][i] + r[i][l])
        q = [s * (r[l][j] - r[j][l])] + v
    q = torch.stack(q)
    if float(q[0]) < 0.0:
        q = -q
    return q / torch.clamp_min(torch.sqrt(torch.sum(q * q)), 1e-20)


def look_at_quaternion(position, target, up=(0.0, 1.0, 0.0), device=None):
    """Orientation quaternion so that a camera at `position` looks at
    `target` (camera forward = -z, as `generate_rays` builds
    d_cam = (x, y, -1)), on `device` (default: the position's, else the
    CPU)."""
    if device is None:
        device = (position.device if isinstance(position, torch.Tensor)
                  else "cpu")
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.as_tensor(position, **f32)
    target = torch.as_tensor(target, **f32)
    up = torch.as_tensor(up, **f32)

    def normalize(v):
        return v / torch.clamp_min(torch.sqrt(torch.sum(v * v)), 1e-20)

    f = normalize(target - position)
    r = torch.linalg.cross(f, up)
    # up parallel to forward: any right vector perpendicular to forward
    if float(torch.sqrt(torch.sum(r * r))) < 1e-8:
        r = torch.linalg.cross(f, torch.tensor([1.0, 0.0, 0.0], **f32))
    r = normalize(r)
    u2 = torch.linalg.cross(r, f)
    return matrix_to_quat(torch.stack([r, u2, -f], dim=1))
