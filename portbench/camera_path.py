"""The viewer's camera path: a closed loop of orbit steps around the
config's orbit target, from the reference app's start pose. The loop is
the traffic's own (`path_seed`): a walk of `path_period` / 2 frames, each
an orbit step of `orbit_step_deg` in a random direction and a zoom of up
to `zoom_step`, looking at the target, then the same walk back. A run's
seed picks where on the loop it starts, so every seed renders the same
poses in another order, and a window of many loops the same work. Poses
are numpy [n, 7] f32: position, then the quaternion (w, x, y, z) that
the port's and the reference's cameras take."""

from __future__ import annotations

import numpy as np


def _walk(n: int, config: dict, traffic: dict) -> np.ndarray:
    """n poses of the walk from the start pose."""
    rs = np.random.default_rng(traffic["path_seed"])
    start = np.asarray(config["camera"]["position"], np.float64)
    target = np.asarray(config["camera"]["orbit_target"], np.float64)
    off = start - target
    r = float(np.linalg.norm(off))
    yaw = float(np.degrees(np.arctan2(off[0], off[2])))
    pitch = float(np.degrees(np.arcsin(off[1] / r)))
    lo, hi = traffic["orbit_step_deg"]
    zoom = traffic["zoom_step"]
    out = np.zeros((n, 7), np.float32)
    for i in range(n):
        if i:
            step = rs.uniform(lo, hi)
            turn = rs.uniform(0.0, 2 * np.pi)
            yaw += step * np.cos(turn)
            pitch += step * np.sin(turn)
            r *= 1.0 + rs.uniform(-zoom, zoom)
        a, e = np.radians(yaw), np.radians(pitch)
        out[i, :3] = target + r * np.array([np.cos(e) * np.sin(a), np.sin(e),
                                            np.cos(e) * np.cos(a)])
        # the camera's -z turned onto the target: the yaw about y after
        # the pitch about x
        ca, sa = np.cos(a / 2), np.sin(a / 2)
        ce, se = np.cos(e / 2), np.sin(e / 2)
        out[i, 3:] = (ca * ce, -ca * se, sa * ce, sa * se)
    return out


def loop(config: dict, traffic: dict) -> np.ndarray:
    """The closed loop of `path_period` poses: the walk out and back."""
    w = _walk(traffic["path_period"] // 2 + 1, config, traffic)
    return np.concatenate([w, w[-2:0:-1]])


def poses(seed: int, n: int, config: dict, traffic: dict) -> np.ndarray:
    """n poses of the loop from the place the run's seed picks."""
    lp = loop(config, traffic)
    phase = int(np.random.default_rng([seed, 3]).integers(lp.shape[0]))
    return lp[(phase + np.arange(n)) % lp.shape[0]]
