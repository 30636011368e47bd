"""Film: sample accumulation with tile-grained checkpoint/resume (the port
of `tracer/render/film.py`, numpy only, kept as a copy because importing
`tracer` imports JAX).

The film is an associative sum of per-sample radiance, so a long high-spp
render checkpoints (film_sum, samples_done) per tile and a restarted job
resumes exactly: a tile re-renders only if its checkpoint is missing. The
on-disk format is the JAX package's (`np.savez_compressed` with keys `sum`
and `samples_done`; tile files `tile_{t:05d}.npz`, written atomically), so
a tile store written by either package resumes in the other.
"""

from __future__ import annotations

import os

import numpy as np


def to_image(mean: np.ndarray, width: int, height: int,
             gamma: bool = True) -> np.ndarray:
    """Mean linear radiance [H*W, 3] -> the image [H, W, 3]: gamma 1/2.2
    and a clamp to [0, 1] (main.cpp:193-196 / 258-261). A film on the host
    finishes here: `Film.image`, `TileManifest.assemble`, and the direct
    and the tiled render of a CPU scene (`renderer.finish_frame`). On the
    card, the direct render finishes its film's sum and the tiled render
    its assembled mean in the finish kernel (`kernels/finish.py`, the
    same division and clamps, CUDA's powf), so on either device the two
    images are equal bit for bit."""
    if gamma:
        mean = np.power(np.clip(mean, 0.0, None), 1.0 / 2.2)
    return np.clip(mean, 0.0, 1.0).reshape(height, width, 3)


class Film:
    """Accumulation buffer for a width x height frame."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.sum = np.zeros((height * width, 3), np.float32)
        self.samples_done = 0

    def add_sample(self, radiance: np.ndarray):
        """radiance: [H*W, 3] linear radiance for one sample pass."""
        self.sum += np.asarray(radiance, np.float32)
        self.samples_done += 1

    def image(self, gamma: bool = True) -> np.ndarray:
        return to_image(self.sum / max(self.samples_done, 1), self.width,
                        self.height, gamma)

    # --- checkpointing ---------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(path, sum=self.sum,
                            samples_done=self.samples_done,
                            width=self.width, height=self.height)

    @classmethod
    def load(cls, path: str) -> "Film":
        z = np.load(path)
        f = cls(int(z["width"]), int(z["height"]))
        f.sum = z["sum"]
        f.samples_done = int(z["samples_done"])
        return f


class TileManifest:
    """Deterministic tile -> host assignment + per-tile checkpoints.

    Assignment is a pure function of (n_tiles, n_hosts) so elastic restarts
    re-render identical pixels (SURVEY.md §5).
    """

    def __init__(self, width: int, height: int, tile: int, ckpt_dir: str):
        self.width = width
        self.height = height
        self.tile = tile
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self.nx = (width + tile - 1) // tile
        self.ny = (height + tile - 1) // tile

    @property
    def n_tiles(self) -> int:
        return self.nx * self.ny

    def tiles_for_host(self, host: int, n_hosts: int):
        return [t for t in range(self.n_tiles) if t % n_hosts == host]

    def tile_pixels(self, t: int) -> np.ndarray:
        ty, tx = divmod(t, self.nx)
        xs = np.arange(tx * self.tile, min((tx + 1) * self.tile, self.width))
        ys = np.arange(ty * self.tile, min((ty + 1) * self.tile, self.height))
        g = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        return (g[:, 1] * self.width + g[:, 0]).astype(np.int32)

    def _path(self, t: int) -> str:
        return os.path.join(self.ckpt_dir, f"tile_{t:05d}.npz")

    def done(self, t: int, nsamples: int) -> bool:
        p = self._path(t)
        if not os.path.exists(p):
            return False
        try:
            return int(np.load(p)["samples_done"]) >= nsamples
        except Exception:
            return False

    def save_tile(self, t: int, film_sum: np.ndarray, samples_done: int):
        tmp = self._path(t) + ".tmp.npz"  # np.savez appends .npz itself
        np.savez_compressed(tmp, sum=film_sum, samples_done=samples_done)
        os.replace(tmp, self._path(t))  # atomic: crash-safe

    def load_tile(self, t: int):
        p = self._path(t)
        if not os.path.exists(p):
            return None, 0
        z = np.load(p)
        return z["sum"], int(z["samples_done"])

    def mean(self) -> np.ndarray:
        """The mean radiance [H*W, 3] f32 of every tile checkpoint, each
        tile's sum over its own samples (0 where a tile is missing)."""
        img = np.zeros((self.height * self.width, 3), np.float32)
        for t in range(self.n_tiles):
            s, n = self.load_tile(t)
            if s is None or n == 0:
                continue
            img[self.tile_pixels(t)] = s / n
        return img

    def assemble(self, nsamples: int, gamma: bool = True) -> np.ndarray:
        """Gather all tile checkpoints into the final image."""
        return to_image(self.mean(), self.width, self.height, gamma)
