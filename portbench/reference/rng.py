"""Frozen for the benchmark's reference from the port's `core/rng.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Counter-based RNG: the PCG hash chain of `tracer/core/rng.py` in torch.

Every random draw is a pure function of (seed, pixel, sample, bounce,
purpose): a "key" is a uint32 word, deriving a sub-stream (`salted`) is one
hash application, and a uniform draw is one hash plus a 24-bit mantissa
scale. There is no global generator state, and the streams are bit-identical
to the JAX package's, so the port and the reference trace the same paths.

torch has few uint32 ops, so a key lives in an int64 tensor holding a value
in [0, 2^32): every product is masked back to 32 bits and every shift is
then logical. `tracer_torch/kernels/csrc/pcg.cuh` is the same chain in
`uint32_t` for the CUDA kernels.

Seeds: the JAX renderer folds `jax.random.key(s)` into one word with
`rng._seed_word`; for the default threefry key the key data is [0, s], so
that word is `_pcg(s)`. `seed_word` computes it without JAX, and
`seed_tensor` writes it into a 0-d tensor on the device (a fill, not a
copy from the host): the form a compiled entry point takes the seed in,
as `jax.jit` traces `base_key` (`render/graphs.py`). Sample indices may
be 0-d tensors too (`salted`).
"""

from __future__ import annotations

import numpy as np
import torch

# Purpose salts — one sub-stream per use site (tracer/core/rng.py).
PIXEL_JITTER = 0
RAY_TIME = 1
SCATTER_DIR = 2
SCATTER_GLASS = 3
SHADOW_LIGHT_POS = 4
SHADOW_BERNOULLI = 5

_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF
# 2^-24 as f32: the top 24 bits of a word scale to [0, 1) exactly
_UNIT = float(np.float32(1.0 / 16777216.0))


def _pcg(x):
    """pcg_output_rxs_m_xs_32_32 on uint32 values held in int64 tensors
    (or in a python int)."""
    x = (x * 747796405 + 2891336453) & _M32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (w >> 22) ^ w


def _salt_word(salt) -> int | torch.Tensor:
    """salt * GOLDEN + 1 in uint32 (salt: python int or int tensor)."""
    return (salt * _GOLDEN + 1) & _M32


def _mix(key, salt):
    """Derive a sub-stream: full-avalanche hash of (key, salt)."""
    if isinstance(salt, torch.Tensor):
        salt = salt.to(torch.int64) & _M32
    else:
        salt = int(salt) & _M32
    return _pcg(key ^ _salt_word(salt))


def seed_word(seed: int) -> int:
    """The uint32 seed word of `jax.random.key(seed)` (see module doc)."""
    return _pcg(int(seed) & _M32)


def seed_tensor(seed: int, device) -> torch.Tensor:
    """`seed_word(seed)` in a 0-d int64 tensor on `device`, written by a
    fill (a launch with the word as its argument; no host sync)."""
    return torch.full((), seed_word(seed), dtype=torch.int64, device=device)


def ray_keys(seed, ray_ids):
    """Per-ray keys: hash the flat ray id with the seed word.

    `seed` is the seed (a python int, hashed here by `seed_word`) or its
    word in a 0-d int64 tensor (`seed_tensor`); the int64 arithmetic is
    the same either way, so are the keys. `ray_ids` is an int tensor [N];
    returns keys [N] (int64, uint32 values).
    """
    word = seed if isinstance(seed, torch.Tensor) else seed_word(seed)
    ids = ray_ids.to(torch.int64) & _M32
    return _pcg(word ^ _salt_word(ids))


def salted(keys, *salts):
    """Derive sub-stream keys from one or more scalar salts (python ints or
    0-d int tensors, such as a compiled frame's sample index)."""
    for s in salts:
        keys = _mix(keys, s)
    return keys


def lane_keys(keys, n: int):
    """Expand keys [...] into [..., n] independent per-lane keys."""
    lanes = torch.arange(n, dtype=torch.int64, device=keys.device)
    return _mix(keys[..., None], lanes + 2)


def _to_unit_float(bits):
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * _UNIT


def uniform(keys, shape_suffix=(), minval=0.0, maxval=1.0):
    """Per-key uniforms: keys [...] -> [..., *shape_suffix] float32.

    Each suffix lane is an independent sub-stream of its key.
    """
    n = 1
    for s in shape_suffix:
        n *= s
    if shape_suffix:
        bits = _pcg(lane_keys(keys, n))
        bits = bits.reshape(tuple(keys.shape) + tuple(shape_suffix))
    else:
        bits = _pcg(_mix(keys, 0))
    u = _to_unit_float(bits)
    if minval != 0.0 or maxval != 1.0:
        u = minval + (maxval - minval) * u
    return u


def lane_uniform(keys, lane: int):
    """Flat lane `lane` of `uniform(keys, (K,))`: key _mix(keys, lane+2)."""
    return _to_unit_float(_pcg(_mix(keys, lane + 2)))


def cube_unit_vector_lane_p(keys, k: int):
    """Lane k of the reference's `random_unit_vector` (Functions.cpp:14-18),
    a normalized uniform cube sample, planar: lane keys _mix(keys, k*3+a+2).
    """
    x, y, z = (-1.0 + 2.0 * lane_uniform(keys, k * 3 + a) for a in range(3))
    n = torch.clamp_min(torch.sqrt(x * x + y * y + z * z), 1e-20)
    return x / n, y / n, z / n


def sphere_unit_vector_lane_p(keys, k: int):
    """Lane k of the uniform-on-sphere sample (compat=physical), planar:
    lane keys _mix(keys, k*2+2) and _mix(keys, k*2+3)."""
    u0 = lane_uniform(keys, k * 2)
    u1 = lane_uniform(keys, k * 2 + 1)
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    # 2*pi rounds to f32 first, as the JAX weak-typed constant does
    phi = float(np.float32(2.0 * np.pi)) * u1
    return r * torch.cos(phi), r * torch.sin(phi), z


def uniform_lane_key_p(keys, k: int):
    """Column k of `lane_keys(keys, K)`: the key _mix(keys, k+2)."""
    return _mix(keys, k + 2)


def uniform_lanes_leading_p(keys, n: int):
    """[n, N] uniforms whose row i equals column i of `uniform(keys, (n,))`
    (rays in the trailing dimension)."""
    lanes = torch.arange(n, dtype=torch.int64, device=keys.device)[:, None]
    return _to_unit_float(_pcg(_mix(keys[None, :], lanes + 2)))


def as_int32_bits(keys):
    """int64 uint32-valued keys -> int32 tensor with the same bit pattern
    (the form the CUDA kernels read as `uint32_t`)."""
    return torch.where(keys >= (1 << 31), keys - (1 << 32), keys).to(
        torch.int32)
