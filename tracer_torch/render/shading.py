"""Branchless texturing, emission and skybox helpers (the port of the parts
of `tracer/render/shading.py` and `tracer/kernels/shade.py` that the
forward slice uses). Planar: colors are (r, g, b) tuples of [N] tensors.
"""

from __future__ import annotations

import numpy as np
import torch

TEX_NONE = 0
TEX_CHECKERBOARD = 1
TEX_IMAGE = 2

PACK_BLOCK = 16  # texels per packed-atlas row (scene/device.py)
_INV255 = float(np.float32(1.0 / 255.0))


def trunc_mod2(x):
    """C++ `(int)(x) % 2` for x >= 0 (every call site): floor(x) mod 2 in
    exact float arithmetic (kernels/shade.py `_trunc_mod2`)."""
    t = torch.floor(x)
    return t - 2.0 * torch.floor(t * 0.5)


def decode_word(v):
    """Packed-u32 texel word 0xRRGGBB -> planar rgb, byte * f32(1/255)."""
    return (((v >> 16) & 0xFF).to(torch.float32) * _INV255,
            ((v >> 8) & 0xFF).to(torch.float32) * _INV255,
            (v & 0xFF).to(torch.float32) * _INV255)


def magenta_checker_p(u, v):
    """Missing-image fallback (Material.cpp:74-81): 8x8 black/magenta."""
    same = trunc_mod2(u * 8.0) == trunc_mod2(v * 8.0)
    on = torch.where(same, 0.0, 1.0)
    return on, torch.zeros_like(on), on


def texel_xy(wf, hf, u, v, sx, sy):
    """Image-relative nearest texel (x, y) as int32 (Material.cpp:82-88):
    u' = frac(u*sx), v' = 1 - frac(v*sy), x = int(u'*(w-1)), y likewise.
    wf/hf are the image dims as f32. The floor form is the first-hit
    kernel's `_staircase` (tracer/kernels/intersect.py); shading._texel_xy
    spells it with fmod/trunc, identical for u*sx >= 0."""
    xs = u * sx
    uu = xs - torch.floor(xs)
    ys = v * sy
    vv = 1.0 - (ys - torch.floor(ys))
    x = torch.floor(uu * (wf - 1.0)).to(torch.int32)
    y = torch.floor(vv * (hf - 1.0)).to(torch.int32)
    wi = wf.to(torch.int32)
    hi = hf.to(torch.int32)
    x = torch.minimum(torch.clamp_min(x, 0), torch.clamp_min(wi - 1, 0))
    y = torch.minimum(torch.clamp_min(y, 0), torch.clamp_min(hi - 1, 0))
    return x, y


def skybox_color_p(scene, d, n_remaining: int, compat_reference: bool):
    """Procedural Scene::skyboxTexture (Scene.h:149-161): black if dark_sky,
    else a white->blue gradient whose blue term is scaled by
    (NRemainingBounces+1) under compat=reference (quirk)."""
    if scene.has_sky_image:
        raise NotImplementedError(
            "image skyboxes are not ported yet (ROADMAP.md Queue A, "
            "'Sky image, sphere UV and exact atlas')")
    a = 0.5 * (d[1] + 1.0)
    scale = float(n_remaining) + 1.0 if compat_reference else 1.0
    w = 1.0 - a
    k = 1.0 - scene.dark_sky
    return (k * (w + a * 0.5 * scale), k * (w + a * 0.7 * scale),
            k * (w + a * 1.0 * scale))
