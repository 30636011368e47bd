"""Frozen for the benchmark's reference from the port's `render/shading.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Branchless texturing, emission, normal mapping and skybox (the port of
`tracer/render/shading.py`). Planar: colors are (r, g, b) tuples of [N]
tensors.

The general bounce (`render/integrator.py::_gather_hit_p`) takes its
texels from the exact [P, 3] atlases (`atlas_fetch_rows_p`,
`tex_image_fetch_p`) or from the packed-u32 twins (`packed_fetch`,
`packed_fetch2`, `paired_fetch`: the decoders only; the record-replay
backward takes its texels from the record, so the fetches need no
gradient of their own). For an atlas made from u8 images both give the
same bits: byte -> f32 times the same f32(1/255).

Two spellings of the C++ truncations appear, as in the JAX package: the
general path's `cpp_trunc_mod2` and `_texel_xy` (fmod and trunc, the
reference's semantics for any sign), and the kernels' `trunc_mod2` and
`texel_xy` (floor forms, identical for the non-negative arguments the
kernels see).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import vec3p as vp

TEX_NONE = 0
TEX_CHECKERBOARD = 1
TEX_IMAGE = 2

PACK_BLOCK = 16  # texels per packed-atlas row (scene/device.py)
_INV255 = float(np.float32(1.0 / 255.0))
# 1/(2 pi) and 1/pi as f32: XLA turns the JAX package's division by the
# constants 2*pi and pi into a multiply by their f32 reciprocals in jitted
# code, and the kernels do the same
INV_2PI = float(np.float32(1.0) / np.float32(2.0 * np.pi))
INV_PI = float(np.float32(1.0) / np.float32(np.pi))
PI = float(np.float32(np.pi))
# the clip of -n_y in the sphere's theta, as f32 (Sphere.h:130 guard)
ACOS_LO = float(np.float32(-1.0 + 1e-7))
ACOS_HI = float(np.float32(1.0 - 1e-7))


def trunc_mod2(x):
    """C++ `(int)(x) % 2` for x >= 0 (the kernels' call sites): floor(x)
    mod 2 in exact float arithmetic (kernels/shade.py `_trunc_mod2`)."""
    t = torch.floor(x)
    return t - 2.0 * torch.floor(t * 0.5)


def cpp_trunc_mod2(x):
    """C++ `(int)(x) % 2` for any sign: fmod(trunc(x), 2)
    (mathutils.trunc_mod2)."""
    return torch.fmod(torch.trunc(x), 2.0)


def decode_word(v):
    """Packed-u32 texel word 0xRRGGBB -> planar rgb, byte * f32(1/255)."""
    return (((v >> 16) & 0xFF).to(torch.float32) * _INV255,
            ((v >> 8) & 0xFF).to(torch.float32) * _INV255,
            (v & 0xFF).to(torch.float32) * _INV255)


def magenta_checker_p(u, v):
    """Missing-image fallback (Material.cpp:74-81): 8x8 black/magenta,
    floor form (the kernels')."""
    same = trunc_mod2(u * 8.0) == trunc_mod2(v * 8.0)
    on = torch.where(same, 0.0, 1.0)
    return on, torch.zeros_like(on), on


def _magenta_checker_p(u, v):
    """Missing-image fallback (Material.cpp:74-81), C truncation (the
    general path's)."""
    same = cpp_trunc_mod2(u * 8.0) == cpp_trunc_mod2(v * 8.0)
    on = torch.where(same, 0.0, 1.0)
    return on, torch.zeros_like(on), on


def texel_xy(wf, hf, u, v, sx, sy):
    """Image-relative nearest texel (x, y) as int32 (Material.cpp:82-88):
    u' = frac(u*sx), v' = 1 - frac(v*sy), x = int(u'*(w-1)), y likewise.
    wf/hf are the image dims as f32. The floor form is the first-hit
    kernel's `_staircase` (tracer/kernels/intersect.py); `_texel_xy`
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


def _clip_xy(x, y, W, H):
    x = torch.minimum(torch.clamp_min(x, 0), torch.clamp_min(W - 1, 0))
    y = torch.minimum(torch.clamp_min(y, 0), torch.clamp_min(H - 1, 0))
    return x, y


def _texel_xy(W, H, u, v, sx, sy):
    """Image-relative nearest texel (x, y) (Material.cpp:82-88) with C
    fmod/trunc; W, H int32 per lane (W = 0 gives (0, 0))."""
    uu = torch.fmod(u * sx, 1.0)
    vv = 1.0 - torch.fmod(v * sy, 1.0)
    x = torch.trunc(uu * (W - 1).to(torch.float32)).to(torch.int32)
    y = torch.trunc(vv * (H - 1).to(torch.float32)).to(torch.int32)
    return _clip_xy(x, y, W, H)


def _texel_index(P, off_r, W, H, u, v, sx, sy):
    """Nearest-texel flat index (Material.cpp:82-88), clipped to an atlas
    of P texels, and the present mask (W > 0 and H > 0)."""
    present = (W > 0) & (H > 0)
    x, y = _texel_xy(W, H, u, v, sx, sy)
    idx = torch.clamp(off_r + y * W + x, 0, P - 1)
    return idx, present


def _atlas_fetch_p(data, off, w, h, slot, u, v, scale_x, scale_y):
    """Nearest-texel fetch by image slot: ((r, g, b) [N], present [N])."""
    sl = slot.long()
    W, H = w[sl], h[sl]
    idx, present = _texel_index(data.shape[0], off[sl], W, H, u, v,
                                scale_x, scale_y)
    return vp.splat(data[idx.long()]), present


def atlas_fetch_rows_p(data, off_r, W, H, u, v, sx, sy, pack=None):
    """`_atlas_fetch_p` with the per-lane (offset, W, H) already gathered.
    With `pack` (the atlas's packed-u32 twin) one packed-word decode, else
    one exact `data[idx]` row gather; the same bits for a u8 atlas."""
    idx, present = _texel_index(data.shape[0], off_r, W, H, u, v, sx, sy)
    if pack is not None:
        return packed_fetch(pack, idx), present
    return vp.splat(data[idx.long()]), present


def packed_fetch(pack, idx):
    """Texel `idx` of a packed-u32 atlas [R, 16] i32: one word, decoded
    (shading._packed_decode)."""
    return decode_word(pack.reshape(-1)[idx.long()])


def packed_fetch2(pack_t, pack_n, idx_t, idx_n):
    """The texture and normal-map texels of a bounce from their packed
    twins (shading._packed_decode2): two words, decoded."""
    return packed_fetch(pack_t, idx_t), packed_fetch(pack_n, idx_n)


def paired_fetch(pair_pack, row_idx, sub):
    """The texture and normal-map texels of a bounce from the pair-packed
    atlas [Rp, 32] i32 (shading._paired_decode): one row, two words."""
    r = row_idx.long()
    s = sub.long()
    return (decode_word(pair_pack[r, s]),
            decode_word(pair_pack[r, PACK_BLOCK + s]))


def tex_image_fetch_p(scene, mid, u, v):
    """The bounce's one texture-atlas fetch, shared by diffuse texturing and
    emission; present = False (the magenta fallback) when the scene has no
    image texture."""
    if scene.tex_data.shape[0] <= 1:
        z = torch.zeros_like(u)
        return (z, z, z), torch.zeros_like(u, dtype=torch.bool)
    m = mid.long()
    return _atlas_fetch_p(scene.tex_data, scene.tex_off, scene.tex_w,
                          scene.tex_h, scene.mat_tex[m], u, v,
                          scene.mat_texscale[:, 0][m],
                          scene.mat_texscale[:, 1][m])


def texture_color_p(scene, mid, u, v, base, fetched=None):
    """Planar Material::texture (Material.cpp:63-92): `base` when TEX_NONE,
    the checker or the image texel (magenta when absent) otherwise."""
    m = mid.long()
    textype = scene.mat_textype[m]
    sx = scene.mat_texscale[:, 0][m]
    sy = scene.mat_texscale[:, 1][m]
    same = cpp_trunc_mod2(u * sx) == cpp_trunc_mod2(v * sy)
    checker = vp.where(same, vp.splat(scene.mat_check1[m]),
                       vp.splat(scene.mat_check2[m]))
    img, present = (fetched if fetched is not None
                    else tex_image_fetch_p(scene, mid, u, v))
    img = vp.where(present, img, _magenta_checker_p(u, v))
    out = vp.where(textype == TEX_CHECKERBOARD, checker, base)
    return vp.where(textype == TEX_IMAGE, img, out)


def emission_color_p(scene, mid, u, v, fetched=None):
    """Planar Material::emit (Material.cpp:13-24)."""
    m = mid.long()
    textype = scene.mat_textype[m]
    lc = vp.splat(scene.mat_light_color[m])
    tex = texture_color_p(scene, mid, u, v, lc, fetched)
    col = vp.where(textype == TEX_NONE, lc, tex)
    k = scene.mat_light_intensity[m] * scene.mat_emissive[m]
    return vp.scale(k, col)


def perturb_normal_p(scene, mid, u, v, tangent, bitangent, normal):
    """Planar Material::get_normal (Material.cpp:114-130): the tangent-space
    normal map in the quad's stored frame; a no-op without normal maps."""
    if scene.nm_data.shape[0] <= 1:
        return normal
    m = mid.long()
    slot = scene.mat_nm[m]
    raw, present = _atlas_fetch_p(scene.nm_data, scene.nm_off, scene.nm_w,
                                  scene.nm_h, slot, u, v,
                                  scene.mat_texscale[:, 0][m],
                                  scene.mat_texscale[:, 1][m])
    nm = tuple(2.0 * c - 1.0 for c in raw)
    n2 = vp.normalize(tuple(
        nm[0] * tangent[i] + nm[1] * bitangent[i] + nm[2] * normal[i]
        for i in range(3)))
    return vp.where(present & (slot > 0), n2, normal)


def sky_texel_index(d, sky_w: int, sky_h: int, n_texels: int):
    """The equirect texel of each direction (Scene.h:155-159): u = 0.5 +
    atan2(d_z, d_x)/(2 pi), v = 0.5 - asin(clip(d_y, -1, 1))/pi,
    x = int(u*W), y = int(v*H), each clipped, idx = y*W + x clipped to
    the image. The shade kernel's `sky_index` computes the same."""
    u = 0.5 + torch.atan2(d[2], d[0]) * INV_2PI
    v = 0.5 - torch.asin(torch.clamp(d[1], -1.0, 1.0)) * INV_PI
    x = torch.clamp((u * float(sky_w)).to(torch.int32), 0, sky_w - 1)
    y = torch.clamp((v * float(sky_h)).to(torch.int32), 0, sky_h - 1)
    return torch.clamp(y * sky_w + x, 0, n_texels - 1)


def skybox_color_p(scene, d, n_remaining: int, compat_reference: bool,
                   packed: bool = False, sky_wh=None):
    """Scene::skyboxTexture (Scene.h:149-161).

    Image: the equirect texel (`sky_texel_index`), from the packed twin
    when `packed`, else from `sky_data` (the same bits), scaled by
    NRemainingBounces under compat=reference (quirk: not +1).
    No image: black if dark_sky, else a white->blue gradient whose blue
    term is scaled by (NRemainingBounces+1) under compat=reference
    (quirk: the *(N+1) binds to the blue constant only, Scene.h:153).
    `sky_wh`: the image's (W, H) as host ints, if the caller has them
    (else they are read from the scene's tensors)."""
    if scene.has_sky_image:
        if sky_wh is None:
            sky_wh = int(scene.sky_w), int(scene.sky_h)
        idx = sky_texel_index(d, sky_wh[0], sky_wh[1],
                              scene.sky_data.shape[0])
        if packed and scene.sky_pack.shape[0] > 1:
            col = packed_fetch(scene.sky_pack, idx)
        else:
            col = vp.splat(scene.sky_data[idx.long()])
        if compat_reference:
            col = vp.scale(float(n_remaining), col)
        return col
    a = 0.5 * (d[1] + 1.0)
    scale = float(n_remaining) + 1.0 if compat_reference else 1.0
    w = 1.0 - a
    k = 1.0 - scene.dark_sky
    return (k * (w + a * 0.5 * scale), k * (w + a * 0.7 * scale),
            k * (w + a * 1.0 * scale))
