"""The reference's scene compiler: SceneBuilder -> DeviceScene (SoA torch
tensors), frozen from the port's `scene/device.py` without the packed-u32
and pair-packed atlases (the reference reads the exact [P, 3] atlases
only) and with the numpy median-split BVH builder: one flat SoA table per primitive
class plus a material table indexed by a per-primitive material id, so
shading is branchless gathers and selects. Textures live in flat atlases
with per-texture (offset, w, h). The pair-atlas columns of the material
table are zero (no pair atlas).

Meshes become one triangle soup (with a shared vertex table and per-corner
colors) and one flattened BVH per mesh, concatenated with node and
triangle offsets; `mesh_root` / `mesh_end` give each mesh's node range.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from portbench.reference.bvh import (TRIANGLE_SCALING, build_bvh,
                                    triangle_bounds)
from portbench.reference import builder as B

_META = ("mesh_root", "mesh_end", "leaf_width", "has_sky_image",
         "emissive_tex_image", "sphere_uv_needed", "n_sph_real",
         "n_quad_real")


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    # --- spheres (padded to multiple of 8) -------------------------------
    sph_center: torch.Tensor      # [S, 3]
    sph_radius: torch.Tensor      # [S]
    sph_mat: torch.Tensor         # [S] i32
    sph_valid: torch.Tensor       # [S] f32 (1 real, 0 pad)

    # --- quads -----------------------------------------------------------
    quad_v0: torch.Tensor         # [Q, 3] transformed vertex 0 (bottom-left)
    quad_er: torch.Tensor         # [Q, 3] v1 - v0
    quad_eu: torch.Tensor         # [Q, 3] v3 - v0
    quad_normal: torch.Tensor     # [Q, 3] normalize(cross(er, eu))
    quad_tan: torch.Tensor        # [Q, 3] setQuad m_right_vector (stale frame)
    quad_bitan: torch.Tensor      # [Q, 3] setQuad m_up_vector
    quad_mat: torch.Tensor        # [Q] i32
    quad_valid: torch.Tensor      # [Q] f32

    # --- triangle soup (+ a degenerate sentinel row, index T) ------------
    tri_a: torch.Tensor           # [T, 3]
    tri_b: torch.Tensor           # [T, 3]
    tri_c: torch.Tensor           # [T, 3]
    mesh_verts: torch.Tensor      # [V, 3]
    tri_va: torch.Tensor          # [T] i32
    tri_vb: torch.Tensor          # [T] i32
    tri_vc: torch.Tensor          # [T] i32
    tri_mesh: torch.Tensor        # [T] i32
    tri_col_a: torch.Tensor       # [T, 3]
    tri_col_b: torch.Tensor       # [T, 3]
    tri_col_c: torch.Tensor       # [T, 3]
    tri_has_col: torch.Tensor     # [T] f32
    mesh_mat: torch.Tensor        # [Nm] i32

    # --- flattened BVHs --------------------------------------------------
    bvh_lo: torch.Tensor          # [Bn, 3]
    bvh_hi: torch.Tensor          # [Bn, 3]
    bvh_leaf_start: torch.Tensor  # [Bn] i32
    bvh_skip: torch.Tensor        # [Bn] i32
    bvh_leaf_tris: torch.Tensor   # [NL * LW] i32

    # --- material table --------------------------------------------------
    mat_diffuse: torch.Tensor     # [M, 3]
    mat_specular: torch.Tensor    # [M, 3]
    mat_shininess: torch.Tensor   # [M]
    mat_mb: torch.Tensor          # [M, 3] motion_blur_translation
    mat_ior: torch.Tensor         # [M]
    mat_transparency: torch.Tensor  # [M]
    mat_type: torch.Tensor        # [M] i32 (0 diffuse, 1 glass, 2 mirror)
    mat_textype: torch.Tensor     # [M] i32 (0 none, 1 checker, 2 image)
    mat_check1: torch.Tensor      # [M, 3]
    mat_check2: torch.Tensor      # [M, 3]
    mat_texscale: torch.Tensor    # [M, 2] (x, y)
    mat_emissive: torch.Tensor    # [M] f32
    mat_light_color: torch.Tensor  # [M, 3]
    mat_light_intensity: torch.Tensor  # [M]
    mat_tex: torch.Tensor         # [M] i32 texture slot (0 reserved = none)
    mat_nm: torch.Tensor          # [M] i32 normal-map slot (0 = none)

    # --- texture atlas (slot 0 is a 0x0 "missing" entry) -----------------
    tex_data: torch.Tensor        # [P, 3] f32 in [0,1]
    tex_off: torch.Tensor         # [K] i32
    tex_w: torch.Tensor           # [K] i32
    tex_h: torch.Tensor           # [K] i32
    nm_data: torch.Tensor         # [Pn, 3] f32 raw (decode at sample time)
    nm_off: torch.Tensor
    nm_w: torch.Tensor
    nm_h: torch.Tensor
    mat_pair_off: torch.Tensor    # [M] i32 pair-region row offset
    mat_pair_wa: torch.Tensor     # [M] i32 primary index-space width
    mat_pair_ha: torch.Tensor     # [M] i32 primary index-space height
    mat_pair_wb: torch.Tensor     # [M] i32 product-region 2nd width (0=plain)
    mat_pair_hb: torch.Tensor     # [M] i32 product-region 2nd height
    mat_pair_tex: torch.Tensor    # [M] i32 1 = cols 0:16 hold real texels
    mat_pair_nm: torch.Tensor     # [M] i32 1 = cols 16:32 hold real texels

    # --- lights ----------------------------------------------------------
    light_pos: torch.Tensor       # [L, 3]
    light_radius: torch.Tensor    # [L]
    light_color: torch.Tensor     # [L, 3]

    # --- skybox ----------------------------------------------------------
    sky_data: torch.Tensor        # [Ps, 3] f32 (size 1 when absent)
    sky_w: torch.Tensor           # i32 scalar (0 when absent)
    sky_h: torch.Tensor           # i32 scalar
    dark_sky: torch.Tensor        # f32 scalar (1 => black fallback sky)

    # --- static metadata -------------------------------------------------
    mesh_root: Tuple[int, ...] = ()
    mesh_end: Tuple[int, ...] = ()
    leaf_width: int = 4
    has_sky_image: bool = False
    emissive_tex_image: bool = True   # some emissive material is TEX_IMAGE
    n_sph_real: int = 0   # real (non-padding) sphere rows
    n_quad_real: int = 0  # real (non-padding) quad rows
    sphere_uv_needed: bool = False    # some sphere material has a textype

    @property
    def device(self) -> torch.device:
        return self.sph_center.device


def _to_tensor(a, device) -> torch.Tensor:
    """numpy -> torch with the JAX package's dtypes (x64 off: f64 -> f32,
    i64 -> i32)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def device_scene_from_numpy(fields: dict, meta: dict,
                            device="cuda") -> DeviceScene:
    """A DeviceScene on `device` from numpy fields and static metadata."""
    data = {k: _to_tensor(v, device) for k, v in fields.items()
            if k not in _META}
    return DeviceScene(**data, **{k: meta[k] for k in _META if k in meta})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def _atlas(images):
    """Concatenate images (uint8 [H,W,3] or None) into a flat [P, 3] f32
    atlas in [0, 1] with per-slot (offset, w, h). Slot 0 is always the
    'missing' entry (w=h=0). Bytes become f32 by a multiply with
    f32(1/255), the port's decode."""
    data = [np.zeros((1, 3), np.uint8)]
    off, ws, hs = [0], [0], [0]
    cursor = 1
    for img in images:
        if img is None:
            off.append(0)
            ws.append(0)
            hs.append(0)
            continue
        h, w = img.shape[:2]
        data.append(img.reshape(-1, 3).astype(np.uint8))
        off.append(cursor)
        ws.append(w)
        hs.append(h)
        cursor += h * w
    rows_u8 = np.concatenate(data, axis=0)
    return (rows_u8.astype(np.float32) * np.float32(1.0 / 255.0),
            np.asarray(off, np.int32), np.asarray(ws, np.int32),
            np.asarray(hs, np.int32))


def _meshes(sb: B.SceneBuilder, mat_id, leaf_width: int, bvh_max_depth: int):
    """The triangle soup, the shared vertex table and every mesh's BVH,
    flattened and offset to global ids (`tracer/scene/device.py:488-588`).
    Materials are numbered after the spheres' and quads', as in JAX."""
    tri_a_l, tri_b_l, tri_c_l = [], [], []
    verts_l, tri_va_l, tri_vb_l, tri_vc_l = [], [], [], []
    tri_mesh_l, tca, tcb, tcc, thc = [], [], [], [], []
    mesh_mat_l, mesh_root_l, mesh_end_l = [], [], []
    bvh_lo_l, bvh_hi_l, bvh_ls_l, bvh_skip_l, leaf_tris_l = [], [], [], [], []
    vert_cursor = tri_cursor = node_cursor = leaf_cursor = 0
    for mi, m in enumerate(sb.meshes):
        mesh_mat_l.append(mat_id(m.material))
        v = m.verts * TRIANGLE_SCALING  # KDTree.cpp:38-40 leaf-test scaling
        t = m.tris
        tri_a_l.append(v[t[:, 0]])
        tri_b_l.append(v[t[:, 1]])
        tri_c_l.append(v[t[:, 2]])
        verts_l.append(v.astype(np.float32))
        for lst, c in ((tri_va_l, 0), (tri_vb_l, 1), (tri_vc_l, 2)):
            lst.append(t[:, c].astype(np.int32) + vert_cursor)
        vert_cursor += v.shape[0]
        tri_mesh_l.append(np.full(t.shape[0], mi, np.int32))
        if m.vert_colors is not None:
            cols = [m.vert_colors[t[:, c]] for c in range(3)]
        elif m.face_colors is not None:
            cols = [m.face_colors] * 3
        else:
            cols = [np.zeros((t.shape[0], 3), np.float32)] * 3
        for lst, col in zip((tca, tcb, tcc), cols):
            lst.append(col)
        has = m.vert_colors is not None or m.face_colors is not None
        thc.append(np.full(t.shape[0], 1.0 if has else 0.0, np.float32))

        lo, hi = triangle_bounds(m.verts, t)
        bvh = build_bvh(lo, hi, leaf_width, bvh_max_depth, sentinel=-1)
        lt = bvh.leaf_tris.copy()           # mesh-local ids -> global
        lt[lt >= 0] += tri_cursor
        ls = bvh.node_leaf_start.copy()
        ls[ls >= 0] += leaf_cursor
        bvh_lo_l.append(bvh.node_lo)
        bvh_hi_l.append(bvh.node_hi)
        bvh_ls_l.append(ls)
        bvh_skip_l.append(bvh.node_skip + node_cursor)
        leaf_tris_l.append(lt)
        mesh_root_l.append(node_cursor)
        node_cursor += bvh.n_nodes
        mesh_end_l.append(node_cursor)
        leaf_cursor += lt.shape[0]
        tri_cursor += t.shape[0]

    def cat3(lst):  # + the sentinel row (degenerate, never hits)
        return np.concatenate(lst + [np.zeros((1, 3), np.float32)],
                              axis=0).astype(np.float32)

    tri_a = cat3(tri_a_l)
    mesh_verts = cat3(verts_l)
    sent = np.full(1, mesh_verts.shape[0] - 1, np.int32)
    T = tri_a.shape[0] - 1
    leaf_tris = (np.concatenate(leaf_tris_l) if leaf_tris_l
                 else np.zeros(0, np.int32))
    out = dict(
        tri_a=tri_a, tri_b=cat3(tri_b_l), tri_c=cat3(tri_c_l),
        mesh_verts=mesh_verts,
        tri_va=np.concatenate(tri_va_l + [sent]).astype(np.int32),
        tri_vb=np.concatenate(tri_vb_l + [sent]).astype(np.int32),
        tri_vc=np.concatenate(tri_vc_l + [sent]).astype(np.int32),
        tri_mesh=np.concatenate(tri_mesh_l + [np.zeros(1, np.int32)]),
        tri_col_a=cat3(tca), tri_col_b=cat3(tcb), tri_col_c=cat3(tcc),
        tri_has_col=np.concatenate(thc + [np.zeros(1, np.float32)]),
        mesh_mat=np.asarray(mesh_mat_l, np.int32).reshape(-1),
        bvh_leaf_tris=np.where(leaf_tris < 0, T, leaf_tris).astype(np.int32))
    if sb.meshes:
        out.update(bvh_lo=np.concatenate(bvh_lo_l, axis=0),
                   bvh_hi=np.concatenate(bvh_hi_l, axis=0),
                   bvh_leaf_start=np.concatenate(bvh_ls_l),
                   bvh_skip=np.concatenate(bvh_skip_l))
    else:
        out.update(bvh_lo=np.zeros((0, 3), np.float32),
                   bvh_hi=np.zeros((0, 3), np.float32),
                   bvh_leaf_start=np.zeros(0, np.int32),
                   bvh_skip=np.zeros(0, np.int32))
    meta = dict(mesh_root=tuple(int(x) for x in mesh_root_l),
                mesh_end=tuple(int(x) for x in mesh_end_l))
    return out, meta


def compile_scene(sb: B.SceneBuilder, device, leaf_width: int = 16,
                  bvh_max_depth: int = 64, pad: int = 8) -> DeviceScene:
    """Lower a SceneBuilder to a DeviceScene on `device`."""
    mats: list[B.Material] = []

    def mat_id(m: B.Material) -> int:
        mats.append(m)
        return len(mats) - 1

    # ---- spheres --------------------------------------------------------
    S = len(sb.spheres)
    Sp = max(_round_up(S, pad), pad)
    sph_center = np.zeros((Sp, 3), np.float32)
    sph_radius = np.zeros(Sp, np.float32)
    sph_mat = np.zeros(Sp, np.int32)
    sph_valid = np.zeros(Sp, np.float32)
    for i, s in enumerate(sb.spheres):
        sph_center[i] = s.center
        sph_radius[i] = s.radius
        sph_mat[i] = mat_id(s.material)
        sph_valid[i] = 1.0

    # ---- quads ----------------------------------------------------------
    Q = len(sb.squares)
    Qp = max(_round_up(Q, pad), pad)
    quad_v0 = np.zeros((Qp, 3), np.float32)
    quad_er = np.zeros((Qp, 3), np.float32)
    quad_eu = np.zeros((Qp, 3), np.float32)
    quad_normal = np.zeros((Qp, 3), np.float32)
    quad_tan = np.zeros((Qp, 3), np.float32)
    quad_bitan = np.zeros((Qp, 3), np.float32)
    quad_mat = np.zeros(Qp, np.int32)
    quad_valid = np.zeros(Qp, np.float32)
    quad_er[:, 0] = 1.0  # avoid zero-length pads
    quad_eu[:, 1] = 1.0
    quad_normal[:, 2] = 1.0
    for i, q in enumerate(sb.squares):
        v = q.verts
        er, eu = v[1] - v[0], v[3] - v[0]
        n = np.cross(er.astype(np.float64), eu.astype(np.float64))
        n = n / max(np.linalg.norm(n), 1e-30)
        quad_v0[i], quad_er[i], quad_eu[i] = v[0], er, eu
        quad_normal[i] = n
        quad_tan[i], quad_bitan[i] = q.tangent, q.bitangent
        quad_mat[i] = mat_id(q.material)
        quad_valid[i] = 1.0

    # ---- meshes / triangle soup ----------------------------------------
    mesh_fields, mesh_meta = _meshes(sb, mat_id, leaf_width, bvh_max_depth)

    # ---- material table -------------------------------------------------
    if not mats:
        mats = [B.Material()]
    mat_diffuse = np.stack([m.diffuse for m in mats])
    mat_specular = np.stack([m.specular for m in mats])
    mat_shininess = np.asarray([m.shininess for m in mats], np.float32)
    mat_mb = np.stack([m.motion_blur_translation for m in mats])
    mat_ior = np.asarray([m.index_medium for m in mats], np.float32)
    mat_transp = np.asarray([m.transparency for m in mats], np.float32)
    mat_type = np.asarray([m.mtype for m in mats], np.int32)
    mat_textype = np.asarray([m.texture_type for m in mats], np.int32)
    mat_check1 = np.stack([m.checkerboard_color1 for m in mats])
    mat_check2 = np.stack([m.checkerboard_color2 for m in mats])
    mat_texscale = np.asarray(
        [[m.texture_scale_x, m.texture_scale_y] for m in mats], np.float32)
    mat_emissive = np.asarray([float(m.emissive) for m in mats], np.float32)
    mat_light_color = np.stack([m.light_color for m in mats])
    mat_light_int = np.asarray([m.light_intensity for m in mats], np.float32)
    mat_tex = np.asarray([m.texture_id + 1 for m in mats], np.int32)
    mat_nm = np.asarray([m.normal_map_id + 1 for m in mats], np.int32)

    tex_data, tex_off, tex_w, tex_h = _atlas(sb.textures)
    nm_data, nm_off, nm_w, nm_h = _atlas(sb.normal_maps)
    zm = np.zeros(len(mats), np.int32)   # no pair atlas

    # ---- lights ---------------------------------------------------------
    L = len(sb.lights)
    light_pos = (np.stack([l.pos for l in sb.lights])
                 if L else np.zeros((0, 3), np.float32))
    light_radius = np.asarray([l.radius for l in sb.lights], np.float32)
    light_color = (np.stack([l.color for l in sb.lights])
                   if L else np.zeros((0, 3), np.float32))

    # ---- skybox ---------------------------------------------------------
    if sb.skybox is not None:
        sh, sw = sb.skybox.shape[:2]
        sky_u8 = sb.skybox.reshape(-1, 3).astype(np.uint8)
        sky_data = sky_u8.astype(np.float32) * np.float32(1.0 / 255.0)
    else:
        sh = sw = 0
        sky_data = np.zeros((1, 3), np.float32)

    fields = dict(
        sph_center=sph_center, sph_radius=sph_radius, sph_mat=sph_mat,
        sph_valid=sph_valid,
        quad_v0=quad_v0, quad_er=quad_er, quad_eu=quad_eu,
        quad_normal=quad_normal, quad_tan=quad_tan, quad_bitan=quad_bitan,
        quad_mat=quad_mat, quad_valid=quad_valid,
        **mesh_fields,
        mat_diffuse=mat_diffuse, mat_specular=mat_specular,
        mat_shininess=mat_shininess, mat_mb=mat_mb, mat_ior=mat_ior,
        mat_transparency=mat_transp, mat_type=mat_type,
        mat_textype=mat_textype, mat_check1=mat_check1,
        mat_check2=mat_check2, mat_texscale=mat_texscale,
        mat_emissive=mat_emissive, mat_light_color=mat_light_color,
        mat_light_intensity=mat_light_int, mat_tex=mat_tex, mat_nm=mat_nm,
        tex_data=tex_data, tex_off=tex_off, tex_w=tex_w, tex_h=tex_h,
        nm_data=nm_data, nm_off=nm_off, nm_w=nm_w, nm_h=nm_h,
        mat_pair_off=zm, mat_pair_wa=zm, mat_pair_ha=zm, mat_pair_wb=zm,
        mat_pair_hb=zm, mat_pair_tex=zm, mat_pair_nm=zm,
        light_pos=light_pos, light_radius=light_radius,
        light_color=light_color,
        sky_data=sky_data, sky_w=np.int32(sw), sky_h=np.int32(sh),
        dark_sky=np.float32(1.0 if sb.dark_sky else 0.0))
    meta = dict(
        **mesh_meta, leaf_width=leaf_width,
        has_sky_image=sb.skybox is not None,
        emissive_tex_image=bool(
            np.any((mat_emissive > 0) & (mat_textype == 2))),
        sphere_uv_needed=bool(
            np.any((sph_valid > 0) & (mat_textype[sph_mat] != 0))),
        n_sph_real=S, n_quad_real=Q)
    return device_scene_from_numpy(fields, meta, device)
