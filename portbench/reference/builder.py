"""Host-side scene construction for the reference (numpy only), frozen
from the port's `scene/builder.py` without its file loaders: the
benchmark's recipes hand every image and mesh in as arrays.

This is the user-facing API for describing scenes, mirroring the reference's
`Scene` builder surface (`src/Scene.h:57-196`): spheres,
quads (`Square::setQuad`, `Square.h:33-63`), OFF meshes with transforms
(`Mesh.h:173-224`), materials (`Material.h:23-60`), point-ish spherical
lights, textures / normal maps, skybox, and the `add_box` composite
(`Scene.h:92-146`). The port's `compile_scene` lowers a
`SceneBuilder` into the SoA `DeviceScene` the kernels consume; here
`portbench/reference/scene.py` does it for the reference.

Transform conventions are the reference's exactly: `rotate_x/y/z` use the
Mat3 forms at `Mesh.h:202-224` (degrees), and transforms move *vertices
only* — a `Square`'s tangent frame (`m_right_vector`/`m_up_vector`, set in
`setQuad`) is deliberately NOT transformed, replicating the stale-tangent
quirk that the reference's normal mapping relies on (`Material.cpp:114-130`
is called with the untransformed members at `Scene.h:284`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# MaterialType (reference: Material.h:11-15)
DIFFUSE = 0
GLASS = 1
MIRROR = 2

# TextureType (reference: Material.h:17-21)
TEX_NONE = 0
TEX_CHECKERBOARD = 1
TEX_IMAGE = 2


@dataclasses.dataclass
class Material:
    """Mirror of the reference Material struct (Material.h:23-49)."""
    diffuse: np.ndarray = None
    specular: np.ndarray = None
    shininess: float = 0.0
    motion_blur_translation: np.ndarray = None
    index_medium: float = 1.0
    transparency: float = 0.0
    mtype: int = DIFFUSE
    texture_type: int = TEX_NONE
    checkerboard_color1: np.ndarray = None
    checkerboard_color2: np.ndarray = None
    texture_scale_x: float = 1.0
    texture_scale_y: float = 1.0
    emissive: bool = False
    light_color: np.ndarray = None
    light_intensity: float = 0.0
    texture_id: int = -1       # index into SceneBuilder.textures
    normal_map_id: int = -1    # index into SceneBuilder.normal_maps

    def __post_init__(self):
        def v3(x, default=0.0):
            if x is None:
                return np.full(3, default, np.float32)
            return np.asarray(x, np.float32) * np.ones(3, np.float32)
        self.diffuse = v3(self.diffuse)
        self.specular = v3(self.specular)
        self.motion_blur_translation = v3(self.motion_blur_translation)
        self.checkerboard_color1 = v3(self.checkerboard_color1)
        self.checkerboard_color2 = v3(self.checkerboard_color2)
        self.light_color = v3(self.light_color)


@dataclasses.dataclass
class Light:
    """Spherical area light (reference: Scene.h:28-42)."""
    pos: np.ndarray = None
    radius: float = 1.0
    color: np.ndarray = None          # Light.material
    power_correction: float = 1.0     # stored but unused in shading (parity)

    def __post_init__(self):
        self.pos = np.asarray(self.pos, np.float32)
        self.color = (np.ones(3, np.float32) if self.color is None
                      else np.asarray(self.color, np.float32))


class _Transformable:
    """Vertex-array transforms matching Mesh.h:173-224 (degrees)."""

    verts: np.ndarray  # [V, 3] float32

    def translate(self, t):
        self.verts = self.verts + np.asarray(t, np.float32)
        return self

    def apply_matrix(self, m):
        self.verts = self.verts @ np.asarray(m, np.float32).T
        return self

    def scale(self, s):
        s = np.asarray(s, np.float32) * np.ones(3, np.float32)
        return self.apply_matrix(np.diag(s))

    def rotate_x(self, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        return self.apply_matrix([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rotate_y(self, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        return self.apply_matrix([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rotate_z(self, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        return self.apply_matrix([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class Sphere:
    def __init__(self, center, radius, material: Optional[Material] = None):
        self.center = np.asarray(center, np.float32)
        self.radius = float(radius)
        self.material = material or Material()


class Square(_Transformable):
    """Quad defined by 4 vertices (v0=bl, v1=bl+R, v2=bl+R+U, v3=bl+U).

    Reference: Square::setQuad (Square.h:33-63). The tangent frame
    (tangent/bitangent = m_right_vector/m_up_vector members) is frozen at
    set_quad time and NOT updated by transforms — quirk parity.
    """

    def __init__(self, bottom_left, right, up, width=1.0, height=1.0,
                 material: Optional[Material] = None):
        self.material = material or Material()
        self.set_quad(bottom_left, right, up, width, height)

    def set_quad(self, bottom_left, right, up, width=1.0, height=1.0):
        bl = np.asarray(bottom_left, np.float32)
        r = np.asarray(right, np.float64)
        u = np.asarray(up, np.float64)
        n = np.cross(r, u)
        n = n / np.linalg.norm(n)
        r = r / np.linalg.norm(r) * width
        u = u / np.linalg.norm(u) * height
        self.tangent = r.astype(np.float32)     # m_right_vector member
        self.bitangent = u.astype(np.float32)   # m_up_vector member
        self.normal_member = n.astype(np.float32)
        self.verts = np.stack([bl, bl + r, bl + r + u, bl + u]).astype(np.float32)
        return self


class MeshObject(_Transformable):
    """Triangle mesh with optional vertex/face colors (Mesh.h:111-124)."""

    def __init__(self, verts=None, tris=None, vert_colors=None,
                 face_colors=None, material: Optional[Material] = None):
        self.verts = (np.zeros((0, 3), np.float32) if verts is None
                      else np.asarray(verts, np.float32))
        self.tris = (np.zeros((0, 3), np.int32) if tris is None
                     else np.asarray(tris, np.int32))
        self.vert_colors = (None if vert_colors is None
                            else np.asarray(vert_colors, np.float32))
        self.face_colors = (None if face_colors is None
                            else np.asarray(face_colors, np.float32))
        self.material = material or Material()

    def center_and_scale_to_unit(self):
        """Reference: Mesh::centerAndScaleToUnit (Mesh.cpp:92-105)."""
        c = self.verts.mean(axis=0)
        d = np.linalg.norm(self.verts - c, axis=1).max()
        self.verts = (self.verts - c) / d
        return self


class SceneBuilder:
    """Accumulates objects; `compile_scene` lowers to a DeviceScene."""

    def __init__(self):
        self.spheres: List[Sphere] = []
        self.squares: List[Square] = []
        self.meshes: List[MeshObject] = []
        self.lights: List[Light] = []
        self.textures: List[Optional[np.ndarray]] = []     # uint8 [H,W,3]
        self.normal_maps: List[Optional[np.ndarray]] = []
        self.skybox: Optional[np.ndarray] = None
        self.dark_sky: bool = True

    # --- assets -----------------------------------------------------------
    def add_texture(self, img: Optional[np.ndarray]) -> int:
        self.textures.append(img)
        return len(self.textures) - 1

    def add_normal_map(self, img: Optional[np.ndarray]) -> int:
        self.normal_maps.append(img)
        return len(self.normal_maps) - 1

    # --- objects ----------------------------------------------------------
    def add_sphere(self, center, radius, material=None) -> Sphere:
        s = Sphere(center, radius, material)
        self.spheres.append(s)
        return s

    def add_square(self, bottom_left=(-1., -1., 0.), right=(1., 0., 0.),
                   up=(0., 1., 0.), width=1.0, height=1.0,
                   material=None) -> Square:
        s = Square(bottom_left, right, up, width, height, material)
        self.squares.append(s)
        return s

    def add_mesh(self, mesh: MeshObject) -> MeshObject:
        self.meshes.append(mesh)
        return mesh

    def add_light(self, pos, radius=1.0, color=None,
                  power_correction=1.0) -> Light:
        l = Light(pos, radius, color, power_correction)
        self.lights.append(l)
        return l

    def add_box(self, materials: List[Material], faces, pos, size=1.0):
        """Reference: Scene::addBox (Scene.h:92-146). `faces` is 6 bools
        (bottom, top, front, back, left, right). The reference's
        `facing_out` flag only flips the GL-draw normal member, not the
        traced normal (Square::intersect recomputes it, Square.h:68-72),
        so it is irrelevant here.
        """
        half = size / 2.0
        bl = np.array([-half, -half, -half], np.float32)
        rv = np.array([size, 0., 0.], np.float32)
        uv = np.array([0., 0., size], np.float32)
        made = []
        rots = [None, ("x", 180.), ("x", 90.), ("x", -90.),
                [("x", 90.), ("y", 90.)], [("x", 90.), ("y", -90.)]]
        for i in range(6):
            if not faces[i]:
                continue
            sq = Square(bl, rv, uv, 1.0, 1.0)
            r = rots[i]
            if r is not None:
                steps = r if isinstance(r, list) else [r]
                for axis, deg in steps:
                    getattr(sq, f"rotate_{axis}")(deg)
            made.append(sq)
        for i, sq in enumerate(made):
            sq.translate(pos)
            sq.material = materials[i]
            self.squares.append(sq)
        return made
