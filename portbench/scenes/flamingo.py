"""The reference app's flamingo scene (`src/Scene.h:1000-1078`, the port's
`scenes/zoo.py::setup_flamingo`): two lights, a checker floor, a glass and
a mirror sphere, and in place of `mesh/flamingo_lowpoly_colored.off`
(absent) a procedural mesh of the config's triangle count at the
flamingo's place, with seeded smooth vertex colors (the port's
`testing.py::standin_mesh`, frozen)."""

from __future__ import annotations

import numpy as np


def standin_mesh(n_tris: int, seed: int):
    """A torus about the x axis, nu rings of 2*nu quads (2 * 2*nu^2
    triangles) whose minor radius is displaced by seeded low-frequency
    waves, with seeded smooth vertex colors: (verts [V, 3] f32, tris
    [T, 3] i32, colors [V, 3] f32)."""
    rs = np.random.RandomState(seed)
    nu = max(3, int(round(np.sqrt(n_tris / 4.0))))
    nv = 2 * nu
    u = 2.0 * np.pi * np.arange(nu) / nu
    v = 2.0 * np.pi * np.arange(nv) / nv
    U, V = np.meshgrid(u, v, indexing="ij")
    bump = np.zeros_like(U)
    for _ in range(4):
        ku, kv = rs.randint(1, 6), rs.randint(1, 9)
        bump += rs.uniform(0.02, 0.06) * np.sin(ku * U + kv * V
                                                + rs.uniform(0, 2 * np.pi))
    R, r = 0.45, 0.15 * (1.0 + bump)
    verts = np.stack([r * np.sin(U),
                      (R + r * np.cos(U)) * np.cos(V),
                      (R + r * np.cos(U)) * np.sin(V)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    tris = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])
    phase = rs.uniform(0, 2 * np.pi, 3)
    colors = 0.5 + 0.4 * np.sin(np.stack([U + phase[0], V + phase[1],
                                          U + V + phase[2]], -1))
    return (verts.astype(np.float32), tris.astype(np.int32),
            colors.reshape(-1, 3).astype(np.float32))


def build(mod, cfg: dict, seed: int):
    """The scene; the mesh is the config's (`mesh_seed`), not the run's:
    every run walks the same tree."""
    sb = mod.SceneBuilder()
    sb.dark_sky = False
    Material = mod.Material
    for x in (-1.0, 1.0):
        sb.add_light((x, 8., 2.0), radius=1.5, color=(1, 1, 1),
                     power_correction=2.0)
    sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                  Material(diffuse=(0.8, 0.8, 0.), specular=(1., 1., 1.),
                           shininess=16, texture_type=mod.TEX_CHECKERBOARD,
                           checkerboard_color1=(0.8, 0.8, 0.),
                           checkerboard_color2=(0.6, 0.6, 0.),
                           texture_scale_x=100., texture_scale_y=100.)
                  ).translate((0., 0., -2.)).scale((50., 50., 1.)).rotate_x(-90)
    sb.add_sphere((-4., 0., -8.), 2.0, Material(
        mtype=mod.GLASS, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        index_medium=1.5, shininess=20))
    sb.add_sphere((4., 0., -8.), 2.0, Material(
        mtype=mod.MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        shininess=32))
    verts, tris, colors = standin_mesh(cfg["mesh_triangles"],
                                       cfg["mesh_seed"])
    m = mod.MeshObject(verts, tris, vert_colors=colors,
                       material=Material(diffuse=(0.1, 0.2, 0.5),
                                         specular=(0.9, 0.9, 0.9),
                                         shininess=6.))
    # the zoo's placement of the flamingo (Scene.h:1063-1066)
    m.scale((2.5,) * 3).rotate_x(90).rotate_y(90).rotate_z(180)
    m.translate((0., 1., -8.))
    sb.add_mesh(m)
    return sb
