"""The reference app's Cornell box (`src/Scene.h:421-619`, the port's
`scenes/zoo.py::setup_cornell_box`) with its wall textures and normal
maps as seeded uint8 images at the sizes the config gives (the image
files are absent): brick texture and brick normal map of one size (a
plain pair-atlas region), the sand texture and the floor normal map of
two (a product region), the water normal map loaded and unused."""

from __future__ import annotations

import numpy as np


def textures(dims: dict, seed: int) -> dict:
    """Seeded uint8 [H, W, 3] images for the five slots, drawn in the order
    brick, sand, brick normal map, floor normal map, water normal map."""
    rs = np.random.RandomState(seed % 2 ** 32)
    out = {}
    for slot, key in (("brick", "brick"), ("sand", "sand"),
                      ("brick_nm", "brick"), ("floor_nm", "floor_nm"),
                      ("water_nm", "water_nm")):
        out[slot] = rs.randint(0, 256, size=tuple(dims[key]) + (3,),
                               dtype=np.uint8)
    return out


def build(mod, cfg: dict, seed: int):
    aspect = cfg["width"] / cfg["height"]
    img = textures(cfg["textures"], seed)
    sb = mod.SceneBuilder()
    Material = mod.Material
    brick_tex = sb.add_texture(img["brick"])
    brick_nm = sb.add_normal_map(img["brick_nm"])
    floor_nm = sb.add_normal_map(img["floor_nm"])
    sand_tex = sb.add_texture(img["sand"])
    sb.add_normal_map(img["water_nm"])  # loaded, unused

    white = Material(diffuse=(0.9, 0.9, 0.9), specular=(1., 1., 1.),
                     shininess=16)
    emissive = Material(emissive=True, light_color=(1., 1., 1.),
                        light_intensity=60.)
    # ceiling light box (Scene.h:476-491)
    sb.add_box([emissive] + [white] * 4,
               [True, False, True, True, True, True],
               pos=(0., 1.95, 0.), size=1.0)

    def brick(diffuse, specular, sx=1.0, sy=1.0):
        return Material(diffuse=diffuse, specular=specular, shininess=16,
                        texture_type=mod.TEX_IMAGE, texture_id=brick_tex,
                        normal_map_id=brick_nm, texture_scale_x=sx,
                        texture_scale_y=sy)

    def square(material):
        return sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 2.,
                             2., material)

    # back, left, right walls
    square(brick((1., 1., 1.), (1., 1., 1.), sx=1. * aspect)).scale(
        (2. * aspect, 2., 1.)).translate((0., 0., -2.))
    square(brick((1., 0., 0.), (1., 0., 0.))).rotate_x(180).scale(
        (2., 2., 1.)).translate((0., 0., 2. * aspect)).rotate_y(90)
    square(brick((0., 1., 0.), (0., 1., 0.))).rotate_x(180).translate(
        (0., 0., 2. * aspect)).scale((2., 2., 1.)).rotate_y(-90)
    # floor
    square(Material(diffuse=(246 / 255., 204 / 255., 162 / 255.),
                    specular=(1., 1., 1.), shininess=1,
                    texture_type=mod.TEX_IMAGE, texture_id=sand_tex,
                    normal_map_id=floor_nm)).translate((0., 0., -2.)).scale(
        (2. * aspect, 2., 1.)).rotate_x(-90)
    # ceiling
    square(Material(diffuse=(1., 1., 1.), specular=(1., 1., 1.),
                    shininess=16, texture_type=mod.TEX_CHECKERBOARD,
                    checkerboard_color1=(0.95, 0.95, 0.95),
                    checkerboard_color2=(0.5, 0.5, 0.5),
                    texture_scale_x=8. * aspect,
                    texture_scale_y=8.)).translate((0., 0., -2.)).scale(
        (2. * aspect, 2., 1.)).rotate_x(90)
    # front wall
    square(brick((1., 1., 1.), (1., 1., 1.))).translate((0., 0., -2.)).scale(
        (2. * aspect, 2., 1.)).rotate_y(180)
    # glass and mirrored spheres
    sb.add_sphere((1.0, -1.25, 0.5), 0.75, Material(
        mtype=mod.GLASS, diffuse=(1., 1., 1.), specular=(1., 1., 1.),
        shininess=16, transparency=1.0, index_medium=1.4))
    sb.add_sphere((-1.0, -1.25, -0.5), 0.75, Material(
        mtype=mod.MIRROR, diffuse=(0.7, 0.7, 0.7), specular=(1., 1., 1.),
        shininess=16, transparency=0., index_medium=0.))
    return sb
