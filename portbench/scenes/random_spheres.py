"""The reference app's random spheres (`src/Scene.h:829-924`, the port's
`scenes/zoo.py::setup_random_spheres`): a light, a floor, three large
spheres and 79 random ones, each moving by its motion-blur translation
(Scene.h:922). The layout is the app's (`layout_seed`), not the run's."""

from __future__ import annotations

import numpy as np


def build(mod, cfg: dict, seed: int):
    sb = mod.SceneBuilder()
    sb.dark_sky = False
    Material = mod.Material
    rng_ = np.random.RandomState(cfg["layout_seed"])
    sb.add_light((-1.0, 8., 2.0), radius=1.5, color=(1, 1, 1),
                 power_correction=2.0)
    sb.add_square((-1., -0.2, 0.), (1., 0., 0.), (0., 1., 0.), 2., 2.,
                  Material(diffuse=(0.8, 0.8, 0.), specular=(1., 1., 1.))
                  ).translate((0., 0., -4.)).scale((100., 100., 1.)).rotate_x(-90)
    sb.add_sphere((-3., 0., -22.), 4.0, Material(
        mtype=mod.MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        shininess=32))
    sb.add_sphere((4., -2., -15.), 2.0, Material(
        mtype=mod.MIRROR, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        shininess=32))
    sb.add_sphere((-1., -2.5, -8.), 1.5, Material(
        mtype=mod.GLASS, diffuse=(0.8,) * 3, specular=(0.8,) * 3,
        shininess=20))

    def rf(lo, hi):
        return float(lo + (hi - lo) * rng_.rand())

    for _ in range(cfg["random_spheres"]):
        height = rf(0.25, 1.)
        radius = rf(0.25, 1.5)
        mtype = rng_.randint(3)
        center = (rf(-30., 30.), -4 + radius + height, rf(-50., -2.))
        if mtype == 0:
            mat = Material(mtype=mod.MIRROR,
                           diffuse=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           specular=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           shininess=rf(32., 100.))
        elif mtype == 1:
            g = rf(0.7, 1.)
            mat = Material(mtype=mod.GLASS, diffuse=(g,) * 3,
                           specular=(rf(0.7, 1.),) * 3,
                           shininess=rf(32., 70.),
                           transparency=rf(0.7, 1.),
                           index_medium=rf(1., 2.))
        else:
            mat = Material(diffuse=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           specular=(rf(0, 1), rf(0, 1), rf(0, 1)),
                           shininess=rf(0., 30.))
        mat.motion_blur_translation = np.array([0., height, 0.], np.float32)
        sb.add_sphere(center, radius, mat)
    return sb
