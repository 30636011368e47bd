"""Test scenes for the parity tests and the chip smoke run (not a render
feature): a Cornell box whose image textures and normal maps are seeded
uint8 arrays instead of the reference's PPM assets.

The Cornell builder loads two textures (brick, sand) and three normal maps
(brick, floor, water — the last unused). `fill_cornell_textures` fills those
slots so that the brick walls get MATCHED texture/normal-map dims (a plain
pair-atlas region) and the floor gets MISMATCHED dims (a product region).
It takes any object with `textures` / `normal_maps` lists, so the same
arrays can be put into a `tracer` and a `tracer_torch` SceneBuilder.
"""

from __future__ import annotations

import numpy as np

# (H, W) of each slot: brick texture and brick normal map match; the sand
# texture and the floor normal map do not
SMALL = dict(brick=(40, 56), sand=(64, 48), floor_nm=(24, 36),
             water_nm=(8, 8))
FULL = dict(brick=(1024, 1024), sand=(1024, 1024), floor_nm=(512, 512),
            water_nm=(512, 512))


def fill_cornell_textures(sb, dims=SMALL, seed: int = 0):
    """Fill a `setup_cornell_box` builder's texture and normal-map slots
    with seeded uint8 images of the given (H, W) dims; returns `sb`."""
    rs = np.random.RandomState(seed)

    def img(hw):
        return rs.randint(0, 256, size=hw + (3,), dtype=np.uint8)

    sb.textures[0] = img(dims["brick"])      # brick texture
    sb.textures[1] = img(dims["sand"])       # sand texture
    sb.normal_maps[0] = img(dims["brick"])   # brick normal map (matched)
    sb.normal_maps[1] = img(dims["floor_nm"])  # floor normal map (product)
    sb.normal_maps[2] = img(dims["water_nm"])  # loaded, unused
    return sb
