"""Small runs of the harness on the CPU for the tests: the cell as
BENCHMARK.json gives it, at a tiny size and few samples, the plain
versions of the port's kernels (CPU tensors take them)."""

import time

from portbench import core

SIZE = (16, 12)


def small_cell(name: str, spp: int = 2, frames: int = 2, pixels: int = 192):
    cell = core.load_cell(name)
    cell.traffic = dict(cell.traffic, spp=spp)
    if "check_frames" in cell.limits:
        cell.limits = dict(cell.limits, check_frames=frames,
                           check_pixels=pixels)
    return cell


def run(cell, seed=2 ** 31 + 5, seconds=1e-6, control=False, traced=False):
    """One CPU run of the cell's driver: (result, extra)."""
    return core.driver(cell).run(cell, seed, seconds, traced,
                                 time.perf_counter(), device="cpu",
                                 size=SIZE, control=control)
