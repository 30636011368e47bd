"""Frozen for the benchmark's reference from the port's `core/config.py`,
unchanged but for its imports, so that a later change of the port
cannot move the yardstick.

Render configuration.

Copy of `tracer/core/config.py` with the same fields and defaults (the
port never imports the JAX package); only the meaning of `kernels` is the
port's own. Mirrors every compile-time constant of the reference
(`src/Constants.h:4-18`) as a runtime config, with the
reference values as defaults. `compat="reference"` replicates the reference's
quirks bit-for-bit in semantics (see SURVEY.md §2.19); `compat="physical"`
fixes them (correct per-light shading, no /MAXBOUNCES normalization, correct
refraction ratio, uniform sphere sampling).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Reference: src/Constants.h:10-12
    nsamples: int = 20          # DEFAULT_NSAMPLES
    max_bounces: int = 6        # MAXBOUNCES
    shadow_rays: int = 10       # NB_ECH

    # Reference: src/Constants.h:15-16 (KD build params; our BVH
    # analogues — the reference uses 40 tris/leaf). 16 is the JAX
    # package's default, chosen for its TPU packet walk; the port keeps it
    # so that both packages build the same trees (the port's per-ray walk,
    # kernels/csrc/bvh.cuh, stops a leaf at its first padding slot).
    bvh_leaf_size: int = 16
    bvh_max_depth: int = 64

    # Reference: src/Constants.h:18
    epsilon: float = 1e-5

    # Reference: main.cpp:52-53 default framebuffer
    width: int = 850
    height: int = 480

    # "reference" replicates quirks (lights[0] color, /6 normalization,
    # glass -0.6 fudge, bounce-scaled skybox, cube-sampled unit vectors,
    # mesh emission skipped); "physical" fixes them.
    compat: str = "reference"

    # RNG seed for the counter-based sampler.
    seed: int = 0

    # CUDA kernel dispatch: "auto" = the hand-written kernel for CUDA
    # tensors and its plain PyTorch version for CPU tensors; "on" = the
    # kernel, and raise for CPU tensors; "off" = the plain version on any
    # device (the reference the kernels are held against on the card).
    kernels: str = "auto"

    # Rays per device-step batch (wavefront width). Pixels*samples are
    # processed in chunks of this size to bound device memory.
    rays_per_batch: int = 1 << 20

    # Record-replay custom VJP for trace(): the forward records per-bounce
    # discrete selections and the backward differentiates a selected-hit
    # replay (no candidate argmin / BVH walks / shadow search in bwd).
    # "off" = plain remat'd scan autodiff.
    custom_vjp: str = "on"

    # Sorted ray queues for the BVH traversal kernel: "auto" buckets
    # rays by direction octant + coarse position before the packet walk
    # (coherent packets prune; measured 3.5x on backrooms_pool whose
    # post-bounce rays are fully incoherent), "off" walks in ray order.
    # Kept (and validated) for parity with the JAX package's config; it
    # has no effect in the port, whose GPU kernels walk each ray on its
    # own thread and always take rays in ray order.
    ray_sort: str = "auto"

    # Packed-u32 / pair-packed texture-atlas fast paths. The packed twins
    # encode the PRISTINE u8 atlases; an optimization loop that moves
    # tex_data/nm_data off the u8 grid must render with "off" (the exact
    # [P,3] row-gather path) or the forward silently uses stale texels
    # while gradients flow to the live arrays (tracer/train.py sets this
    # automatically). "auto" = on whenever kernels are on.
    packed_atlas: str = "auto"

    def __post_init__(self):
        if self.max_bounces < 1:
            # the trace loops unroll the final bounce out of the scan,
            # so zero bounces would still execute one (at b = -1)
            raise ValueError("max_bounces must be >= 1")
        if self.compat not in ("reference", "physical"):
            raise ValueError(f"unknown compat mode: {self.compat!r}")
        if self.kernels not in ("auto", "on", "off"):
            raise ValueError(f"unknown kernels mode: {self.kernels!r}")
        if self.custom_vjp not in ("on", "off"):
            raise ValueError(f"unknown custom_vjp mode: {self.custom_vjp!r}")
        if self.packed_atlas not in ("auto", "off"):
            raise ValueError(
                f"unknown packed_atlas mode: {self.packed_atlas!r}")
        if self.ray_sort not in ("auto", "off"):
            raise ValueError(f"unknown ray_sort mode: {self.ray_sort!r}")
