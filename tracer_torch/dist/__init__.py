"""Distribution over ranks and hosts (the port of `tracer/dist/`):
`sharding` (the (dp, sp) mesh, the sharded render and training step),
`multihost` (process groups, host-major pod meshes, the film gather),
`launch` (a group of local ranks) and `dryrun` (the twin of the JAX
package's `dryrun_multichip`)."""

from tracer_torch.dist.sharding import (make_ray_mesh, render_pixels_sharded,
                                        train_step)

__all__ = ["make_ray_mesh", "render_pixels_sharded", "train_step"]
