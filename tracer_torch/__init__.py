"""tracer_torch — the PyTorch and CUDA port of `tracer` for an NVIDIA H100.

The JAX package `tracer` is the reference; this package imports torch and
numpy only, never `jax` or `tracer`, so it runs where JAX is absent. It
keeps its own copy of the numpy host layer (scene builder, zoo, image and
mesh I/O, RenderConfig) because importing anything under `tracer` imports
JAX. Layout and names mirror `tracer/`: each module sits at the same path.

The forward render (Cornell, lit scenes, mesh scenes) and the Cornell
backward run on six hand-written CUDA kernels (`kernels/csrc/*.cu`: first
hit, shade+scatter, BVH walk, soft shadows, bounce adjoint, texel fold);
on CPU tensors each kernel's plain PyTorch version runs instead. On top of
them: `train.py` (`fit`: Adam with exact-resume checkpoints in the JAX
package's layout), `render/film.py` (`Film`, `TileManifest`: the tiled,
checkpointed render of `render(ckpt_dir=...)`), `cli.py`
(`python -m tracer_torch.cli render|probe|benchmark|grad-check|train|
scenes`) and `dist/` (the sharded render and training step over a
(dp, sp) mesh of torch.distributed ranks, the multi-host film, the
dry-run twin). On the card, `render`, the tiled render, `fit`'s step on
every scene and the bench's bodies replay CUDA graphs keyed by their
arguments' shapes (`render/graphs.py`), the counterpart of the JAX
package's `jax.jit`.
"""

from tracer_torch.core.config import RenderConfig
from tracer_torch.render.renderer import render, render_image
from tracer_torch.scenes import zoo

__all__ = ["RenderConfig", "render", "render_image", "zoo"]
__version__ = "0.1.0"
