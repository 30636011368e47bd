from tracer_torch.core.config import RenderConfig
from tracer_torch.core import rng, mathutils

__all__ = ["RenderConfig", "rng", "mathutils"]
