from tracer_torch.io.ppm import load_ppm, write_ppm
from tracer_torch.io.off import load_off

__all__ = ["load_ppm", "write_ppm", "load_off"]
