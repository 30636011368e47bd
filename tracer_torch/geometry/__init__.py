from tracer_torch.geometry import primitives

__all__ = ["primitives"]
