from tracer_torch.scenes import zoo

__all__ = ["zoo"]
