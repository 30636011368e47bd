from tracer_torch.accel.bvh import build_bvh, FlatBVH

__all__ = ["build_bvh", "FlatBVH"]
