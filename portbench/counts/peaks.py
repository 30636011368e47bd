"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def bound_s(nbytes: float, ops: float):
    """(seconds, "bytes" or "operations"): the least time the card could
    take, the larger of the bytes over the memory rate and the f32
    operations over the f32 rate."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (b, "bytes") if b >= o else (o, "operations")
