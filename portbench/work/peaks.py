"""The chip's peaks that every share is taken against: NVIDIA's H100 SXM
data sheet (dense rates), at the full 700 W power limit."""

# HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# float32-accurate products on the tensor cores: TF32's 495 TFLOP/s over
# the three products of a 3xTF32 multiply (how K3 reaches float32
# accuracy), so that no kernel that keeps float32 accuracy reads above it
FP32_ACCURATE_FLOP_PER_S = 495e12 / 3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / FP32_ACCURATE_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
