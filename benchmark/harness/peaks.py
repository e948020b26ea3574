"""One NVIDIA H100 SXM's published peaks (dense, at 700 W)."""

BF16_FLOPS = 989e12         # tensor cores, bf16 / fp16
TF32_FLOPS = 495e12         # tensor cores, the highest rate of an f32 product
F32_FLOPS = 67e12           # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# the step's share of the peak is taken against the highest rate the chip
# has for any precision these models use, so no implementation reads over
# 100%
STEP_PEAK = BF16_FLOPS

# a recurrence's operands' precision -> the highest rate of its product
PRODUCT_PEAK = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS}
