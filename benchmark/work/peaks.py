"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense, no sparsity). A share of a peak is stated against these,
with the card's power limit beside it."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# the peak of a step's model FLOP by the configuration's stated precision
# (float32 with TF32 off runs outside the tensor cores)
PRECISION_PEAK = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS}
