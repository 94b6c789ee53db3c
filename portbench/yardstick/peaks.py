"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity), at the full power limit of 700 W. A share of a peak is stated
against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12  # CUDA cores (TF32 off)
