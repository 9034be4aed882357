"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

F32_FLOPS = 67e12       # f32 outside the tensor cores; an FMA is 2
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
