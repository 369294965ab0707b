"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). The port runs its nets in float32 with TF32
off (PyTorch's default for matmuls), so its model FLOPs are set against the
float32 rate outside the tensor cores."""

F32_FLOPS = 67e12  # FLOP/s, float32, no tensor cores
HBM_BYTES = 3.35e12  # bytes/s
