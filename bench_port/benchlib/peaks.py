"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

BF16_FLOPS = 989e12      # bf16 tensor-core FLOP/s, dense
HBM_BYTES = 3.35e12      # HBM3 bytes/s
