"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM3 bandwidth and the float32
rate outside the tensor cores.  A run prints the card's power limit
beside every share of them."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
