"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit). A run prints the card's power limit beside
every share of these."""

HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
