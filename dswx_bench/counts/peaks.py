"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the yardstick of every roofline share."""

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_OPS_PER_S = 67e12          # float32 outside the tensor cores
