"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every share
of a peak or roofline the benchmark reports."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
INT8_OPS = 1979e12         # int8 tensor cores
FP32_FLOPS = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
