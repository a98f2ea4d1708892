"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit). The special-function rate is the same clock's 16 MUFU
operations per SM per cycle (132 SMs x 16 x 1.98 GHz)."""

BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OP_PER_S = 132 * 16 * 1.98e9
