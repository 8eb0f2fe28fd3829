"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): HBM bytes a second, dense TF32 tensor-core FLOP/s (the
fastest unit on which a float32-accurate product has been shown on this
card, 3xTF32) and float32 FLOP/s outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
