"""The card's published peaks: one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates, at its 700 W limit). A share of a peak or of a roofline is
stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense bf16 tensor cores; float32 FMA
