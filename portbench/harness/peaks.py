"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A card set below 700 W runs
slower under load; a share of these peaks is stated with the card's
power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores: the port's float32 configs run with
# TF32 off (the port's ``use_strict_float32``)
FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def flops_peak(compute_dtype: str) -> float:
    """The chip's peak for a configuration's compute dtype."""
    return FLOPS[compute_dtype]
