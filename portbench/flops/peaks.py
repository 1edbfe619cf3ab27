"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): HBM bytes a second, and flops a second of the
float32 FMA units outside the tensor cores (TF32 off) and of the bfloat16
tensor cores."""

HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(ops: float, n_bytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the HBM rate."""
    return max(ops / PEAK_FLOPS[dtype], n_bytes / HBM_BPS)
