"""The Conformer's fused feed-forward and conv modules: the model's
operations of each (its products and the depthwise window; a backward is
twice its forward, with no recompute counted)."""


def ffn_forward_ops(rows: int, d: int, f: int) -> float:
    """LN -> W1 [D, F] -> SiLU -> W2 [F, D] over ``rows`` frames."""
    return 2.0 * rows * d * f * 2


def conv_forward_ops(rows: int, d: int, kernel: int) -> float:
    """LN -> W1 [D, 2D] -> GLU -> depthwise ``kernel`` taps -> LN -> W2 [D, D]."""
    return 2.0 * rows * (d * 2 * d + d * d) + 2.0 * rows * d * kernel


def weight_bytes(d: int, f: int, kernel: int) -> float:
    """float32 weights of one FF and one conv module."""
    return 4.0 * (2 * d * f + 3 * d * d + d * kernel)
