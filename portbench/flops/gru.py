"""Model FLOPs of the GRU baseline's forward over a padded batch: the
smoothing and day affine, layer 0's projection over the unfolded frames,
layers 1+'s projections, every layer's scan products and the head. The
envelope is static, so every frame of it counts, padding included, as the
model computes it."""

from . import gru_scan


def frames(t: int, kernel: int, stride: int) -> int:
    return (t - kernel) // stride + 1


def forward_flops(config: dict, b: int, t: int, out_lens=None, train: bool = False) -> float:
    """The forward's FLOPs; the GRU's do not depend on the lengths or the
    mode (every frame of the envelope is scanned)."""
    a = config["args"]
    c, h, k, s = a["nInputFeatures"], a["nUnits"], a["kernelLen"], a["strideLen"]
    d = 2 if a["bidirectional"] else 1
    taps = config["gaussian_taps"]
    n_out = a["nClasses"] + 1
    length = frames(t, k, s)
    rows = b * length
    total = 2.0 * taps * b * t * c + 2.0 * b * t * c * c
    total += 2.0 * rows * (c * k) * (3 * h * d)
    total += (a["nLayers"] - 1) * 2.0 * rows * (h * d) * (3 * h * d)
    total += a["nLayers"] * gru_scan.forward_ops(b, h, length, d)
    total += 2.0 * rows * (h * d) * n_out
    return total
