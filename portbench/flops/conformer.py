"""Model FLOPs of the Conformer's forward over a padded batch: the day
affine, smoothing, strided depthwise conv and projection, the bottleneck,
each block's two FF modules, qkv and out projections, attention over each
row's valid keys and the conv module, the InterCTC head (training) and the
deep head."""

from . import attention, fused_modules


def frames(t: int, kernel: int, stride: int) -> int:
    return (t - kernel) // stride + 1


def forward_flops(config: dict, b: int, t: int, out_lens, train: bool) -> float:
    a = config["args"]
    c, f, d = a["nInputFeatures"], a["frontend_dim"], a["latent_dim"]
    length = frames(t, a["temporal_kernel"], a["temporal_stride"])
    rows = b * length
    n_out = a["nClasses"] + 1
    taps = int(4 * a["gaussian_smooth_width"]) + 1
    heads = a["transformer_n_heads"]
    total = 2.0 * b * t * c * c + 2.0 * taps * b * t * c
    total += 2.0 * rows * c * a["temporal_kernel"] + 2.0 * rows * c * f
    total += 2.0 * rows * (f * a["autoencoder_hidden_dim"] + a["autoencoder_hidden_dim"] * d)
    block = (2 * fused_modules.ffn_forward_ops(rows, d, a["transformer_dim_ff"])
             + 2.0 * rows * d * 3 * d + 2.0 * rows * d * d
             + fused_modules.conv_forward_ops(rows, d, a["conformer_conv_kernel"]))
    total += a["transformer_num_layers"] * block
    total += a["transformer_num_layers"] * attention.forward_ops(out_lens, length, heads,
                                                                 d // heads)
    total += 2.0 * rows * d * d + 2.0 * rows * d * n_out
    if train and config["reference"]["interctc"]:
        total += 2.0 * rows * d * n_out
    return total
