"""``fused_roofline.train`` / ``fused_roofline.decode``: the fused FF and
conv modules' share of their roofline. The modules' model operations (a
train step: forward and backward, no recompute) at the float32 peak over
the device time of the port's kernels of their stages, named as in a
frozen copy of the port's ``training/profile.py::FUSED_STAGES``, in %.
Only the port's own kernels count: cuBLAS's ``sm80_xmma_gemm_f32f32_...``
and cuDNN's ``..._implicit_gemm_f32f32_...`` hold ``gemm_f32`` too."""

from portbench.flops import fused_modules, peaks
from portbench.readers import port_kernels, roofline

STAGES = port_kernels("gemm_sm90", "gemm_wmma", "gemm_fma", "gemm_f32", "split_sum", "ln_stats",
                      "ln_apply", "mask_grad", "colsum", "sum_parts", "ln_bwd", "glu_dwconv",
                      "dwconv_bwd", "each_cols")


def read(run):
    a = run.config["args"]
    if run.config["family"] != "conformer" or not (a.get("fused_ffn") and a.get("fused_conv")):
        return None
    frames = (run.mix["t_envelope"] - a["temporal_kernel"]) // a["temporal_stride"] + 1
    rows = run.mix["batch"] * frames
    d = a["latent_dim"]
    ops = (2 * fused_modules.ffn_forward_ops(rows, d, a["transformer_dim_ff"])
           + fused_modules.conv_forward_ops(rows, d, a["conformer_conv_kernel"]))
    if run.kind == "train":
        ops *= 3.0
    n_bytes = fused_modules.weight_bytes(d, a["transformer_dim_ff"], a["conformer_conv_kernel"])
    one = a["transformer_num_layers"] * peaks.bound_s(ops, n_bytes)
    return roofline(run, run.units * one, STAGES)
