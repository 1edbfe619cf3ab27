"""The attention kernels' share of their roofline in a train step: the
forward's two and the backward's five products over each row's valid keys
at the float32 peak (or the bytes at the HBM rate, whichever is larger),
over the device time of the port's kernels whose names start with
``attn_``, in %."""

from portbench.flops import attention, peaks
from portbench.readers import port_kernels, roofline, unit_out_lens


def read(run):
    if run.config["family"] != "conformer":
        return None
    a = run.config["args"]
    b, heads, d = run.mix["batch"], a["transformer_n_heads"], a["latent_dim"]
    frames = (run.mix["t_envelope"] - a["temporal_kernel"]) // a["temporal_stride"] + 1
    bound = 0.0
    for lens in run.lens:
        out = unit_out_lens(run, lens)
        bound += (peaks.bound_s(attention.forward_ops(out, frames, heads, d // heads),
                                attention.forward_bytes(b, frames, d))
                  + peaks.bound_s(attention.backward_ops(out, frames, heads, d // heads),
                                  attention.backward_bytes(b, frames, d)))
    return roofline(run, bound * a["transformer_num_layers"], port_kernels("attn_"))
