"""``scan_roofline.train`` / ``scan_roofline.decode``: the GRU scan's share
of its roofline. The scans' least time over the window (each layer's
recurrent products at the float32 peak, or their bytes at the HBM rate,
whichever is larger; a train step adds the backward's) over the device time
of the port's kernels whose names start with ``gru_``, in %."""

from portbench.flops import gru_scan, peaks
from portbench.readers import port_kernels, roofline


def read(run):
    if run.config["family"] != "gru":
        return None
    train = run.kind == "train"
    a = run.config["args"]
    b, h = run.mix["batch"], a["nUnits"]
    d = 2 if a["bidirectional"] else 1
    frames = (run.mix["t_envelope"] - a["kernelLen"]) // a["strideLen"] + 1
    one = peaks.bound_s(gru_scan.forward_ops(b, h, frames, d),
                        gru_scan.forward_bytes(b, h, frames, d, train))
    if train:
        one += peaks.bound_s(gru_scan.backward_ops(b, h, frames, d),
                             gru_scan.backward_bytes(b, h, frames, d))
    return roofline(run, run.units * a["nLayers"] * one, port_kernels("gru_"))
