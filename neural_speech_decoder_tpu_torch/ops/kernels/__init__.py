"""See the package docstring of neural_speech_decoder_tpu_torch.

Importing the package registers the serving kernels as the operators
``torch.ops.nsd_torch.*`` (``library.py``), which the wrappers' eager
entry points call. ``launch_counts()`` reads every wrapper's launch
counters."""

from . import library  # noqa: F401


def launch_counts() -> dict[str, int]:
    """This process's kernel launches so far: each wrapper's ``launches``
    under its name, and its ``launches_by_body`` as ``<name>/<body>``."""
    from . import adam, attention, conv_module, ctc, ffn, frontend, gru_scan, matmul

    wrappers = {
        "frontend": frontend.fused_frontend,
        "gru_scan": gru_scan.gru_sequence,
        "gru_scan_gates": gru_scan.gru_sequence_gates,
        "gru_scan_bwd": gru_scan.gru_sequence_bwd,
        "ctc_alpha": ctc.ctc_alpha,
        "ctc_beta": ctc.ctc_beta,
        "mhsa_qkv": attention.mhsa_qkv,
        "mhsa_qkv_bwd": attention.mhsa_qkv_bwd,
        "dropout_masks": attention.dropout_masks,
        "ffn": ffn.ffn,
        "ffn_bwd": ffn.ffn_bwd,
        "ffn_dropout_masks": ffn.ffn_dropout_masks,
        "conv_module": conv_module.conv_module,
        "conv_module_bwd": conv_module.conv_module_bwd,
        "adam_update": adam.adam_update,
        "tiled_matmul": matmul.tiled_matmul,
    }
    counts = {}
    for name, fn in wrappers.items():
        counts[name] = fn.launches
        for body, n in getattr(fn, "launches_by_body", {}).items():
            counts[f"{name}/{body}"] = n
    return counts
