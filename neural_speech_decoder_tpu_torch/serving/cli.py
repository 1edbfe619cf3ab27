"""``nsd-export-torch``: export a trained run directory of the port as an
AOT serving artifact (see ``serving/export.py``).

  nsd-export-torch MODEL_DIR OUT_DIR [--batch-size 64] [--t-max 1280]
  nsd-export-torch MODEL_DIR OUT_DIR --streaming [--frames-per-chunk 2]
                                     [--day-idx 0] [--causal] [--beam ...]

Export on the device you will serve on (``--device``, default ``cuda``): a
CUDA artifact runs the hand kernels and needs a card, a CPU artifact runs
their plain versions.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--t-max", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device the artifact is exported for and served on")
    ap.add_argument("--streaming", action="store_true",
                    help="export the streaming prime/step programs (GRU or causal "
                         "Conformer, by the saved model family) instead of the batch "
                         "forward")
    ap.add_argument("--day-idx", type=int, default=0)
    ap.add_argument("--frames-per-chunk", type=int, default=1)
    ap.add_argument("--causal", action="store_true",
                    help="GRU only: zero-lookahead smoothing (no offline parity)")
    ap.add_argument("--beam", action="store_true",
                    help="with --streaming: also export the on-device n-best beam "
                         "programs (ExportedStreamer.decode_beam)")
    ap.add_argument("--beam-width", type=int, default=8)
    ap.add_argument("--beam-top-k", type=int, default=8)
    ap.add_argument("--beam-max-len", type=int, default=512)
    a = ap.parse_args(argv)

    from .export import export_beam, export_inference, export_streaming

    if a.streaming:
        out = export_streaming(
            a.model_dir, a.out_dir, day_idx=a.day_idx, batch=a.batch_size or 1,
            frames_per_chunk=a.frames_per_chunk, causal=a.causal, device=a.device)
        if a.beam:
            import json
            import os

            with open(os.path.join(out, "stream_meta.json")) as f:
                sm = json.load(f)
            export_beam(out, batch=sm["batch"], n_classes=sm["n_classes"],
                        beam_width=a.beam_width, top_k_tokens=a.beam_top_k,
                        max_len=a.beam_max_len, device=a.device)
    else:
        out = export_inference(a.model_dir, a.out_dir, batch_size=a.batch_size,
                               t_max=a.t_max, device=a.device)
    print(f"exported -> {out}")
    return out


if __name__ == "__main__":
    main()
