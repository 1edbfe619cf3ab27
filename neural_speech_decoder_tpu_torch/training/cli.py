"""Training CLI: a YAML config and ``key=value`` overrides -> ``train_model``.

Port of ``neural_speech_decoder_tpu/training/cli.py`` (``nsd-train``) for one
run:

    python -m neural_speech_decoder_tpu_torch.training.cli \\
        --config neural_speech_decoder_tpu/configs/gru_baseline.yaml \\
        outputDir=runs/gru datasetPath=data/ptDecoder_ctc \\
        fused_optimizer=true use_pallas_matmul=true deviceResidentData=true

(also installed as ``nsd-train-torch``). The run trains on ``device``
(default ``cuda``; ``device=cpu`` for the CPU). ``-m/--multirun`` (hydra's
sweeps over comma-separated values) is not ported: it needs
``parallel/sweep.py`` (ROADMAP queue 1 item 10) and raises.
"""

from __future__ import annotations

import argparse

from ..utils.config import apply_overrides, expand_multirun, load_yaml_config


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("-m", "--multirun", action="store_true",
                        help="not ported (ROADMAP queue 1 item 10): raises")
    parser.add_argument("overrides", nargs="*", help="key=value overrides (YAML-typed)")
    args = parser.parse_args(argv)
    if args.multirun:
        raise NotImplementedError(
            "-m/--multirun needs parallel/sweep.py, not ported (ROADMAP queue 1 item 10)")
    if len(expand_multirun(args.overrides)) > 1:
        raise SystemExit("comma-swept override values need -m/--multirun, which "
                         "the port does not have (ROADMAP queue 1 item 10)")
    cfg = apply_overrides(load_yaml_config(args.config), args.overrides)
    if not cfg.get("outputDir"):
        raise SystemExit("outputDir must be set (config or override)")
    from .trainer import train_model

    return train_model(cfg)


if __name__ == "__main__":
    main()
