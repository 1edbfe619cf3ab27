"""Training CLI: a YAML config and ``key=value`` overrides -> ``train_model``.

Port of ``neural_speech_decoder_tpu/training/cli.py`` (``nsd-train``),
installed as ``nsd-train-torch``:

    python -m neural_speech_decoder_tpu_torch.training.cli \\
        --config neural_speech_decoder_tpu/configs/gru_baseline.yaml \\
        outputDir=runs/gru datasetPath=data/ptDecoder_ctc \\
        fused_optimizer=true use_pallas_matmul=true deviceResidentData=true

The run trains on ``device`` (default ``cuda``; ``device=cpu`` for the CPU),
data-parallel over every visible card by default (``n_data_devices``: JAX's
rule; one rank process a card, started by ``train_model``), and
tensor-parallel with ``n_model_devices`` (``n_data x n_model`` ranks). Under
``torchrun`` (``WORLD_SIZE`` > 1) each process joins the group first
(``parallel/multihost.py::initialize``) and is one rank:

    torchrun --nproc_per_node 4 -m neural_speech_decoder_tpu_torch.training.cli \
        --config neural_speech_decoder_tpu/configs/gru_baseline.yaml \
        outputDir=runs/gru datasetPath=data/ptDecoder_ctc

Multirun (hydra's ``--multirun`` sweeps): ``-m``/``--multirun`` expands
comma-swept override values into the cartesian product of jobs; each job
runs under ``${outputDir}/${override_dirname}`` (the overrides sorted by
key, joined with ``,``, without outputDir/datasetPath; ``job_<i>`` when
that is empty). ``--jobs N`` runs up to N jobs at once in ``spawn`` worker
processes (``parallel/sweep.py``; each its own CUDA context, sharing the
card by time-slicing):

    nsd-train-torch --config cfg.yaml -m lrStart=0.01,0.02 nUnits=512,1024 \\
        outputDir=runs/sweep --jobs 2

Comma-swept values without ``-m`` raise ``SystemExit``, as does a sweep
whose every job failed.
"""

from __future__ import annotations

import argparse
import copy
import os

from ..utils.config import (
    apply_overrides,
    expand_multirun,
    load_yaml_config,
    override_dirname,
)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("-m", "--multirun", action="store_true",
                        help="expand comma-swept overrides into a job per combination "
                        "(hydra --multirun), each under outputDir/<override_dirname>")
    parser.add_argument("--jobs", type=int, default=1,
                        help="multirun concurrency (worker processes; array_parallelism)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides (YAML-typed)")
    args = parser.parse_args(argv)
    base_cfg = load_yaml_config(args.config)
    job_overrides = expand_multirun(args.overrides)
    if not args.multirun:
        if len(job_overrides) > 1:
            raise SystemExit("comma-swept override values need -m/--multirun "
                             f"(would launch {len(job_overrides)} jobs)")
        cfg = apply_overrides(base_cfg, args.overrides)
        if not cfg.get("outputDir"):
            raise SystemExit("outputDir must be set (config or override)")
        from .trainer import train_model

        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            return _train_torchrun_rank(cfg)
        return train_model(cfg)
    return _multirun(base_cfg, job_overrides, jobs=args.jobs)


def _train_torchrun_rank(cfg: dict) -> dict:
    """One rank of a ``torchrun`` job: join the group on this rank's device
    (``cuda:LOCAL_RANK`` over nccl, or the CPU over gloo), train, leave."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import default_device
    from ..parallel.multihost import initialize
    from .trainer import train_model

    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda":
        device = default_device()
    initialize(device=device, timeout_s=cfg.get("dist_timeout_s"))
    try:
        return train_model({**cfg, "device": str(device)})
    finally:
        dist.destroy_process_group()


def _multirun(base_cfg: dict, job_overrides: list[list[str]], *, jobs: int = 1) -> dict:
    """Run every override combination under hydra's sweep layout
    (``sweep.dir = ${outputDir}``, ``subdir = ${override_dirname}``);
    returns the sweep dir, each job's dir and status, and the best CER."""
    from ..parallel.sweep import run_sweep

    job_cfgs, names = [], []
    for i, ov_list in enumerate(job_overrides):
        cfg = apply_overrides(copy.deepcopy(base_cfg), ov_list)
        cfg.pop("outputDir", None)  # run_sweep assigns the per-job dir
        job_cfgs.append(cfg)
        # hydra leaves override_dirname empty when every override is
        # excluded; distinct jobs still need distinct dirs
        names.append(override_dirname(ov_list) or f"job_{i}")
    # sweep.dir = ${outputDir}, the same for every job (a swept outputDir
    # would nest runs inside each other)
    probe = apply_overrides(copy.deepcopy(base_cfg), job_overrides[0])
    sweep_dir = probe.get("outputDir")
    if not sweep_dir:
        raise SystemExit("outputDir must be set (config or override)")
    trials = run_sweep({}, job_cfgs, str(sweep_dir), array_parallelism=jobs,
                       use_processes=jobs > 1, subdir_names=names)
    failed = [t for t in trials if t.status == "failed"]
    for t in failed:
        print(f"job {t.output_dir} failed:\n{t.error}")
    if len(failed) == len(trials):
        raise SystemExit(f"all {len(trials)} multirun jobs failed")
    best = trials[0]
    return {
        "sweep_dir": str(sweep_dir),
        "jobs": {t.output_dir: t.status for t in trials},
        "best_dir": best.output_dir,
        "summary/best_cer": best.best_cer,
        "n_failed": len(failed),
    }


if __name__ == "__main__":
    main()
