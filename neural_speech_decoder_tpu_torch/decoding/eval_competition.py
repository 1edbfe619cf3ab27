"""Competition evaluation pipeline: model -> beam+LM decode -> LLM rescore.

The port's counterpart of
``neural_speech_decoder_tpu/decoding/eval_competition.py``, a working
re-design of the reference ``scripts/eval_competition.py``. Behavior
preserved:
  * competition partition day indices [4,5,6,7,8,9,10,12,13,14,15,16,18,19,20]
    (``eval_competition.py:45-47``),
  * transcription cleanup regex (``:76-78``),
  * decode hyperparameters: acoustic_scale 0.5, blank penalty ln 7,
    beam 18, nbest 100, LLM alpha 0.5 (``:95-98,110-116,127-137``),
  * artifacts: ``llm_out`` pickle + ``5gramLLMCompetitionSubmission.txt``
    (``:142-148``).

The forward is the port's eval forward (``models.api.forward``, its hand
kernels on the card) over batches of one static envelope; the decoder is
the port's native engine (``decoding/lm_decoder.py``); the LLM rescorer is
``decoding/llm_engine.py`` (``--llmBackend engine``, every OPT checkpoint;
``decoding/torch_lm.py`` for GPT-2) or ``transformers``
(``--llmBackend hf``). A checkpoint the engine cannot take raises, naming
``--llmBackend hf``.

Usage:
    nsd-eval-competition-torch --modelPath RUN_DIR --datasetPath PICKLE \\
        --lexicon LEX --lm ARPA [--llmPath OPT_DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import time
import warnings

import numpy as np
import torch

from ..data.formatter import clean_transcription  # single normalization source

COMPETITION_DAY_IDXS = [4, 5, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 18, 19, 20]


def collect_model_outputs(model_path, dataset_path=None, dataset=None,
                          partition="competition", batch_size=16,
                          model_bundle=None, day_indices=None, device=None,
                          plain=False):
    """Run the trained model over the partition; returns the reference's
    ``rnn_outputs`` structure (logits, logitLengths, trueSeqs,
    transcriptions) and ``forward_seconds``.

    ``model_bundle`` (a model of ``models.api``) skips the run-dir load,
    which otherwise is ``training.trainer.load_model`` on ``device`` (the
    run's own device by default, ``"cuda"`` unless it says otherwise).
    ``plain`` runs the kernels' plain versions.

    ``day_indices`` explicitly maps each partition day to its
    day-specific-layer slot. Default (None) applies the reference's
    competition-calendar heuristic (``COMPETITION_DAY_IDXS``) when it
    fits — with a warning, since a non-reference dataset that happens to
    satisfy the gate would silently get the wrong day embeddings."""
    from ..data.batching import choose_envelope, eval_batches
    from ..data.dataset import load_pickle_dataset, pack_days
    from ..models.api import forward
    from ..training.trainer import load_model

    raw = dataset if dataset is not None else load_pickle_dataset(dataset_path)
    if model_bundle is not None:
        model = model_bundle
    else:
        model, _ = load_model(model_path, len(raw["train"]), device=device)
    dev = next(model.parameters()).device

    day_list = raw[partition]
    n_train_days = len(raw["train"])
    if day_indices is not None:
        if len(day_indices) != len(day_list):
            raise ValueError(
                f"day_indices has {len(day_indices)} entries for "
                f"{len(day_list)} partition days"
            )
        day_idxs = list(day_indices)
    elif (
        partition == "competition"
        and len(day_list) <= len(COMPETITION_DAY_IDXS)
        and max(COMPETITION_DAY_IDXS[: len(day_list)], default=0) < n_train_days
    ):
        # Reference mapping: competition hold-out days index into the full
        # 24-day training calendar (eval_competition.py:45-47). Only valid
        # when the model actually has those day slots — and only CORRECT
        # for the reference's competition pickle; warn so a non-reference
        # dataset that happens to fit the gate doesn't silently evaluate
        # with the wrong day embeddings.
        day_idxs = COMPETITION_DAY_IDXS[: len(day_list)]
        warnings.warn(
            f"Applying the reference competition day mapping "
            f"{day_idxs} for {len(day_list)} partition days over a "
            f"{n_train_days}-day training calendar; pass day_indices= "
            f"(CLI: --dayIndices) if this dataset is not the reference "
            f"competition pickle.",
            stacklevel=2,
        )
    else:
        day_idxs = list(range(len(day_list)))

    outputs = {"logits": [], "logitLengths": [], "trueSeqs": [], "transcriptions": []}
    t_forward = time.time()
    # One static (T, U) envelope across the whole partition: every batch
    # has one shape.
    t_max, u_max = choose_envelope(pack_days(day_list), time_multiple=128)
    for pos, true_day in zip(range(len(day_list)), day_idxs):
        ds = pack_days([day_list[pos]])
        for batch in eval_batches(ds, batch_size, t_max, u_max):
            x, days, x_lens = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                batch.x, np.full_like(batch.days, true_day), batch.x_lens))
            with torch.no_grad():
                log_probs, out_lens, _ = forward(model, x, days, x_lens, plain=plain)
            log_probs = log_probs.cpu().numpy()
            out_lens = out_lens.cpu().numpy()
            for i in range(len(batch.weight)):
                if batch.weight[i] == 0:
                    continue
                outputs["logits"].append(log_probs[i, : out_lens[i]])
                outputs["logitLengths"].append(int(out_lens[i]))
                outputs["trueSeqs"].append(np.asarray(batch.y[i, : batch.y_lens[i]]))
        for tr in day_list[pos]["transcriptions"]:
            outputs["transcriptions"].append(clean_transcription(tr))
    outputs["forward_seconds"] = time.time() - t_forward
    return outputs


def run_pipeline(
    outputs: dict,
    *,
    lexicon_path: str | None,
    arpa_path: str | None,
    acoustic_scale: float = 0.5,
    blank_penalty: float = math.log(7),
    nbest: int = 100,
    beam: float = 18.0,
    lm_weight: float = 1.0,
    oov_cost: float | None = None,
    llm_scorer=None,
    alpha: float = 0.5,
    length_penalty: float = 0.0,
    return_ci: bool = True,
    verbose: bool = True,
    n_threads: int = 0,
) -> dict:
    """Beam+LM decode each utterance, rescore n-best, compute WER/CER/PER."""
    from ..ops.decode import edit_distance
    from .lm_decoder import build_lm_decoder, lm_decode_batch
    from .rescore import evaluate_transcripts, rescore_nbest

    decoder = build_lm_decoder(
        lexicon_path, arpa_path, acoustic_scale, nbest, beam,
        lm_weight=lm_weight, oov_cost=oov_cost,
    )
    start = time.time()
    # One padded [N, T_max, K] batch; the native engine decodes utterances
    # OpenMP-parallel (the reference's loop is strictly serial —
    # eval_competition.py:110-119).
    logits = outputs["logits"]
    n = len(logits)
    t_lens = np.asarray([lp.shape[0] for lp in logits], np.int32)
    t_max = int(t_lens.max()) if n else 0
    padded = np.zeros((n, t_max, logits[0].shape[-1] if n else 41), np.float32)
    for i, lp in enumerate(logits):
        padded[i, : lp.shape[0]] = lp
    nbest_lists = lm_decode_batch(
        decoder, padded, t_lens, blank_penalty=blank_penalty, n_threads=n_threads,
    )
    beam_seconds = time.time() - start
    per_sample = beam_seconds / max(len(outputs["logits"]), 1)
    if verbose:
        print(f"beam decoding took {per_sample:.4f} seconds per sample")

    # Phoneme error rate of the top hypothesis (pre-rescore).
    dist = total = 0
    for nb, true_seq in zip(nbest_lists, outputs["trueSeqs"]):
        hyp = nb[0].phones if nb else []
        dist += edit_distance(np.asarray(true_seq), np.asarray(hyp))
        total += len(true_seq)
    per = dist / max(total, 1)

    # Pre-rescore top-1 word error rate: the WFST's own best hypothesis,
    # before the LLM pass — the baseline the rescoring win is measured
    # against (the reference only reports the post-rescore number).
    top1 = [" ".join(nb[0].words) if nb else "" for nb in nbest_lists]
    top1_result = evaluate_transcripts(outputs["transcriptions"], top1, return_ci=False)

    t_rescore = time.time()
    decoded = rescore_nbest(nbest_lists, llm_scorer, alpha=alpha,
                            length_penalty=length_penalty)
    rescore_seconds = time.time() - t_rescore
    result = evaluate_transcripts(outputs["transcriptions"], decoded, return_ci=return_ci)
    return {
        "cer": result.cer,
        "wer": result.wer,
        "per": per,
        "wer_top1": top1_result.wer,
        "cer_top1": top1_result.cer,
        "cer_ci": result.cer_ci,
        "wer_ci": result.wer_ci,
        "decoded_transcripts": result.decoded_transcripts,
        "nbest": nbest_lists,
        "decode_seconds_per_sample": per_sample,
        "beam_seconds": beam_seconds,
        "rescore_seconds": rescore_seconds,
        "forward_seconds": outputs.get("forward_seconds"),
    }


def _llm_config(llm_path: str) -> dict | None:
    """The checkpoint's ``config.json``, or None when it has none."""
    cfg_path = os.path.join(llm_path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return json.load(f)


def _is_opt(cfg: dict | None) -> bool:
    """OPT family by ``model_type``, or by ``architectures`` (older HF
    exports omit ``model_type``)."""
    if cfg is None:
        return False
    archs = " ".join(cfg.get("architectures") or []).lower()
    return cfg.get("model_type", "").lower() == "opt" or "opt" in archs


def _is_large_opt(llm_path: str, threshold: float = 1e9) -> bool:
    """True when the checkpoint is an OPT-family model over ~1B params —
    the scale where ``--llmDtype int8`` applies (the reference's 8-bit
    OPT-6.7B setting).

    A missing config.json returns False quietly, but an unreadable/odd
    config warns before answering False."""
    try:
        c = _llm_config(llm_path)
        if not _is_opt(c):
            return False
        d, ffn = c["hidden_size"], c["ffn_dim"]
        est = c["num_hidden_layers"] * (4 * d * d + 2 * d * ffn)
        return est > threshold
    except Exception as e:
        warnings.warn(
            f"could not size the LLM checkpoint at {llm_path} "
            f"({type(e).__name__}: {e}); assuming small",
            stacklevel=2,
        )
        return False


def make_llm_scorer(llm_path: str, backend: str = "engine", llm_dtype: str = "bf16",
                    device: str = "cuda"):
    """The rescorer of ``--llmBackend``: ``engine`` scores OPT checkpoints
    (any size; int8 weights when ``llm_dtype`` is ``int8`` and the model is
    over ~1B parameters) with ``llm_engine.engine_scorer``, which needs no
    ``transformers``, and other families with ``torch_lm.torch_causal_scorer``
    (GPT-2; reads the checkpoint through ``transformers``); ``hf`` runs the
    checkpoint in ``transformers`` (``rescore.hf_causal_scorer``)."""
    if backend == "hf":
        from .rescore import hf_causal_scorer

        return hf_causal_scorer(llm_path, device=device)
    try:
        if _is_opt(_llm_config(llm_path)):
            from .llm_engine import engine_scorer

            return engine_scorer(
                llm_path, quantize=llm_dtype == "int8" and _is_large_opt(llm_path),
                device=device)
        from .torch_lm import torch_causal_scorer

        return torch_causal_scorer(llm_path, device=device)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"the engine backend cannot score {llm_path} ({e}); pass --llmBackend hf "
            "to run it in transformers") from e


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--modelPath", required=True)
    parser.add_argument("--datasetPath", required=True)
    parser.add_argument("--partition", default="competition")
    parser.add_argument("--lexicon", default=None)
    parser.add_argument("--lm", default=None, help="ARPA LM path")
    parser.add_argument("--llmPath", default=None,
                        help="local HF causal-LM checkpoint for rescoring")
    parser.add_argument("--llmBackend", default="engine", choices=("engine", "hf"),
                        help="rescoring engine: 'engine' runs the checkpoint "
                             "in this package's forward on the device (OPT "
                             "through the streamed engine, GPT-2 through "
                             "torch_lm; default); 'hf' runs it in transformers")
    parser.add_argument("--llmDtype", default="bf16", choices=("bf16", "int8"),
                        help="weight precision for >1B-param OPT rescoring "
                             "(int8 mirrors the reference's 8-bit OPT-6.7B "
                             "setting and halves the weight bytes)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model's forward and the LLM run")
    parser.add_argument("--acousticScale", type=float, default=0.5)
    parser.add_argument("--blankPenalty", type=float, default=math.log(7))
    parser.add_argument("--nbest", type=int, default=100)
    parser.add_argument("--beam", type=float, default=18.0)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--oovCost", type=float, default=None,
                        help="per-phone OOV fallback score (e.g. -4.0); "
                             "unset = lexicon-strict decoding")
    parser.add_argument("--decodeThreads", type=int, default=0,
                        help="OpenMP threads for batched decode (0 = all)")
    parser.add_argument("--dayIndices", default=None,
                        help="comma-separated day-layer slot per partition "
                             "day (overrides the reference competition-"
                             "calendar heuristic)")
    args = parser.parse_args(argv)

    day_indices = (
        [int(s) for s in args.dayIndices.split(",")] if args.dayIndices else None
    )
    outputs = collect_model_outputs(
        args.modelPath, args.datasetPath, partition=args.partition,
        day_indices=day_indices, device=args.device,
    )
    llm_scorer = None
    if args.llmPath:
        llm_scorer = make_llm_scorer(args.llmPath, args.llmBackend, args.llmDtype,
                                     args.device)
    elif args.lm:
        from .lexicon import ArpaLM
        from .rescore import ngram_scorer

        llm_scorer = ngram_scorer(ArpaLM.from_file(args.lm))

    result = run_pipeline(
        outputs,
        lexicon_path=args.lexicon,
        arpa_path=args.lm,
        acoustic_scale=args.acousticScale,
        blank_penalty=args.blankPenalty,
        nbest=args.nbest,
        beam=args.beam,
        oov_cost=args.oovCost,
        llm_scorer=llm_scorer,
        alpha=args.alpha,
        n_threads=args.decodeThreads,
    )
    print(result["cer"], result["wer"])
    print(
        f"wall-clock breakdown: forward {result['forward_seconds']:.1f}s, "
        f"beam {result['beam_seconds']:.1f}s, "
        f"rescore {result['rescore_seconds']:.1f}s; "
        f"top-1 WER {result['wer_top1']:.4f} -> rescored {result['wer']:.4f}"
    )
    out = {k: v for k, v in result.items() if k != "nbest"}
    with open(os.path.join(args.modelPath, "llm_out"), "wb") as f:
        pickle.dump(out, f)
    with open(os.path.join(args.modelPath, "5gramLLMCompetitionSubmission.txt"), "w") as f:
        for line in result["decoded_transcripts"]:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
