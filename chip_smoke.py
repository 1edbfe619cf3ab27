#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving path and its training path
(``neural_speech_decoder_tpu_torch``) at the full width of
``neural_speech_decoder_tpu/configs/gru_baseline.yaml`` and of the Conformer
(``configs/conformer.yaml``, bench.py's ``CONFORMER_ARGS``) with seeded
random weights:

1. Device: requires CUDA, prints the card's name and power limit, the torch
   and CUDA versions, and builds the kernels from ``csrc/``.
2. Serving kernels: the frontend and the inference scan against their plain
   PyTorch versions on the card at the serving path's shapes, in float32
   and bfloat16, with the max abs error, the tolerance, and both times. The
   bfloat16 frontend runs on the tensor-core body (``tc``, reruns
   bit-equal), timed in turns with its plain version beside PR 1's FMA body
   (``body="fma"``, also held against the plain version); the float32 one
   on the ``f32`` body (``gemm_f32.cuh``'s tile), reruns bit-equal and bit
   for bit equal to the FMA body, timed in turns with it and the plain
   version (the kernels line's ``frontend_f32`` row). The
   scan runs on the persistent body in both dtypes (reruns bit-equal),
   timed in turns with its plain version, beside the step body at the
   same shapes (held against the plain version too) and cuDNN's
   bidirectional layer in the same dtype (``torch.nn.GRU``, context: it
   also does the input projection).
3. Serving: ``InferenceModel`` answers 3 float32 requests of random
   trials (pad -> forward -> greedy decode); checks finite log-probs, empty
   decodes for padded rows, the kernels' launch counts, and the float32
   logits against the same model run through the plain versions; prints
   the median request latency and sequences per second; then the float32
   request A/B'd in turns against the same code forced onto the step body
   (``scan_body("step")``), 3 requests a turn, with each arm's median, and
   against the first frontend body (``frontend_body("fma")``) in
   ``FRONT_AB_TURNS`` turns of one request an arm (responses bit-equal).
   Then one request in the recipe's bfloat16 compute, with the same checks.
4. Training kernels: the gates-storing scan, the scan's backward and the
   CTC alpha and beta recursions against their plain versions at the train
   step's shapes (L=313, B=64, H=1024, U=64), in float32 and bfloat16, with
   errors, tolerances and times; ``F.ctc_loss`` timed as the CTC rows'
   library call; the CTC recursions run on the prefetch body, bit for bit
   equal to PR 2's block body (``body="block"``, also held against the
   plain versions and timed beside it). The scans run on the persistent
   bodies in both dtypes (reruns bit-equal); the backward's dW_hh
   contraction alone (bf16 on the tensor cores, float32 on
   ``gemm_f32.cuh``'s FMA tile) against its plain version; the step
   bodies in both dtypes against the plain versions and timed beside them,
   with cuDNN's layer forward + backward in each dtype; the float32
   backward's device time by part (recurrence, contraction) on both bodies.
5. Train step: ``make_train_step`` at bench.py's shapes and ``GRU_ARGS``
   (B=64, T=1280, U=64, bfloat16, dropout and noise on): 2 warm-up and 10
   timed steps, the median step time and seq/s, a finite loss, moved
   parameters, the launches per step; then one float32 step without noise
   and dropout whose every gradient leaf is checked against the plain path,
   and one bf16 step and one eval batch each with ``use_pallas: false`` and
   ``ctc_use_kernel: false`` held against the default path (the switched
   kernels launch no time); then the float32 eval batch A/B'd against the
   first frontend body as the request is (outputs bit-equal).
6. ``train_model`` at full width on the port's synthetic dataset (20 steps,
   evals and checkpoints every 10), then ``load_model``, an eval pass
   (checked to launch the frontend, the inference scan and alpha, and not
   beta) and a greedy decode.
7. Attention kernels: the forward, the backward (dqkv) and the dropout masks
   against their plain versions at B=64, T'=313, H=8, dh=128 in float32 and
   bfloat16 (float32 also at dh=64), at dropout rates 0 and 0.3 (masks
   bit-equal), and once each with a band (``left_context=128``),
   interleaved qkv columns, T'=1250 and a row of length 0; forward and
   backward reruns bit-equal, every launch counted on the dtype's body
   (bf16 ``tc``, the tensor cores; float32 ``f32``, the redesigned FMA body,
   its backward from ``mhsa_qkv_residuals``' out and stats and once
   forming them itself); the older float32 body (``body="fma"``) held against
   the plain versions too. Times: the bf16 kernels in turns with the plain
   versions; the float32 ``f32`` body in turns with the older one (plain, fma,
   f32, f32, fma, plain); ``F.scaled_dot_product_attention`` (forward and
   backward) as the library yardstick, in both dtypes; the bounds. The
   sha256 of the bf16 forward's and backward's outputs on numpy-seeded
   inputs equal to the pin taken before the float32 redesign. The kernels
   line has the bf16 rows and the f32 body's own (``mhsa_qkv_f32``,
   ``mhsa_qkv_bwd_f32``).
8. Conformer train step at ``CONFORMER_ARGS`` (8 blocks, D=1024, bfloat16,
   label smoothing, InterCTC, AdamW; B=64, T=1280, U=64): 2 warm-up and 10
   timed steps, median and seq/s, 8 attention forward and backward (on the
   ``tc`` body), 2 CTC alpha and beta launches per step; one float32 step
   (dropout, DropPath, SpecAugment and noise on: both paths draw the same
   bits) whose every gradient leaf is checked against the plain path, its
   attention on the ``f32`` body; two bf16 runs of two steps from one seed,
   bit-equal. Then the float32 step A/B (``attention_body``): 2 warm-up
   steps, then 3 timed steps a turn in turns fma, f32, f32, fma (every
   float32 attention on the older ``fma`` bodies, then on ``f32``), with each
   arm's median.
9. ``train_model`` of the Conformer at full width (10 steps, evals and
   checkpoints every 5), ``load_model``, an eval pass that re-scores the
   best PER exactly (8 attention launches per eval batch), a greedy decode.
10. Fused FF and conv-module kernels (``fused_ffn``, ``fused_conv``): the
    forward and backward of each and the FF's dropout masks against their
    plain versions at B=64, T'=313, D=1024, F=2048, k=31 in float32 and
    bfloat16, at rates 0 and 0.3 (masks bit-equal), and a causal conv;
    times of kernel, plain version and the unfused module (forward and
    backward) as the yardstick, and the bounds. The four wrappers' launches
    by body: every bfloat16 forward and backward on the sm90 body (TMA +
    wgmma), every float32 forward and backward on the f32 body
    (``gemm_f32.cuh``'s pipelined FP32 tile); the bf16 sm90 and the float32
    f32 forwards' and backwards' reruns bit-equal; the sha256 of the bf16
    sm90 and the float32 f32 backwards' outputs on numpy-seeded inputs
    pinned; the tile body (``body="tile"``) at rate 0.3, centred and causal
    conv, against the plain versions at the dtype's tolerance, forward and
    backward; in each dtype the tile body timed in turns
    with the default one (tile, default, default, tile), the device time of
    one call of each by kernel and by stage
    (``training/profile.py::device_split``), and, as context, the products
    of each forward and backward as one ``torch.mm`` each at their shapes
    (bf16 ``out_dtype=float32``; float32 cuBLAS SGEMM, TF32 off). The
    forwards' and backwards' rows in the kernels line report bfloat16; the
    f32 body's own rows (``ffn_f32``, ``ffn_bwd_f32``, ``conv_module_f32``,
    ``conv_module_bwd_f32``) float32. The workspace bytes of each body.
11. The bf16 Conformer train step with both fused flags: 2 warm-up and 10
    timed steps, median and seq/s beside phase 8's default step, 16 FF and 8
    conv forward and backward launches per step (every one on the sm90
    body); one float32 step (randomness on) checked leaf by leaf against the
    plain path (its forwards and backwards on f32); two
    bf16 runs of 2 steps from one seed bit-equal; one eval forward launching
    16 FF and 8 conv forwards on the sm90 body and no backward. Then two
    float32 fused step A/Bs: 2 warm-up steps, then 3 timed steps a turn in
    turns tile, f32, f32, tile, first of the backwards (``fused_bwd_body``:
    every float32 fused backward on the tile body, then on f32, the
    forwards on f32), then of the forwards (``fused_fwd_body``, the
    backwards on f32), whose turns also time float32 eval forwards of the
    fused model (B=64, T=1280) with their launches by body; each arm's
    median beside phase 8's unfused float32 step's.
12. The GRU's opt-in kernels (``fused_optimizer``, ``use_pallas_matmul``):
    the projection matmul in its three layouts (``nn`` with the bias, ``nt``,
    ``tn``) at M=B*L=20032, K=2048, N=6144 and at a ragged M=1001, and Adam
    over the GRU's 24 leaves (133,845,033 parameters), against their plain
    versions in float32 and bfloat16, with errors, tolerances, times of
    kernel, plain version and ``torch.mm`` / ``torch.optim.Adam(fused=True)``
    as the library yardsticks, and the bounds; reruns bit-equal. The
    matmul's launches are counted by body: every bf16 product on the sm90
    body (TMA + wgmma), every float32 one on the f32 body (the pipelined
    FMA tile), and a bf16 product with K=2044 (a row stride TMA cannot read)
    on the tile body; kernel / ``torch.mm`` for each layout and dtype.
13. The bf16 GRU train step with both flags (``BENCH_ARGS`` + the flags): 2
    warm-up and 10 timed steps, median and seq/s beside phase 5's, 12
    matmul (all on the sm90 body) and 1 Adam launches per step; one float32
    step without noise and dropout (kernel path vs plain path: every
    gradient leaf and every parameter after the update; its 12 projections
    on the f32 body); two seeded bf16 runs of 2 steps bit-equal.
    Then the float32 GRU step at full width, default and flagged (2 warm-up
    steps, then 3 timed steps a turn in turns step, plan, plan, step: the
    scans forced onto the step body, then on ``scan_plan``'s body; the
    flagged one's 12 projections a step on the f32 body), with each arm's
    median and the flagged / default ratio.
14. ``nsd-train`` end to end: ``training/cli.py::main`` on
    ``configs/gru_baseline.yaml`` with a pickled synthetic dataset at C=256,
    20 steps, evals and checkpoints every 10, the three flags
    (``deviceResidentData`` too) and a profile window over steps 12-14: both
    new kernels launched as counted, the trace written with them, the
    device-assembled batches bit-equal to the host's, then ``load_model`` ->
    eval -> greedy decode.
15. Streaming (``neural_speech_decoder_tpu_torch/streaming``), at the
    widths of ``configs/gru_streaming.yaml`` (5 unidirectional layers) and of
    the Conformer with ``causal=True`` and a 128-frame left context
    (``serving/profile.py::STREAM_GRU`` / ``STREAM_CONFORMER``): a float32
    utterance of each streamed in 4-bin chunks against the offline forward
    (``models.api.forward``, the kernel path) within 1e-4 of its largest
    |log-prob|, the streamed length (T - k) // s; the unidirectional GRU's
    bf16 offline forward (the dirs=1 persistent scan) against its plain
    path; in bf16, 20 steady chunks replayed as CUDA graphs bit-equal to
    the eager step (outputs and carried state); the B=1 latency a chunk
    (host p50 with a sync each, device time of 50 chained chunks, the eager
    path's beside them) with the bytes bound; the capacity sweeps with the
    W=8 on-device beam chained (GRU B up to 512, Conformer up to 256, best
    of 3 windows, the largest B under 80 ms); ``prefix_beam_search`` on the
    card against chained ``beam_extend`` and against the CPU. No hand
    kernel launches during any streamed chunk (the launch counters stay 0).
16. Export (``serving/export.py``): ``nsd-export-torch`` of phase 14's GRU
    run (``use_pallas_matmul``, as its eval) and phase 9's Conformer run (and of a copy of it with
    ``fused_ffn``/``fused_conv``) at B=64, T=1280, each artifact loaded with
    ``load_exported`` and served phase 3's three requests: log-probs and
    lengths bit-equal to the eager ``InferenceModel`` (else within
    ``LOGITS_TOL``), launches exact (1 frontend on ``tc`` + 5 scans on
    ``persistent`` + 4 projection matmuls on ``sm90``; 8 attention on
    ``tc``; + 16 FF and 8 conv on ``sm90``, a request) and counted in the kernels line, then 21 requests of each
    server in turns, host ms split into pad, forward and decode; then both
    bf16 streaming cells exported with beam programs (B=1, a frame a
    chunk) and driven by ``ExportedStreamer`` against the live streamer
    over one utterance (outputs bit-equal, else within twice the live bf16
    stream's distance from float32; greedy and beam decodes equal; no hand
    kernel), and the host p50 of a chunk beside the live graph's. It
    removes phases 9 and 14's run directories.
17. The competition decode (``decoding/``; lines start ``competition``),
    run before phase 16 on phases 9 and 14's run directories: (a)
    ``eval_competition.collect_model_outputs`` of the GRU run (bf16,
    ``use_pallas_matmul``) and of the Conformer run, as trained and with
    ``fused_ffn``/``fused_conv``, over a synthetic partition of 2 days of
    400-1200 bins in batches of 16: launches a batch exact (1 frontend on
    ``tc`` + 5 scans on ``persistent`` + 4 matmuls on ``sm90``; 8 attention
    on ``tc``; + 16 FF and 8 conv on ``sm90``), no backward or CTC kernel,
    every row against the same call through the plain versions within
    phase 3's bf16 rule, ``forward_seconds``; (b) the native decoder built
    from ``csrc/ctc_beam.cpp`` (``g++ -fopenmp``), ``lm_decode_batch`` at
    nbest 100, beam 18 over (a)'s outputs with a lexicon and ARPA the smoke
    writes (an n-best for every utterance, ms a sample), and 8 utterances
    against ``force_python=True``; (c) the LLM engine at OPT-6.7B shapes on
    weights drawn on the card, bf16 and int8: sequences/s over 2,000
    sequences, peak memory and the bound, bf16 against the float32 engine
    on the same weights (all layers), and the top-1 of 100 n-best lists
    under ``quantize_int8`` of the bf16 weights against bf16's; (d)
    ``run_pipeline`` on a constructed-ambiguity set (homophone decoys, a
    flattened noisy ARPA, log-probs from the true phones plus noise) with
    a bigram OPT rescorer from its ``pytorch_model.bin`` at 125m shapes and
    the same bigram built in memory at 6.7B shapes (rescored WER below 0.8 x
    the top-1 WER, and the top-1 WER above 0.05), then
    ``nsd-eval-competition-torch`` on phase 14's run (``llm_out`` and a
    submission line for each trial). Runs with none of ``transformers``,
    ``tokenizers`` or ``safetensors`` installed.
18. The research workflow (lines start ``workflow``), run before phase 16
    on phase 9's run directory: (a) two synthetic sessions in the
    competition's ``.mat`` layout (``train/``, ``test/``, one
    ``competitionHoldOut/``; 100/20/20 trials of 400-1200 bins, ``tx1`` and
    ``spikePow`` of 256 columns, 4 blocks) through
    ``data/formatter.py::format_competition_data`` with a g2p over the
    smoke's lexicon: the schema, every block's z-scored columns, the labels
    against the lexicon; (b) ``nsd-train-torch -m --jobs 2
    lrStart=0.01,0.02`` on ``configs/gru_baseline.yaml`` at full width
    (bf16, B=64) on the formatted pickle, 11 steps and evals at 0 and 10:
    both jobs done under their override dirnames, ``sweep_summary.json``
    ranked by best CER, the kernel library loaded as built (no rebuild),
    the two workers' steps overlapping in time and each worker's launches
    exact by body (from the spans and counts its trainer records in
    metrics.jsonl), each job's per-step losses and launches equal to its
    overrides run alone in a process of their own, a spawn worker pinned by
    ``slice_env`` before its first CUDA call; the sweep's wall seconds
    beside the two jobs one after the other, and each job's step span in
    the sweep beside its span alone; (c) the best job and phase 9's
    Conformer exported by ``models/torch_export.py::main`` (contiguous
    float32 CPU tensors): the GRU loaded with ``strict=True`` into
    ``ReferenceGRUDecoder`` (``torch.nn`` only) whose cuDNN float32 forward
    over phase 3's requests is held against the port's float32 eval
    forward (``REF_TOL`` of the largest |logit|), the Conformer's keys and
    shapes against ``ReferenceConformerLayout``; each imported back with
    ``models/torch_import.py::load_checkpoint``: trees bit-equal to
    ``load_model``'s, a bf16 request bit-equal with exact launches (1
    frontend on ``tc`` + 5 scans on ``persistent``; 8 attention on ``tc``).
    (b)'s workers' launches and (c)'s count in the kernels line.
19. Data parallelism (lines start ``dp``), run before phase 16, at the
    GRU recipe's full width on ``train_model_phase``'s synthetic trials:
    (a) 6 bf16 steps in a one-rank nccl group
    (``parallel/multihost.py::initialize``) against the same run with no
    group, every per-step loss bit-equal; (b) 3 float32 steps on two gloo
    ranks of the one card (``parallel/data_parallel.py::launch``, each
    rank calling ``train_model`` in the group) against one rank: step-0
    loss within ``DP_LOSS_TOL[0]``, later steps within ``DP_LOSS_TOL[1]``,
    each parameter leaf's two updates within ``DP_PARAM_TOL`` in L2, each
    rank's launches by body (from the run's last metrics.jsonl record)
    exact for the bodies ``scan_plan`` picks at B/2 rows; (c) the same for
    the float32 Conformer with ``fused_ffn``/``fused_conv``, depth cut to
    ``DP_CONFORMER_LAYERS`` blocks, the kernels' dropout 0, its backwards
    on the f32 body; (d) with two
    cards or more, (b) over nccl on two cards (``n_data_devices: 2``),
    else one line saying it did not run. The ranks' launches count in the
    kernels line.
20. Tensor parallelism (lines start ``tp``), run after phase 19, on the
    same trials at full width, B=16, 3 steps: two gloo model ranks on the
    one card (``n_model_devices: 2``; all three runs in one ``launch``)
    against one rank: (a) the float32 GRU, 2 layers, ``use_pallas_matmul``
    and ``fused_optimizer`` (the projection matmul on the rank's
    contraction rows, Adam on its shard leaves, the scan whole); (b) the
    float32 Conformer with ``fused_conv``, 2 blocks, the kernels' dropout
    0, the attention kernel on 4 of 8 heads a rank; (c) the same in
    bfloat16. (a)/(b): losses within ``TP_LOSS_TOL``, each leaf's update
    within ``DP_PARAM_TOL`` in L2 (from the ranks' whole checkpoint, the
    Conformer's de-interleaved); (c): losses within ``TP_BF16_LOSS_TOL``;
    every rank's launches by body exact. (d) with two cards or more, (a)
    over nccl on two cards, else one line saying it did not run. The
    ranks' launches count in the kernels line.
21. Tensor-parallel rescoring and the multichip dryrun (lines start
    ``tpllm``), run after phase 20: the LLM engine at OPT-6.7B shapes on
    random weights drawn on the card, two gloo model ranks on the one card
    (a 1x2 grid) against this process's one-rank engine on the same
    weights, bf16 and int8: (a) each rank draws only its shards
    (``synth_params_on_device(shardings=, mesh=)``), whose sha256 per
    leaf equals that of the same slice of the one-rank tree, with its
    seconds and peak memory; (b) bf16 and (c) int8 log-probs of 8 batches
    of ``LLM_BATCH`` sentences (``params_scorer(mesh=)``) within
    ``LLM_TOL`` relative of one rank's, the largest difference, top-1
    agreement over the whole n-best lists, seq/s; (d)
    ``parallel/dryrun.py::dryrun_multichip(2)`` on the card, every rank's
    launches by body exact in every stage (into the kernels line); (e)
    with two cards or more, (b) over nccl on two cards, else one line
    saying it did not run.
The default GRU and Conformer phases check that the fused kernels and the
GRU's opt-in kernels launch no time there. Every GRU phase checks the scan
launches by body: all bfloat16 scans at full width on the persistent body,
all float32 ones on the body ``scan_plan`` picks (the persistent one on an
H100), those of an A/B's step turns on the step body; every phase that counts launches checks
the frontend's (``tc`` for bfloat16, ``f32`` for float32) and every CTC
recursion's (the prefetch body). Each phase prints its seconds.

Run from the repository root:  python3 chip_smoke.py
It imports no jax. It exits non-zero without a result when there is no
CUDA device or any check fails; otherwise its last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import multiprocessing as mp
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.io
import torch

from neural_speech_decoder_tpu_torch.data.batching import choose_envelope
from neural_speech_decoder_tpu_torch.data.batching import eval_batches, sample_batch
from neural_speech_decoder_tpu_torch.data import formatter
from neural_speech_decoder_tpu_torch.data.dataset import pack_days
from neural_speech_decoder_tpu_torch.data.formatter import clean_transcription
from neural_speech_decoder_tpu_torch.data.device_data import DeviceData
from neural_speech_decoder_tpu_torch.data.phonemes import PHONE_DEF
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.decoding import (
    bigram_opt,
    eval_competition,
    llm_engine,
    lm_decoder,
)
from neural_speech_decoder_tpu_torch.decoding.ondevice_beam import (
    beam_extend,
    beam_finalize,
    beam_init,
    prefix_beam_search,
)
from neural_speech_decoder_tpu_torch.models.api import build_model
from neural_speech_decoder_tpu_torch.models.api import forward as model_forward
from neural_speech_decoder_tpu_torch.models import conformer as port_conformer
from neural_speech_decoder_tpu_torch.models.common import orthogonal, uniform_bound
from neural_speech_decoder_tpu_torch.models.gru import GRUConfig, GRUDecoder, init_gru_params
from neural_speech_decoder_tpu_torch.models.torch_export import main as export_main
from neural_speech_decoder_tpu_torch.models.torch_import import load_checkpoint
from neural_speech_decoder_tpu_torch.ops.ctc import ctc_loss
from neural_speech_decoder_tpu_torch.ops.decode import greedy_decode
from neural_speech_decoder_tpu_torch.ops.kernels import _build
from neural_speech_decoder_tpu_torch.ops.kernels import attention as attention_mod
from neural_speech_decoder_tpu_torch.ops.kernels.adam import (
    adam_scalars,
    adam_update,
    adam_update_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.attention import (
    dropout_masks,
    dropout_masks_plain,
    mhsa_qkv,
    mhsa_qkv_bwd,
    mhsa_qkv_bwd_plain,
    mhsa_qkv_plain,
    mhsa_qkv_residuals,
)
from neural_speech_decoder_tpu_torch.ops.kernels.conv_module import (
    conv_module,
    conv_module_bwd,
    conv_module_bwd_plain,
    conv_module_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.ctc import (
    ctc_alpha,
    ctc_alpha_plain,
    ctc_beta,
    ctc_beta_plain,
    prepare,
)
from neural_speech_decoder_tpu_torch.ops.kernels import ffn as ffn_mod
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    BwdPlan,
    ffn,
    ffn_bwd,
    ffn_bwd_plain,
    ffn_dropout_masks,
    ffn_dropout_masks_plain,
    ffn_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels import frontend as frontend_mod
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    frontend_plan,
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels import gru_scan as gru_scan_mod
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    bwd_recurrence_plain,
    gru_sequence,
    gru_sequence_bwd,
    gru_sequence_bwd_plain,
    gru_sequence_gates,
    gru_sequence_gates_plain,
    gru_sequence_plain,
    dw_contraction,
    scan_plan,
    hh_grads_plain,
    scan_backward,
    scan_forward,
)
from neural_speech_decoder_tpu_torch.ops.kernels.matmul import (
    tiled_matmul,
    tiled_matmul_plain,
)
from neural_speech_decoder_tpu_torch.parallel import data_parallel as dp
from neural_speech_decoder_tpu_torch.parallel import multihost, sweep
from neural_speech_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
from neural_speech_decoder_tpu_torch.parallel.mesh import make_mesh
from neural_speech_decoder_tpu_torch.parallel.shardings import deinterleave_attention_params
from neural_speech_decoder_tpu_torch.parallel.tensor_parallel import ModelShard
from neural_speech_decoder_tpu_torch.serving import (
    export_beam,
    export_streaming_conformer_params,
    export_streaming_params,
    load_exported,
    load_exported_streamer,
)
from neural_speech_decoder_tpu_torch.serving import cli as serve_cli
from neural_speech_decoder_tpu_torch.serving.model import InferenceModel
from neural_speech_decoder_tpu_torch.serving.profile import (
    STREAM_CHUNK,
    make_streamer,
    stream_model,
)
from neural_speech_decoder_tpu_torch.training import cli as train_cli
from neural_speech_decoder_tpu_torch.training.checkpoints import load_args, save_args
from neural_speech_decoder_tpu_torch.training.optim import FusedAdam, lr_schedule, make_optimizer
from neural_speech_decoder_tpu_torch.training.profile import (
    BENCH_ARGS,
    CONFORMER_ARGS,
    FUSED_FLAGS,
    bench_batch,
    by_stage,
    device_split,
)
from neural_speech_decoder_tpu_torch.training.trainer import (
    _loss_and_metrics,
    batch_tensors,
    load_model,
    make_eval_step,
    make_train_step,
    run_eval,
    step_generator,
    train_model,
)
from neural_speech_decoder_tpu_torch.utils.config import override_dirname

# The serving path's shapes: B=64 trials in a T=1280 envelope, C=256
# channels, 24 days, H=1024, both directions, L=(1280-32)//4+1=313 frames.
B, T, C, N_DAYS, H, D = 64, 1280, 256, 24, 1024, 2
L = (T - 32) // 4 + 1
N_OUT = 41  # 40 phoneme classes and the CTC blank

# Max abs error allowed between a kernel and its plain version on the same
# inputs. Both accumulate in float32 but in different orders (the plain
# versions sum through cuBLAS/cuDNN), so float32 differs by rounding only.
# In bfloat16 such a difference can flip the rounding of a stored value by
# one bf16 step (2**-8 = 0.0039 just below 1.0; the outputs lie in (-1, 1)),
# and in the scan a flipped h feeds the later steps.
TOL = {
    ("frontend", "float32"): 1e-5,
    ("frontend", "bfloat16"): 1.6e-2,  # four bf16 steps near 1.0
    ("gru_scan", "float32"): 1e-4,  # 313 steps of H=1024-long sums
    ("gru_scan", "bfloat16"): 3e-2,
}
# float32 logits of the full model, kernel path vs plain path: five layers
# of 313-step scans and 6144-wide products over rounding-level differences.
LOGITS_TOL = 2e-3
# bfloat16 logits, kernel path vs plain path: each is a bf16 rounding of
# the same float32 function, so the two may differ by up to the sum of their
# distances from it. The plain bf16 path's distance from the plain float32
# path, measured on the same request, stands for each; the bound is twice it.
BF16_LOGITS_FACTOR = 2.0
# One bf16 train step (noise and dropout off), kernel path vs plain path, by
# the same rule, leaf by leaf: each gradient leaf's max abs error relative to
# its largest entry, against the plain bf16 leaf's distance from the plain
# float32 one.
BF16_GRAD_FACTOR = 2.0

# The train step's kernels, against their plain versions on the same
# inputs. The gates-storing scan shares the inference scan's arithmetic, so
# its ys tolerance is the scan's; its gates include hp_n, an H=1024-long sum
# (|hp_n| up to ~4, where one bf16 step is 2**-6 and a flipped rounding of
# h upstream moves it by a step or two). The backward's outputs are
# compared relative to each output's largest entry: float32 differs by
# summation order over 3H-long products carried 313 steps and L*B = 20032
# row sums; bfloat16 also by roundings of dhp to bf16 (2**-8 relative)
# that fall the other way. CTC alpha and beta are float32 whatever the
# input's dtype; they are compared on the live lanes (the -1e30 sentinel
# lanes must agree exactly) relative to max(1, |value|): each is a sum over
# up to 313 frames of log-adds, and the card's exp/log in the kernel and in
# torch may differ by an ulp.
TRAIN_TOL = {
    ("gru_scan_gates", "float32"): 1e-4,
    ("gru_scan_gates", "bfloat16"): 3e-2,
    ("gru_scan_gates.gates", "float32"): 1e-4,
    ("gru_scan_gates.gates", "bfloat16"): 3.125e-2,
    ("gru_scan_bwd", "float32"): 1e-4,
    ("gru_scan_bwd", "bfloat16"): 1e-2,
    ("ctc", "float32"): 1e-5,
    ("ctc", "bfloat16"): 1e-5,
}
# One float32 train step (noise and dropout off), kernel path vs plain
# path, every gradient leaf relative to its largest entry: five layers of
# recurrences and 313-step CTC recursions summed in other orders.
GRAD_TOL = 5e-4
U = 64  # labels per row in the train step (bench.py's u)

SOURCES = {
    "frontend": ("neural_speech_decoder_tpu_torch/csrc/frontend.cu",
                 "neural_speech_decoder_tpu/ops/pallas/frontend_kernel.py:56"),
    "gru_scan": ("neural_speech_decoder_tpu_torch/csrc/gru_scan.cu",
                 "neural_speech_decoder_tpu/ops/pallas/gru_scan.py:58"),
    "gru_scan_gates": ("neural_speech_decoder_tpu_torch/csrc/gru_scan.cu",
                       "neural_speech_decoder_tpu/ops/pallas/gru_scan.py:69"),
    "gru_scan_bwd": ("neural_speech_decoder_tpu_torch/csrc/gru_scan_bwd.cu",
                     "neural_speech_decoder_tpu/ops/pallas/gru_scan.py:88"),
    "ctc_alpha": ("neural_speech_decoder_tpu_torch/csrc/ctc.cu",
                  "neural_speech_decoder_tpu/ops/pallas/ctc_kernel.py:63"),
    "ctc_beta": ("neural_speech_decoder_tpu_torch/csrc/ctc.cu",
                 "neural_speech_decoder_tpu/ops/pallas/ctc_kernel.py:84"),
    "mhsa_qkv": ("neural_speech_decoder_tpu_torch/csrc/attention.cu",
                 "neural_speech_decoder_tpu/ops/pallas/attention_kernel.py:179"),
    "mhsa_qkv_bwd": ("neural_speech_decoder_tpu_torch/csrc/attention.cu",
                     "neural_speech_decoder_tpu/ops/pallas/attention_kernel.py:195"),
    "dropout_masks": ("neural_speech_decoder_tpu_torch/csrc/attention.cu",
                      "neural_speech_decoder_tpu/ops/pallas/attention_kernel.py:270"),
    "ffn": ("neural_speech_decoder_tpu_torch/csrc/ffn.cu",
            "neural_speech_decoder_tpu/ops/pallas/ffn_kernel.py:103"),
    "ffn_bwd": ("neural_speech_decoder_tpu_torch/csrc/ffn.cu",
                "neural_speech_decoder_tpu/ops/pallas/ffn_kernel.py:136"),
    "ffn_dropout_masks": ("neural_speech_decoder_tpu_torch/csrc/ffn.cu",
                          "neural_speech_decoder_tpu/ops/pallas/ffn_kernel.py:341"),
    "conv_module": ("neural_speech_decoder_tpu_torch/csrc/conv_module.cu",
                    "neural_speech_decoder_tpu/ops/pallas/conv_module_kernel.py:104"),
    "conv_module_bwd": ("neural_speech_decoder_tpu_torch/csrc/conv_module.cu",
                        "neural_speech_decoder_tpu/ops/pallas/conv_module_kernel.py:135"),
    "adam_update": ("neural_speech_decoder_tpu_torch/csrc/adam.cu",
                    "neural_speech_decoder_tpu/ops/pallas/adam_kernel.py:65"),
    "tiled_matmul": ("neural_speech_decoder_tpu_torch/csrc/matmul.cu",
                     "neural_speech_decoder_tpu/ops/pallas/matmul.py:61"),
}
KERNELS = tuple(SOURCES)
# The float32 attention's redesigned body ("f32") and the fused FF and conv
# modules' ("f32") have rows of their own in the kernels line: their
# launches by body (``launch_counts()``'s keys), summed over the float32
# main paths.
F32_ATTN = {"mhsa_qkv_f32": "mhsa_qkv/f32", "mhsa_qkv_bwd_f32": "mhsa_qkv_bwd/f32"}
F32_FUSED = {"ffn_f32": "ffn/f32", "ffn_bwd_f32": "ffn_bwd/f32",
             "conv_module_f32": "conv_module/f32", "conv_module_bwd_f32": "conv_module_bwd/f32"}
# The float32 frontend's redesigned body ("f32") likewise.
F32_FRONT = {"frontend_f32": "frontend/f32"}
F32_ROWS = {**F32_FRONT, **F32_ATTN, **F32_FUSED}
COUNTED = KERNELS + tuple(F32_ROWS.values())
# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W): HBM bytes/s,
# FP32 FMA flop/s outside the tensor cores, bf16 tensor-core flop/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the HBM
    rate and flops over the peak of the dtype's units."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, kernel, plain, reps_kernel, reps_plain) -> dict:
    """Kernel vs plain on the same inputs in float32 and bfloat16; times
    taken in turns (plain, kernel, kernel, plain) in float32."""
    row = {}
    for dtype in ("float32", "bfloat16"):
        with torch.inference_mode():
            err = (kernel(dtype).float() - plain(dtype).float()).abs().max().item()
        torch.cuda.synchronize()
        tol = TOL[(name, dtype)]
        check(err <= tol, f"{name} {dtype}: max abs err {err:.3e} <= {tol:.2g}")
        row.setdefault("max_abs_err", err)
    with torch.inference_mode():
        p1 = time_ms(lambda: plain("float32"), reps_plain)
        k1 = time_ms(lambda: kernel("float32"), reps_kernel)
        k2 = time_ms(lambda: kernel("float32"), reps_kernel)
        p2 = time_ms(lambda: plain("float32"), reps_plain)
        kb = time_ms(lambda: kernel("bfloat16"), reps_kernel)
        pb = time_ms(lambda: plain("bfloat16"), reps_plain)
    row["ms"] = (k1 + k2) / 2
    row["plain_ms"] = (p1 + p2) / 2
    print(f"time  {name} float32: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms; bfloat16: kernel {kb:.4f} ms, plain "
          f"{pb:.4f} ms", flush=True)
    return row


def kernel_phase() -> list[dict]:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, T, C), generator=g, device="cuda")
    day_w = (torch.eye(C, device="cuda")
             + 0.05 * torch.randn((N_DAYS, C, C), generator=g, device="cuda"))
    day_b = 0.1 * torch.randn((N_DAYS, C), generator=g, device="cuda")
    # -1 and 24 lie outside the table and must be clipped to 0 and 23
    day = (torch.arange(B, device="cuda") % (N_DAYS + 2) - 1).to(torch.int32)
    xs = {k: x.to(v) for k, v in dt.items()}
    fe = dict(kernel_size=20, sigma=2.0)
    front = compare(
        "frontend",
        lambda d: fused_frontend(xs[d], day_w, day_b, day, **fe),
        lambda d: fused_frontend_plain(xs[d], day_w, day_b, day, **fe),
        reps_kernel=20, reps_plain=20,
    )
    # float32: x read and the output written once, every day's matrix and
    # bias read once; the product and the 20-tap smoothing
    f32_bound = bound_ms(nbytes(x, x, day_w, day_b, day),
                         2 * B * T * C * C + 2 * fe["kernel_size"] * B * T * C, "float32")
    front32 = frontend_f32_row(xs["float32"], day_w, day_b, day, fe, f32_bound)
    # bfloat16, the recipe's compute: the tensor-core body, reruns bit-equal,
    # timed in turns with the plain version, beside PR 1's FMA body on the
    # same inputs, itself still held against the plain version
    xb = xs["bfloat16"]
    reset_launches()
    with torch.inference_mode():
        f1 = fused_frontend(xb, day_w, day_b, day, **fe)
        f2 = fused_frontend(xb, day_w, day_b, day, **fe)
        f_fma = fused_frontend(xb, day_w, day_b, day, body="fma", **fe)
        f_ref = fused_frontend_plain(xb, day_w, day_b, day, **fe)
    torch.cuda.synchronize()
    check_front_ctc_bodies("frontend bfloat16, two calls and one with body='fma'", tc=2, fma=1)
    tol = TOL[("frontend", "bfloat16")]
    err_tc = (f1.float() - f_ref.float()).abs().max().item()
    err_fma = (f_fma.float() - f_ref.float()).abs().max().item()
    check(torch.equal(f1, f2) and err_tc <= tol and err_fma <= tol,
          f"frontend bfloat16: tensor-core body max abs err {err_tc:.3e}, PR 1's FMA body "
          f"{err_fma:.3e} <= {tol:.2g}; tensor-core reruns bit-equal")
    with torch.inference_mode():
        k, p, turns = time_turns(lambda: fused_frontend(xb, day_w, day_b, day, **fe),
                                 lambda: fused_frontend_plain(xb, day_w, day_b, day, **fe),
                                 20, 20)
        fma_ms = time_ms(lambda: fused_frontend(xb, day_w, day_b, day, body="fma", **fe), 20)
    print(f"time  frontend bfloat16: tensor cores {turns[0]:.4f}/{turns[1]:.4f} ms, plain "
          f"{turns[2]:.4f}/{turns[3]:.4f} ms, PR 1's FMA body {fma_ms:.4f} ms", flush=True)
    front.update(ms=k, plain_ms=p, fma_ms=fma_ms, max_abs_err=err_tc, dtype="bfloat16")
    # x read and the output written once in bf16, W[day] (bf16) and the bias
    # read once; the product on the bf16 tensor cores and the 20-tap
    # smoothing on the float32 FMA units, other units: the longer of the two
    front["bound_ms"], front["bound_by"] = bound_ms(
        nbytes(xb, xb, day_w.to(torch.bfloat16), day_b, day), 2 * B * T * C * C, "bfloat16")
    smooth_ms = 2 * fe["kernel_size"] * B * T * C / PEAK_FLOPS["float32"] * 1e3
    if smooth_ms > front["bound_ms"]:
        front["bound_ms"], front["bound_by"] = smooth_ms, "operations"
    xp = torch.randn((L, D, B, 3 * H), generator=g, device="cuda")
    w_hh = torch.stack([orthogonal((3 * H, H), g).T for _ in range(D)])
    b_hh = uniform_bound((D, 3 * H), 1 / H**0.5, g)
    xps = {k: xp.to(v) for k, v in dt.items()}
    scan = compare(
        "gru_scan",
        lambda d: gru_sequence(xps[d], w_hh, b_hh),
        lambda d: gru_sequence_plain(xps[d], w_hh, b_hh),
        reps_kernel=3, reps_plain=2,
    )
    # float32, the JAX trainer's default: the body scan_plan picks (the
    # persistent one at these shapes), reruns bit-equal; the step body
    # at the same shapes against the plain version at the same tolerance and
    # timed beside it, and cuDNN's float32 layer as context
    x32 = xps["float32"]
    body32 = f32_scan_body()
    reset_launches()
    with torch.inference_mode():
        y1, y2 = gru_sequence(x32, w_hh, b_hh), gru_sequence(x32, w_hh, b_hh)
        y_step = scan_forward(x32, w_hh, b_hh, gates=False, plan="step")[0]
        y_ref = gru_sequence_plain(x32, w_hh, b_hh)
    torch.cuda.synchronize()
    tol = TOL[("gru_scan", "float32")]
    err32 = (y1 - y_ref).abs().max().item()
    err_step = (y_step - y_ref).abs().max().item()
    want = {"persistent": 0, "step": 1}
    want[body32] += 2
    check(torch.equal(y1, y2) and gru_sequence.launches_by_body == want
          and max(err32, err_step) <= tol,
          f"gru_scan float32: {body32} body max abs err {err32:.3e}, the step body "
          f"{err_step:.3e} <= {tol:.2g}; {body32} reruns bit-equal; launches by body "
          f"{gru_sequence.launches_by_body} == {want}")
    with torch.inference_mode():
        step32_ms = time_ms(lambda: scan_forward(x32, w_hh, b_hh, gates=False, plan="step"), 3)
    cudnn32_ms = cudnn_gru_ms(backward=False, dtype=torch.float32)
    print(f"time  gru_scan float32: {body32} {scan['ms']:.4f} ms (plain {scan['plain_ms']:.4f} "
          f"ms, in turns above), the step body {step32_ms:.4f} ms; cuDNN's float32 "
          f"bidirectional layer (projection included) {cudnn32_ms:.4f} ms", flush=True)
    f32_row = {"f32_body": body32, "f32_ms": scan["ms"], "f32_plain_ms": scan["plain_ms"],
               "f32_step_ms": step32_ms, "f32_cudnn_layer_ms": cudnn32_ms,
               "f32_max_abs_err": err32,
               "f32_bound_ms": bound_ms(nbytes(x32, w_hh, b_hh) + x32.numel() // 3 * 4,
                                        scan_flops(), "float32")[0]}
    # bfloat16, the recipe's compute: the persistent body, reruns bit-equal;
    # its times beside the plain version's (in turns), the step body's
    # and cuDNN's whole layer
    xb = xps["bfloat16"]
    reset_launches()
    with torch.inference_mode():
        y1, y2 = gru_sequence(xb, w_hh, b_hh), gru_sequence(xb, w_hh, b_hh)
        y_step = scan_forward(xb, w_hh, b_hh, gates=False, plan="step")[0]
        y_ref = gru_sequence_plain(xb, w_hh, b_hh)
    torch.cuda.synchronize()
    check(torch.equal(y1, y2) and gru_sequence.launches_by_body == {"persistent": 2,
                                                                    "step": 1},
          f"gru_scan bfloat16: persistent body reruns bit-equal; launches by body "
          f"{gru_sequence.launches_by_body}")
    # PR 1-2's step body, kept for the shapes the persistent body cannot
    # hold, against the plain version as before
    err_step = (y_step.float() - y_ref.float()).abs().max().item()
    tol = TOL[("gru_scan", "bfloat16")]
    check(err_step <= tol, f"gru_scan bfloat16 step body: max abs err {err_step:.3e} <= "
          f"{tol:.2g} (persistent {(y1.float() - y_ref.float()).abs().max().item():.3e})")
    with torch.inference_mode():
        k, p, turns = time_turns(lambda: gru_sequence(xb, w_hh, b_hh),
                                 lambda: gru_sequence_plain(xb, w_hh, b_hh), 5, 2)
        step_ms = time_ms(lambda: scan_forward(xb, w_hh, b_hh, gates=False, plan="step"), 3)
    cudnn_ms = cudnn_gru_ms(backward=False)
    print(f"time  gru_scan bfloat16: persistent {turns[0]:.4f}/{turns[1]:.4f} ms, plain "
          f"{turns[2]:.4f}/{turns[3]:.4f} ms, step body {step_ms:.4f} ms; cuDNN's "
          f"bidirectional layer (torch.nn.GRU, 2H -> H, projection included) {cudnn_ms:.4f} ms",
          flush=True)
    scan.update(ms=k, plain_ms=p, step_ms=step_ms, cudnn_layer_ms=cudnn_ms,
                max_abs_err=(y1.float() - y_ref.float()).abs().max().item(), **f32_row)
    # xp, W_hh, b_hh read once, ys written once; h @ W_hh every step
    scan["bound_ms"], scan["bound_by"] = bound_ms(
        nbytes(xb, w_hh.to(torch.bfloat16), b_hh) + xb.numel() // 3 * 2, scan_flops(),
        "bfloat16")
    front["library_ms"] = None
    # no single PyTorch call computes the scan on these inputs: cuDNN's GRU
    # takes the layer input, not the projections xp (its time is context)
    scan["library_ms"] = None
    scan["dtype"] = "bfloat16"
    return [front, scan, front32]


FRONT_ARMS = ("f32", "fma", "plain", "plain", "fma", "f32")


def frontend_f32_row(x32, day_w, day_b, day, fe, bound) -> dict:
    """The float32 frontend's ``f32`` body (``gemm_f32.cuh``'s tile, the
    smoothing in its A loader) at the serving shapes: two calls bit-equal,
    bit-equal to the first body (``body="fma"``), within ``TOL`` of the
    plain version; the three timed in turns (``FRONT_ARMS``). Its row of
    the kernels line."""
    reset_launches()
    with torch.inference_mode():
        o1 = fused_frontend(x32, day_w, day_b, day, **fe)
        o2 = fused_frontend(x32, day_w, day_b, day, **fe)
        o_fma = fused_frontend(x32, day_w, day_b, day, body="fma", **fe)
        o_ref = fused_frontend_plain(x32, day_w, day_b, day, **fe)
    torch.cuda.synchronize()
    check_front_ctc_bodies("frontend float32, two calls and one with body='fma'", f32=2, fma=1)
    err = (o1 - o_ref).abs().max().item()
    err_fma = (o_fma - o_ref).abs().max().item()
    tol = TOL[("frontend", "float32")]
    same = torch.equal(o1, o_fma)
    check(torch.equal(o1, o2) and same and max(err, err_fma) <= tol,
          f"frontend float32: f32 body bit-equal to the first (FMA) body {same}, reruns bit-equal; "
          f"max abs err {err:.3e} (fma {err_fma:.3e}) <= {tol:.2g}")
    arms = {"f32": lambda: fused_frontend(x32, day_w, day_b, day, **fe),
            "fma": lambda: fused_frontend(x32, day_w, day_b, day, body="fma", **fe),
            "plain": lambda: fused_frontend_plain(x32, day_w, day_b, day, **fe)}
    times = {a: [] for a in arms}
    with torch.inference_mode():
        for a in FRONT_ARMS:
            times[a].append(time_ms(arms[a], 20))
    mean = {a: sum(v) / len(v) for a, v in times.items()}
    print(f"time  frontend float32 B={B} T={T} C={C}: f32 body "
          f"{'/'.join(f'{v:.4f}' for v in times['f32'])} ms, the first (FMA) body "
          f"{'/'.join(f'{v:.4f}' for v in times['fma'])} ms, plain "
          f"{'/'.join(f'{v:.4f}' for v in times['plain'])} ms (turns {', '.join(FRONT_ARMS)}); "
          f"f32 / fma {mean['f32'] / mean['fma']:.3f}; bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{bound[0] / mean['f32']:.1%} of it", flush=True)
    return {"ms": mean["f32"], "plain_ms": mean["plain"], "fma_ms": mean["fma"],
            "max_abs_err": err, "bit_equal_fma": same, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, "dtype": "float32"}


def scan_flops() -> int:
    """One layer's recurrent products at the main path's shapes."""
    return 2 * L * D * B * H * 3 * H


def check_request(tag: str, n: int, log_probs, out_lens, decoded) -> None:
    check(tuple(log_probs.shape) == (B, L, N_OUT)
          and bool(torch.isfinite(log_probs).all()),
          f"{tag} request of {n}: log-probs {tuple(log_probs.shape)} finite")
    check(bool((out_lens[n:] == 0).all())
          and all(r == [] for r in decoded[n:])
          and bool((out_lens[:n] > 0).all()),
          f"{tag} request of {n}: {B - n} padded rows decode empty, "
          f"{n} real rows have frames")


WRAPPERS = {
    "frontend": fused_frontend,
    "gru_scan": gru_sequence,
    "gru_scan_gates": gru_sequence_gates,
    "gru_scan_bwd": gru_sequence_bwd,
    "ctc_alpha": ctc_alpha,
    "ctc_beta": ctc_beta,
    "mhsa_qkv": mhsa_qkv,
    "mhsa_qkv_bwd": mhsa_qkv_bwd,
    "dropout_masks": dropout_masks,
    "ffn": ffn,
    "ffn_bwd": ffn_bwd,
    "ffn_dropout_masks": ffn_dropout_masks,
    "conv_module": conv_module,
    "conv_module_bwd": conv_module_bwd,
    "adam_update": adam_update,
    "tiled_matmul": tiled_matmul,
}


NO_FUSED = {"ffn": 0, "ffn_bwd": 0, "ffn_dropout_masks": 0, "conv_module": 0,
            "conv_module_bwd": 0}
NO_ATTENTION = {"mhsa_qkv": 0, "mhsa_qkv_bwd": 0, "dropout_masks": 0, **NO_FUSED}
# the GRU's opt-in kernels (fused_optimizer, use_pallas_matmul)
NO_GRU_FUSED = {"adam_update": 0, "tiled_matmul": 0}
NO_GRU = {"frontend": 0, "gru_scan": 0, "gru_scan_gates": 0, "gru_scan_bwd": 0,
          **NO_GRU_FUSED}
# the test hooks: the kernels of the main paths draw the same bits themselves
HOOKS = ("dropout_masks", "ffn_dropout_masks")


SCANS = ("gru_scan", "gru_scan_gates", "gru_scan_bwd")
# the fused forwards and backwards, counted by body ("sm90" or "tile")
FUSED_FWDS = ("ffn", "conv_module")
FUSED_BWDS = ("ffn_bwd", "conv_module_bwd")
FUSED_BODIES = FUSED_FWDS + FUSED_BWDS
# the serving frontend ("tc" for bfloat16, "f32" for float32) and the CTC
# recursions ("prefetch" for S <= 256, "block" beyond), counted by body
BY_BODY = ("frontend", "ctc_alpha", "ctc_beta")
CTC_BODY = "prefetch"  # ctc_plan(2 * U + 1)


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for counts in (tiled_matmul.launches_by_body, mhsa_qkv.launches_by_body,
                   mhsa_qkv_bwd.launches_by_body,
                   *(WRAPPERS[k].launches_by_body for k in SCANS + FUSED_BODIES + BY_BODY)):
        for body in counts:
            counts[body] = 0
    mhsa_qkv_bwd.forward_recomputes = 0


def read_launches(names=KERNELS) -> dict:
    return {k: WRAPPERS[k].launches for k in names}


def check_scan_bodies(tag: str, body: str) -> None:
    """Every GRU scan launch since the last reset ran on ``body``
    (``"persistent"`` for bfloat16 at full width, ``f32_scan_body()`` for
    float32, ``"step"`` inside ``scan_body("step")``), and there was one."""
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in SCANS}
    ok = (all(n == 0 for c in bodies.values() for b, n in c.items() if b != body)
          and any(c[body] for c in bodies.values()))
    check(ok, f"{tag}: GRU scan launches by body {bodies}, all on the {body} body")


def f32_scan_body(hidden: int = H, rows: int = B, dirs: int = D) -> str:
    """The body ``scan_plan`` picks on this card for a float32 scan of
    ``hidden`` units, ``rows`` batch rows and ``dirs`` directions."""
    props = torch.cuda.get_device_properties(0)
    plan = scan_plan(hidden, rows, dirs, torch.float32, props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    return plan if isinstance(plan, str) else "persistent"


@contextlib.contextmanager
def frontend_body(body: str | None):
    """Inside, every float32 frontend of the model's normal entry points
    runs on ``body`` (``"fma"``, the first body, the other arm of an A/B:
    ``plan_for`` answers it for float32 whatever the shape), or on
    ``frontend_plan``'s choice (``None``)."""
    saved = frontend_mod.plan_for
    if body is not None:
        frontend_mod.plan_for = (
            lambda dtype, *a: body if dtype == torch.float32 else saved(dtype, *a))
    try:
        yield
    finally:
        frontend_mod.plan_for = saved


FRONT_AB_TURNS = 30  # pairs of the float32 frontend A/B (one run an arm a pair)


def front_ab(tag: str, run, card: str) -> None:
    """``run()`` (a float32 request or eval batch, ending in a sync; returns
    a tensor) in ``FRONT_AB_TURNS`` pairs, the order alternating (f32, fma),
    (fma, f32), ...: the ``f32`` arm on the frontend's planned body, the
    ``fma`` arm inside ``frontend_body("fma")``. Checks each run's frontend
    launch on its arm's body and the arms' outputs bit-equal; prints both
    medians, their quartile spreads, the pairs the f32 arm won and the
    sign test's one-sided p of at least that many wins by chance."""
    times, first, ok = {"f32": [], "fma": []}, {}, True
    for i in range(FRONT_AB_TURNS):
        for arm in (("f32", "fma") if i % 2 == 0 else ("fma", "f32")):
            with frontend_body("fma" if arm == "fma" else None):
                reset_launches()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                times[arm].append(time.perf_counter() - t0)
            ok &= fused_frontend.launches_by_body == {"tc": 0, "f32": int(arm == "f32"),
                                                      "fma": int(arm == "fma")}
            first.setdefault(arm, out)
    check(ok and torch.equal(first["f32"], first["fma"]),
          f"{tag} frontend A/B: every run's frontend on its arm's body {ok}; the arms' "
          f"outputs bit-equal")
    med = {a: statistics.median(v) for a, v in times.items()}
    iqr = {a: float(np.subtract(*np.percentile(v, [75, 25]))) for a, v in times.items()}
    wins = sum(a < b for a, b in zip(times["f32"], times["fma"]))
    p = sum(math.comb(FRONT_AB_TURNS, k) for k in range(wins, FRONT_AB_TURNS + 1))
    print(f"{tag} frontend A/B in {FRONT_AB_TURNS} pairs (f32 first in even pairs): f32 "
          f"median {med['f32'] * 1e3:.3f} ms (IQR {iqr['f32'] * 1e3:.3f}), fma median "
          f"{med['fma'] * 1e3:.3f} ms (IQR {iqr['fma'] * 1e3:.3f}); f32 - fma "
          f"{(med['f32'] - med['fma']) * 1e3:+.3f} ms; f32 faster in {wins} of "
          f"{FRONT_AB_TURNS} pairs (sign test p = {p / 2 ** FRONT_AB_TURNS:.2g}) ({card})",
          flush=True)


@contextlib.contextmanager
def scan_body(body: str | None):
    """Inside, every GRU scan of the model's normal entry points runs on the
    step body (``body="step"``, the other arm of an A/B: ``plan_for``
    answers ``"step"`` whatever the shape), or on ``scan_plan``'s choice
    (``None``)."""
    saved = gru_scan_mod.plan_for
    if body == "step":
        gru_scan_mod.plan_for = lambda *a, **k: "step"
    try:
        yield
    finally:
        gru_scan_mod.plan_for = saved


def check_front_ctc_bodies(tag: str, tc: int = 0, f32: int = 0, fma: int = 0, alpha: int = 0,
                           beta: int = 0) -> None:
    """The frontend and CTC launches since the last reset, by body: ``tc``
    bfloat16 and ``f32`` float32 frontends, ``fma`` the first body (forced),
    and every CTC recursion on the prefetch body."""
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in BY_BODY}
    want = {"frontend": {"tc": tc, "f32": f32, "fma": fma},
            "ctc_alpha": {CTC_BODY: alpha, "block": 0},
            "ctc_beta": {CTC_BODY: beta, "block": 0}}
    check(bodies == want, f"{tag}: frontend and CTC launches by body {bodies} == {want}")


def cudnn_gru_ms(backward: bool, dtype: torch.dtype = torch.bfloat16) -> float:
    """cuDNN's bidirectional GRU layer in ``dtype`` (``torch.nn.GRU``, input
    2H -> H, L steps, B rows; float32 without TF32, as ``main`` sets): the
    input projection and the recurrence, with ``backward`` also their
    gradients. A superset of a scan's work, timed as context for the scan
    rows, never called by the port."""
    g = torch.Generator(device="cuda").manual_seed(5)
    gru = torch.nn.GRU(2 * H, H, bidirectional=True).cuda().to(dtype)
    x = torch.randn((L, B, 2 * H), generator=g, device="cuda").to(dtype)
    if not backward:
        with torch.inference_mode():
            return time_ms(lambda: gru(x), 5)
    x.requires_grad_()
    gy = torch.randn((L, B, 2 * H), generator=g, device="cuda").to(dtype)

    def fwd_bwd():
        y, _ = gru(x)
        y.backward(gy)

    return time_ms(fwd_bwd, 5)


REQUEST_SIZES = (B, 41, B)  # the second request leaves 23 padded rows
AB_REQUESTS = 3  # float32 requests a turn of the step-body A/B


def serving_trials() -> tuple[list[np.ndarray], list[int]]:
    """The serving requests' trials (``REQUEST_SIZES``, then one more
    request of B for a warm-up): Gaussian trials of 400-1200 bins, the
    recipe's range of trial lengths, and their days."""
    rng = np.random.default_rng(0)
    trials = [rng.standard_normal((int(rng.integers(400, 1201)), C),
                                  dtype=np.float32)
              for _ in range(sum(REQUEST_SIZES) + B)]
    return trials, [i % N_DAYS for i in range(len(trials))]


def serving_phase(card: str) -> dict:
    cfg = GRUConfig(
        neural_dim=C, n_classes=N_OUT - 1, hidden_dim=H, num_layers=5, n_days=N_DAYS,
        stride_len=4, kernel_len=32, gaussian_smooth_width=2.0,
        bidirectional=True, compute_dtype=torch.float32,
    )
    params = init_gru_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    model = InferenceModel(params, cfg, "cuda", batch_size=B, t_max=T)
    sizes = list(REQUEST_SIZES)
    trials, days = serving_trials()

    def request(m, lo, n):
        x, dd, lens = m.pad_batch(trials[lo : lo + n], days[lo : lo + n])
        log_probs, out_lens = m(x, dd, lens)
        return x, dd, log_probs, out_lens, m.decode(log_probs, out_lens)

    request(model, sum(sizes), B)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    results, latencies, lo = [], [], 0
    for n in sizes:
        t0 = time.perf_counter()
        results.append(request(model, lo, n))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        lo += n
    launches = read_launches(KERNELS)
    front32 = fused_frontend.launches_by_body["f32"]
    body32 = f32_scan_body()
    check_scan_bodies("float32 serving", body32)
    check_front_ctc_bodies("float32 serving", f32=3)
    want = {k: 0 for k in KERNELS} | {"frontend": 3, "gru_scan": 15}
    check(launches == want,
          f"launches over 3 requests {launches} == 1 frontend and "
          f"{cfg.num_layers} scans per request, no other kernel")
    launches["frontend/f32"] = front32
    for n, (_, _, log_probs, out_lens, decoded) in zip(sizes, results):
        check_request("float32", n, log_probs, out_lens, decoded)

    x, dd = results[0][0], results[0][1]
    with torch.inference_mode():
        logits = model.module(x, dd)
        logits_plain = model.module(x, dd, plain=True)
    err = (logits - logits_plain).abs().max().item()
    check(err <= LOGITS_TOL,
          f"full-width float32 logits, kernels vs plain: max abs err "
          f"{err:.3e} <= {LOGITS_TOL:.2g}")

    med = statistics.median(latencies)
    seq_s = sum(sizes) / sum(latencies)
    print(f"serving float32 B={B} T={T}, 3-request smoke reading: latencies "
          f"{', '.join(f'{s * 1e3:.2f}' for s in latencies)} ms, median "
          f"{med * 1e3:.2f} ms, {seq_s:.2f} seq/s ({card})", flush=True)
    # A/B of the float32 request against the same code forced onto the step
    # body, in turns (step, plan, plan, step), AB_REQUESTS requests of
    # B trials a turn: the medians of each arm's requests
    ab = {"step": [], body32: []}
    for arm in ("step", body32, body32, "step"):
        with scan_body(arm if arm == "step" else None):
            reset_launches()
            for _ in range(AB_REQUESTS):
                t0 = time.perf_counter()
                request(model, 0, B)
                torch.cuda.synchronize()
                ab[arm].append(time.perf_counter() - t0)
            check_scan_bodies(f"float32 serving A/B, a {arm} turn", arm)
    med_plan, med_step = statistics.median(ab[body32]), statistics.median(ab["step"])
    print(f"serving float32 A/B in turns, {2 * AB_REQUESTS} requests of {B} an arm: {body32} "
          f"body median {med_plan * 1e3:.2f} ms ({', '.join(f'{v * 1e3:.2f}' for v in ab[body32])}), "
          f"step body median {med_step * 1e3:.2f} ms "
          f"({', '.join(f'{v * 1e3:.2f}' for v in ab['step'])}); {body32} / step "
          f"{med_plan / med_step:.3f} ({card})", flush=True)
    front_ab(f"serving float32 B={B} T={T} request", lambda: request(model, 0, B)[2], card)

    # The recipe's bfloat16 compute (configs/gru_baseline.yaml) on the same
    # weights, for the second request's trials (23 padded rows).
    model16 = InferenceModel(
        params, dataclasses.replace(cfg, compute_dtype=torch.bfloat16), "cuda",
        batch_size=B, t_max=T,
    )
    lo, n = sizes[0], sizes[1]
    request(model16, lo, n)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    x, dd, log_probs, out_lens, decoded = request(model16, lo, n)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches16 = read_launches(KERNELS)
    check_scan_bodies("bfloat16 serving", "persistent")
    check_front_ctc_bodies("bfloat16 serving", tc=1)
    check(launches16 == {k: 0 for k in KERNELS} | {"frontend": 1,
                                                    "gru_scan": cfg.num_layers},
          f"bfloat16 request launches {launches16} == 1 frontend and "
          f"{cfg.num_layers} scans, no other kernel")
    check_request("bfloat16", n, log_probs, out_lens, decoded)
    with torch.inference_mode():
        logits = model16.module(x, dd)
        logits_plain = model16.module(x, dd, plain=True)
        logits_f32 = model.module(x, dd, plain=True)
    err = (logits - logits_plain).abs().max().item()
    dist = (logits_plain - logits_f32).abs().max().item()
    tol = BF16_LOGITS_FACTOR * dist
    check(err <= tol,
          f"full-width bfloat16 logits, kernels vs plain: max abs err "
          f"{err:.3e} <= {tol:.3e} ({BF16_LOGITS_FACTOR:g} x the plain bf16 "
          f"path's distance {dist:.3e} from float32)")
    print(f"serving bfloat16 B={B} T={T}: one request of {n} trials "
          f"{latency * 1e3:.2f} ms ({card})", flush=True)
    return launches


def time_turns(kernel, plain, reps_kernel, reps_plain):
    """(kernel ms, plain ms, readings) with the runs taken in turns
    plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps_plain)
    k1 = time_ms(kernel, reps_kernel)
    k2 = time_ms(kernel, reps_kernel)
    p2 = time_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def rel_err(got, ref) -> float:
    """Max abs error relative to the reference's largest entry."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def train_kernel_phase() -> dict:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(2)
    xp = torch.randn((L, D, B, 3 * H), generator=g, device="cuda")
    w_hh = torch.stack([orthogonal((3 * H, H), g).T for _ in range(D)])
    b_hh = uniform_bound((D, 3 * H), 1 / H**0.5, g)
    dys = torch.randn((L, D, B, H), generator=g, device="cuda")
    rows = {"gru_scan_gates": {}, "gru_scan_bwd": {}, "ctc_alpha": {},
            "ctc_beta": {}}
    inputs = {}
    for name in ("float32", "bfloat16"):
        x, dy = xp.to(dt[name]), dys.to(dt[name])
        with torch.inference_mode():
            ys, gates = gru_sequence_gates(x, w_hh, b_hh)
            ys_p, gates_p = gru_sequence_gates_plain(x, w_hh, b_hh)
            ys_i = gru_sequence(x, w_hh, b_hh)
            # the backward from the same (plain) gates on both sides
            dxp, dw, db = gru_sequence_bwd(gates_p, w_hh, ys_p, dy)
            dxp_p, dw_p, db_p = gru_sequence_bwd_plain(gates_p, w_hh, ys_p, dy)
        torch.cuda.synchronize()
        inputs[name] = (x, dy, gates_p, ys_p)
        # the step bodies, kept for the shapes the persistent bodies
        # cannot hold and as the other arm of the A/Bs, against the plain
        # versions as before
        with torch.inference_mode():
            ys_s, gates_s = scan_forward(x, w_hh, b_hh, gates=True, plan="step")
            bwd_s = scan_backward(gates_p, w_hh, ys_p, dy, plan="step")
        torch.cuda.synchronize()
        err_y = (ys_s.float() - ys_p.float()).abs().max().item()
        err_g = (gates_s.float() - gates_p.float()).abs().max().item()
        errs = {k: rel_err(a, b) for k, a, b in zip(("dxp", "dW_hh", "db_hh"), bwd_s,
                                                    (dxp_p, dw_p, db_p))}
        tol_y = TRAIN_TOL[("gru_scan_gates", name)]
        tol_g = TRAIN_TOL[("gru_scan_gates.gates", name)]
        tol = TRAIN_TOL[("gru_scan_bwd", name)]
        check(err_y <= tol_y and err_g <= tol_g and max(errs.values()) <= tol,
              f"gru_scan_gates and gru_scan_bwd {name} step bodies: max abs err ys "
              f"{err_y:.3e} <= {tol_y:.3g}, gates {err_g:.3e} <= {tol_g:.3g}; backward "
              "max abs err / max |ref| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" <= {tol:.3g}")
        del ys_s, gates_s, bwd_s
        check(torch.equal(ys, ys_i),
              f"gru_scan_gates {name}: ys equal to the inference scan's bit for bit")
        err_y = (ys.float() - ys_p.float()).abs().max().item()
        err_g = (gates.float() - gates_p.float()).abs().max().item()
        check(err_y <= tol_y and err_g <= tol_g,
              f"gru_scan_gates {name}: max abs err ys {err_y:.3e} <= {tol_y:.3g}, "
              f"gates {err_g:.3e} <= {tol_g:.3g}")
        errs = {k: rel_err(a, b) for k, a, b in (
            ("dxp", dxp, dxp_p), ("dW_hh", dw, dw_p), ("db_hh", db, db_p))}
        check(max(errs.values()) <= tol,
              f"gru_scan_bwd {name}: max abs err / max |ref| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" <= {tol:.3g}")
        pre = "" if name == "bfloat16" else "f32_"
        rows["gru_scan_gates"][f"{pre}max_abs_err"] = max(err_y, err_g)
        rows["gru_scan_bwd"][f"{pre}max_abs_err"] = max(
            (a.float() - b.float()).abs().max().item()
            for a, b in ((dxp, dxp_p), (dw, dw_p), (db, db_p)))
        with torch.inference_mode():
            ys2, gates2 = gru_sequence_gates(x, w_hh, b_hh)
            again = gru_sequence_bwd(gates_p, w_hh, ys_p, dy)
        torch.cuda.synchronize()
        check(torch.equal(ys, ys2) and torch.equal(gates, gates2)
              and all(torch.equal(a, b) for a, b in zip((dxp, dw, db), again)),
              f"gru_scan_gates and gru_scan_bwd {name}: reruns bit-equal")
    for name in ("float32", "bfloat16"):
        x, dy, gates_p, ys_p = inputs[name]
        with torch.inference_mode():
            fg = time_turns(lambda: gru_sequence_gates(x, w_hh, b_hh),
                            lambda: gru_sequence_gates_plain(x, w_hh, b_hh), 3, 2)
            fb = time_turns(lambda: gru_sequence_bwd(gates_p, w_hh, ys_p, dy),
                            lambda: gru_sequence_bwd_plain(gates_p, w_hh, ys_p, dy),
                            3, 2)
        pre = "" if name == "bfloat16" else "f32_"
        for key, (k, p, turns) in (("gru_scan_gates", fg), ("gru_scan_bwd", fb)):
            print(f"time  {key} {name}: kernel {turns[0]:.4f}/{turns[1]:.4f} ms, "
                  f"plain {turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
            rows[key].update({f"{pre}ms": k, f"{pre}plain_ms": p})
    # each dtype: the step bodies at the same shapes, the contraction alone
    # against its plain version, and cuDNN's layer forward + backward; in
    # float32 the backward's device time by part (recurrence, contraction)
    # on both bodies
    contraction_flops = 2 * D * L * B * H * 3 * H
    parts = (("recurrence", ("gru_bwd_persistent", "gru_bwd_step")),
             ("contraction", ("gru_bwd_dw",)))
    for name in ("float32", "bfloat16"):
        x, dy, gates_p, ys_p = inputs[name]
        pre = "" if name == "bfloat16" else "f32_"
        with torch.inference_mode():
            step_fwd = time_ms(lambda: scan_forward(x, w_hh, b_hh, gates=True, plan="step"), 3)
            step_bwd = time_ms(lambda: scan_backward(gates_p, w_hh, ys_p, dy, plan="step"), 3)
            dxp_r, dhp_n_r = bwd_recurrence_plain(gates_p, w_hh, ys_p, dy)
            dw_c = dw_contraction(ys_p, dxp_r, dhp_n_r)
            dw_c2 = dw_contraction(ys_p, dxp_r, dhp_n_r)
            dw_cp = hh_grads_plain(ys_p, dxp_r, dhp_n_r)[0]
        torch.cuda.synchronize()
        # products of the stored values summed in float32 in another order
        tol = TRAIN_TOL[("gru_scan_bwd", "float32")]
        err = rel_err(dw_c, dw_cp)
        unit = "tensor cores" if name == "bfloat16" else "gemm_f32.cuh's FMA tile"
        check(err <= tol and torch.equal(dw_c, dw_c2),
              f"gru_scan_bwd {name} dW_hh contraction alone ({unit}): {err:.3e} <= "
              f"{tol:.3g} of max |ref|; reruns bit-equal")
        with torch.inference_mode():
            kc, pc, turns = time_turns(lambda: dw_contraction(ys_p, dxp_r, dhp_n_r),
                                       lambda: hh_grads_plain(ys_p, dxp_r, dhp_n_r), 10, 3)
        print(f"time  gru_scan_bwd {name} contraction: {unit} {turns[0]:.4f}/"
              f"{turns[1]:.4f} ms ({contraction_flops / kc / 1e9:.1f} TFLOP/s), plain "
              f"{turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
        del dxp_r, dhp_n_r
        if name == "float32":
            for body in (f32_scan_body(), "step"):
                with torch.inference_mode():
                    split = by_stage(device_split(lambda: scan_backward(
                        gates_p, w_hh, ys_p, dy, plan=None if body != "step" else "step"), 2),
                        parts)
                print(f"time  gru_scan_bwd float32 {body} body by part (device ms a call, "
                      "torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
                      flush=True)
                rows["gru_scan_bwd"][f"f32_{body}_split_ms"] = split
        cudnn_ms = cudnn_gru_ms(backward=True, dtype=dt[name])
        print(f"time  {name} step bodies (a launch a step): gates forward {step_fwd:.4f} ms, "
              f"backward {step_bwd:.4f} ms; cuDNN's {name} bidirectional layer forward + "
              f"backward (torch.nn.GRU, 2H -> H, projection included) {cudnn_ms:.4f} ms",
              flush=True)
        rows["gru_scan_gates"][f"{pre}step_ms"] = step_fwd
        rows["gru_scan_bwd"].update({f"{pre}step_ms": step_bwd, f"{pre}contraction_ms": kc,
                                     f"{pre}cudnn_layer_fwd_bwd_ms": cudnn_ms})
        w_t = w_hh.to(dt[name])
        bound = bound_ms(nbytes(x, w_t, b_hh, ys_p, gates_p), scan_flops(), name)
        # gates, W_hh, ys, dys read once, dxp, dW_hh, db_hh written once; the
        # step products dhp @ W^T and the dW_hh contraction, each as many
        # flops as the forward's products
        bound_bwd = bound_ms(nbytes(gates_p, w_t, ys_p, dy, x) + 4 * (D * H * 3 * H + D * 3 * H),
                             2 * scan_flops(), name)
        if name == "bfloat16":
            rows["gru_scan_gates"]["bound_ms"], rows["gru_scan_gates"]["bound_by"] = bound
            rows["gru_scan_bwd"]["bound_ms"], rows["gru_scan_bwd"]["bound_by"] = bound_bwd
        else:
            rows["gru_scan_gates"]["f32_bound_ms"] = bound[0]
            rows["gru_scan_bwd"]["f32_bound_ms"] = bound_bwd[0]

    # CTC at the train step's shapes: T = L frames, B rows, U labels, 41
    # classes, with an empty target, an infeasible target and a row of
    # length 0
    logits = torch.randn((B, L, N_OUT), generator=g, device="cuda")
    labels = torch.randint(1, N_OUT, (B, U), generator=g, device="cuda")
    label_lens = torch.randint(20, U + 1, (B,), generator=g, device="cuda")
    input_lens = torch.randint(92, L + 1, (B,), generator=g, device="cuda")
    label_lens[0] = 0
    input_lens[1], label_lens[1] = 40, U
    input_lens[2] = 0
    input_lens[3] = L
    prepared = {}
    for name in ("float32", "bfloat16"):
        _, lpz, _, skip, s_end, lens = prepare(logits.to(dt[name]), labels,
                                               label_lens, input_lens)
        prepared[name] = (lpz, skip, s_end, lens)
        # the prefetch body (ctc_plan at S = 129), then PR 2's block body on
        # the same inputs: both against the plain versions, the prefetch body
        # bit for bit against the block body, its reruns bit-equal
        reset_launches()
        with torch.inference_mode():
            pre = (ctc_alpha(lpz, skip, lens), ctc_beta(lpz, skip, lens, s_end))
            again = (ctc_alpha(lpz, skip, lens), ctc_beta(lpz, skip, lens, s_end))
            block = (ctc_alpha(lpz, skip, lens, body="block"),
                     ctc_beta(lpz, skip, lens, s_end, body="block"))
            ref = (ctc_alpha_plain(lpz, skip, lens), ctc_beta_plain(lpz, skip, lens, s_end))
        torch.cuda.synchronize()
        by_body = {k: dict(WRAPPERS[k].launches_by_body) for k in ("ctc_alpha", "ctc_beta")}
        check(all(torch.equal(a, b) for a, b in zip(pre + pre, block + again))
              and by_body == {k: {CTC_BODY: 2, "block": 1} for k in by_body},
              f"ctc_alpha and ctc_beta ({name} log-probs, S={lpz.shape[-1]}): prefetch body "
              f"bit-equal to PR 2's block body and to its rerun; launches by body {by_body}")
        for i, key in enumerate(("ctc_alpha", "ctc_beta")):
            for body, got in ((CTC_BODY, pre[i]), ("block", block[i])):
                same_dead = torch.equal(got <= -1e29, ref[i] <= -1e29)
                live = ref[i] > -1e29
                err = ((got[live] - ref[i][live]).abs()
                       / ref[i][live].abs().clamp_min(1.0)).max().item()
                tol = TRAIN_TOL[("ctc", name)]
                check(same_dead and err <= tol,
                      f"{key} {body} body ({name} log-probs): sentinel lanes equal "
                      f"{same_dead}, max abs err / max(1, |ref|) {err:.3e} <= {tol:.3g}")
                if name == "float32" and body == CTC_BODY:
                    rows[key]["max_abs_err"] = (got[live] - ref[i][live]).abs().max().item()
        del pre, again, block, ref
    lpz, skip, s_end, lens = prepared["float32"]
    fa = time_turns(lambda: ctc_alpha(lpz, skip, lens),
                    lambda: ctc_alpha_plain(lpz, skip, lens), 20, 3)
    fb = time_turns(lambda: ctc_beta(lpz, skip, lens, s_end),
                    lambda: ctc_beta_plain(lpz, skip, lens, s_end), 20, 3)
    block_ms = {"ctc_alpha": time_ms(lambda: ctc_alpha(lpz, skip, lens, body="block"), 20),
                "ctc_beta": time_ms(lambda: ctc_beta(lpz, skip, lens, s_end, body="block"), 20)}
    # the library yardstick: torch's own CTC loss on the same rows, forward
    # (alpha's work) and backward alone (beta's), and both
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_()
    ctc_args = (labels, input_lens, label_lens)
    lib_f = lambda: torch.nn.functional.ctc_loss(
        lp, *ctc_args, reduction="none", zero_infinity=True)
    lib_loss = lib_f().sum()
    lib_b = lambda: torch.autograd.grad(lib_loss, lp, retain_graph=True)
    lib_fb = lambda: torch.autograd.grad(lib_f().sum(), lp)
    lib = {"ctc_alpha": time_ms(lib_f, 20), "ctc_beta": time_ms(lib_b, 20)}
    lib_both = time_ms(lib_fb, 20)
    for key, (k, p, turns) in (("ctc_alpha", fa), ("ctc_beta", fb)):
        print(f"time  {key} float32: prefetch body {turns[0]:.4f}/{turns[1]:.4f} ms, "
              f"plain {turns[2]:.4f}/{turns[3]:.4f} ms, PR 2's block body "
              f"{block_ms[key]:.4f} ms, F.ctc_loss "
              f"{'forward' if key == 'ctc_alpha' else 'backward'} "
              f"{lib[key]:.4f} ms", flush=True)
        rows[key].update(ms=k, plain_ms=p, block_ms=block_ms[key], library_ms=lib[key])
    print(f"time  F.ctc_loss forward+backward {lib_both:.4f} ms", flush=True)
    # lpz, skip, lens read once and the recursion written once (beta also
    # reads s_end); a logsum3 (3 exp, 1 log, ~8 adds and compares) per
    # state and frame
    flops = 12 * lpz.numel()
    rows["ctc_alpha"]["bound_ms"], rows["ctc_alpha"]["bound_by"] = bound_ms(
        nbytes(lpz, skip, lens, lpz), flops, "float32")
    rows["ctc_beta"]["bound_ms"], rows["ctc_beta"]["bound_by"] = bound_ms(
        nbytes(lpz, skip, lens, s_end, lpz), flops, "float32")
    for key in ("gru_scan_gates", "gru_scan_bwd"):
        # cuDNN's GRU backward is tied to its own forward over the layer
        # input, not to projections and stored gates (its time is context)
        rows[key]["library_ms"] = None
    for key, row in rows.items():
        row["dtype"] = "bfloat16" if key.startswith("gru") else "float32"
    return rows


def train_step_phase(card: str) -> tuple[dict, float]:
    """bench.py's train step at full width in bf16; then one float32 and
    one bf16 step without noise and dropout, each checked leaf by leaf
    against the plain path. Returns the launches and the bf16 step's median
    seconds."""
    device = torch.device("cuda")
    args = dict(BENCH_ARGS)
    model = build_model(args, N_DAYS, device, seed=0)
    opt, sched = make_optimizer(args, model.parameters())
    step = make_train_step(args, model, opt, sched)
    batch = batch_tensors(bench_batch(B, T, U), device)
    before = [p.detach().clone() for p in model.parameters()]
    losses = []
    for i in range(2):  # warm-up
        losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
    torch.cuda.synchronize()
    n = 10
    reset_launches()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        metrics = step(batch, step_generator(device, 0, 2 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["train/loss"]))
    launches = read_launches(KERNELS)
    check_scan_bodies(f"{n} bf16 train steps", "persistent")
    check_front_ctc_bodies(f"{n} bf16 train steps", alpha=n, beta=n)
    want = {"frontend": 0, "gru_scan": 0, "gru_scan_gates": 5 * n,
            "gru_scan_bwd": 5 * n, "ctc_alpha": n, "ctc_beta": n,
            **NO_ATTENTION, **NO_GRU_FUSED}
    check(launches == want, f"launches over {n} bf16 train steps {launches} "
          f"== per step 5 gates-forward, 5 backward, 1 alpha, 1 beta, no "
          f"frontend, inference scan, fused Adam or projection matmul")
    check(all(math.isfinite(v) for v in losses),
          f"bf16 train losses finite: {', '.join(f'{v:.4f}' for v in losses)}")
    moved = [not torch.equal(a, p.detach()) for a, p in zip(before, model.parameters())]
    check(all(moved), f"all {len(moved)} parameter leaves moved after "
          f"{n + 2} steps ({sum(moved)} moved)")
    med = statistics.median(times)
    print(f"train step bf16 B={B} T={T} U={U} (dropout 0.4, noise 0.8/0.2): "
          f"steps {', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median "
          f"{med * 1e3:.2f} ms, {B / med:.2f} seq/s ({card})", flush=True)
    del model, opt, sched, step, before

    # one float32 step without noise and dropout: kernel path vs plain path
    args32 = {**BENCH_ARGS, "compute_dtype": "float32", "dropout": 0.0,
              "whiteNoiseSD": 0.0, "constantOffsetSD": 0.0}
    model = build_model(args32, N_DAYS, device, seed=1)
    out = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss, _ = _loss_and_metrics(args32, model, batch,
                                    step_generator(device, 0, 0), plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        out[plain] = (loss.item(), [p.grad.clone() for p in model.parameters()],
                      read_launches(KERNELS))
        if not plain:
            check_scan_bodies("float32 train step", f32_scan_body())
    (loss_k, grads_k, launch_k), (loss_p, grads_p, launch_p) = out[False], out[True]
    check(launch_k == {k: v // n for k, v in want.items()}
          and not any(launch_p.values()),
          f"float32 step launches: kernel path {launch_k}, plain path {launch_p}")
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    check(abs(loss_k - loss_p) <= GRAD_TOL * abs(loss_p) and max(errs) <= GRAD_TOL,
          f"float32 train step, kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; {len(errs)} gradient leaves, max abs err / max |ref| "
          f"{max(errs):.3e} <= {GRAD_TOL:g}")

    # the same step in bf16, the recipe's compute, on the same weights and
    # batch: kernel path vs plain path, leaf by leaf, against the plain bf16
    # path's distance from the plain float32 one (grads_p)
    model16 = build_model({**args32, "compute_dtype": "bfloat16"}, N_DAYS, device, seed=1)
    with torch.no_grad():
        for a, b in zip(model16.parameters(), model.parameters()):
            a.copy_(b)
    out16 = {}
    for plain in (False, True):
        model16.zero_grad(set_to_none=True)
        reset_launches()
        loss, _ = _loss_and_metrics(args32, model16, batch,
                                    step_generator(device, 0, 0), plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        out16[plain] = (loss.item(), [p.grad.clone() for p in model16.parameters()],
                        read_launches(KERNELS))
        if not plain:
            check_scan_bodies("bf16 train step without noise and dropout", "persistent")
    (loss_k, grads_k, launch_k), (loss_p16, grads_p16, launch_p) = out16[False], out16[True]
    check(launch_k == {k: v // n for k, v in want.items()}
          and not any(launch_p.values()),
          f"bf16 step launches: kernel path {launch_k}, plain path {launch_p}")
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p16)]
    dists = [rel_err(a, b) for a, b in zip(grads_p16, grads_p)]
    names = [name for name, _ in model16.named_parameters()]
    worst = max(range(len(errs)), key=lambda i: errs[i] / max(dists[i], 1e-30))
    check(math.isfinite(loss_k) and all(e <= BF16_GRAD_FACTOR * dd
                                        for e, dd in zip(errs, dists)),
          f"bf16 train step, kernels vs plain: loss {loss_k:.6f} vs {loss_p16:.6f} "
          f"(float32 {loss_p:.6f}); {len(errs)} gradient leaves, each max abs err / "
          f"max |ref| <= {BF16_GRAD_FACTOR:g} x the plain bf16 leaf's distance from "
          f"float32: errors {min(errs):.3e}..{max(errs):.3e}, distances "
          f"{min(dists):.3e}..{max(dists):.3e}; tightest leaf {names[worst]}: "
          f"{errs[worst]:.3e} vs {dists[worst]:.3e}")
    plain_switch_phase(args32, model, model16, batch, (loss_k, grads_k),
                       (loss_p16, grads_p16), (loss_p, grads_p))
    x, y, x_lens, y_lens, days = batch
    eval_step = make_eval_step(model, args32)

    def eval_batch():
        with torch.inference_mode():
            return eval_step(x, y, x_lens, y_lens, days)[0]

    front_ab(f"eval batch float32 B={B} T={T}", eval_batch, card)
    return {k: launches[k] for k in ("gru_scan_gates", "gru_scan_bwd",
                                     "ctc_alpha", "ctc_beta")}, med


# The run args that pick plain versions on the card, and the kernels each
# leaves idle: ``use_pallas: false`` the GRU time scan and the serving
# frontend, ``ctc_use_kernel: false`` the CTC recursions.
PLAIN_SWITCHES = {
    "use_pallas": ("frontend", "gru_scan", "gru_scan_gates", "gru_scan_bwd"),
    "ctc_use_kernel": ("ctc_alpha", "ctc_beta"),
}


def plain_switch_phase(args32, model32, model16, batch, default, plain16, plain32) -> None:
    """One bf16 train step (noise and dropout off) and one eval batch with
    each of ``PLAIN_SWITCHES`` set to false, on the weights and batch of the
    bf16 default step (``model16``), held against the default path: the
    loss and every gradient leaf, the eval's log-probs and per-sequence
    losses, each within ``BF16_GRAD_FACTOR`` times the plain bf16 path's
    distance from the plain float32 one (``plain16``, ``plain32``: loss and
    gradients of that step; the eval's from ``model16`` and ``model32``);
    the switched kernels launch no time, the others as on the default
    path."""
    device = torch.device("cuda")
    x, y, x_lens, y_lens, days = batch
    args16 = {**args32, "compute_dtype": "bfloat16"}
    (loss_k, grads_k), (loss_p16, grads_p16), (loss_p, grads_p) = default, plain16, plain32
    dists = [rel_err(a, b) for a, b in zip(grads_p16, grads_p)]
    loss_dist = abs(loss_p16 - loss_p) / abs(loss_p)

    def eval_batch(model, args, plain=False):
        """(log-probs, per-sequence losses, the eval step's launches): the
        eval step (``make_eval_step``) of the run's args, or with ``plain``
        the plain versions throughout."""
        with torch.inference_mode():
            lp, out_lens, _ = model_forward(model, x, days, x_lens, plain=plain)
            if plain:
                return lp, ctc_loss(lp, out_lens, y, y_lens, reduction="none", plain=True), None
            reset_launches()
            per_seq, _, _ = make_eval_step(model, args)(x, y, x_lens, y_lens, days)
        torch.cuda.synchronize()
        return lp, per_seq, read_launches(KERNELS)

    lp_k, per_k, _ = eval_batch(model16, args16)
    lp_p16, per_p16, _ = eval_batch(model16, args16, plain=True)
    lp_p, per_p, _ = eval_batch(model32, args32, plain=True)
    eval_dists = (rel_err(lp_p16, lp_p), rel_err(per_p16, per_p))
    train_want = {k: 0 for k in KERNELS} | {"gru_scan_gates": 5, "gru_scan_bwd": 5,
                                            "ctc_alpha": 1, "ctc_beta": 1}
    eval_want = {k: 0 for k in KERNELS} | {"frontend": 1, "gru_scan": 5, "ctc_alpha": 1}
    for switch, idle in PLAIN_SWITCHES.items():
        args = {**args16, switch: False}
        model = build_model(args, N_DAYS, device, seed=1)
        with torch.no_grad():
            for a, b in zip(model.parameters(), model16.parameters()):
                a.copy_(b)
        reset_launches()
        loss, _ = _loss_and_metrics(args, model, batch, step_generator(device, 0, 0))
        loss.backward()
        torch.cuda.synchronize()
        launches = read_launches(KERNELS)
        want = train_want | {k: 0 for k in idle}
        check_front_ctc_bodies(f"bf16 train step with {switch}: false",
                               alpha=want["ctc_alpha"], beta=want["ctc_beta"])
        errs = [rel_err(p.grad, g) for p, g in zip(model.parameters(), grads_k)]
        loss_err = abs(loss.item() - loss_k) / abs(loss_k)
        check(launches == want and loss_err <= BF16_GRAD_FACTOR * loss_dist
              and all(e <= BF16_GRAD_FACTOR * d for e, d in zip(errs, dists)),
              f"bf16 train step with {switch}: false against the default path: launches "
              f"{launches} (none of {', '.join(idle)}); loss {loss.item():.6f} vs "
              f"{loss_k:.6f}, relative {loss_err:.3e} <= {BF16_GRAD_FACTOR:g} x "
              f"{loss_dist:.3e}; {len(errs)} gradient leaves, each max abs err / max |ref| "
              f"<= {BF16_GRAD_FACTOR:g} x the plain bf16 leaf's distance from float32: "
              f"errors {min(errs):.3e}..{max(errs):.3e}, largest error / distance "
              f"{max(e / max(d, 1e-30) for e, d in zip(errs, dists)):.3f}")
        lp_s, per_s, launches = eval_batch(model, args)
        want = eval_want | {k: 0 for k in idle}
        check_front_ctc_bodies(f"bf16 eval batch with {switch}: false", tc=want["frontend"],
                               alpha=want["ctc_alpha"])
        errs = (rel_err(lp_s, lp_k), rel_err(per_s, per_k))
        check(launches == want and all(e <= BF16_GRAD_FACTOR * d
                                       for e, d in zip(errs, eval_dists)),
              f"bf16 eval batch with {switch}: false against the default path: launches "
              f"{launches}; log-probs {errs[0]:.3e}, per-sequence losses {errs[1]:.3e} of "
              f"max |ref|, <= {BF16_GRAD_FACTOR:g} x the plain bf16 path's distances "
              f"{eval_dists[0]:.3e}, {eval_dists[1]:.3e}")
        del model, loss


def train_model_phase(card: str) -> None:
    """train_model at full width on synthetic data, then load_model, an
    eval pass and a greedy decode."""
    out_dir = Path("runs") / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    ds = synthetic_dataset(seed=0, n_days=N_DAYS, trials_per_day=8,
                           n_channels=C, min_t=400, max_t=1200, min_u=20,
                           max_u=U)
    args = {**BENCH_ARGS, "outputDir": str(out_dir), "device": "cuda",
            "dataset": ds, "batchSize": B, "nBatch": 20, "evalEvery": 10,
            "checkpointEvery": 10, "wandb_mode": "offline"}
    t0 = time.perf_counter()
    summary = train_model(args)
    print(f"train_model: 20 steps with 2 evals and 2 checkpoints in "
          f"{time.perf_counter() - t0:.1f} s; {summary} ({card})", flush=True)
    names = ("args", "trainingStats", "modelState", "lastState", "trainerState",
             "metrics.jsonl")
    present = [n for n in names if (out_dir / n).is_file()]
    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    n_train = sum("train/loss" in r for r in recs)
    n_eval = sum("eval/cer" in r for r in recs)
    check(len(present) == len(names) and n_train == 20 and n_eval == 2,
          f"artifacts {present}; metrics.jsonl has {n_train} train and "
          f"{n_eval} eval records")

    model, run_args = load_model(str(out_dir), device="cuda")
    train_ds, test_ds = pack_days(ds["train"]), pack_days(ds["test"])
    t_max, u_max = choose_envelope(train_ds, test_ds)
    reset_launches()
    _, per, _, _ = run_eval(make_eval_step(model), test_ds, B, t_max, u_max,
                            torch.device("cuda"))
    launches = read_launches(KERNELS)
    check_scan_bodies("eval of the reloaded bf16 model", "persistent")
    n_batches = -(-test_ds.n_trials // B)
    check_front_ctc_bodies("eval of the reloaded bf16 model", tc=n_batches, alpha=n_batches)
    want = {"frontend": n_batches, "gru_scan": 5 * n_batches,
            "gru_scan_gates": 0, "gru_scan_bwd": 0, "ctc_alpha": n_batches,
            "ctc_beta": 0, **NO_ATTENTION, **NO_GRU_FUSED}
    check(launches == want, f"eval of the reloaded model over {n_batches} "
          f"batch(es) launched {launches}: frontend, inference scan and alpha, "
          f"not beta")
    best = float(summary["summary/best_cer"])
    check(math.isfinite(per) and abs(per - best) <= 0.02,
          f"reloaded best model's PER {per:.6f} vs the run's best {best:.6f}")
    trial = test_ds.trial(0)
    x = torch.zeros((1, t_max, C), device="cuda")
    x[0, : len(trial)] = torch.from_numpy(trial).to(x.device)
    with torch.inference_mode():
        log_probs, out_lens, _ = model_forward(
            model, x, torch.as_tensor(test_ds.days[:1], device="cuda"),
            torch.tensor([len(trial)], device="cuda"))
        tokens, lens = greedy_decode(log_probs, out_lens)
    ref = test_ds.labels[0, : test_ds.label_lens[0]].tolist()
    hyp = tokens[0, : lens[0]].tolist()
    check(bool(torch.isfinite(log_probs).all()) and out_lens.item() > 0,
          f"load_model -> greedy decode of one test trial: {len(hyp)} labels "
          f"decoded, {len(ref)} in the reference")
    shutil.rmtree(out_dir, ignore_errors=True)


# ----------------------------------------------------------- the Conformer

# Attention at the Conformer's train step: B=64, T'=313 frames, 8 heads of
# dh=128 (D=1024); the float32 body also at dh=64, the tensor-parallel and
# dryrun ranks' head width.
A_HEADS, A_DH = 8, 128
# Kernel vs plain, max abs error relative to the output's largest entry.
# Float32: the same float32 sums in another order (T-long softmax sums and
# 128- or T-long products). Bfloat16: p and dS are rounded to bf16 before
# their products, and the outputs too; a rounding that falls the other way
# moves an entry by one bf16 step (2**-8 relative), and up to four such
# steps of the largest entry are allowed.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
# The body each dtype's forward and backward take (``attention_plan``;
# ``launches_by_body``): the tensor cores in bf16, the redesigned FMA body
# in float32 (the older FMA body, "fma", stays for the A/Bs).
ATTN_BODY = {"float32": "f32", "bfloat16": "tc"}
# sha256 of the bf16 tensor-core forward's and backward's outputs on
# attn_tc_digests' numpy-seeded inputs, as they were computed on the commit
# before the float32 redesign (f6ca10e): the bf16 bodies must not move a
# bit.
ATTN_TC_SHA256 = {
    "mhsa_qkv": "2cd6f2246cf424fe27f89e0997704a79b0a71dc97dc0b9ee4038817ded21d793",
    "mhsa_qkv_bwd": "ebf98227abe113dde1379fcf064dfd30d5f6cb4ddba6fce2fd2b7d10ce65240c",
    "mhsa_qkv band interleaved":
        "f3c5d89089cb8abd271b76864d67d17ceb793945b4ae4850a52d98b343c198e5",
    "mhsa_qkv_bwd band interleaved":
        "add4458f3d2e55a94b1e42abbb56cee42eebf7dc1fa39c667596a148a0e37443",
}
# One float32 Conformer train step, kernel path vs plain path, every
# gradient leaf relative to its largest entry: 8 blocks of attention whose
# sums run in other orders, the CTC recursions, and 128M parameters' worth
# of products shared by both paths.
CONFORMER_GRAD_TOL = 5e-4
CONFORMER_LAYERS = 8


def attention_inputs(g, b, t, dtype, lens=None, dh=A_DH):
    d = A_HEADS * dh
    qkv = torch.randn((b, t, 3 * d), generator=g, device="cuda").to(dtype)
    gout = torch.randn((b, t, d), generator=g, device="cuda").to(dtype)
    if lens is None:
        # the frames of bench.py's trials (400-1280 bins): (len - 32) // 4
        lens = (torch.randint(400, 1281, (b,), generator=g, device="cuda") - 32) // 4
        lens[1] = t
    lens = torch.as_tensor(lens, device="cuda").to(torch.int32)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    return qkv, gout, lens, seed


def attention_check(tag, qkv, gout, lens, seed, body=None, **kw) -> tuple[float, float]:
    """Forward and dqkv, kernel vs plain, on ``body`` (forced; the dtype's
    planned body by default); forward and backward reruns bit-equal (the f32
    body's backward from ``mhsa_qkv_residuals``' out and stats, as the train
    step runs it, and once forming them itself). Returns the abs errors."""
    kw = dict(num_heads=A_HEADS, **kw)
    name = "float32" if qkv.dtype == torch.float32 else "bfloat16"
    want = body or ATTN_BODY[name]
    forced = {} if body is None else {"body": body}
    before = (mhsa_qkv.launches_by_body[want], mhsa_qkv_bwd.launches_by_body[want])
    with torch.inference_mode():
        out, ref = (mhsa_qkv(qkv, lens, seed, **forced, **kw),
                    mhsa_qkv_plain(qkv, lens, seed, **kw))
        again = mhsa_qkv(qkv, lens, seed, **forced, **kw)
        res = {}
        if want == "f32":
            res = dict(zip(("out", "stats"), mhsa_qkv_residuals(qkv, lens, seed, **kw)))
        dq = mhsa_qkv_bwd(qkv, lens, seed, gout, **forced, **res, **kw)
        dq_again = mhsa_qkv_bwd(qkv, lens, seed, gout, **forced, **kw)
        dref = mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw)
    torch.cuda.synchronize()
    took = (mhsa_qkv.launches_by_body[want] - before[0],
            mhsa_qkv_bwd.launches_by_body[want] - before[1])
    e_f, e_b = rel_err(out, ref), rel_err(dq, dref)
    dead = lens <= 0
    zero_rows = not bool(out[dead].any()) if bool(dead.any()) else True
    same = torch.equal(out, again) and (not res or torch.equal(out, res["out"]))
    same_b = torch.equal(dq, dq_again)
    tol = ATTN_TOL[name]
    n_fwd = 3 if res else 2
    check(e_f <= tol and e_b <= tol and zero_rows and same and same_b and took == (n_fwd, 2),
          f"attention {tag} {name} dh={qkv.shape[-1] // (3 * A_HEADS)} on the {want} body: "
          f"max abs err / max |ref| forward {e_f:.3e}, dqkv {e_b:.3e} <= {tol:.3g}; rows of "
          f"length 0 are zero {zero_rows}; forward reruns bit-equal {same}; backward reruns "
          f"bit-equal {same_b}{' (from the residuals, then forming them)' if res else ''}; "
          f"forward and backward launches on the {want} body {took} == {(n_fwd, 2)}")
    return ((out.float() - ref.float()).abs().max().item(),
            (dq.float() - dref.float()).abs().max().item())


def attention_flops(lens, t, n_products) -> float:
    """Each of ``n_products`` [T x keys x dh] products per (batch, head),
    over the keys each row's length lets in."""
    keys = lens.clamp(0, t).sum().item()
    return n_products * 2.0 * A_DH * A_HEADS * t * keys


def sha256_of(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def attn_tc_digests() -> dict:
    """The sha256 of the bf16 tensor-core forward's and backward's outputs at
    rate 0.3, without a band and with one (128 frames, interleaved columns),
    on numpy-seeded inputs at the recipe's shapes (two rows of length T' and
    0)."""
    rng = np.random.default_rng(21)
    b, t, h, dh = B, L, A_HEADS, A_DH

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16()

    qkv, g = r(b, t, 3 * h * dh), r(b, t, h * dh)
    lens = torch.from_numpy(((rng.integers(400, 1281, b) - 32) // 4).astype(np.int32)).cuda()
    lens[1], lens[2] = t, 0
    seed = torch.tensor([20251018], dtype=torch.int32, device="cuda")
    out = {}
    with torch.inference_mode():
        for tag, kw in (("", dict(rate=0.3)),
                        (" band interleaved", dict(rate=0.3, left_context=128,
                                                   interleaved=True))):
            kw = dict(num_heads=h, **kw)
            out["mhsa_qkv" + tag] = sha256_of([mhsa_qkv(qkv, lens, seed, **kw)])
            out["mhsa_qkv_bwd" + tag] = sha256_of([mhsa_qkv_bwd(qkv, lens, seed, g, **kw)])
    return out


# The dtype each attention row of the kernels line reports: the forward's and
# the backward's bf16 bodies (tensor cores) are the ones the recipe runs; the
# mask hook reports float32; the f32 body's rows (F32_ATTN) float32.
ROW_DTYPE = {"mhsa_qkv": "bfloat16", "mhsa_qkv_bwd": "bfloat16", "dropout_masks": "float32",
             "mhsa_qkv_f32": "float32", "mhsa_qkv_bwd_f32": "float32"}


def attention_f32_turns(qkv, gout, lens, seed, kw) -> dict:
    """The float32 forward and backward on the f32 body beside the older FMA
    body, in turns fma, f32, f32, fma (the f32 backward from the forward's
    residuals, as the train step runs it), with the plain versions before
    and after; the f32 backward forming its residuals itself once. Returns
    ms by arm and direction."""
    res_out, res_stats = mhsa_qkv_residuals(qkv, lens, seed, **kw)
    arms = {"f32": (lambda: mhsa_qkv(qkv, lens, seed, body="f32", **kw),
                    lambda: mhsa_qkv_bwd(qkv, lens, seed, gout, out=res_out, stats=res_stats,
                                         **kw)),
            "fma": (lambda: mhsa_qkv(qkv, lens, seed, body="fma", **kw),
                    lambda: mhsa_qkv_bwd(qkv, lens, seed, gout, body="fma", **kw))}
    plain = (lambda: mhsa_qkv_plain(qkv, lens, seed, **kw),
             lambda: mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw))
    got = {(a, k): [] for a in ("f32", "fma", "plain") for k in (0, 1)}
    for arm in ("plain", "fma", "f32", "f32", "fma", "plain"):
        for k in (0, 1):
            fn, reps = (plain[k], 3) if arm == "plain" else (arms[arm][k], 10)
            got[(arm, k)].append(time_ms(fn, reps))
    got[("alone", 1)] = [time_ms(lambda: mhsa_qkv_bwd(qkv, lens, seed, gout, **kw), 10)]
    return got


def attention_kernel_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    t = L
    rows = {k: {} for k in ROW_DTYPE}
    inputs = {}
    for name, dt, dh in (("float32", torch.float32, A_DH), ("float32", torch.float32, 64),
                         ("bfloat16", torch.bfloat16, A_DH)):
        qkv, gout, lens, seed = attention_inputs(g, B, t, dt, dh=dh)
        if dh == A_DH:
            inputs[name] = (qkv, gout, lens, seed)
        for rate in (0.0, 0.3):
            errs = attention_check(f"B={B} T'={t} rate {rate}", qkv, gout, lens,
                                   seed, rate=rate)
            if rate > 0 and dh == A_DH:
                for key in ("mhsa_qkv", "mhsa_qkv_f32"):
                    if name == ROW_DTYPE[key]:
                        rows[key]["max_abs_err"] = errs[0]
                for key in ("mhsa_qkv_bwd", "mhsa_qkv_bwd_f32"):
                    if name == ROW_DTYPE[key]:
                        rows[key]["max_abs_err"] = errs[1]
            if dh != A_DH:
                continue
            masks = dropout_masks(B * A_HEADS, t, seed, rate)
            same = torch.equal(masks, dropout_masks_plain(B * A_HEADS, t, seed, rate))
            check(same, f"dropout_masks {B * A_HEADS}x{t}x{t} rate {rate}: "
                  f"bit-equal to the plain version {same}")
            rows["dropout_masks"]["max_abs_err"] = 0.0 if same else 1.0
        # the edge cases, each once
        attention_check("band left_context=128", qkv, gout, lens, seed,
                        rate=0.3, left_context=128)
        attention_check("interleaved columns", qkv, gout, lens, seed,
                        rate=0.3, interleaved=True)
        if name == "float32" and dh == A_DH:
            # the older float32 FMA body, the A/Bs' other arm
            attention_check(f"B={B} T'={t} rate 0.3", qkv, gout, lens, seed, body="fma",
                            rate=0.3)
            attention_check("band left_context=128", qkv, gout, lens, seed, body="fma",
                            rate=0.3, left_context=128)
        zq, zg, zl, zs = attention_inputs(g, 4, t, dt, lens=[t, 0, 17, 0], dh=dh)
        attention_check("with rows of length 0", zq, zg, zl, zs, rate=0.3)
        lq, lg, ll, ls = attention_inputs(g, 4, 1250, dt, lens=[1250, 1000, 700, 1249], dh=dh)
        attention_check("T'=1250", lq, lg, ll, ls, rate=0.3)
        attention_check("T'=1250 band", lq, lg, ll, ls, rate=0.3, left_context=128)
        del zq, zg, lq, lg

    for name in ("float32", "bfloat16"):
        qkv, gout, lens, seed = inputs[name]
        kw = dict(num_heads=A_HEADS, rate=0.3)
        with torch.inference_mode():
            if name == "float32":
                turns = attention_f32_turns(qkv, gout, lens, seed, kw)
                mean = {key: statistics.fmean(v) for key, v in turns.items()}
                ff, fb = ((mean[("f32", k)], mean[("plain", k)]) for k in (0, 1))
                for k, what in ((0, "mhsa_qkv"), (1, "mhsa_qkv_bwd")):
                    times = {arm: "/".join(f"{v:.4f}" for v in turns[(arm, k)])
                             for arm in ("f32", "fma", "plain")}
                    print(f"time  {what} float32 B={B} T'={t} rate 0.3, in turns (plain, fma, "
                          f"f32, f32, fma, plain): f32 body {times['f32']} ms, the fma body "
                          f"{times['fma']} ms, plain {times['plain']} ms; f32 / fma "
                          f"{mean[('f32', k)] / mean[('fma', k)]:.3f}"
                          + (f"; the f32 backward forming its residuals itself "
                             f"{mean[('alone', 1)]:.4f} ms" if k else ""), flush=True)
            else:
                ff = time_turns(lambda: mhsa_qkv(qkv, lens, seed, **kw),
                                lambda: mhsa_qkv_plain(qkv, lens, seed, **kw), 10, 3)
                fb = time_turns(lambda: mhsa_qkv_bwd(qkv, lens, seed, gout, **kw),
                                lambda: mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw),
                                10, 3)
                fm = time_turns(lambda: dropout_masks(B * A_HEADS, t, seed, 0.3),
                                lambda: dropout_masks_plain(B * A_HEADS, t, seed, 0.3),
                                10, 3)
                for what, (_, _, turns) in (("mhsa_qkv", ff), ("mhsa_qkv_bwd", fb)):
                    print(f"time  {what} bfloat16 B={B} T'={t} rate 0.3: kernel "
                          f"{turns[0]:.4f}/{turns[1]:.4f} ms, plain {turns[2]:.4f}/"
                          f"{turns[3]:.4f} ms", flush=True)
        # the library yardstick: F.scaled_dot_product_attention on the same
        # q, k, v (head-split copies) with the key-padding mask and dropout
        b_, t_, d3 = qkv.shape
        q, k, v = (z.transpose(1, 2).contiguous().requires_grad_() for z in
                   qkv.detach().reshape(b_, t_, 3, A_HEADS, A_DH).unbind(2))
        keep = (torch.arange(t_, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, dropout_p=0.3)
        go = gout.reshape(b_, t_, A_HEADS, A_DH).transpose(1, 2)
        lib_f = time_ms(sdpa, 10)
        out = sdpa()
        lib_b = time_ms(lambda: torch.autograd.grad(out, (q, k, v), go,
                                                    retain_graph=True), 10)
        del out, q, k, v
        print(f"time  F.scaled_dot_product_attention {name} B={B} T'={t} rate 0.3: forward "
              f"{lib_f:.4f} ms, backward {lib_b:.4f} ms; the {ATTN_BODY[name]} body / SDPA "
              f"forward {ff[0] / lib_f:.2f}, backward {fb[0] / lib_b:.2f}", flush=True)
        if name == "bfloat16":
            kt, pt, turns = fm
            print(f"time  dropout_masks B={B} T'={t} rate 0.3: kernel {turns[0]:.4f}/"
                  f"{turns[1]:.4f} ms, plain {turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
            rows["dropout_masks"].update(ms=kt, plain_ms=pt, library_ms=None)
        for key, (kt, pt, *_), lib in (("mhsa_qkv", ff, lib_f), ("mhsa_qkv_bwd", fb, lib_b)):
            if name == "float32":
                key += "_f32"
            rows[key].update(ms=kt, plain_ms=pt, library_ms=lib)
        # qkv read once and out written once (the backward also reads g and
        # writes dqkv); the forward's two products (scores, p @ V), the
        # backward's five (scores, dP, dV, dQ, dK), over the unmasked keys
        fwd_b = bound_ms(nbytes(qkv, lens, seed) + qkv.numel() // 3 * qkv.element_size(),
                         attention_flops(lens, t, 2), name)
        bwd_b = bound_ms(nbytes(qkv, gout, lens, seed, qkv), attention_flops(lens, t, 5),
                         name)
        print(f"bound mhsa_qkv {name}: {fwd_b[0]:.4f} ms ({fwd_b[1]}), "
              f"{attention_flops(lens, t, 2) / 1e9:.2f} GFLOP; mhsa_qkv_bwd "
              f"{bwd_b[0]:.4f} ms ({bwd_b[1]}), {attention_flops(lens, t, 5) / 1e9:.2f} "
              f"GFLOP", flush=True)
        suffix = "_f32" if name == "float32" else ""
        rows["mhsa_qkv" + suffix]["bound_ms"], rows["mhsa_qkv" + suffix]["bound_by"] = fwd_b
        rows["mhsa_qkv_bwd" + suffix]["bound_ms"], rows["mhsa_qkv_bwd" + suffix]["bound_by"] = (
            bwd_b)
        if name == ROW_DTYPE["dropout_masks"]:
            # one bool written per entry; the hash's integer work is not
            # counted (the table of peaks has no integer rate)
            rows["dropout_masks"]["bound_ms"], rows["dropout_masks"]["bound_by"] = (
                bound_ms(B * A_HEADS * t * t + 4, 0, name))
    # the mask hook at the edges of its 16-byte walk: rows of 17 and 1 bytes
    # (a chunk over several rows and salts) and a tail shorter than 16
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    edge = {(bh, tt): torch.equal(dropout_masks(bh, tt, seed, 0.3),
                                  dropout_masks_plain(bh, tt, seed, 0.3))
            for bh, tt in ((5, 17), (7, 1), (3, L))}
    check(all(edge.values()), f"dropout_masks at (bh, t) {list(edge)}: bit-equal to the "
          f"plain version {list(edge.values())}")
    if not all(edge.values()):
        rows["dropout_masks"]["max_abs_err"] = 1.0
    got = attn_tc_digests()
    check(got == ATTN_TC_SHA256,
          f"bf16 attention (tc) forward and backward outputs' sha256 on numpy-seeded inputs "
          f"equal to the pin taken before the float32 redesign: {got}")
    for key, row in rows.items():
        row["dtype"] = ROW_DTYPE[key]
    return rows


def train_steps(args, seed, batch, n_warm, n_timed):
    """A fresh model of ``args`` from ``seed`` and ``n_warm + n_timed`` train steps:
    (model, losses, step times of the timed steps, launches over them)."""
    device = torch.device("cuda")
    model = build_model(args, N_DAYS, device, seed=seed)
    opt, sched = make_optimizer(args, model.parameters())
    step = make_train_step(args, model, opt, sched)
    losses, times = [], []
    launches = None
    for i in range(n_warm + n_timed):
        if i == n_warm:
            torch.cuda.synchronize()
            reset_launches()
        t0 = time.perf_counter()
        metrics = step(batch, step_generator(device, 0, i))
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append(time.perf_counter() - t0)
        losses.append(float(metrics["train/loss"]))
    launches = read_launches(KERNELS)
    return model, losses, times, launches


def conformer_train_step_phase(card: str) -> tuple[dict, float]:
    """The Conformer's bf16 train step at bench.py's shapes; one float32
    step checked leaf by leaf against the plain path; two seeded runs
    bit-equal. Returns the launches and the median step time."""
    device = torch.device("cuda")
    batch = batch_tensors(bench_batch(B, T, U), device)
    n = 10
    model, losses, times, launches = train_steps(dict(CONFORMER_ARGS), 0, batch, 2, n)
    want = {**NO_GRU, **NO_FUSED, "ctc_alpha": 2 * n, "ctc_beta": 2 * n,
            "mhsa_qkv": CONFORMER_LAYERS * n, "mhsa_qkv_bwd": CONFORMER_LAYERS * n,
            "dropout_masks": 0}
    bodies = (dict(mhsa_qkv.launches_by_body), dict(mhsa_qkv_bwd.launches_by_body))
    on_tc = {"tc": CONFORMER_LAYERS * n, "f32": 0, "fma": 0}
    check_front_ctc_bodies(f"{n} bf16 Conformer train steps (InterCTC)", alpha=2 * n,
                           beta=2 * n)
    check(launches == want and bodies == (on_tc, on_tc),
          f"launches over {n} bf16 Conformer train steps {launches} == per step 8 "
          f"attention forward and 8 backward (by body {bodies}: all on the tensor "
          f"cores), 2 alpha, 2 beta (main and InterCTC heads), no fused FF or conv "
          f"kernel")
    check(all(math.isfinite(v) for v in losses),
          f"bf16 Conformer train losses finite: {', '.join(f'{v:.4f}' for v in losses)}")
    n_params = sum(p.numel() for p in model.parameters())
    med = statistics.median(times)
    print(f"conformer train step bf16 B={B} T={T} U={U} ({n_params:,} parameters; "
          f"dropout 0.3, DropPath 0.1, SpecAugment, noise 1.0/0.2, label "
          f"smoothing 0.1, InterCTC): steps {', '.join(f'{t * 1e3:.2f}' for t in times)} "
          f"ms, median {med * 1e3:.2f} ms, {B / med:.2f} seq/s ({card})", flush=True)
    del model

    # one float32 step of the full recipe (its randomness on), kernel path
    # vs plain path: both draw the same seeds, DropPath rows and SpecAugment
    # masks from the step's generator, and the plain attention the same bits
    args32 = {**CONFORMER_ARGS, "compute_dtype": "float32"}
    model = build_model(args32, N_DAYS, device, seed=1)
    out = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss, _ = _loss_and_metrics(args32, model, batch,
                                    step_generator(device, 0, 0), plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        out[plain] = (loss.item(), [p.grad.clone() for p in model.parameters()],
                      read_launches(KERNELS))
        bodies = (dict(mhsa_qkv.launches_by_body), dict(mhsa_qkv_bwd.launches_by_body),
                  mhsa_qkv_bwd.forward_recomputes)
        if not plain:
            on_f32 = {"tc": 0, "f32": CONFORMER_LAYERS, "fma": 0}
            check(bodies == (on_f32, on_f32, 0),
                  f"float32 Conformer step: attention forward and backward launches by body, "
                  f"and forwards recomputed by the backward, {bodies} == {(on_f32, on_f32, 0)}")
    (loss_k, grads_k, launch_k), (loss_p, grads_p, launch_p) = out[False], out[True]
    check(launch_k == {k: v // n for k, v in want.items()}
          and not any(launch_p.values()),
          f"float32 Conformer step launches: kernel path {launch_k}, plain path "
          f"{launch_p}")
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    check(abs(loss_k - loss_p) <= CONFORMER_GRAD_TOL * abs(loss_p)
          and max(errs) <= CONFORMER_GRAD_TOL,
          f"float32 Conformer train step, kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; {len(errs)} gradient leaves, max abs err / max |ref| "
          f"{max(errs):.3e} <= {CONFORMER_GRAD_TOL:g}")
    del model, out, grads_k, grads_p

    # reproducibility: two runs of two bf16 steps from one seed
    runs = []
    for _ in range(2):
        model, losses, _, _ = train_steps(dict(CONFORMER_ARGS), 0, batch, 0, 2)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
        del model
    (l1, p1), (l2, p2) = runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    check(same, f"two bf16 Conformer runs of 2 steps from one seed bit-equal: "
          f"losses {l1} / {l2}")
    return ({k: launches[k] for k in ("mhsa_qkv", "mhsa_qkv_bwd", "dropout_masks")}
            | {k: launch_k[k.split("/")[0]] for k in F32_ATTN.values()}), med


@contextlib.contextmanager
def attention_body(body: str | None):
    """Inside, every float32 attention of the model's normal entry points
    runs on ``body`` (``"fma"``, the older bodies, the other arm of an A/B:
    ``plan_for`` answers it for float32 whatever the shape), or on
    ``attention_plan``'s choice (``None``)."""
    saved = attention_mod.plan_for
    if body is not None:
        attention_mod.plan_for = (
            lambda dtype, dh: body if dtype == torch.float32 else saved(dtype, dh))
    try:
        yield
    finally:
        attention_mod.plan_for = saved


def conformer_float32_steps_phase(card: str) -> dict:
    """The float32 Conformer train step at full width (``CONFORMER_ARGS`` in
    float32, the JAX trainer's default dtype): after 2 warm-up steps,
    ``AB_STEPS`` timed steps a turn in turns fma, f32, f32, fma
    (``attention_body``): its 8 attention forwards and backwards a step on
    the older ``fma`` bodies in the fma turns, on the f32 body (the backward
    from the forward's residuals) in the others. The medians of each arm;
    returns the f32 turns' launches by body and the f32 arm's median (s)."""
    device = torch.device("cuda")
    batch = batch_tensors(bench_batch(B, T, U), device)
    args32 = {**CONFORMER_ARGS, "compute_dtype": "float32"}
    model = build_model(args32, N_DAYS, device, seed=0)
    opt, sched = make_optimizer(args32, model.parameters())
    step = make_train_step(args32, model, opt, sched)
    losses, i = [], 0
    for _ in range(2):  # warm-up
        losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
        i += 1
    times = {"fma": [], "f32": []}
    ran = dict.fromkeys(F32_ATTN.values(), 0)
    n = CONFORMER_LAYERS * AB_STEPS
    for arm in ("fma", "f32", "f32", "fma"):
        with attention_body("fma" if arm == "fma" else None):
            torch.cuda.synchronize()
            reset_launches()
            for _ in range(AB_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
                torch.cuda.synchronize()
                times[arm].append(time.perf_counter() - t0)
                i += 1
        bodies = (dict(mhsa_qkv.launches_by_body), dict(mhsa_qkv_bwd.launches_by_body))
        on_arm = {b: n if b == arm else 0 for b in ("tc", "f32", "fma")}
        check(bodies == (on_arm, on_arm) and mhsa_qkv_bwd.forward_recomputes == 0,
              f"{AB_STEPS} float32 Conformer train steps, a {arm} turn: attention forward and "
              f"backward launches by body {bodies}, each {on_arm}; forwards recomputed by the "
              f"backward {mhsa_qkv_bwd.forward_recomputes}")
        if arm == "f32":
            ran["mhsa_qkv/f32"] += bodies[0]["f32"]
            ran["mhsa_qkv_bwd/f32"] += bodies[1]["f32"]
    del model, opt, sched, step
    check(all(math.isfinite(v) for v in losses),
          f"float32 Conformer train losses finite: {', '.join(f'{v:.4f}' for v in losses)}")
    med = {arm: statistics.median(v) for arm, v in times.items()}
    print(f"conformer train step float32 B={B} T={T} U={U}, A/B in turns (fma, f32, f32, "
          f"fma), {2 * AB_STEPS} steps an arm: f32 attention median {med['f32'] * 1e3:.2f} ms "
          f"({', '.join(f'{t * 1e3:.2f}' for t in times['f32'])}), {B / med['f32']:.2f} "
          f"seq/s; fma attention median {med['fma'] * 1e3:.2f} ms "
          f"({', '.join(f'{t * 1e3:.2f}' for t in times['fma'])}); f32 - fma "
          f"{(med['f32'] - med['fma']) * 1e3:+.2f} ms ({card})", flush=True)
    return ran, med["f32"]


CONFORMER_RUN = Path("runs") / "chip_smoke_conformer"
CLI_RUN = Path("runs") / "chip_smoke_cli"


def conformer_train_model_phase(card: str) -> None:
    """train_model of the Conformer at full width on synthetic data, then
    load_model, an eval pass that re-scores the best PER, a greedy decode."""
    out_dir = CONFORMER_RUN
    shutil.rmtree(out_dir, ignore_errors=True)
    ds = synthetic_dataset(seed=0, n_days=N_DAYS, trials_per_day=8,
                           n_channels=C, min_t=400, max_t=1200, min_u=20,
                           max_u=U)
    n_steps = 10
    args = {**CONFORMER_ARGS, "outputDir": str(out_dir), "device": "cuda",
            "dataset": ds, "batchSize": B, "nBatch": n_steps, "evalEvery": 5,
            "checkpointEvery": 5, "warmup_steps": 2, "wandb_mode": "offline"}
    t0 = time.perf_counter()
    summary = train_model(args)
    print(f"conformer train_model: {n_steps} steps with 2 evals and 2 "
          f"checkpoints in {time.perf_counter() - t0:.1f} s; {summary} ({card})",
          flush=True)
    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    n_train = sum("train/loss" in r for r in recs)
    keys = {k for r in recs for k in r}
    want_keys = {"train/ctc_loss", "train/kl_loss", "train/inter_ctc_loss",
                 "train/main_loss", "train/grad_norm"}
    check(n_train == n_steps and want_keys <= keys
          and (out_dir / "modelState").is_file(),
          f"conformer metrics.jsonl has {n_train} train records with "
          f"{sorted(want_keys & keys)}; modelState written")

    model, _ = load_model(str(out_dir), device="cuda")
    train_ds, test_ds = pack_days(ds["train"]), pack_days(ds["test"])
    t_max, u_max = choose_envelope(train_ds, test_ds)
    reset_launches()
    _, per, _, _ = run_eval(make_eval_step(model), test_ds, B, t_max, u_max,
                            torch.device("cuda"), torch_mean_semantics=False)
    launches = read_launches(KERNELS)
    n_batches = -(-test_ds.n_trials // B)
    check_front_ctc_bodies("eval of the reloaded Conformer", alpha=n_batches)
    want = {**NO_GRU, **NO_FUSED, "ctc_alpha": n_batches, "ctc_beta": 0,
            "mhsa_qkv": CONFORMER_LAYERS * n_batches, "mhsa_qkv_bwd": 0,
            "dropout_masks": 0}
    check(launches == want, f"eval of the reloaded Conformer over {n_batches} "
          f"batch(es) launched {launches}")
    best = float(summary["summary/best_cer"])
    check(per == best, f"reloaded best Conformer's PER {per:.6f} == the run's "
          f"best {best:.6f}")
    trial = test_ds.trial(0)
    x = torch.zeros((1, t_max, C), device="cuda")
    x[0, : len(trial)] = torch.from_numpy(trial).to(x.device)
    with torch.inference_mode():
        log_probs, out_lens, _ = model_forward(
            model, x, torch.as_tensor(test_ds.days[:1], device="cuda"),
            torch.tensor([len(trial)], device="cuda"))
        tokens, lens = greedy_decode(log_probs, out_lens)
    check(bool(torch.isfinite(log_probs).all()) and out_lens.item() > 0,
          f"Conformer load_model -> greedy decode of one test trial: "
          f"{int(lens[0])} labels decoded, {int(test_ds.label_lens[0])} in the "
          f"reference")
    # the run directory stays for export_phase, which removes it

# ------------------------------------------ the fused FF and conv module

# The fused modules at the Conformer's train step: B=64, T'=313, D=1024,
# F=2048, conv k=31.
F_FF, KW = 2048, 31
# Kernel vs plain, max abs error relative to each output's largest entry,
# for the output and every gradient. Float32: the same float32 sums in
# another order (D-, F- and B*T'-long). Bfloat16: s, h, the GLU, the conv
# output, the norms and dW are rounded to bf16, and a rounding that falls
# the other way moves an entry by a bf16 step (2**-8 relative); up to four
# such steps of the largest entry are allowed, as for the attention.
FUSED_TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
FF_NAMES = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
CONV_NAMES = ("dx", "dln_s", "dln_b", "dw1", "db1", "ddw_w", "ddw_b", "dln2_s",
              "dln2_b", "dw2", "db2")


def fused_inputs(g, dtype):
    """x, the cotangent, the FF's and the conv module's parameters (vectors
    and taps float32, weights in dtype), as the model passes them."""
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device="cuda")
    d, f = A_HEADS * A_DH, F_FF
    x, gout = r(B, L, d).to(dtype), r(B, L, d).to(dtype)
    ff = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5).to(dtype),
          r(f, sc=0.1), r(f, d, sc=f**-0.5).to(dtype), r(d, sc=0.1))
    conv = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5).to(dtype),
            r(2 * d, sc=0.1), r(KW, d, sc=KW**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1),
            r(d, sc=0.1), r(d, d, sc=d**-0.5).to(dtype), r(d, sc=0.1))
    return x, gout, ff, conv


def fused_check(tag, name, fwd, fwd_plain, bwd, bwd_plain, names) -> tuple[float, float]:
    """One module's forward and backward, kernel vs plain: (output abs
    error, largest gradient abs error)."""
    with torch.inference_mode():
        out, ref = fwd(), fwd_plain()
        grads, refs = bwd(), bwd_plain()
    torch.cuda.synchronize()
    tol = FUSED_TOL[name]
    errs = {"out": rel_err(out, ref)} | {k: rel_err(a, b)
                                         for k, a, b in zip(names, grads, refs)}
    dtypes = all(a.dtype == b.dtype for a, b in zip(grads, refs)) and out.dtype == ref.dtype
    check(max(errs.values()) <= tol and dtypes,
          f"{tag} {name}: max abs err / max |ref| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" <= {tol:.3g}; dtypes equal "
          f"{dtypes}")
    return ((out.float() - ref.float()).abs().max().item(),
            max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, refs)))


def unfused_module(kind, x, gout, params, rate, causal=False):
    """The model's unfused module (``_ff_module`` or ``_conv_module`` with
    both flags off) on the same inputs, forward then backward: the
    yardstick the fused kernels replace (no single PyTorch call computes
    either)."""
    d = x.shape[-1]
    cfg = port_conformer.ConformerConfig(latent_dim=d, ff_dim=F_FF, conv_kernel=KW,
                                         compute_dtype=x.dtype)
    leaves = [v.detach().clone().requires_grad_() for v in params]
    xg = x.detach().clone().requires_grad_()
    rng = port_conformer._Draws(torch.Generator(device="cuda").manual_seed(0), True)
    if kind == "ffn":
        sc, bi, w1, b1, w2, b2 = leaves
        tree = {"ln": {"scale": sc, "bias": bi}, "lin1": {"w": w1, "b": b1},
                "lin2": {"w": w2, "b": b2}}
        out = port_conformer._ff_module(tree, xg, rng, rate, cfg, False)
    else:
        s1, c1, w1, b1, dww, dwb, s2, c2, w2, b2 = leaves
        tree = {"ln": {"scale": s1, "bias": c1}, "pw1": {"w": w1, "b": b1},
                "dw_w": dww, "dw_b": dwb, "ln_conv": {"scale": s2, "bias": c2},
                "pw2": {"w": w2, "b": b2}}
        out = port_conformer._conv_module(tree, xg, rng, rate, causal, cfg, False) - xg
    return torch.autograd.grad(out, [xg, *leaves], gout)


# The dtype each fused row of the kernels line reports: the forwards' and
# backwards' bf16 bodies are the ones the main path runs (the sm90 body);
# the mask hook keeps its float32 row; the float32 f32 body (F32_FUSED) its
# own rows.
FUSED_ROW_DTYPE = {"ffn": "bfloat16", "ffn_bwd": "bfloat16", "ffn_dropout_masks": "float32",
                   "conv_module": "bfloat16", "conv_module_bwd": "bfloat16",
                   **dict.fromkeys(F32_FUSED, "float32")}
# The body each dtype's forwards ("fwd") and backwards ("bwd") take at these
# shapes (ops/kernels/ffn.py::body_plan).
FUSED_BODY = {"fwd": {"float32": "f32", "bfloat16": "sm90"},
              "bwd": {"float32": "f32", "bfloat16": "sm90"}}


def fused_body(key: str, dtype: str) -> str:
    """The body the fused wrapper ``key`` takes in ``dtype``."""
    return FUSED_BODY["bwd" if key in FUSED_BWDS else "fwd"][dtype]
# sha256 of the bf16 sm90 backwards' outputs (every gradient's bits, in
# order) on fused_bwd_digests' numpy-seeded inputs, as the backwards
# computed them before the forwards moved onto gemm_sm90.cuh (commit
# 66c0b3e): the front they now share with the forwards and the wide window
# kernel must not move a bit.
FUSED_BWD_SHA256 = {
    "ffn_bwd": "d139cf0248ae70e87df2d52ded8461b9b7366635d923bb5afed8cf4398c75f76",
    "conv_module_bwd": "7fbbbd97f6ab661447bf49bcfc5b07ea2d249f3ad328135f3c8f813cdd7fb6ef",
    "conv_module_bwd causal": "91ed7af3c19704118260f8a6697a60fda488d222fb37664ecfb46fbc2f3b9a4f",
}


# sha256 of the float32 f32 backwards' outputs on the same inputs in
# float32, as the backwards computed them before the forwards moved onto
# gemm_f32.cuh (commit b04dd14): the front they now share with the forwards
# must not move a bit.
FUSED_BWD_F32_SHA256 = {
    "ffn_bwd": "f167fce3a215ba9254d1373bb0c52431531bce81093e0994e93f18e5cd94ccbf",
    "conv_module_bwd": "1d7c586a817ed3ecc5efd961c30af767662a7f12f52ce94fd44f18a21d83781f",
    "conv_module_bwd causal": "77994add583acb941e2a271b291811d458bb22da4c15a9def896a422e1bd8aa5",
}


def fused_bwd_digests(dtype: torch.dtype = torch.bfloat16, body: str = "sm90") -> dict:
    """The sha256 of each ``dtype`` backward's outputs on ``body`` at rate
    0.3 (the conv centred and causal) on numpy-seeded inputs at the
    recipe's shapes."""
    rng = np.random.default_rng(10)
    d, f, cdt = A_HEADS * A_DH, F_FF, dtype

    def r(*s, sc=1.0, dt=torch.float32):
        return (sc * torch.from_numpy(rng.standard_normal(s, dtype=np.float32))).cuda().to(dt)

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    x, gout = r(B, L, d, dt=cdt), r(B, L, d, dt=cdt)
    ff = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5, dt=cdt), r(f, sc=0.1),
          r(f, d, sc=f**-0.5, dt=cdt))
    conv = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5, dt=cdt),
            r(2 * d, sc=0.1), r(KW, d, sc=KW**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1),
            r(d, sc=0.1), r(d, d, sc=d**-0.5, dt=cdt))
    seed = torch.tensor([20251017], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        out = {"ffn_bwd": digest(ffn_bwd(x, *ff, seed, gout, rate=0.3, body=body))}
        for causal in (False, True):
            out["conv_module_bwd" + (" causal" if causal else "")] = digest(conv_module_bwd(
                x, *conv, seed, gout, rate=0.3, causal=causal, body=body))
    return out


def fused_products(ff, conv, dtype) -> dict:
    """The products of each forward (two) and backward (five) at its shapes
    (operands in ``dtype``, M = B*T' rows), each as one ``torch.mm`` call
    (bf16 with ``out_dtype=float32``; float32 cuBLAS SGEMM, TF32 off):
    context for the kernels' times, never called by the port."""
    m, d, f = B * L, A_HEADS * A_DH, F_FF
    g = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    if dtype == torch.bfloat16:
        mm = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)  # noqa: E731
    else:
        mm = torch.mm
    xn, gq, s_, hq, dsq, dhq = r(m, d), r(m, d), r(m, d), r(m, f), r(m, f), r(m, 2 * d)
    w1, w2, cw1, cw2 = ff[2], ff[4], conv[2], conv[8]
    return {
        "ffn": {"xn.W1": lambda: mm(xn, w1), "h.W2": lambda: mm(hq, w2)},
        "conv_module": {"xn.W1": lambda: mm(xn, cw1), "s.W2": lambda: mm(s_, cw2)},
        "ffn_bwd": {"xn.W1": lambda: mm(xn, w1), "hq^T.gq": lambda: mm(hq.T, gq),
                    "gq.W2^T": lambda: mm(gq, w2.T), "xn^T.dsq": lambda: mm(xn.T, dsq),
                    "dsq.W1^T": lambda: mm(dsq, w1.T)},
        "conv_module_bwd": {"xn.W1": lambda: mm(xn, cw1), "s^T.gq": lambda: mm(s_.T, gq),
                            "gq.W2^T": lambda: mm(gq, cw2.T),
                            "xn^T.dhq": lambda: mm(xn.T, dhq),
                            "dhq.W1^T": lambda: mm(dhq, cw1.T)},
    }


def fused_tile_check(key, tag, call, plain, names, name) -> None:
    """One ``name`` call of a forward or backward forced onto the tile body
    (``body="tile"``, the body ``bwd_plan`` still picks where neither sm90
    nor f32 can read a shape, and an A/B's other arm) against its plain
    version at ``FUSED_TOL[name]`` (``call`` and ``plain`` return tuples of
    outputs); its one launch counted on the tile body."""
    before = dict(WRAPPERS[key].launches_by_body)
    with torch.inference_mode():
        grads, refs = call(body="tile"), plain()
    torch.cuda.synchronize()
    took = {b: n - before[b] for b, n in WRAPPERS[key].launches_by_body.items()}
    tol = FUSED_TOL[name]
    errs = {k: rel_err(a, b) for k, a, b in zip(names, grads, refs)}
    dtypes = all(a.dtype == b.dtype for a, b in zip(grads, refs))
    check(max(errs.values()) <= tol and dtypes and took["tile"] == 1
          and sum(took.values()) == 1,
          f"{key} {name} {tag} on the tile body: max abs err / max |ref| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" <= {tol:.3g}; dtypes equal "
          f"{dtypes}; launches by body {took}")


def fused_bodies(x, gout, ff, conv, seed, name) -> None:
    """At rate 0.3, the forwards and backwards, whose default body (bf16:
    sm90; float32: f32) has the tile body beside it: the tile body against
    the plain version (centred and causal conv), the default body's reruns
    bit-equal, the backwards' sha256 pins, one call of each body by kernel
    and by stage, the tile body timed in turns with the default one, and
    the products of each as ``torch.mm`` as context."""
    kw = dict(rate=0.3)
    tag = f"B={B} T'={L} rate 0.3"
    bf16 = name == "bfloat16"
    fused_tile_check("ffn", tag, lambda **b: (ffn(x, *ff, seed, **kw, **b),),
                     lambda: (ffn_plain(x, *ff, seed, **kw),), ("out",), name)
    fused_tile_check("ffn_bwd", tag, lambda **b: ffn_bwd(x, *ff[:5], seed, gout, **kw, **b),
                     lambda: ffn_bwd_plain(x, *ff[:5], seed, gout, **kw), FF_NAMES, name)
    for causal in (False, True):
        ck = dict(rate=0.3, causal=causal)
        ctag = tag + (" causal" if causal else "")
        fused_tile_check("conv_module", ctag,
                         lambda **b: (conv_module(x, *conv, seed, **ck, **b),),
                         lambda: (conv_module_plain(x, *conv, seed, **ck),), ("out",), name)
        fused_tile_check(
            "conv_module_bwd", ctag,
            lambda **b: conv_module_bwd(x, *conv[:9], seed, gout, **ck, **b),
            lambda: conv_module_bwd_plain(x, *conv[:9], seed, gout, **ck), CONV_NAMES, name)
    if bf16:
        digests = fused_bwd_digests()
        check(digests == FUSED_BWD_SHA256, f"sha256 of the bf16 sm90 backwards' outputs "
              f"{digests} == the pinned {FUSED_BWD_SHA256}")
    else:
        digests = fused_bwd_digests(torch.float32, "f32")
        check(digests == FUSED_BWD_F32_SHA256, f"sha256 of the float32 f32 backwards' outputs "
              f"{digests} == the pinned {FUSED_BWD_F32_SHA256}")
    calls = {"ffn": lambda **b: (ffn(x, *ff, seed, **kw, **b),),
             "conv_module": lambda **b: (conv_module(x, *conv, seed, **kw, **b),),
             "ffn_bwd": lambda **b: ffn_bwd(x, *ff[:5], seed, gout, **kw, **b),
             "conv_module_bwd": lambda **b: conv_module_bwd(x, *conv[:9], seed, gout,
                                                            **kw, **b)}
    products = fused_products(ff, conv, x.dtype)
    mm_what = "torch.mm(out_dtype=float32)" if bf16 else "torch.mm (cuBLAS SGEMM, TF32 off)"
    with torch.inference_mode():
        for key in FUSED_BODIES:
            call, body = calls[key], fused_body(key, name)
            one, two = call(), call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            check(same, f"{key} {name} {tag} on the {body} body: reruns bit-equal {same}")
            del one, two
            for b in (body, "tile"):
                split = device_split(lambda: call(body=b))
                for kname, n, ms in split:
                    print(f"  split {key} {name} {b}: {ms:9.4f} ms {n:3d}x  {kname[:100]}")
                stages = by_stage(split)
                print(f"split {key} {name} {b} body, one call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in stages.items())
                    + f"; device total {sum(stages.values()):.4f} ms", flush=True)
            t1 = time_ms(lambda: call(body="tile"), 3)
            s1 = time_ms(call, 5)
            s2 = time_ms(call, 5)
            t2 = time_ms(lambda: call(body="tile"), 3)
            mm_ms = {k: time_ms(fn, 5) for k, fn in products[key].items()}
            print(f"time  {key} {name} {tag}: {body} body {s1:.4f}/{s2:.4f} "
                  f"ms, tile body {t1:.4f}/{t2:.4f} ms (turns tile, {body}, {body}, tile); "
                  f"context, its products as {mm_what}: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in mm_ms.items())
                  + f" = {sum(mm_ms.values()):.4f} ms", flush=True)
    del products


def fused_workspaces(name: str) -> None:
    """Prints the bytes of scratch each forward and backward body takes at
    the recipe's shapes in ``name`` (the workspace queries of csrc/ffn.cu
    and csrc/conv_module.cu, with the plan's K ranges)."""
    lib = _build.load_library()
    d, f, bf16 = A_HEADS * A_DH, F_FF, int(name == "bfloat16")
    props = torch.cuda.get_device_properties(0)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for key, query, shapes, width in (("ffn", "ffn", ((f, d), (d, f)), f),
                                      ("conv_module", "conv", ((d, d), (d, 2 * d)), KW)):
        for bwd in (False, True):
            direction = "bwd" if bwd else "fwd"
            body = FUSED_BODY[direction][name]
            plan = ffn_mod.body_plan(dtype, B * L, shapes, props.multi_processor_count)
            splits = plan.splits if bwd else ()
            own = getattr(lib, f"nsd_{query}_{direction}_{body}_workspace")(B, L, d, width,
                                                                             *splits)
            tile = getattr(lib, f"nsd_{query}_workspace")(B, L, d, width, bf16, int(bwd))
            print(f"workspace {key}{'_bwd' if bwd else ''} {name} B={B} T'={L}: {body} body "
                  f"{own} bytes" + (f" (dW K ranges {splits})" if bwd else "")
                  + f", tile body {tile} bytes, {own - tile:+d}", flush=True)


def fused_rows(key: str, name: str) -> list[str]:
    """The kernels line's rows that report wrapper ``key``'s ``name`` calls
    (its own, and the f32 body's for a float32 backward)."""
    return [k for k in (key, key + "_f32") if FUSED_ROW_DTYPE.get(k) == name]


def fused_kernel_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {k: {} for k in FUSED_ROW_DTYPE}
    seed = torch.randint(0, 2**31 - 1, (1,), generator=g, device="cuda", dtype=torch.int32)
    d, f = A_HEADS * A_DH, F_FF
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x, gout, ff, conv = fused_inputs(g, dt)
        by_body = {k: dict(WRAPPERS[k].launches_by_body) for k in FUSED_BODIES}
        for rate in (0.0, 0.3):
            kw = dict(rate=rate)
            e_ff = fused_check(
                f"ffn B={B} T'={L} D={d} F={f} rate {rate}", name,
                lambda: ffn(x, *ff, seed, **kw), lambda: ffn_plain(x, *ff, seed, **kw),
                lambda: ffn_bwd(x, *ff[:5], seed, gout, **kw),
                lambda: ffn_bwd_plain(x, *ff[:5], seed, gout, **kw), FF_NAMES)
            e_conv = []
            for causal in ((False, True) if rate > 0 else (False,)):
                ck = dict(rate=rate, causal=causal)
                e_conv.append(fused_check(
                    f"conv_module B={B} T'={L} D={d} k={KW} rate {rate}"
                    + (" causal" if causal else ""), name,
                    lambda: conv_module(x, *conv, seed, **ck),
                    lambda: conv_module_plain(x, *conv, seed, **ck),
                    lambda: conv_module_bwd(x, *conv[:9], seed, gout, **ck),
                    lambda: conv_module_bwd_plain(x, *conv[:9], seed, gout, **ck),
                    CONV_NAMES))
            if rate > 0:
                errs = {"ffn": e_ff[0], "ffn_bwd": e_ff[1],
                        "conv_module": max(e[0] for e in e_conv),
                        "conv_module_bwd": max(e[1] for e in e_conv)}
                for key, err in errs.items():
                    for row in fused_rows(key, name):
                        rows[row]["max_abs_err"] = err
            if name == "float32":
                m1, m2 = ffn_dropout_masks(B, L, d, f, seed, rate)
                r1, r2 = ffn_dropout_masks_plain(B, L, d, f, seed, rate)
                same = torch.equal(m1, r1) and torch.equal(m2, r2)
                check(same, f"ffn_dropout_masks {B}x{L}x({f}, {d}) rate {rate}: "
                      f"bit-equal to the plain version {same}")
                # and at the edges of the 16-byte walk: widths 36 and 20, 12
                # and 4 (not multiples of 16), rows of T' = 17 and 1
                for shape in ((2, 17, 20, 36), (2, 1, 4, 12)):
                    e1, e2 = ffn_dropout_masks(*shape, seed, rate)
                    q1, q2 = ffn_dropout_masks_plain(*shape, seed, rate)
                    edge = torch.equal(e1, q1) and torch.equal(e2, q2)
                    check(edge, f"ffn_dropout_masks (b, t, d, f) {shape} rate {rate}: "
                          f"bit-equal to the plain version {edge}")
                    same &= edge
                rows["ffn_dropout_masks"]["max_abs_err"] = 0.0 if same else 1.0
        ran = {k: {b: n - by_body[k][b] for b, n in WRAPPERS[k].launches_by_body.items()}
               for k in FUSED_BODIES}
        check(all(c[fused_body(k, name)] > 0 and sum(c.values()) == c[fused_body(k, name)]
                  for k, c in ran.items()),
              f"{name} fused forwards' and backwards' launches by body {ran}: the forwards on "
              f"the {FUSED_BODY['fwd'][name]} body, the backwards on the "
              f"{FUSED_BODY['bwd'][name]} body")
        fused_workspaces(name)
        fused_bodies(x, gout, ff, conv, seed, name)

        kw = dict(rate=0.3)
        with torch.inference_mode():
            t_ff = time_turns(lambda: ffn(x, *ff, seed, **kw),
                              lambda: ffn_plain(x, *ff, seed, **kw), 5, 3)
            t_ffb = time_turns(lambda: ffn_bwd(x, *ff[:5], seed, gout, **kw),
                               lambda: ffn_bwd_plain(x, *ff[:5], seed, gout, **kw), 3, 3)
            t_cv = time_turns(lambda: conv_module(x, *conv, seed, **kw),
                              lambda: conv_module_plain(x, *conv, seed, **kw), 5, 3)
            t_cvb = time_turns(lambda: conv_module_bwd(x, *conv[:9], seed, gout, **kw),
                               lambda: conv_module_bwd_plain(x, *conv[:9], seed, gout,
                                                             **kw), 3, 3)
            t_m = time_turns(lambda: ffn_dropout_masks(B, L, d, f, seed, 0.3),
                             lambda: ffn_dropout_masks_plain(B, L, d, f, seed, 0.3), 10, 3)
        # the yardstick: the unfused modules, forward and backward (autograd)
        ref_ff = time_ms(lambda: unfused_module("ffn", x, gout, ff, 0.3), 3)
        ref_cv = time_ms(lambda: unfused_module("conv", x, gout, conv, 0.3), 3)
        fused_ff = time_ms(lambda: (ffn(x, *ff, seed, **kw),
                                    ffn_bwd(x, *ff[:5], seed, gout, **kw)), 3)
        fused_cv = time_ms(lambda: (conv_module(x, *conv, seed, **kw),
                                    conv_module_bwd(x, *conv[:9], seed, gout, **kw)), 3)
        for key, (kt, pt, turns) in (("ffn", t_ff), ("ffn_bwd", t_ffb),
                                     ("conv_module", t_cv), ("conv_module_bwd", t_cvb),
                                     ("ffn_dropout_masks", t_m)):
            print(f"time  {key} {name} B={B} T'={L} rate 0.3 ({fused_body(key, name)} body): "
                  f"kernel {turns[0]:.4f}/{turns[1]:.4f} ms, plain {turns[2]:.4f}/"
                  f"{turns[3]:.4f} ms", flush=True)
            for row in fused_rows(key, name):
                rows[row].update(ms=kt, plain_ms=pt, library_ms=None)
        print(f"time  {name} forward+backward, fused kernels vs the unfused module "
              f"(autograd): FF {fused_ff:.4f} vs {ref_ff:.4f} ms, conv {fused_cv:.4f} vs "
              f"{ref_cv:.4f} ms", flush=True)
        # x read and out written once, the weights and vectors read once (the
        # backward also reads g and writes dx, dW and the vectors); the
        # products (2 forward, 5 backward) and the conv's k taps per element
        m = B * L
        vec_ff = 4 * (3 * d + f)
        vec_cv = 4 * (8 * d + KW * d)
        bounds = {
            "ffn": bound_ms(nbytes(x, x, *ff), 2 * 2.0 * m * d * f, name),
            "ffn_bwd": bound_ms(nbytes(x, gout, x, *ff[:5], ff[2], ff[4]) + vec_ff,
                                5 * 2.0 * m * d * f, name),
            "conv_module": bound_ms(nbytes(x, x, *conv),
                                    2.0 * m * d * (2 * d + d) + 2.0 * m * d * KW, name),
            "conv_module_bwd": bound_ms(nbytes(x, gout, x, *conv[:9], conv[2], conv[8])
                                        + vec_cv, 2.0 * m * d * (3 * 2 * d + 2 * d)
                                        + 3 * 2.0 * m * d * KW, name),
            # one bool written per entry; the hash's integer work is not counted
            "ffn_dropout_masks": bound_ms(m * (d + f) + 4, 0, name),
        }
        for key, (bt, by) in bounds.items():
            print(f"bound {key} {name}: {bt:.4f} ms ({by})", flush=True)
            for row in fused_rows(key, name):
                rows[row]["bound_ms"], rows[row]["bound_by"] = bt, by
        del x, gout, ff, conv
    for key, row in rows.items():
        row["dtype"] = FUSED_ROW_DTYPE[key]
    return rows


@contextlib.contextmanager
def fused_bwd_body(body: str | None):
    """Inside, every float32 fused backward of the model's normal entry
    points runs on ``body`` (``"tile"``, the other arm of an A/B: the
    replaced ``ffn.py::bwd_plan`` answers it for float32 whatever the shape;
    the forwards keep ``fwd_plan``'s body), or on ``bwd_plan``'s choice
    (``None``)."""
    saved = ffn_mod.bwd_plan
    if body is not None:
        ffn_mod.bwd_plan = (lambda dtype, *a, **k: BwdPlan(body) if dtype == torch.float32
                            else saved(dtype, *a, **k))
    try:
        yield
    finally:
        ffn_mod.bwd_plan = saved


@contextlib.contextmanager
def fused_fwd_body(body: str):
    """Inside, every float32 fused forward of the model's normal entry points
    that names no body runs on ``body`` (``"tile"`` or ``"f32"``, an arm of
    the forwards' A/B: the replaced ``ffn.py::fwd_plan`` answers it for
    float32; the backwards keep ``bwd_plan``'s body)."""
    saved = ffn_mod.fwd_plan
    ffn_mod.fwd_plan = (lambda what, x, w1, w2, b=None:
                        BwdPlan(body) if x.dtype == torch.float32 and b is None
                        else saved(what, x, w1, w2, b))
    try:
        yield
    finally:
        ffn_mod.fwd_plan = saved


FUSED_ARGS = {**CONFORMER_ARGS, **FUSED_FLAGS["conformer"]}


def fused_conformer_phase(card: str, default_median: float, unfused32_median: float) -> dict:
    """The bf16 Conformer train step with the fused FF and conv modules,
    beside the default step's median (``default_median``, phase 8); one
    float32 step against the plain path; two seeded runs bit-equal; one
    eval forward; the float32 fused step's A/B (``fused_float32_steps``)
    beside the unfused float32 step's median (``unfused32_median``, phase
    8)."""
    device = torch.device("cuda")
    batch = batch_tensors(bench_batch(B, T, U), device)
    n = 10
    model, losses, times, launches = train_steps(dict(FUSED_ARGS), 0, batch, 2, n)
    per_step = {"ffn": 2 * CONFORMER_LAYERS, "ffn_bwd": 2 * CONFORMER_LAYERS,
                "conv_module": CONFORMER_LAYERS, "conv_module_bwd": CONFORMER_LAYERS,
                "ffn_dropout_masks": 0, "mhsa_qkv": CONFORMER_LAYERS,
                "mhsa_qkv_bwd": CONFORMER_LAYERS, "dropout_masks": 0, "ctc_alpha": 2,
                "ctc_beta": 2, **NO_GRU}
    want = {k: v * n for k, v in per_step.items()}
    check_front_ctc_bodies(f"{n} fused bf16 Conformer train steps", alpha=2 * n, beta=2 * n)
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in FUSED_BODIES}
    want_bodies = {k: {b: per_step[k] * n * (b == "sm90") for b in WRAPPERS[k].launches_by_body}
                   for k in FUSED_BODIES}
    check(launches == want and bodies == want_bodies,
          f"launches over {n} fused bf16 Conformer train steps {launches} == per step 16 "
          f"FF forward and backward, 8 conv forward and backward, 8/8 attention, 2/2 CTC; "
          f"forwards and backwards by body {bodies}: all on the sm90 body")
    check(all(math.isfinite(v) for v in losses),
          f"fused bf16 Conformer train losses finite: "
          f"{', '.join(f'{v:.4f}' for v in losses)}")
    med = statistics.median(times)
    print(f"conformer train step fused FF + conv bf16 B={B} T={T} U={U} (the recipe of "
          f"phase 8): steps {', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median "
          f"{med * 1e3:.2f} ms, {B / med:.2f} seq/s, beside the default step's median "
          f"{default_median * 1e3:.2f} ms ({med / default_median:.4f}x) ({card})", flush=True)

    # one eval forward of the fused model: forwards only
    reset_launches()
    with torch.inference_mode():
        log_probs, _, _ = model_forward(model, batch[0], batch[4], batch[2])
    torch.cuda.synchronize()
    ev = read_launches()
    ev_bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in FUSED_FWDS}
    want_ev = {k: 0 for k in KERNELS} | {"ffn": 2 * CONFORMER_LAYERS,
                                         "conv_module": CONFORMER_LAYERS,
                                         "mhsa_qkv": CONFORMER_LAYERS}
    check(ev == want_ev and bool(torch.isfinite(log_probs).all())
          and ev_bodies == {k: {"sm90": want_ev[k], "f32": 0, "tile": 0} for k in FUSED_FWDS},
          f"eval forward of the fused model launched {ev}: 16 FF and 8 conv forwards "
          f"(by body {ev_bodies}: all on the sm90 body), 8 attention forwards, no "
          f"backward; log-probs finite")
    del model

    args32 = {**FUSED_ARGS, "compute_dtype": "float32"}
    model = build_model(args32, N_DAYS, device, seed=1)
    out = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss, _ = _loss_and_metrics(args32, model, batch, step_generator(device, 0, 0),
                                    plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        out[plain] = (loss.item(), [p.grad.clone() for p in model.parameters()],
                      read_launches())
        if not plain:
            bodies32 = {k: dict(WRAPPERS[k].launches_by_body) for k in FUSED_BODIES}
    (loss_k, grads_k, launch_k), (loss_p, grads_p, launch_p) = out[False], out[True]
    on_body = all(c[fused_body(k, "float32")] == per_step[k] == sum(c.values())
                  for k, c in bodies32.items())
    check(launch_k == per_step and not any(launch_p.values()) and on_body,
          f"float32 fused Conformer step launches: kernel path {launch_k} (forwards and "
          f"backwards by body {bodies32}: the forwards on the {FUSED_BODY['fwd']['float32']} "
          f"body, the backwards on the {FUSED_BODY['bwd']['float32']} body), plain path "
          f"{launch_p}")
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    check(abs(loss_k - loss_p) <= CONFORMER_GRAD_TOL * abs(loss_p)
          and max(errs) <= CONFORMER_GRAD_TOL,
          f"float32 fused Conformer train step (dropout, DropPath, SpecAugment, noise "
          f"on), kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f}; {len(errs)} "
          f"gradient leaves, max abs err / max |ref| {max(errs):.3e} <= "
          f"{CONFORMER_GRAD_TOL:g}")
    del model, out, grads_k, grads_p

    runs = []
    for _ in range(2):
        model, losses, _, _ = train_steps(dict(FUSED_ARGS), 0, batch, 0, 2)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
        del model
    (l1, p1), (l2, p2) = runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    check(same, f"two fused bf16 Conformer runs of 2 steps from one seed bit-equal: "
          f"losses {l1} / {l2}")
    del p1, p2, runs
    ran = fused_float32_steps(card, batch, unfused32_median)
    for k in FUSED_BODIES:
        ran[f"{k}/f32"] += bodies32[k]["f32"]
    return {k: launches[k] for k in NO_FUSED} | ran


def fused_float32_steps(card: str, batch, unfused_median: float) -> dict:
    """The float32 fused Conformer train step (``FUSED_ARGS`` in float32):
    after 2 warm-up steps, two A/Bs of ``AB_STEPS`` timed steps a turn in
    turns tile, f32, f32, tile: the backwards' (``fused_bwd_body``: their
    16 FF and 8 conv launches a step on the tile body in the tile turns, on
    f32 in the others; the forwards on ``fwd_plan``'s body throughout),
    then the forwards' (``fused_fwd_body``, the backwards on ``bwd_plan``'s
    body throughout), whose turns also time ``AB_EVALS`` eval forwards of
    the model at the batch's shapes (B=64, T=1280: 16 FF and 8 conv
    forwards each on the turn's body). Each arm's median beside the unfused
    float32 step's (``unfused_median``, phase 8); returns the f32 launches
    of the turns on f32."""
    device = torch.device("cuda")
    args32 = {**FUSED_ARGS, "compute_dtype": "float32"}
    model = build_model(args32, N_DAYS, device, seed=0)
    opt, sched = make_optimizer(args32, model.parameters())
    step = make_train_step(args32, model, opt, sched)
    losses, i = [], 0
    for _ in range(2):  # warm-up
        losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
        i += 1
    ran = dict.fromkeys(F32_FUSED.values(), 0)
    per_step = {"ffn": 2 * CONFORMER_LAYERS, "ffn_bwd": 2 * CONFORMER_LAYERS,
                "conv_module": CONFORMER_LAYERS, "conv_module_bwd": CONFORMER_LAYERS}
    fixed = {k: fused_body(k, "float32") for k in FUSED_BODIES}
    for what, keys, arm_body in (("backwards", FUSED_BWDS, fused_bwd_body),
                                 ("forwards", FUSED_FWDS, fused_fwd_body)):
        times, evals = {"tile": [], "f32": []}, {"tile": [], "f32": []}
        for arm in ("tile", "f32", "f32", "tile"):
            on = {k: arm if k in keys else fixed[k] for k in FUSED_BODIES}
            # the backwards' f32 arm is bwd_plan's own (its K ranges)
            ctx = arm_body(arm) if what == "forwards" else arm_body(
                "tile" if arm == "tile" else None)
            with ctx:
                torch.cuda.synchronize()
                reset_launches()
                for _ in range(AB_STEPS):
                    t0 = time.perf_counter()
                    losses.append(float(step(batch, step_generator(device, 0, i))
                                        ["train/loss"]))
                    torch.cuda.synchronize()
                    times[arm].append(time.perf_counter() - t0)
                    i += 1
                bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in FUSED_BODIES}
                n_eval = AB_EVALS if what == "forwards" else 0
                for _ in range(n_eval):
                    t0 = time.perf_counter()
                    with torch.inference_mode():
                        log_probs, _, _ = model_forward(model, batch[0], batch[4], batch[2])
                    torch.cuda.synchronize()
                    evals[arm].append(time.perf_counter() - t0)
                if n_eval:
                    check(bool(torch.isfinite(log_probs).all()),
                          f"float32 fused eval forwards, a {arm} turn: log-probs finite")
                    del log_probs
                ev_bodies = {k: {b: n - bodies[k][b]
                                 for b, n in WRAPPERS[k].launches_by_body.items()}
                             for k in FUSED_BODIES}
            want = {k: {b: n * AB_STEPS if b == on[k] else 0 for b in ("sm90", "f32", "tile")}
                    for k, n in per_step.items()}
            want_ev = {k: {b: n * n_eval if b == on[k] and k in FUSED_FWDS else 0
                           for b in ("sm90", "f32", "tile")} for k, n in per_step.items()}
            check(bodies == want and ev_bodies == want_ev,
                  f"{AB_STEPS} float32 fused Conformer train steps, the {what}' A/B, a {arm} "
                  f"turn: forwards and backwards by body {bodies} == {want}; {n_eval} eval "
                  f"forwards {ev_bodies} == {want_ev}")
            if arm == "f32":
                for k in FUSED_BODIES:
                    ran[f"{k}/f32"] += bodies[k]["f32"] + ev_bodies[k]["f32"]
        med = {arm: statistics.median(v) for arm, v in times.items()}
        print(f"conformer train step fused FF + conv float32 B={B} T={T} U={U}, the {what}' "
              f"A/B in turns (tile, f32, f32, tile), {2 * AB_STEPS} steps an arm: f32 {what} "
              f"median {med['f32'] * 1e3:.2f} ms "
              f"({', '.join(f'{t * 1e3:.2f}' for t in times['f32'])}), "
              f"{B / med['f32']:.2f} seq/s; tile {what} median {med['tile'] * 1e3:.2f} ms "
              f"({', '.join(f'{t * 1e3:.2f}' for t in times['tile'])}); f32 - tile "
              f"{(med['f32'] - med['tile']) * 1e3:+.2f} ms; the unfused float32 step's median "
              f"(phase 8) {unfused_median * 1e3:.2f} ms ({card})", flush=True)
        if what == "forwards":
            ev = {arm: statistics.median(v) for arm, v in evals.items()}
            print(f"conformer eval forward fused FF + conv float32 B={B} T={T}, in the same "
                  f"turns, {2 * AB_EVALS} forwards an arm: f32 forwards median "
                  f"{ev['f32'] * 1e3:.2f} ms "
                  f"({', '.join(f'{t * 1e3:.2f}' for t in evals['f32'])}); tile forwards "
                  f"median {ev['tile'] * 1e3:.2f} ms "
                  f"({', '.join(f'{t * 1e3:.2f}' for t in evals['tile'])}); f32 - tile "
                  f"{(ev['f32'] - ev['tile']) * 1e3:+.2f} ms ({card})", flush=True)
    del model, opt, sched, step
    check(all(math.isfinite(v) for v in losses),
          f"float32 fused Conformer train losses finite: "
          f"{', '.join(f'{v:.4f}' for v in losses)}")
    return ran


# ------------------------------- the GRU's opt-in kernels: Adam and the matmul

# The projection of GRU layers 1-4 at the train step: M = B*L = 20032 rows,
# K = H*D = 2048, N = 3H*D = 6144.
MM_M, MM_K, MM_N = B * L, H * D, 3 * H * D
MM_RAGGED_M = 1001  # M % 128 = 105
# Kernel vs plain, max abs error relative to the output's largest entry.
# Float32: the same float32 products summed in another order (2048-, 6144-
# and 20032-long sums). Bfloat16: both round the same float32 sums once to
# bf16, and a sum that falls the other way moves an entry by one bf16 step,
# at most 2**-7 of the largest entry.
MM_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
# The body each dtype takes at these shapes (ops/kernels/matmul.py::matmul_body).
MM_BODY = {"float32": "f32", "bfloat16": "sm90"}
# Adam, kernel vs plain: the same float32 operations in the same order, each
# rounded once (the kernel's _rn intrinsics forbid FMA contraction), so equal
# up to the card's correctly rounded sqrt and division; the bounds are one
# float32 ulp of |p| < 8 and of the moments (|m| < 1, v < 1).
ADAM_TOL = {"p": 1e-6, "m": 1e-7, "v": 1e-7}
ADAM_HYPER = dict(b1=0.9, b2=0.999, eps=0.1, l2=1e-5)  # the GRU recipe's


def mm_library(a, b, kind):
    """One PyTorch call for the same product (bias and rounding left out):
    ``torch.mm`` in the layout, float32 out for bf16 operands."""
    x, y = {"nn": (a, b), "nt": (a, b.T), "tn": (a.T, b)}[kind]
    if x.dtype == torch.bfloat16:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.mm(x, y)


def matmul_kernel_phase() -> dict:
    """The projection matmul, kernel vs plain, at the train step's shapes
    and at a ragged M, float32 and bfloat16; times and bounds. Every bf16
    product here takes the sm90 body (TMA + wgmma), every float32 one the
    tile body, and a bf16 product whose K is not a multiple of 8 the tile
    body (the per-body launch counts)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    reset_launches()
    x = torch.randn((MM_M, MM_K), generator=g, device="cuda")
    w = MM_K**-0.5 * torch.randn((MM_K, MM_N), generator=g, device="cuda")
    gout = torch.randn((MM_M, MM_N), generator=g, device="cuda")
    bias = 0.1 * torch.randn((MM_N,), generator=g, device="cuda")
    row = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ops = {"nn": (x.to(dt), w.to(dt)), "nt": (gout.to(dt), w.to(dt)),
               "tn": (x.to(dt), gout.to(dt))}
        for kind, (a, b) in ops.items():
            bb = bias if kind == "nn" else None
            for m in (MM_M, MM_RAGGED_M):
                ak, bk = (a[:m], b) if kind != "tn" else (a[:m], b[:m])
                before = dict(tiled_matmul.launches_by_body)
                with torch.inference_mode():
                    out = tiled_matmul(ak, bk, kind=kind, bias=bb)
                    ref = tiled_matmul_plain(ak, bk, kind=kind, bias=bb)
                    again = tiled_matmul(ak, bk, kind=kind, bias=bb)
                torch.cuda.synchronize()
                err, same = rel_err(out, ref), torch.equal(out, again)
                body = MM_BODY[name]
                took = tiled_matmul.launches_by_body[body] - before[body]
                check(err <= MM_TOL[name] and same and out.dtype == ref.dtype and took == 2,
                      f"tiled_matmul {kind} {name} M={m} K={MM_K} N={MM_N}"
                      f"{' + bias' if bb is not None else ''}: max abs err / max |ref| "
                      f"{err:.3e} <= {MM_TOL[name]:.3g}; rerun bit-equal {same}; "
                      f"{took} of 2 launches on the {body} body")
                if name == "bfloat16" and kind == "nn" and m == MM_M:
                    row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                del out, ref, again
            with torch.inference_mode():
                kt, pt, turns = time_turns(lambda: tiled_matmul(a, b, kind=kind, bias=bb),
                                           lambda: tiled_matmul_plain(a, b, kind=kind,
                                                                      bias=bb), 3, 3)
                lib = time_ms(lambda: mm_library(a, b, kind), 5)
            out_bytes = {"nn": MM_M * MM_N, "nt": MM_M * MM_K, "tn": MM_K * MM_N}[kind]
            bt, by = bound_ms(nbytes(a, b) + out_bytes * a.element_size()
                              + (nbytes(bb) if bb is not None else 0),
                              2.0 * MM_M * MM_K * MM_N, name)
            tflops = 2.0 * MM_M * MM_K * MM_N / kt / 1e9
            print(f"time  tiled_matmul {kind} {name} M={MM_M} K={MM_K} N={MM_N} "
                  f"({MM_BODY[name]} body): kernel {turns[0]:.4f}/{turns[1]:.4f} ms "
                  f"({tflops:.1f} TFLOP/s), plain {turns[2]:.4f}/{turns[3]:.4f} ms, "
                  f"torch.mm {lib:.4f} ms (kernel / torch.mm {kt / lib:.2f}); bound "
                  f"{bt:.4f} ms ({by})", flush=True)
            if name == "bfloat16" and kind == "nn":
                row.update(ms=kt, plain_ms=pt, library_ms=lib, bound_ms=bt, bound_by=by)
        del ops
    # K = 2044: a row stride TMA cannot take sends bf16 to the tile body
    a, b = x[:MM_RAGGED_M, :2044].bfloat16(), w[:2044].bfloat16()
    before = dict(tiled_matmul.launches_by_body)
    with torch.inference_mode():
        out = tiled_matmul(a, b, kind="nn", bias=bias)
        err = rel_err(out, tiled_matmul_plain(a, b, kind="nn", bias=bias))
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in tiled_matmul.launches_by_body.items()}
    check(err <= MM_TOL["bfloat16"] and took == {"sm90": 0, "f32": 0, "tile": 1},
          f"tiled_matmul nn bfloat16 M={MM_RAGGED_M} K=2044 N={MM_N} + bias: max abs err / "
          f"max |ref| {err:.3e} <= {MM_TOL['bfloat16']:.3g}; launches by body {took}")
    print(f"tiled_matmul launches by body in this phase: {tiled_matmul.launches_by_body}",
          flush=True)
    # the main path's dtype (the recipe's bf16) and its forward layout
    row.update(dtype="bfloat16", layout="nn + bias", body="sm90")
    return row


def adam_kernel_phase() -> dict:
    """Adam over the GRU baseline's 24 leaves, kernel vs plain; times and
    the bound; ``torch.optim.Adam(fused=True)`` as the library yardstick."""
    g = torch.Generator(device="cuda").manual_seed(6)
    shapes = [p.shape for p in build_model(BENCH_ARGS, N_DAYS, "cuda").parameters()]
    n = sum(math.prod(s) for s in shapes)
    grads = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    base = [[torch.randn(s, generator=g, device="cuda") for s in shapes],
            [0.1 * torch.randn(s, generator=g, device="cuda") for s in shapes],
            [0.01 * torch.rand(s, generator=g, device="cuda") for s in shapes]]
    c1, c2 = adam_scalars(4, 0.9, 0.999)
    hyper = dict(lr=0.02, c1=c1, c2=c2, **ADAM_HYPER)
    kern = [[t.clone() for t in leaves] for leaves in base]
    plain = [[t.clone() for t in leaves] for leaves in base]
    before = adam_update.launches
    adam_update(grads, *kern, **hyper)
    adam_update_plain(grads, *plain, **hyper)
    torch.cuda.synchronize()
    one_launch = adam_update.launches - before == 1
    errs = {k: max((a - b).abs().max().item() for a, b in zip(ka, pa))
            for k, ka, pa in zip("pmv", kern, plain)}
    check(all(errs[k] <= ADAM_TOL[k] for k in errs) and len(shapes) == 24 and one_launch,
          f"adam_update over the GRU's {len(shapes)} leaves ({n:,} parameters) in one "
          f"launch {one_launch}: max abs err p {errs['p']:.3e} <= {ADAM_TOL['p']:g}, m "
          f"{errs['m']:.3e} <= {ADAM_TOL['m']:g}, v {errs['v']:.3e} <= {ADAM_TOL['v']:g}")
    kt, pt, turns = time_turns(lambda: adam_update(grads, *kern, **hyper),
                               lambda: adam_update_plain(grads, *plain, **hyper), 20, 5)
    del plain
    lib = {}
    for impl in ("fused", "foreach"):
        leaves = [torch.nn.Parameter(t.clone()) for t in base[0]]
        for p, gr in zip(leaves, grads):
            p.grad = gr
        opt = torch.optim.Adam(leaves, lr=0.02, betas=(0.9, 0.999), eps=0.1,
                               weight_decay=ADAM_HYPER["l2"], **{impl: True})
        lib[impl] = time_ms(opt.step, 20)
        del leaves, opt
    # g, p, m, v read once and p, m, v written once; ~16 float32 operations
    # an element
    bt, by = bound_ms(28.0 * n, 16.0 * n, "float32")
    print(f"time  adam_update over {n:,} parameters: kernel {turns[0]:.4f}/{turns[1]:.4f} "
          f"ms, plain {turns[2]:.4f}/{turns[3]:.4f} ms, torch.optim.Adam fused "
          f"{lib['fused']:.4f} ms, foreach {lib['foreach']:.4f} ms; bound {bt:.4f} ms "
          f"({by})", flush=True)
    return {"max_abs_err": max(errs.values()), "ms": kt, "plain_ms": pt,
            "library_ms": lib["fused"], "bound_ms": bt, "bound_by": by, "dtype": "float32"}


GRU_FUSED_ARGS = {**BENCH_ARGS, **FUSED_FLAGS["gru"]}
GRU_FUSED_PER_STEP = {"gru_scan_gates": 5, "gru_scan_bwd": 5, "ctc_alpha": 1, "ctc_beta": 1,
                      "tiled_matmul": 12, "adam_update": 1}


def gru_fused_step_phase(card: str, default_median: float) -> dict:
    """The bf16 GRU step with ``fused_optimizer`` and ``use_pallas_matmul``;
    one float32 step (gradients and the update) against the plain path; two
    seeded runs bit-equal."""
    device = torch.device("cuda")
    batch = batch_tensors(bench_batch(B, T, U), device)
    n = 10
    model, losses, times, launches = train_steps(dict(GRU_FUSED_ARGS), 0, batch, 2, n)
    per_step = {k: 0 for k in KERNELS} | GRU_FUSED_PER_STEP
    check_scan_bodies(f"{n} flagged bf16 GRU train steps", "persistent")
    check_front_ctc_bodies(f"{n} flagged bf16 GRU train steps", alpha=n, beta=n)
    by_body = dict(tiled_matmul.launches_by_body)
    check(launches == {k: v * n for k, v in per_step.items()},
          f"launches over {n} flagged bf16 GRU train steps {launches} == per step 12 "
          f"projection matmuls (4 layers x nn, nt, tn), 1 Adam, 5/5 scan, 1/1 CTC")
    check(by_body == {"sm90": 12 * n, "f32": 0, "tile": 0},
          f"projection matmul launches by body over the {n} steps {by_body}: all 12 a "
          f"step on the sm90 body (TMA + wgmma)")
    check(all(math.isfinite(v) for v in losses),
          f"flagged bf16 GRU train losses finite: {', '.join(f'{v:.4f}' for v in losses)}")
    med = statistics.median(times)
    print(f"train step bf16 with fused_optimizer + use_pallas_matmul B={B} T={T} U={U}: "
          f"steps {', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median "
          f"{med * 1e3:.2f} ms, {B / med:.2f} seq/s; the default step (phase 5) "
          f"{default_median * 1e3:.2f} ms, {B / default_median:.2f} seq/s; ratio "
          f"{med / default_median:.3f} ({card})", flush=True)
    del model

    # one float32 step without noise and dropout, kernel path vs plain path:
    # the gradients, then the update (FusedAdam on the kernel; the plain
    # update on the plain path's gradients). The first update is
    # lr * g / (|g| + eps) (c1, c2 undo the moments' decay), which moves by
    # at most lr / eps = 0.2 times a change of g: each updated parameter may
    # differ by 0.2 times its leaf's largest gradient difference, plus its
    # float32 rounding (1e-6).
    args32 = {**GRU_FUSED_ARGS, "compute_dtype": "float32", "dropout": 0.0,
              "whiteNoiseSD": 0.0, "constantOffsetSD": 0.0}
    model = build_model(args32, N_DAYS, device, seed=1)
    start = [p.detach().clone() for p in model.parameters()]
    out = {}
    for plain in (False, True):
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss, _ = _loss_and_metrics(args32, model, batch, step_generator(device, 0, 0),
                                    plain=plain)
        loss.backward()
        ps = list(model.parameters())
        if plain:
            c1, c2 = adam_scalars(0, 0.9, 0.999)
            with torch.no_grad():
                adam_update_plain([p.grad for p in ps], ps, [torch.zeros_like(p) for p in ps],
                                  [torch.zeros_like(p) for p in ps], lr=args32["lrStart"],
                                  c1=c1, c2=c2, **ADAM_HYPER)
        else:
            opt, _ = make_optimizer(args32, ps)
            check(type(opt) is FusedAdam, f"fused_optimizer gives {type(opt).__name__}")
            opt.step()
        torch.cuda.synchronize()
        out[plain] = (loss.item(), [p.grad.clone() for p in ps],
                      [p.detach().clone() for p in ps], read_launches())
        if not plain:
            by_body = dict(tiled_matmul.launches_by_body)
            check_scan_bodies("float32 flagged GRU step", f32_scan_body())
    (loss_k, grads_k, new_k, launch_k), (loss_p, grads_p, new_p, launch_p) = (out[False],
                                                                               out[True])
    check(launch_k == per_step and not any(launch_p.values())
          and by_body == {"sm90": 0, "f32": 12, "tile": 0},
          f"float32 flagged step launches: kernel path {launch_k} (projections by body "
          f"{by_body}: all 12 on the f32 body), plain path {launch_p}")
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    check(abs(loss_k - loss_p) <= GRAD_TOL * abs(loss_p) and max(errs) <= GRAD_TOL,
          f"float32 flagged GRU train step, kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; {len(errs)} gradient leaves, max abs err / max |ref| "
          f"{max(errs):.3e} <= {GRAD_TOL:g}")
    slack = [(a - b).abs().max().item() - (0.2 * (ga - gb).abs().max().item() + 1e-6)
             for a, b, ga, gb in zip(new_k, new_p, grads_k, grads_p)]
    worst = max((a - b).abs().max().item() for a, b in zip(new_k, new_p))
    check(max(slack) <= 0, f"float32 flagged step, parameters after the update, kernels vs "
          f"plain: max abs err {worst:.3e}; every leaf within 0.2 x its largest gradient "
          f"difference + 1e-6 (worst margin {max(slack):.3e})")
    del model, out, grads_k, grads_p, new_k, new_p

    runs = []
    for _ in range(2):
        model, losses, _, _ = train_steps(dict(GRU_FUSED_ARGS), 0, batch, 0, 2)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
        del model
    (l1, p1), (l2, p2) = runs
    same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    check(same, f"two flagged bf16 GRU runs of 2 steps from one seed bit-equal: losses "
          f"{l1} / {l2}")
    return {k: launches[k] for k in NO_GRU_FUSED}


AB_STEPS = 3  # float32 train steps a turn of the step-body A/B
AB_EVALS = 3  # float32 fused eval forwards a turn of the fused forwards' A/B


def gru_float32_steps_phase(card: str) -> None:
    """The float32 GRU train step at full width (``BENCH_ARGS`` in float32,
    the JAX trainer's default dtype), default and with both flags: after 2
    warm-up steps each model takes ``AB_STEPS`` timed steps a turn, in turns
    step, plan, plan, step (``scan_body``): its scans on the step body
    in the step turns, on ``scan_plan``'s body in the others. The medians of
    each arm; the flagged step's 12 projections on the f32 body."""
    device = torch.device("cuda")
    batch = batch_tensors(bench_batch(B, T, U), device)
    body32 = f32_scan_body()
    medians = {}
    for tag, args in (("default", BENCH_ARGS), ("flagged", GRU_FUSED_ARGS)):
        args32 = {**args, "compute_dtype": "float32"}
        model = build_model(args32, N_DAYS, device, seed=0)
        opt, sched = make_optimizer(args32, model.parameters())
        step = make_train_step(args32, model, opt, sched)
        losses, i = [], 0
        for _ in range(2):  # warm-up
            losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
            i += 1
        times = {"step": [], body32: []}
        mm = 12 * AB_STEPS if tag == "flagged" else 0
        for arm in ("step", body32, body32, "step"):
            with scan_body(arm if arm == "step" else None):
                torch.cuda.synchronize()
                reset_launches()
                for _ in range(AB_STEPS):
                    t0 = time.perf_counter()
                    losses.append(float(step(batch, step_generator(device, 0, i))["train/loss"]))
                    torch.cuda.synchronize()
                    times[arm].append(time.perf_counter() - t0)
                    i += 1
            check_scan_bodies(f"{AB_STEPS} {tag} float32 GRU train steps, a {arm} turn", arm)
            by_body = dict(tiled_matmul.launches_by_body)
            check(read_launches(KERNELS)["tiled_matmul"] == mm
                  and by_body == {"sm90": 0, "f32": mm, "tile": 0},
                  f"{AB_STEPS} {tag} float32 GRU train steps, a {arm} turn: projection matmul "
                  f"launches by body {by_body}")
        del model, opt, sched, step
        check(all(math.isfinite(v) for v in losses),
              f"{tag} float32 GRU train losses finite: {', '.join(f'{v:.4f}' for v in losses)}")
        medians[tag] = {arm: statistics.median(v) for arm, v in times.items()}
        m = medians[tag]
        print(f"train step float32 {tag} B={B} T={T} U={U}, A/B in turns (step, {body32}, "
              f"{body32}, step), {2 * AB_STEPS} steps an arm: {body32} body median "
              f"{m[body32] * 1e3:.2f} ms ({', '.join(f'{t * 1e3:.2f}' for t in times[body32])}), "
              f"{B / m[body32]:.2f} seq/s; step body median {m['step'] * 1e3:.2f} ms "
              f"({', '.join(f'{t * 1e3:.2f}' for t in times['step'])}); {body32} / step "
              f"{m[body32] / m['step']:.3f} ({card})", flush=True)
    print(f"train step float32 on the {body32} body: flagged / default "
          f"{medians['flagged'][body32] / medians['default'][body32]:.3f}", flush=True)


def cli_phase(card: str) -> None:
    """``nsd-train`` (``training/cli.py::main``) on the recipe's config with
    the three flags and a profile window, then load_model -> eval -> decode."""
    out_dir = CLI_RUN
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ds = synthetic_dataset(seed=0, n_days=N_DAYS, trials_per_day=8, n_channels=C,
                           min_t=400, max_t=1200, min_u=20, max_u=U)
    data = out_dir / "dataset.pkl"
    data.write_bytes(pickle.dumps(ds))
    run = out_dir / "run"
    n_steps, n_evals = 20, 2
    reset_launches()
    t0 = time.perf_counter()
    summary = train_cli.main([
        "--config", "neural_speech_decoder_tpu/configs/gru_baseline.yaml",
        f"outputDir={run}", f"datasetPath={data}", f"nBatch={n_steps}", "evalEvery=10",
        "checkpointEvery=10", "fused_optimizer=true", "use_pallas_matmul=true",
        "deviceResidentData=true", "profile_steps=[12,14]", "wandb_mode=disabled"])
    launches = read_launches()
    check_scan_bodies("nsd-train (bf16 steps and evals)", "persistent")
    print(f"nsd-train (training/cli.py) on configs/gru_baseline.yaml with the three flags: "
          f"{n_steps} steps with {n_evals} evals and 2 checkpoints in "
          f"{time.perf_counter() - t0:.1f} s; {summary} ({card})", flush=True)
    train_ds, test_ds = pack_days(ds["train"]), pack_days(ds["test"])
    nb = -(-test_ds.n_trials // B)
    per_step = {k: v * n_steps for k, v in GRU_FUSED_PER_STEP.items()}
    want = {k: 0 for k in KERNELS} | per_step | {
        "tiled_matmul": per_step["tiled_matmul"] + 4 * nb * n_evals,
        "frontend": nb * n_evals, "gru_scan": 5 * nb * n_evals,
        "ctc_alpha": per_step["ctc_alpha"] + nb * n_evals}
    check_front_ctc_bodies("nsd-train (bf16 steps and evals)", tc=nb * n_evals,
                           alpha=want["ctc_alpha"], beta=want["ctc_beta"])
    check(launches == want and tiled_matmul.launches_by_body["tile"] == 0,
          f"nsd-train launched {launches} == {n_steps} flagged steps and {n_evals} evals "
          f"of {nb} batch(es) (4 forward projections each); projection launches by body "
          f"{tiled_matmul.launches_by_body}")
    traces = list((run / "profile").glob("*.json"))
    text = traces[0].read_text() if traces else ""
    check(len(traces) == 1 and "adam_kernel" in text and "gemm_sm90_kernel" in text,
          f"profile window trace {[t.name for t in traces]} ({len(text):,} bytes) holds "
          f"the Adam and projection kernels")
    names = ("args", "trainingStats", "modelState", "lastState")
    check(all((run / k).is_file() for k in names), f"artifacts {names} written")

    # the device-assembled batches against the host path's, bit for bit
    t_max, u_max = choose_envelope(train_ds, test_ds, max_time=1200)
    device = torch.device("cuda")
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    pairs = [(sample_batch(train_ds, r1, B, t_max, u_max),
              sample_batch(train_ds, r2, B, t_max, u_max, materialize_x=False),
              DeviceData(train_ds, device))]
    test_dd = DeviceData(test_ds, device)
    pairs += [(h, i, test_dd) for h, i in zip(
        eval_batches(test_ds, B, t_max, u_max),
        eval_batches(test_ds, B, t_max, u_max, materialize_x=False))]
    same = all(torch.equal(a, b) and a.dtype == b.dtype
               for host, idx, dd in pairs
               for a, b in zip(batch_tensors(host, device), dd.assemble(idx)))
    check(same, f"{len(pairs)} device-assembled batches (1 train, {len(pairs) - 1} eval "
          f"with padded rows) bit-equal to the host path's")

    model, _ = load_model(str(run), device="cuda")
    reset_launches()
    _, per, _, _ = run_eval(make_eval_step(model), test_ds, B, t_max, u_max, device,
                            device_data=test_dd)
    ev = read_launches()
    best = float(summary["summary/best_cer"])
    check(ev["tiled_matmul"] == 4 * nb and ev["adam_update"] == 0
          and math.isfinite(per) and abs(per - best) <= 0.02,
          f"reloaded best model (use_pallas_matmul from its args): eval launched "
          f"{ev['tiled_matmul']} projection matmuls; PER {per:.6f} vs the run's best "
          f"{best:.6f}")
    trial = test_ds.trial(0)
    x = torch.zeros((1, t_max, C), device="cuda")
    x[0, : len(trial)] = torch.from_numpy(trial).to(x.device)
    with torch.inference_mode():
        log_probs, out_lens, _ = model_forward(
            model, x, torch.as_tensor(test_ds.days[:1], device="cuda"),
            torch.tensor([len(trial)], device="cuda"))
        tokens, lens = greedy_decode(log_probs, out_lens)
    check(bool(torch.isfinite(log_probs).all()) and out_lens.item() > 0,
          f"nsd-train run -> load_model -> greedy decode of one test trial: "
          f"{int(lens[0])} labels decoded, {int(test_ds.label_lens[0])} in the reference")
    # the run directory stays for export_phase, which removes it


# ------------------------------------------------------------------ streaming

# The float32 streamed utterances: 400 bins for the GRU (92 frames) and 800
# for the Conformer (192 frames, past its 128-frame left context). Tolerance
# against the offline forward (the kernel path), relative to its largest
# |log-prob|: the same float32 function, its sums in other orders (cuBLAS
# products of other shapes, the smoothing and the strided conv as
# convolutions over other windows, the scan and attention kernels against
# plain steps).
STREAM_BINS = {"gru": 400, "conformer": 800}
STREAM_TOL = 1e-4
STREAM_DAY = 3
STREAM_BATCHES = {"gru": (1, 16, 64, 128, 256, 512), "conformer": (1, 16, 64, 128, 256)}
DEADLINE_MS = 80.0  # a chunk is 4 bins of 20 ms: a stream is real-time below it
BEAM_WIDTH = 8
BEAM_TOL = 1e-5  # scores: log-adds of the same float32 operands in other orders


def check_no_launches(tag: str) -> None:
    launched = {k: n for k, n in read_launches().items() if n}
    check(not launched,
          f"{tag}: no hand kernel launched (the streaming path has none): {launched}")


def stream_chunks(st, x) -> torch.Tensor:
    """Stream ``x [B, T, C]`` (on the card) in 4-bin chunks and flush:
    every output, on the card."""
    outs = [st.process_async(x[:, i: i + STREAM_CHUNK])
            for i in range(0, x.shape[1], STREAM_CHUNK)]
    outs.append(torch.from_numpy(st.flush()).cuda())
    return torch.cat(outs, dim=1)


def stream_float32_check(kind: str, card: str) -> None:
    """A float32 utterance streamed in 4-bin chunks (steady chunks replayed
    as CUDA graphs) against the offline forward of the same weights (a
    non-trivial day affine) through ``models.api.forward``, the kernel path;
    the streamed length is (T - k) // s."""
    cfg, params = stream_model(kind, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    day_w, day_b = params["day"]["weight"], params["day"]["bias"]
    day_w += 0.05 * torch.randn(day_w.shape, generator=g, device="cuda")
    day_b += 0.1 * torch.randn(day_b.shape, generator=g, device="cuda")
    t = STREAM_BINS[kind]
    x = torch.randn((1, t, C), generator=g, device="cuda")
    model = (GRUDecoder if kind == "gru" else port_conformer.ConformerDecoder)(cfg, params)
    reset_launches()
    with torch.inference_mode():
        logp, out_lens, _ = model_forward(model, x, torch.tensor([STREAM_DAY], device="cuda"),
                                          torch.tensor([t], device="cuda"))
    offline = read_launches()
    if kind == "gru":
        check_scan_bodies("float32 unidirectional offline forward",
                          f32_scan_body(cfg.hidden_dim, 1, 1))
    st = make_streamer(kind, cfg, params, 1, day_idx=STREAM_DAY)
    reset_launches()
    got = stream_chunks(st, x)
    check_no_launches(f"{kind} float32 stream of {t} bins")
    if kind == "gru":
        got = torch.log_softmax(got, dim=-1)
    n = (t - 32) // 4
    ref = logp[:, :n]
    err = (got - ref).abs().max().item() if got.shape == ref.shape else math.inf
    scale = ref.abs().max().item()
    check(got.shape[1] == n == int(out_lens[0]) and err <= STREAM_TOL * scale
          and st._fast.replays > 0,
          f"{kind} float32 stream of {t} bins in 4-bin chunks ({st._fast.replays} chunks "
          f"replayed as CUDA graphs): {got.shape[1]} frames == (T-k)//s == {n}; max abs "
          f"err {err:.3e} <= {STREAM_TOL:g} x max|log-prob| {scale:.3f} against the offline "
          f"forward (kernel launches there: {offline})")


def stream_bf16_offline_check() -> None:
    """The unidirectional GRU's bf16 offline forward, kernel path (the dirs=1
    persistent scan, five launches on that body, the frontend on ``tc``)
    against its plain path, within twice the plain bf16 path's distance from
    float32."""
    cfg, params = stream_model("gru", torch.float32)
    model32 = GRUDecoder(cfg, params)
    model16 = GRUDecoder(dataclasses.replace(cfg, compute_dtype=torch.bfloat16), params)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((B, T, C), generator=g, device="cuda")
    dd = torch.arange(B, device="cuda") % N_DAYS
    reset_launches()
    with torch.inference_mode():
        logits = model16(x, dd)
    launches = read_launches()
    check_scan_bodies("bfloat16 unidirectional offline forward", "persistent")
    check_front_ctc_bodies("bfloat16 unidirectional offline forward", tc=1)
    check(launches == {k: 0 for k in KERNELS} | {"frontend": 1, "gru_scan": cfg.num_layers},
          f"bfloat16 unidirectional forward launches {launches} == 1 frontend and "
          f"{cfg.num_layers} scans")
    with torch.inference_mode():
        plain = model16(x, dd, plain=True)
        plain32 = model32(x, dd, plain=True)
    err = (logits - plain).abs().max().item()
    dist = (plain - plain32).abs().max().item()
    tol = BF16_LOGITS_FACTOR * dist
    check(err <= tol, f"bfloat16 unidirectional logits B={B} T={T}, kernels (dirs=1 "
          f"persistent scan) vs plain: max abs err {err:.3e} <= {tol:.3e} "
          f"({BF16_LOGITS_FACTOR:g} x the plain bf16 path's distance {dist:.3e} from float32)")


def stream_graph_check(kind: str, cfg, params) -> None:
    """Two bf16 B=1 streams of the same chunks, one replaying CUDA graphs and
    one running the same steady step eagerly: every chunk's output and the
    carried state bit-equal over 20 steady chunks."""
    rng = np.random.default_rng(9)
    chunks = [rng.standard_normal((1, STREAM_CHUNK, C)).astype(np.float32) for _ in range(50)]
    graph = make_streamer(kind, cfg, params, 1)
    eager = make_streamer(kind, cfg, params, 1, graphs=False)
    reset_launches()
    for c in chunks[:30]:
        graph.process_async(c)
        eager.process_async(c)
    replays = graph._fast.replays
    same = [torch.equal(graph.process_async(c), eager.process_async(c)) for c in chunks[30:]]
    state = [torch.equal(a, b) for a, b in zip(graph.carried_state(), eager.carried_state())]
    torch.cuda.synchronize()
    check_no_launches(f"{kind} bf16 graph and eager streams")
    check(all(same) and all(state) and graph._fast.replays - replays == 20
          and eager._fast.replays == 0 and eager.fast_path_engaged,
          f"{kind} bf16: 20 steady chunks replayed as CUDA graphs bit-equal to the eager "
          f"step: outputs {sum(same)}/20, carried state {sum(state)}/{len(state)} tensors")


def stream_bytes(st) -> int:
    """A steady chunk's least traffic: every weight read once, the carried
    state read and written once, the chunk in and its output out."""
    state = sum(nbytes(t) for t in st.carried_state())
    return (sum(nbytes(t) for t in st.weights()) + 2 * state
            + st.batch * (STREAM_CHUNK * st.channels + st.cfg.n_out) * 4)


def stream_latency(kind: str, cfg, params, card: str) -> None:
    """B=1 bf16, one frame a chunk: the host p50 of a chunk from host data to
    its output on the host (a sync each, >= 100 chunks), the device time a
    chunk (50 chained chunks already on the card, CUDA events), the eager
    path's two beside them, and the bytes bound."""
    rng = np.random.default_rng(10)
    host = [rng.standard_normal((1, STREAM_CHUNK, C)).astype(np.float32) for _ in range(8)]
    dev = torch.from_numpy(np.stack(host)).cuda()
    readings = {}
    for graphs in (True, False):
        st = make_streamer(kind, cfg, params, 1, graphs=graphs)
        for i in range(30):
            st.process_async(host[i % 8])
        torch.cuda.synchronize()
        check(st.fast_path_engaged, f"{kind} bf16 B=1: the fast path is engaged after 30 "
              f"chunks ({'CUDA graphs' if graphs else 'eager'})")
        reset_launches()
        lat = []
        for i in range(120 if graphs else 50):
            t0 = time.perf_counter()
            st.process_async(host[i % 8]).cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(50):
            st.process_async(dev[i % 8])
        end.record()
        torch.cuda.synchronize()
        check_no_launches(f"{kind} bf16 B=1 latency chunks")
        readings[graphs] = (statistics.median(lat), start.elapsed_time(end) / 50, len(lat))
    n_bytes = stream_bytes(st)
    (p50, dev_ms, n), (e_p50, e_dev, e_n) = readings[True], readings[False]
    print(f"stream {kind} bf16 B=1 latency a chunk: CUDA graph host p50 {p50:.4f} ms "
          f"({n} chunks, host data to host output, a sync each), device {dev_ms:.4f} ms "
          f"(50 chained, CUDA events); eager host p50 {e_p50:.4f} ms ({e_n} chunks), "
          f"device {e_dev:.4f} ms; bytes bound {n_bytes / HBM_BPS * 1e3:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB at {HBM_BPS / 1e12:.2f} TB/s) ({card})", flush=True)


def stream_capacity(kind: str, cfg, params, card: str) -> None:
    """bench_streaming.py's capacity sweep: bf16 streams of one frame a chunk
    with the W=8 on-device beam chained after each chunk; a chunk's time is
    the best of 3 windows of 25 chunks (host clock, one sync a window);
    the largest B under the 80 ms deadline."""
    rng = np.random.default_rng(11)
    rows = []
    for b in STREAM_BATCHES[kind]:
        st = make_streamer(kind, cfg, params, b)
        pool = [rng.standard_normal((b, STREAM_CHUNK, C)).astype(np.float32)
                for _ in range(4)]
        for i in range(30):
            nbest = st.decode_beam(st.process_async(pool[i % 4]), beam_width=BEAM_WIDTH)
        nbest[2][0, 0].item()
        reset_launches()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(25):
                nbest = st.decode_beam(st.process_async(pool[i % 4]), beam_width=BEAM_WIDTH)
            nbest[2][0, 0].item()
            windows.append((time.perf_counter() - t0) / 25 * 1e3)
        check_no_launches(f"{kind} capacity B={b}")
        check(st.fast_path_engaged and bool(torch.isfinite(nbest[2][:, 0]).all()),
              f"{kind} capacity B={b}: fast path engaged, finite best scores")
        ms = min(windows)
        rows.append({"streams": b, "chunk_ms": ms, "realtime": ms < DEADLINE_MS})
        print(f"stream {kind} capacity B={b}: windows "
              f"{', '.join(f'{w:.4f}' for w in windows)} ms a chunk (beam W={BEAM_WIDTH} "
              f"chained), best {ms:.4f} ms ({card})", flush=True)
        del st
        if ms >= DEADLINE_MS:
            break
    cap = max((r["streams"] for r in rows if r["realtime"]), default=0)
    print(f"stream {kind} capacity: {cap} streams under the {DEADLINE_MS:g} ms deadline "
          f"(largest B tried {rows[-1]['streams']}) ({card})", flush=True)


def beam_check() -> None:
    """``prefix_beam_search`` on the card against ``beam_extend`` chained in
    chunks of 7 frames over the same log-probs, and against itself on the
    CPU: prefixes and lengths equal, scores within ``BEAM_TOL``."""
    g = torch.Generator(device="cuda").manual_seed(12)
    b, t = 16, 100
    log_probs = torch.log_softmax(3 * torch.randn((b, t, N_OUT), generator=g,
                                                  device="cuda"), dim=-1)
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    reset_launches()
    ref = prefix_beam_search(log_probs, lens, beam_width=BEAM_WIDTH)
    state = beam_init(b, BEAM_WIDTH, t)
    for i in range(0, t, 7):
        state = beam_extend(state, log_probs[:, i: i + 7])
    chained = beam_finalize(state)
    cpu = prefix_beam_search(log_probs.cpu(), lens.cpu(), beam_width=BEAM_WIDTH)
    check_no_launches("beam search")
    for tag, other in (("chained beam_extend", chained), ("the CPU", cpu)):
        err = (ref[2].cpu() - other[2].cpu()).abs().max().item()
        check(torch.equal(ref[0].cpu(), other[0].cpu()) and torch.equal(ref[1].cpu(),
                                                                      other[1].cpu())
              and err <= BEAM_TOL,
              f"prefix_beam_search B={b} T={t} W={BEAM_WIDTH} on the card vs {tag}: "
              f"prefixes and lens equal, scores max abs err {err:.3e} <= {BEAM_TOL:g}")


def streaming_phase(card: str) -> None:
    """Streaming decode of both models at full width (no hand kernel on
    this path, as in JAX): float32 streams against the offline forwards,
    the dirs=1 bf16 offline scan against its plain path, CUDA graph replay
    against the eager step, B=1 latency, the capacity sweeps, the beam."""
    for kind in ("gru", "conformer"):
        stream_float32_check(kind, card)
    stream_bf16_offline_check()
    for kind in ("gru", "conformer"):
        cfg, params = stream_model(kind, torch.bfloat16)
        stream_graph_check(kind, cfg, params)
        stream_latency(kind, cfg, params, card)
        stream_capacity(kind, cfg, params, card)
    beam_check()


# ------------------------------------------------------ competition decode

COMP_DIR = Path("runs") / "chip_smoke_competition"
COMP_BATCH = 16  # eval_competition's batch
COMP_DAY_SLOTS = [3, 17]  # the synthetic partition's two days, as day-layer slots
BEAM_ORACLE_UTTS, BEAM_ORACLE_FRAMES = 8, 100  # native vs force_python
BEAM_SCORE_TOL = 1e-3  # tests/test_native_beam.py's
# The rescorer at OPT-6.7B shapes (random weights): 100 n-best lists of 20
# hypotheses, each a base sequence of 10-40 token ids with 1-3 tokens
# substituted (close rivals, as in a real n-best list).
LLM_SIZE = "6.7b"
LLM_UTTS, LLM_HYPS, LLM_BATCH = 100, 20, 16
LLM_F32_SEQS = 64  # sentences held against the float32 engine
# bf16 engine vs the float32 engine on the same bf16 weights, per sentence,
# relative to |log-prob|: 32 layers of a bf16 residual stream (one rounding
# of 2**-9 relative per add) under a float32 head.
LLM_TOL = 1e-2
# share of n-best lists whose top-1 under the int8 quantization of the
# bf16 weights is the bf16 top-1
INT8_AGREE = 0.8
# the constructed-ambiguity set (scripts/make_competition_scale_demo.py's
# recipe): corpus words, homophone decoys for half of them, filler words
DEMO_CORPUS, DEMO_FILLER, DEMO_UTTS, DEMO_NBEST = 24, 100, 200, 24
DEMO_OPT = "125m"


def launch_bodies(want: dict) -> tuple[dict, dict]:
    """The launches by body of the serving kernels since the last reset, and
    those of ``want``'s counts on the bodies of the bf16 recipe."""
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in
              ("frontend", "gru_scan", "ffn", "conv_module")} | {
        "mhsa_qkv": dict(mhsa_qkv.launches_by_body),
        "tiled_matmul": dict(tiled_matmul.launches_by_body)}
    want_bodies = {"tiled_matmul": {"sm90": want["tiled_matmul"], "f32": 0, "tile": 0},
                   "frontend": {"tc": want["frontend"], "f32": 0, "fma": 0},
                   "gru_scan": {"persistent": want["gru_scan"], "step": 0},
                   "ffn": {"sm90": want["ffn"], "f32": 0, "tile": 0},
                   "conv_module": {"sm90": want["conv_module"], "f32": 0, "tile": 0},
                   "mhsa_qkv": {"tc": want["mhsa_qkv"], "f32": 0, "fma": 0}}
    return bodies, want_bodies


def competition_forward(tag: str, model, args: dict, ds: dict, per_batch: dict,
                        card: str) -> tuple[dict, dict]:
    """(a) ``collect_model_outputs`` of a run's model at full width (bf16)
    over the synthetic partition: the launches a batch, then every row's
    log-probs against the same call through the plain versions, within
    twice the plain bf16 path's distance from the plain float32 path
    (phase 3's bf16 rule). Returns the outputs and the launches."""
    def collect(m, plain=False):
        return eval_competition.collect_model_outputs(
            None, dataset=ds, partition="test", batch_size=COMP_BATCH, model_bundle=m,
            day_indices=COMP_DAY_SLOTS, plain=plain)

    collect(model)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    out = collect(model)
    launches = read_launches()
    n_batches = sum(-(-len(d["sentenceDat"]) // COMP_BATCH) for d in ds["test"])
    want = {k: 0 for k in KERNELS} | {k: v * n_batches for k, v in per_batch.items()}
    bodies, want_bodies = launch_bodies(want)
    check(launches == want and bodies == want_bodies,
          f"competition forward {tag}: {n_batches} batches of {COMP_BATCH} launched "
          f"{launches} == {per_batch} a batch, no backward or CTC kernel; by body {bodies}")
    plain = collect(model, plain=True)
    model32 = build_model({**args, "compute_dtype": "float32"}, N_DAYS, "cuda")
    model32.load_params(model.params)
    ref32 = collect(model32, plain=True)
    del model32
    n = len(out["logits"])
    shapes = all(a.shape == b.shape == (m, N_OUT) and np.isfinite(a).all()
                 for a, b, m in zip(out["logits"], plain["logits"], out["logitLengths"]))
    err = max(float(np.abs(a - b).max()) for a, b in zip(out["logits"], plain["logits"]))
    dist = max(float(np.abs(a - b).max()) for a, b in zip(plain["logits"], ref32["logits"]))
    tol = BF16_LOGITS_FACTOR * dist
    check(shapes and n == sum(len(d["sentenceDat"]) for d in ds["test"])
          and out["logitLengths"] == plain["logitLengths"] == ref32["logitLengths"]
          and err <= tol,
          f"competition forward {tag}: {n} rows of finite [L, {N_OUT}] log-probs, lengths "
          f"equal; kernels vs plain max abs err {err:.3e} <= {tol:.3e} "
          f"({BF16_LOGITS_FACTOR:g} x the plain bf16 path's distance {dist:.3e} from float32)")
    print(f"competition forward {tag}: forward_seconds {out['forward_seconds']:.3f} for "
          f"{n} trials in {n_batches} batches of {COMP_BATCH} ({card})", flush=True)
    return out, launches


def write_lexicon_lm(d: Path, rng) -> tuple[str, str]:
    """A lexicon of a word for each phone and for each pair of phones (so
    every trie node ends a word, and every utterance of a random-weight
    model has an n-best), and a random bigram ARPA over it."""
    prons = smoke_prons()
    words = list(prons)
    lex = d / "lexicon.txt"
    lex.write_text("".join(f"{w} {' '.join(p)}\n" for w, p in prons.items()))
    uni = rng.dirichlet(np.full(len(words), 0.5))
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, len(words), size=(4 * len(words), 2))}
    lines = ["\\data\\", f"ngram 1={len(words) + 2}", f"ngram 2={len(pairs)}", "",
             "\\1-grams:", "-1.0000\t<s>\t-0.3000", "-1.0000\t</s>"]
    lines += [f"{np.log10(p):.4f}\t{w}\t-0.3000" for w, p in zip(words, uni)]
    lines += ["", "\\2-grams:"]
    lines += [f"{rng.uniform(-2.0, -0.2):.4f}\t{words[a]} {words[b]}" for a, b in sorted(pairs)]
    lines += ["", "\\end\\", ""]
    arpa = d / "lm.arpa"
    arpa.write_text("\n".join(lines))
    return str(lex), str(arpa)


def padded_logits(outputs: dict) -> tuple[np.ndarray, np.ndarray]:
    lens = np.asarray([len(lp) for lp in outputs["logits"]], np.int32)
    x = np.zeros((len(lens), int(lens.max()), N_OUT), np.float32)
    for i, lp in enumerate(outputs["logits"]):
        x[i, : len(lp)] = lp
    return x, lens


def competition_beam(outputs: dict, lex: str, arpa: str, card: str) -> None:
    """(b) The native decoder built from the port's copy, ``lm_decode_batch``
    at the reference's settings over (a)'s outputs (an n-best for every
    utterance), and against ``force_python=True`` on the first utterances."""
    t0 = time.perf_counter()
    so = lm_decoder.build()
    lm_decoder.native_library()
    print(f"competition beam: built {so.name} (g++ -fopenmp) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for tag, out in outputs.items():
        x, lens = padded_logits(out)
        dec = lm_decoder.build_lm_decoder(lex, arpa, 0.5, 100, 18.0)
        t0 = time.perf_counter()
        nbest = lm_decoder.lm_decode_batch(dec, x, lens, blank_penalty=math.log(7))
        dt = time.perf_counter() - t0
        sizes = [len(nb) for nb in nbest]
        check(len(nbest) == len(lens) and min(sizes) > 0,
              f"competition beam {tag}: lm_decode_batch gave an n-best for each of "
              f"{len(lens)} utterances (sizes {min(sizes)}-{max(sizes)})")
        print(f"competition beam {tag}: {len(lens)} utterances of {lens.min()}-{lens.max()} "
              f"frames, nbest 100, beam 18, {os.cpu_count()} host cores: "
              f"{dt * 1e3 / len(lens):.2f} ms a sample ({card})", flush=True)
    x, lens = padded_logits(outputs["gru"])
    native = lm_decoder.build_lm_decoder(lex, arpa, 0.5, 10, 18.0)
    python = lm_decoder.build_lm_decoder(lex, arpa, 0.5, 10, 18.0, force_python=True)
    t0 = time.perf_counter()
    same, in_order, first_diff = True, 0, ""
    for i in range(BEAM_ORACLE_UTTS):
        lp = x[i, : min(int(lens[i]), BEAM_ORACLE_FRAMES)]
        a = lm_decoder.lm_decode(native, lp, blank_penalty=math.log(7))
        b = lm_decoder.lm_decode(python, lp, blank_penalty=math.log(7))
        ok = same_nbest(a, b, BEAM_SCORE_TOL)
        same &= ok
        in_order += [hyp_key(h) for h in a] == [hyp_key(h) for h in b]
        if not first_diff and [hyp_key(h) for h in a] != [hyp_key(h) for h in b]:
            first_diff = (f"; utterance {i} first differs at rank "
                          + next(f"{r}: native {hyp_key(h)} {h.score:.6f}, python "
                                 f"{hyp_key(g)} {g.score:.6f}"
                                 for r, (h, g) in enumerate(zip(a, b))
                                 if hyp_key(h) != hyp_key(g))
                          if len(a) == len(b) else f"; utterance {i}: {len(a)} vs {len(b)}")
    check(same,
          f"competition beam: native vs force_python on {BEAM_ORACLE_UTTS} utterances (first "
          f"{BEAM_ORACLE_FRAMES} frames, nbest 10): the same hypotheses (phones and words), "
          f"scores within {BEAM_SCORE_TOL:g}, {in_order} of {BEAM_ORACLE_UTTS} in the same "
          f"order, the rest reordered only among hypotheses tied within {BEAM_SCORE_TOL:g}"
          f"{first_diff} ({time.perf_counter() - t0:.1f} s)")


def hyp_key(h) -> tuple:
    return tuple(int(p) for p in h.phones), tuple(h.words)


def same_nbest(a, b, tol: float) -> bool:
    """Two n-best lists equal up to the order of hypotheses whose scores tie
    within ``tol`` (the native engine sums in float32, the oracle in float64:
    a near-tie may fall either way, also at the list's end): the same length,
    rank by rank scores within ``tol``, and each hypothesis of either list in
    the other with its score within ``tol``, or tied within ``tol`` with the
    other's last."""
    if len(a) != len(b):
        return False
    if any(abs(h.score - g.score) >= tol for h, g in zip(a, b)):
        return False
    for one, other in ((a, b), (b, a)):
        scores = {hyp_key(h): h.score for h in other}
        for h in one:
            ref = scores.get(hyp_key(h), other[-1].score)
            if abs(h.score - ref) >= tol:
                return False
    return True


def llm_sentences(rng, vocab: int) -> list[str]:
    """``LLM_UTTS`` n-best lists of ``LLM_HYPS`` id sequences (see above)."""
    out = []
    for _ in range(LLM_UTTS):
        base = rng.integers(4, vocab, size=int(rng.integers(10, 41)))
        for _ in range(LLM_HYPS):
            h = base.copy()
            k = int(rng.integers(1, 4))
            h[rng.choice(len(h), size=k, replace=False)] = rng.integers(4, vocab, size=k)
            out.append(" ".join(map(str, h)))
    return out


def id_tokenizer(sentences, padding=True):
    """Synthetic weights have no tokenizer: a sentence is its ids, after
    OPT's ``</s>`` (2); pad 1."""
    ids = [[2] + [int(w) for w in s.split()] for s in sentences]
    t = max(map(len, ids))
    return {"input_ids": [r + [1] * (t - len(r)) for r in ids],
            "attention_mask": [[1] * len(r) + [0] * (t - len(r)) for r in ids]}


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def llm_bound_ms(spec, sentences, wbytes: int) -> tuple[float, float]:
    """The least time a batch could take, mean over this run's batches:
    the weights read once over the HBM rate, and the operations at this
    run's padded shapes (T of a batch rounded up to 16, as the scorer
    pads): the bf16 block products at 989 TFLOP/s, the attention scores and
    context (float32 sums) and the float32 tied head at 67 TFLOP/s."""
    d, f, n, v = spec.d_model, spec.ffn_dim, spec.n_layer, spec.vocab
    ops_ms = []
    for i in range(0, len(sentences), LLM_BATCH):
        t = max(len(s.split()) for s in sentences[i: i + LLM_BATCH]) + 1  # + </s>
        t = min(-(-max(t, 2) // 16) * 16, spec.n_positions)
        tokens = LLM_BATCH * t
        bf16 = 2 * tokens * n * (4 * d * d + 2 * d * f)
        f32 = 2 * 2 * tokens * t * d * n + 2 * tokens * v * spec.w_dim
        ops_ms.append((bf16 / PEAK_FLOPS["bfloat16"] + f32 / PEAK_FLOPS["float32"]) * 1e3)
    return wbytes / HBM_BPS * 1e3, float(np.mean(ops_ms))


def timed_scores(score, sentences: list[str]) -> tuple[np.ndarray, float]:
    """A scorer's log-probs of ``sentences`` after a warm-up batch, and the
    seconds they took."""
    score(sentences[:LLM_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = np.asarray(score(sentences))
    torch.cuda.synchronize()
    return lp, time.perf_counter() - t0


def time_scorer(tag: str, params, spec, sentences, card: str) -> np.ndarray:
    score = llm_engine.params_scorer(params, spec, id_tokenizer, batch_size=LLM_BATCH)
    lp, dt = timed_scores(score, sentences)
    n_batches = -(-len(sentences) // LLM_BATCH)
    wbytes = tree_bytes(params)
    bytes_ms, ops_ms = llm_bound_ms(spec, sentences, wbytes)
    print(f"competition rescorer {tag} OPT-{LLM_SIZE} shapes: {len(sentences)} sequences of "
          f"10-40 ids in {n_batches} batches of {LLM_BATCH} (T rounded up to 16): {dt:.2f} s, "
          f"{len(sentences) / dt:.1f} sequences/s, {dt * 1e3 / n_batches:.2f} ms a batch; "
          f"bound {max(bytes_ms, ops_ms):.2f} ms a batch "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {wbytes / 1e9:.2f} GB of "
          f"weights / 3.35 TB/s = {bytes_ms:.2f} ms, operations {ops_ms:.2f} ms); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)
    check(bool(np.isfinite(lp).all()), f"competition rescorer {tag}: finite log-probs")
    return lp


def synth_llm(spec, quantize: bool, card: str) -> dict:
    """``synth_params_on_device`` at ``spec``, with its time and peak memory."""
    tag = "int8" if quantize else "bf16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llm_engine.synth_params_on_device(spec, seed=0, quantize=quantize)
    torch.cuda.synchronize()
    print(f"competition rescorer {tag}: synth_params_on_device in "
          f"{time.perf_counter() - t0:.1f} s, {tree_bytes(params) / 1e9:.2f} GB, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card})", flush=True)
    return params


def competition_rescorer(card: str) -> None:
    """(c) The engine at OPT-6.7B shapes on random weights drawn on the card,
    bf16 and int8: sequences/s against the weight-bytes bound, bf16 against
    the float32 engine on the same weights, and the top-1 of every n-best
    list under the int8 quantization of the bf16 weights (``quantize_int8``
    on the card) against bf16's."""
    spec = llm_engine.opt_spec(LLM_SIZE)
    sentences = llm_sentences(np.random.default_rng(21), spec.vocab)
    params = synth_llm(spec, False, card)
    lp = time_scorer("bf16", params, spec, sentences, card)
    ref = np.asarray(llm_engine.params_scorer(params, spec, id_tokenizer, batch_size=LLM_BATCH,
                                              compute_dtype="float32")(
        sentences[:LLM_F32_SEQS]))
    rel = np.abs(lp[:LLM_F32_SEQS] - ref) / np.abs(ref)
    check(bool((rel <= LLM_TOL).all()),
          f"competition rescorer bf16 vs the float32 engine on the same weights, all "
          f"{spec.n_layer} layers, {LLM_F32_SEQS} sentences: max |diff| / |log-prob| "
          f"{rel.max():.2e} <= {LLM_TOL:g} (log-probs {ref.min():.1f} to {ref.max():.1f})")
    t0 = time.perf_counter()
    qparams = llm_engine.quantize_int8(params)
    torch.cuda.synchronize()
    print(f"competition rescorer: quantize_int8 of the bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lq = time_scorer("int8 (the bf16 weights quantized)", qparams, spec, sentences, card)
    del qparams
    top16 = lp.reshape(LLM_UTTS, LLM_HYPS).argmax(1)
    top8 = lq.reshape(LLM_UTTS, LLM_HYPS).argmax(1)
    agree = float((top16 == top8).mean())
    check(agree >= INT8_AGREE,
          f"competition rescorer: int8 top-1 == bf16 top-1 on {agree:.2%} of "
          f"{LLM_UTTS} n-best lists >= {INT8_AGREE:.0%}")
    params = synth_llm(spec, True, card)
    time_scorer("int8", params, spec, sentences, card)
    del params
    torch.cuda.empty_cache()


def ambiguity_set(d: Path, rng) -> tuple[dict, str, str, str, np.ndarray]:
    """The constructed-ambiguity set of ``scripts/make_competition_scale_demo.py``
    at small scale: a corpus with homophone decoys (out of the rescorer's
    corpus) for half its words, a ground-truth bigram, a flattened and noisy
    ARPA (the WFST's weak LM), log-probs from the true phone sequences plus
    noise, and a ``BigramOptBuilder`` rescorer written as ``pytorch_model.bin``
    + config + WordLevel tokenizer. Returns the outputs, the paths and the
    bigram's log-probs."""
    k = DEMO_CORPUS
    prons, seen = {}, set()
    while len(prons) < k + DEMO_FILLER:
        pr = tuple(rng.choice(PHONE_DEF, size=int(rng.integers(2, 5))))
        if pr not in seen:
            seen.add(pr)
            prons[f"w{len(prons):03d}"] = pr
    words = list(prons)
    corpus = words[:k]
    decoys = {w: f"d{i:03d}" for i, w in enumerate(corpus[: k // 2])}
    lex_lines = [f"{w} {' '.join(p)}" for w, p in prons.items()]
    lex_lines += [f"{dw} {' '.join(prons[w])}" for w, dw in decoys.items()]
    (d / "demo_lexicon.txt").write_text("\n".join(lex_lines) + "\n")
    p = rng.dirichlet(np.full(k, 0.3), size=k + 1)
    p = 0.97 * p + 0.03 / k
    logp = np.log(p / p.sum(axis=1, keepdims=True))
    gamma, sigma = 0.3, 0.5
    flat = np.exp(logp * gamma)
    flat /= flat.sum(axis=1, keepdims=True)
    vocab = ["<s>", "</s>", "<unk>"] + words + list(decoys.values())
    uni = np.full(len(vocab), 1e-6)
    pi = np.exp(logp[0] * gamma)
    uni[3: 3 + k] = pi / pi.sum()
    for j, w in enumerate(decoys):
        uni[3 + len(words) + j] = uni[3 + corpus.index(w)] * 0.8
    uni /= uni.sum()
    bigrams = []
    for row in range(k + 1):
        ctx = "<s>" if row == 0 else corpus[row - 1]
        for v in np.argsort(flat[row])[::-1][:8]:
            bigrams.append(f"{np.log10(flat[row][v]) + rng.normal(0, sigma):.4f}\t"
                           f"{ctx} {corpus[v]}\t-0.30")
            if corpus[v] in decoys:
                bigrams.append(f"{np.log10(flat[row][v] * 0.8) + rng.normal(0, sigma):.4f}"
                               f"\t{ctx} {decoys[corpus[v]]}\t-0.30")
    lines = ["\\data\\", f"ngram 1={len(vocab)}", f"ngram 2={len(bigrams)}", "",
             "\\1-grams:"]
    lines += [f"{np.log10(q):.4f}\t{w}\t-0.30" for w, q in zip(vocab, uni)]
    lines += ["", "\\2-grams:", *bigrams, "", "\\end\\", ""]
    (d / "demo_lm.arpa").write_text("\n".join(lines))

    sil = N_OUT - 1
    pid = {ph: i + 1 for i, ph in enumerate(PHONE_DEF)}
    outputs = {"logits": [], "logitLengths": [], "trueSeqs": [], "transcriptions": []}
    for _ in range(DEMO_UTTS):
        sent = [int(rng.choice(k, p=np.exp(logp[0])))]
        for _ in range(int(rng.integers(3, 8))):
            sent.append(int(rng.choice(k, p=np.exp(logp[1 + sent[-1]]))))
        ids = [i for w in sent for i in [pid[ph] for ph in prons[corpus[w]]] + [sil]]
        frames = np.repeat(ids, 3)
        x = rng.standard_normal((len(frames), N_OUT)).astype(np.float32)
        x[np.arange(len(frames)), frames] += 4.0
        x -= np.log(np.exp(x).sum(-1, keepdims=True))
        outputs["logits"].append(x)
        outputs["logitLengths"].append(len(frames))
        outputs["trueSeqs"].append(np.asarray(ids))
        outputs["transcriptions"].append(" ".join(corpus[w] for w in sent))

    spec = llm_engine.opt_spec(DEMO_OPT)
    ckpt = d / f"opt_{DEMO_OPT}_bigram"
    builder = bigram_opt.BigramOptBuilder(spec, logp, np.arange(k) + bigram_opt.FIRST_WORD_ID)
    bigram_opt.write_checkpoint(spec, str(ckpt), builder.tensor_fn)
    bigram_opt.build_wordlevel_tokenizer(corpus + list(decoys.values()) + words[k:], str(ckpt))
    return (outputs, str(d / "demo_lexicon.txt"), str(d / "demo_lm.arpa"), str(ckpt),
            logp)


def pipeline_check(tag: str, res: dict, card: str) -> None:
    check(res["wer"] < 0.8 * res["wer_top1"] and res["wer_top1"] > 0.05,
          f"competition pipeline {tag} on {DEMO_UTTS} constructed utterances: PER "
          f"{res['per']:.4f}, top-1 WER {res['wer_top1']:.4f} > 0.05, rescored WER "
          f"{res['wer']:.4f} < 0.8 x top-1 (CER {res['cer_top1']:.4f} -> {res['cer']:.4f}); "
          f"beam {res['beam_seconds']:.2f} s ({res['decode_seconds_per_sample'] * 1e3:.2f} ms "
          f"a sample), rescore {res['rescore_seconds']:.2f} s ({card})")


def competition_pipeline(card: str, lex: str, arpa: str) -> None:
    """(d) ``run_pipeline`` on the constructed-ambiguity set with the bigram
    rescorer from its ``.bin`` at OPT-125m shapes, and with the same bigram
    built in memory at OPT-6.7B shapes (``bigram_opt.engine_params``, no
    disk): rescoring must beat the WFST top-1; then
    ``nsd-eval-competition-torch`` on ``cli_phase``'s run."""
    t0 = time.perf_counter()
    outputs, demo_lex, demo_arpa, ckpt, logp = ambiguity_set(COMP_DIR,
                                                             np.random.default_rng(7))
    print(f"competition pipeline: constructed set and OPT-{DEMO_OPT} bigram checkpoint in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kw = dict(lexicon_path=demo_lex, arpa_path=demo_arpa, nbest=DEMO_NBEST,
              return_ci=False, verbose=False)
    scorer = llm_engine.engine_scorer(ckpt, batch_size=LLM_BATCH)
    pipeline_check(f"OPT-{DEMO_OPT} bigram (.bin)",
                   eval_competition.run_pipeline(outputs, llm_scorer=scorer, **kw), card)
    t0 = time.perf_counter()
    spec = llm_engine.opt_spec(LLM_SIZE)
    builder = bigram_opt.BigramOptBuilder(
        spec, logp, np.arange(DEMO_CORPUS) + bigram_opt.FIRST_WORD_ID)
    params = bigram_opt.engine_params(builder)
    scorer = llm_engine.params_scorer(params, spec, llm_engine.load_tokenizer(ckpt),
                                      batch_size=LLM_BATCH)
    del params, builder
    print(f"competition pipeline: OPT-{LLM_SIZE} bigram built in memory and put on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    pipeline_check(f"OPT-{LLM_SIZE} bigram (in memory)",
                   eval_competition.run_pipeline(outputs, llm_scorer=scorer, **kw), card)
    del scorer
    torch.cuda.empty_cache()
    run = CLI_RUN / "run"
    t0 = time.perf_counter()
    eval_competition.main([
        "--modelPath", str(run), "--datasetPath", str(CLI_RUN / "dataset.pkl"),
        "--partition", "test", "--lexicon", lex, "--lm", arpa, "--llmPath", ckpt])
    n_trials = sum(len(d["sentenceDat"])
                   for d in pickle.loads((CLI_RUN / "dataset.pkl").read_bytes())["test"])
    sub = run / "5gramLLMCompetitionSubmission.txt"
    lines = sub.read_text().splitlines() if sub.is_file() else []
    check((run / "llm_out").is_file() and len(lines) == n_trials,
          f"nsd-eval-competition-torch on the nsd-train run (test partition, OPT-{DEMO_OPT} "
          f"bigram rescorer): llm_out and the submission file with {len(lines)} lines for "
          f"{n_trials} trials in {time.perf_counter() - t0:.1f} s")


def competition_phase(card: str) -> dict:
    """The competition decode (phase 17): (a) the eval forward of
    ``cli_phase``'s GRU run and of phase 9's Conformer run (as trained and
    fused) through ``collect_model_outputs``, (b) the native decoder, (c)
    the rescorer at OPT-6.7B shapes, (d) the pipeline end to end. Returns
    the launches of (a)."""
    shutil.rmtree(COMP_DIR, ignore_errors=True)
    COMP_DIR.mkdir(parents=True)
    if any(sys.modules.get(m) for m in ("transformers", "tokenizers", "safetensors")):
        print("competition: note: transformers/tokenizers/safetensors are importable here",
              flush=True)
    ds = synthetic_dataset(seed=11, n_days=2, trials_per_day=96, n_channels=C, min_t=400,
                           max_t=1200, min_u=20, max_u=U)
    launches = {k: 0 for k in KERNELS}
    outputs = {}
    t0 = time.perf_counter()
    gru, gru_args = load_model(str(CLI_RUN / "run"), device="cuda")
    conf, conf_args = load_model(str(CONFORMER_RUN), device="cuda")
    fused_args = {**conf_args, **FUSED_FLAGS["conformer"]}
    fused = build_model(fused_args, N_DAYS, "cuda")
    fused.load_params(conf.params)
    for tag, model, args, per_batch in (
            ("gru", gru, gru_args, {"frontend": 1, "gru_scan": 5, "tiled_matmul": 4}),
            ("conformer", conf, conf_args, {"mhsa_qkv": CONFORMER_LAYERS}),
            ("conformer_fused", fused, fused_args,
             {"mhsa_qkv": CONFORMER_LAYERS, "ffn": 2 * CONFORMER_LAYERS,
              "conv_module": CONFORMER_LAYERS})):
        outputs[tag], counted = competition_forward(tag, model, args, ds, per_batch, card)
        for k, v in counted.items():
            launches[k] += v
    del gru, conf, fused
    print(f"competition (a) forward: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lex, arpa = write_lexicon_lm(COMP_DIR, np.random.default_rng(5))
    competition_beam({k: outputs[k] for k in ("gru", "conformer")}, lex, arpa, card)
    print(f"competition (b) beam: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    competition_rescorer(card)
    print(f"competition (c) rescorer: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    competition_pipeline(card, lex, arpa)
    print(f"competition (d) pipeline: {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(COMP_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------ the research workflow

WORKFLOW_DIR = Path("runs") / "chip_smoke_workflow"
# two of the competition's session names; the first also gets a
# competitionHoldOut file, the second does not
WF_SESSIONS = ("t12.2022.05.05", "t12.2022.05.17")
WF_TRIALS = {"train": 100, "test": 20, "competitionHoldOut": 20}
WF_BLOCKS = 4  # contiguous blockIdx blocks a session file
WF_STEPS, WF_EVAL_EVERY = 11, 10  # steps 0-10, evals at steps 0 and 10
WF_LRS = ("0.01", "0.02")
GRU_CONFIG = "neural_speech_decoder_tpu/configs/gru_baseline.yaml"
# A z-scored block's column means and standard deviations, computed in
# float64 over the formatter's float32 features: within float32 rounding of
# 0 and 1.
NORM_TOL = 1e-3
# The reference-layout module's float32 forward (cuDNN's smoothing
# convolution, einsum, nn.Unfold, nn.GRU and nn.Linear, TF32 off) against
# the port's float32 eval forward (its kernels) on the same weights: the
# same float32 function summed in other orders. Max abs error over the
# largest |logit|.
REF_TOL = 1e-4


class ReferenceGRUDecoder(torch.nn.Module):
    """The reference implementation's GRU decoder (``model.py::GRUDecoder``)
    rebuilt from ``torch.nn`` alone: its state-dict keys and shapes
    (``dayWeights``, ``dayBias``, ``gaussianSmoother.weight`` (a buffer),
    ``gru_decoder`` (``nn.GRU``), the dead ``inpLayer{i}`` Linears,
    ``fc_decoder_out``) and its forward (smoothing by a "same"-padded
    depthwise convolution, the day affine as an einsum, Softsign,
    ``nn.Unfold``, the GRU from a zero state, the head). It shares no code
    with the port."""

    def __init__(self, neural_dim: int, n_classes: int, hidden_dim: int, layer_dim: int,
                 n_days: int, stride_len: int, kernel_len: int, bidirectional: bool = True,
                 smooth_taps: int = 20, device=None):
        super().__init__()
        nn = torch.nn
        self.neural_dim = neural_dim
        self.gaussianSmoother = nn.Module()
        self.gaussianSmoother.register_buffer(
            "weight", torch.zeros(neural_dim, 1, smooth_taps, device=device))
        self.dayWeights = nn.Parameter(torch.zeros(n_days, neural_dim, neural_dim,
                                                   device=device))
        self.dayBias = nn.Parameter(torch.zeros(n_days, 1, neural_dim, device=device))
        self.gru_decoder = nn.GRU(neural_dim * kernel_len, hidden_dim, layer_dim,
                                  batch_first=True, bidirectional=bidirectional,
                                  device=device)
        for day in range(n_days):
            setattr(self, f"inpLayer{day}", nn.Linear(neural_dim, neural_dim, device=device))
        self.fc_decoder_out = nn.Linear(hidden_dim * (2 if bidirectional else 1),
                                        n_classes + 1, device=device)
        self.unfolder = nn.Unfold((kernel_len, 1), stride=(stride_len, 1))

    @classmethod
    def from_config(cls, cfg: GRUConfig, device=None) -> "ReferenceGRUDecoder":
        return cls(cfg.neural_dim, cfg.n_classes, cfg.hidden_dim, cfg.num_layers, cfg.n_days,
                   cfg.stride_len, cfg.kernel_len, cfg.bidirectional,
                   cfg.gaussian_kernel_size, device)

    def forward(self, x: torch.Tensor, day_idx: torch.Tensor) -> torch.Tensor:
        """``[B, T, C]`` features -> ``[B, L, n_classes + 1]`` logits."""
        x = torch.nn.functional.conv1d(x.transpose(1, 2), self.gaussianSmoother.weight,
                                       groups=self.neural_dim, padding="same")
        x = torch.einsum("btd,bdk->btk", x.transpose(1, 2), self.dayWeights[day_idx])
        x = torch.nn.functional.softsign(x + self.dayBias[day_idx])
        x = self.unfolder(x.transpose(1, 2).unsqueeze(3)).transpose(1, 2)
        hid, _ = self.gru_decoder(x)
        return self.fc_decoder_out(hid)


class ReferenceConformerLayout(torch.nn.Module):
    """The parameter layout (state-dict keys and shapes) of the reference's
    ``NeuralTransformerCTCModel`` from ``torch.nn`` modules, on the meta
    device: the day affine, the frontend (bias-free strided depthwise
    convolution, projection, norm), the bottleneck, the conformer layers
    (FF, ``nn.MultiheadAttention``, the conv module, FF, norm), the head
    and, with InterCTC, ``inter_output``. Its forward is not rebuilt."""

    def __init__(self, cfg):
        super().__init__()
        nn, dev = torch.nn, "meta"
        c, f, d, n_out = cfg.n_channels, cfg.frontend_dim, cfg.latent_dim, cfg.n_out

        def ff():
            return nn.Sequential(nn.LayerNorm(d, device=dev), nn.Linear(d, cfg.ff_dim, device=dev),
                                 nn.SiLU(), nn.Dropout(), nn.Linear(cfg.ff_dim, d, device=dev),
                                 nn.Dropout())

        def layer():
            m = nn.Module()
            m.ff1, m.ff2 = ff(), ff()
            m.ln_attn = nn.LayerNorm(d, device=dev)
            m.attn = nn.MultiheadAttention(d, cfg.num_heads, batch_first=True, device=dev)
            m.conv_module = nn.Module()
            m.conv_module.ln = nn.LayerNorm(d, device=dev)
            m.conv_module.pw_conv1 = nn.Linear(d, 2 * d, device=dev)
            m.conv_module.dw_conv = nn.Conv1d(d, d, cfg.conv_kernel, groups=d, device=dev)
            m.conv_module.ln_conv = nn.LayerNorm(d, device=dev)
            m.conv_module.pw_conv2 = nn.Linear(d, d, device=dev)
            m.ln_final = nn.LayerNorm(d, device=dev)
            return m

        self.day_linear = nn.Module()
        self.day_linear.day_weights = nn.Parameter(torch.empty(cfg.n_days, c, c, device=dev))
        self.day_linear.day_bias = nn.Parameter(torch.empty(cfg.n_days, 1, c, device=dev))
        self.frontend = nn.Module()
        self.frontend.temporal_conv = nn.Conv1d(c, c, cfg.temporal_kernel,
                                                stride=cfg.temporal_stride, groups=c,
                                                bias=False, device=dev)
        self.frontend.proj = nn.Linear(c, f, device=dev)
        self.frontend.ln = nn.LayerNorm(f, device=dev)
        self.encoder = nn.Module()
        self.encoder.net = nn.Sequential(nn.Linear(f, cfg.autoencoder_hidden_dim, device=dev),
                                         nn.GELU(),
                                         nn.Linear(cfg.autoencoder_hidden_dim, d, device=dev))
        self.conformer_layers = nn.ModuleList(layer() for _ in range(cfg.num_layers))
        self.output = nn.Sequential(nn.Linear(d, d, device=dev), nn.LayerNorm(d, device=dev),
                                    nn.GELU(), nn.Dropout(), nn.Linear(d, n_out, device=dev))
        if cfg.use_interctc:
            self.inter_output = nn.Linear(d, n_out, device=dev)

    def shapes(self) -> dict[str, tuple[int, ...]]:
        return {k: tuple(v.shape) for k, v in self.state_dict().items()}


def smoke_prons() -> dict[str, tuple[str, ...]]:
    """The smoke's word lexicon: a word for each phone and for each pair."""
    prons = {f"p_{p.lower()}": (p,) for p in PHONE_DEF}
    prons |= {f"p_{p.lower()}_{q.lower()}": (p, q) for p in PHONE_DEF for q in PHONE_DEF}
    return prons


def lexicon_g2p() -> tuple[list[str], dict, object]:
    """The smoke's words whose letters alone name them (``clean_transcription``
    keeps letters, so ``p_n_g`` and ``p_ng`` meet; the first is kept), their
    phones by cleaned word, and a g2p over them that answers as ``g2p_en``
    does: stress digits on the vowels, ``" "`` between words."""
    by_clean, words = {}, []
    for w, phones in smoke_prons().items():
        if clean_transcription(w) not in by_clean:
            by_clean[clean_transcription(w)] = phones
            words.append(w)

    def g2p(text: str) -> list[str]:
        out = []
        for i, w in enumerate(text.split()):
            out += [" "] if i else []
            out += [p + "1" if p[0] in "AEIOU" else p for p in by_clean[w]]
        return out

    return words, by_clean, g2p


def write_sessions(root: Path, rng, words: list[str]) -> dict:
    """Synthetic ``.mat`` session files in the competition's layout:
    ``train/``, ``test/`` for both sessions and ``competitionHoldOut/`` for
    the first, with trials of 400-1200 bins, ``tx1`` (counts) and
    ``spikePow`` (positive powers) of 256 columns each, scaled per block so
    that the z-scoring has work to do, ``WF_BLOCKS`` contiguous blocks in
    ``blockIdx`` and transcriptions of 3-8 of the lexicon's words. Returns
    each file's block indices."""
    blocks_of = {}
    for split, n in WF_TRIALS.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for name in WF_SESSIONS[:1] if split == "competitionHoldOut" else WF_SESSIONS:
            blocks = np.repeat(np.arange(1, WF_BLOCKS + 1), -(-n // WF_BLOCKS))[:n]
            tx1, power = np.empty((1, n), object), np.empty((1, n), object)
            for i, t in enumerate(rng.integers(400, 1201, size=n)):
                b = int(blocks[i])
                tx1[0, i] = rng.poisson(0.5 * b, size=(t, 256)).astype(np.float32)
                power[0, i] = rng.gamma(2.0, 5.0 * b, size=(t, 256)).astype(np.float32)
            text = np.array([" ".join(rng.choice(words, size=int(rng.integers(3, 9))))
                             .capitalize() + "." for _ in range(n)])
            scipy.io.savemat(str(root / split / f"{name}.mat"),
                             {"tx1": tx1, "spikePow": power, "sentenceText": text,
                              "blockIdx": blocks.reshape(-1, 1)})
            blocks_of[split, name] = blocks
    return blocks_of


def workflow_format(card: str) -> Path:
    """(a) ``format_competition_data`` over two synthetic sessions with the
    lexicon's g2p: the schema, each block's z-scored columns, the labels
    against the lexicon's phones. Returns the formatted pickle."""
    root = WORKFLOW_DIR / "competitionData"
    words, by_clean, g2p = lexicon_g2p()
    t0 = time.perf_counter()
    blocks_of = write_sessions(root, np.random.default_rng(21), words)
    write_s = time.perf_counter() - t0
    pkl = WORKFLOW_DIR / "ptDecoder_ctc"
    t0 = time.perf_counter()
    out = formatter.format_competition_data(str(root), str(pkl), session_names=WF_SESSIONS,
                                            g2p=g2p)
    format_s = time.perf_counter() - t0
    keys = {"sentenceDat", "transcriptions", "phonemes", "timeSeriesLens", "phoneLens",
            "phonePerTime"}
    split_of = {"train": "train", "test": "test", "competition": "competitionHoldOut"}
    schema = set(out) == set(split_of) and [len(out[s]) for s in split_of] == [2, 2, 1]
    worst_mean = worst_std = 0.0
    labels_ok = True
    for split, days in out.items():
        for name, day in zip(WF_SESSIONS, days):
            n = WF_TRIALS[split_of[split]]
            x = day["sentenceDat"]
            schema &= (set(day) == keys and len(x) == n
                       and all(a.dtype == np.float32 and a.shape[1] == 256 for a in x)
                       and list(day["timeSeriesLens"]) == [len(a) for a in x]
                       and day["phonePerTime"].dtype == np.float32
                       and all(p.dtype == np.int32 and p.shape == (500,)
                               for p in day["phonemes"]))
            blocks = blocks_of[split_of[split], name]
            for b in np.unique(blocks):
                span = np.concatenate([x[i] for i in np.flatnonzero(blocks == b)]).astype(np.float64)
                worst_mean = max(worst_mean, float(np.abs(span.mean(axis=0)).max()))
                worst_std = max(worst_std, float(np.abs(span.std(axis=0) - 1.0).max()))
            for text, ids, m in zip(day["transcriptions"], day["phonemes"], day["phoneLens"]):
                want = [p for w in clean_transcription(text).split()
                        for p in (*by_clean[w], "SIL")]
                labels_ok &= (int(m) == len(want) and not ids[m:].any()
                              and list(ids[:m]) == [PHONE_DEF.index(p) + 1 if p != "SIL"
                                                    else len(PHONE_DEF) + 1 for p in want])
    check(schema, "workflow format: {train, test, competition} with 2, 2 and 1 sessions of "
          f"{WF_TRIALS['train']}/{WF_TRIALS['test']}/{WF_TRIALS['competitionHoldOut']} trials, "
          "the day-dict schema, [t, 256] float32 features, int32 label buffers of 500")
    check(worst_mean <= NORM_TOL and worst_std <= NORM_TOL,
          f"workflow format: every block z-scored: column |mean| <= {worst_mean:.2e}, "
          f"|std - 1| <= {worst_std:.2e} (limit {NORM_TOL:g})")
    check(labels_ok, "workflow format: every phoneLens equals its buffer's labels, which are "
          "the lexicon's phones with SIL after each word (+1 ids, zeros after)")
    n_trials = sum(len(d["sentenceDat"]) for days in out.values() for d in days)
    print(f"workflow format: {n_trials} trials of 400-1200 bins in 5 session files; writing "
          f"the .mat files {write_s:.1f} s, format_competition_data {format_s:.1f} s "
          f"({card})", flush=True)
    return pkl


def train_losses(run_dir: Path) -> list[float]:
    """The per-step ``train/loss`` of a run's metrics.jsonl, by step."""
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["train/loss"] for r in sorted((r for r in recs if "train/loss" in r),
                                            key=lambda r: r["step"])]


def run_trace(run_dir: Path) -> tuple[tuple[float, float], dict]:
    """A finished run's steps' wall-clock span (the first step queued, the
    last step's metrics read) and its kernel launches by wrapper and body,
    from the last record of its metrics.jsonl (``training/trainer.py``)."""
    rec = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[-1])
    pre = "summary/launches/"
    return ((rec["summary/steps_wall_start"], rec["summary/steps_wall_end"]),
            {k[len(pre):]: int(v) for k, v in rec.items() if k.startswith(pre)})


def workflow_launches_want(run_dir: Path, pkl: Path, launches: dict) -> dict:
    """What a bf16 GRU run of ``WF_STEPS`` steps on the formatted data must
    launch: per step, each layer's gates-forward and backward scans on the
    persistent body and one CTC alpha and beta; per eval batch, the
    frontend on ``tc``, each layer's inference scan and one alpha."""
    args = load_args(str(run_dir))
    with open(pkl, "rb") as f:
        n_test = sum(len(d["sentenceDat"]) for d in pickle.load(f)["test"])
    n, layers = WF_STEPS, int(args["nLayers"])
    e = len(range(0, WF_STEPS, WF_EVAL_EVERY)) * -(-n_test // int(args["batchSize"]))
    counts = {"gru_scan_gates": layers * n, "gru_scan_bwd": layers * n,
              "ctc_alpha": n + e, "ctc_beta": n, "frontend": e, "gru_scan": layers * e}
    by_body = {"gru_scan_gates": "persistent", "gru_scan_bwd": "persistent",
               "gru_scan": "persistent", "ctc_alpha": CTC_BODY, "ctc_beta": CTC_BODY,
               "frontend": "tc"}
    return (dict.fromkeys(launches, 0) | counts
            | {f"{k}/{by_body[k]}": v for k, v in counts.items()})


def pinned_worker_probe(_) -> tuple:
    """Runs in a spawned sweep worker after the pool's initializer pinned
    it (``parallel/sweep.py::_worker_init``): what the pin left and what
    CUDA then shows."""
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), sweep._WORKER_INIT_ERROR,
            "torch" in sys.modules, torch.cuda.device_count(), torch.cuda.get_device_name(0))


def pinned_worker_check() -> None:
    """A spawn worker pinned to slot 0 with one card: torch is imported
    before the initializer runs (the worker re-imports this script), CUDA
    is not initialized yet, so ``CUDA_VISIBLE_DEVICES`` takes effect."""
    ctx = mp.get_context("spawn")
    slots = ctx.Queue()
    slots.put(0)
    with ctx.Pool(1, initializer=sweep._worker_init, initargs=({}, slots, 1)) as pool:
        visible, error, imported, count, name = pool.map(pinned_worker_probe, [0])[0]
    check(visible == "0" and error is None and imported and count == 1,
          f"workflow sweep: a spawn worker pinned by slice_env(0, 1) before its first CUDA "
          f"call (torch imported: {imported}; pin error: {error}) sees "
          f"CUDA_VISIBLE_DEVICES={visible}, {count} device ({name})")


def workflow_sweep(pkl: Path, card: str) -> tuple[Path, dict]:
    """(b) ``nsd-train-torch -m lrStart=0.01,0.02 --jobs 2`` on the recipe's
    config and the formatted pickle (two spawn workers sharing the card),
    then each job's overrides alone in a process of their own, one after
    the other. Returns the best job's run directory and the two workers'
    launches by kernel."""
    sweep = WORKFLOW_DIR / "sweep"
    base = [f"datasetPath={pkl}", f"nBatch={WF_STEPS}", f"evalEvery={WF_EVAL_EVERY}"]
    # hydra's layout: ${outputDir}/${override_dirname}
    jobs = {lr: sweep / override_dirname([*base, f"lrStart={lr}"]) for lr in WF_LRS}
    so = _build.library_path()
    libs = sorted(_build.BUILD_DIR.glob("libnsd_kernels_*.so"))
    mtime = so.stat().st_mtime_ns
    torch.cuda.empty_cache()  # this process's cached blocks, for the workers
    wall0, t0 = time.time(), time.perf_counter()
    res = train_cli.main(["--config", GRU_CONFIG, "-m", "--jobs", "2", *base,
                          f"outputDir={sweep}", f"lrStart={','.join(WF_LRS)}"])
    sweep_s = time.perf_counter() - t0
    summary = json.loads((sweep / "sweep_summary.json").read_text())
    cers = [t["best_cer"] for t in summary]
    check(res["jobs"] == {str(d): "done" for d in jobs.values()} and res["n_failed"] == 0
          and [set(t) for t in summary] == [{"trial_id", "overrides", "outputDir", "best_cer",
                                              "status", "error", "chips"}] * 2
          and cers == sorted(cers) and res["best_dir"] == summary[0]["outputDir"],
          f"workflow sweep: jobs {res['jobs']} all done; sweep_summary.json ranked by "
          f"best_cer {cers}")
    check(so.stat().st_mtime_ns == mtime
          and sorted(_build.BUILD_DIR.glob("libnsd_kernels_*.so")) == libs,
          f"workflow sweep: the workers loaded {so.name} as built (mtime unchanged, no "
          f"other library)")
    # each worker's own record of its steps and launches
    traces = {lr: run_trace(d) for lr, d in jobs.items()}
    spans = {lr: (round(a - wall0, 3), round(b - wall0, 3)) for lr, ((a, b), _) in traces.items()}
    overlap = min(b for _, b in spans.values()) - max(a for a, _ in spans.values())
    check(overlap > 0,
          f"workflow sweep: the two jobs' steps overlapped for {overlap:.3f} s (s after the "
          f"sweep's start, first step queued to last step's metrics read: {spans})")
    want = workflow_launches_want(jobs[WF_LRS[0]], pkl, traces[WF_LRS[0]][1])
    for lr, (_, launches) in traces.items():
        ran = {k: v for k, v in launches.items() if v}
        check(launches == want,
              f"workflow sweep: the lrStart={lr} worker launched {ran} == {WF_STEPS} steps "
              f"(scans on the persistent body, CTC on {CTC_BODY}) and "
              f"{len(range(0, WF_STEPS, WF_EVAL_EVERY))} evals, nothing else")
    alone_s, alone_span = {}, {}
    for lr, job in jobs.items():
        out = WORKFLOW_DIR / f"alone_lrStart={lr}"
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "neural_speech_decoder_tpu_torch.training.cli",
                               "--config", GRU_CONFIG, *base, f"outputDir={out}",
                               f"lrStart={lr}"], capture_output=True, text=True, timeout=900)
        alone_s[lr] = time.perf_counter() - t1
        if proc.returncode:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
        alone, swept = (train_losses(out) if proc.returncode == 0 else []), train_losses(job)
        (a, b), launches = run_trace(out) if proc.returncode == 0 else ((0.0, 0.0), {})
        alone_span[lr] = b - a
        check(proc.returncode == 0 and len(swept) == WF_STEPS and alone == swept
              and launches == traces[lr][1],
              f"workflow sweep: lrStart={lr} run alone (nsd-train-torch without -m, a process "
              f"of its own): its {len(alone)} per-step losses bit-equal to the sweep job's "
              f"(first {swept[:1]}, last {swept[-1:]}), its launches equal")
    pinned_worker_check()
    seq = sum(alone_s.values())
    swept_span = {lr: b - a for lr, (a, b) in spans.items()}
    print(f"workflow sweep: 2 full-width bf16 GRU jobs of {WF_STEPS} steps and 2 evals "
          f"(B=64) at once, --jobs 2: {sweep_s:.1f} s wall; the same two alone one after the "
          f"other {seq:.1f} s ({' + '.join(f'{s:.1f}' for s in alone_s.values())}), "
          f"{seq / sweep_s:.2f}x, which at {WF_STEPS} steps is start-up and checkpoint I/O "
          f"overlapping, not the card's throughput; each job's steps (first queued to last "
          f"read, the step-0 eval and its checkpoint inside) "
          f"{', '.join(f'{swept_span[lr]:.3f}' for lr in WF_LRS)} s in the sweep, "
          f"{', '.join(f'{alone_span[lr]:.3f}' for lr in WF_LRS)} s alone ({card})",
          flush=True)
    return Path(res["best_dir"]), {k: sum(t[1][k] for t in traces.values()) for k in KERNELS}


def pad_request(trials, n_days: int) -> tuple[torch.Tensor, ...]:
    """Trials padded into a ``[B, T, C]`` float32 batch on the card, their
    days (``i % n_days``) and lengths."""
    x = torch.zeros((B, T, C), device="cuda")
    for i, tr in enumerate(trials):
        x[i, : len(tr)] = torch.from_numpy(tr).to(x.device)
    days = torch.arange(B, device="cuda") % n_days
    lens = torch.tensor([len(tr) for tr in trials] + [0] * (B - len(trials)), device="cuda")
    return x, days, lens


def tree_items(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in tree_items(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in tree_items(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def reference_forward_check(ref: ReferenceGRUDecoder, model, args: dict, card: str) -> None:
    """The reference-layout module's float32 forward against the port's
    float32 eval forward of the same weights over phase 3's requests."""
    n_days = model.cfg.n_days
    model32 = build_model({**args, "compute_dtype": "float32"}, n_days, "cuda")
    model32.load_params(model.params)
    trials, _ = serving_trials()
    offsets = np.cumsum((0,) + REQUEST_SIZES)
    err = scale = 0.0
    ref_ms = []
    for k, m in enumerate(REQUEST_SIZES):
        x, days, _ = pad_request(trials[offsets[k]: offsets[k] + m], n_days)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref(x, days)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            got = model32(x, days)
        check(want.shape == got.shape == (B, L, N_OUT), f"reference-layout forward shape "
              f"{tuple(want.shape)} == the port's {tuple(got.shape)}")
        err = max(err, (got - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    check(err <= REF_TOL * scale,
          f"workflow export gru: the reference-layout nn.GRU module (cuDNN, TF32 "
          f"{torch.backends.cudnn.allow_tf32}) vs the port's float32 eval forward over "
          f"{len(REQUEST_SIZES)} requests of B={B}, T={T}: max abs err {err:.3e} <= "
          f"{REF_TOL:g} x max |logit| {scale:.3e}; the module's forward "
          f"{', '.join(f'{t:.1f}' for t in ref_ms)} ms ({card})")


def workflow_interop(best_dir: Path, card: str) -> dict:
    """(c) ``torch_export.main`` of the sweep's best job and of phase 9's
    Conformer run; each file's keys and shapes those of the reference
    layout (the GRU loaded strictly into ``ReferenceGRUDecoder`` and run
    against the port's float32 forward); ``load_checkpoint`` back onto the
    card bit-equal to ``load_model``'s tree, and a bf16 request through
    the kernels bit-equal to ``load_model``'s, launches exact. Returns the
    launches of those requests."""
    launches = {k: 0 for k in KERNELS}
    art = WORKFLOW_DIR / "export"
    art.mkdir(parents=True)
    trials, _ = serving_trials()
    for tag, run_dir, per_request in (
            ("gru", best_dir, {"frontend": 1, "gru_scan": 5}),
            ("conformer", CONFORMER_RUN, {"mhsa_qkv": CONFORMER_LAYERS})):
        out = art / f"{tag}.modelWeights"
        t0 = time.perf_counter()
        export_main([str(run_dir), str(out), "--device", "cuda"])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd = torch.load(out, map_location="cpu", weights_only=True)
        load_s = time.perf_counter() - t0
        model, args = load_model(str(run_dir), device="cuda")
        plain = all(v.device.type == "cpu" and v.dtype == torch.float32 and v.is_contiguous()
                    for v in sd.values())
        if tag == "gru":
            ref = ReferenceGRUDecoder.from_config(model.cfg, device="cuda")
            try:
                ref.load_state_dict(sd, strict=True)
                layout, why = True, "load_state_dict(strict=True) into"
            except RuntimeError as e:
                layout, why = False, f"{e} loading into"
            ref.gru_decoder.flatten_parameters()
            ref.eval()
        else:
            want = ReferenceConformerLayout(model.cfg).shapes()
            got = {k: tuple(v.shape) for k, v in sd.items()}
            layout = got == want
            why = ("keys and shapes equal to" if layout else
                   f"keys only in the file {sorted(set(got) - set(want))[:4]}, only in the "
                   f"layout {sorted(set(want) - set(got))[:4]}, shapes differing "
                   f"{[k for k in got if k in want and got[k] != want[k]][:4]} in")
        n_values = sum(v.numel() for v in sd.values())
        check(plain and layout,
              f"workflow export {tag}: {len(sd)} contiguous float32 CPU tensors ({n_values:,} "
              f"values, {out.stat().st_size / 2**20:.1f} MiB); {why} the reference layout "
              f"({type(ref).__name__ if tag == 'gru' else 'ReferenceConformerLayout'})")
        if tag == "gru":
            reference_forward_check(ref, model, args, card)
            del ref
        t0 = time.perf_counter()
        imported = load_checkpoint(str(out), args, device="cuda")
        import_s = time.perf_counter() - t0
        mine, theirs = tree_items(imported.params), tree_items(model.params)
        check(mine.keys() == theirs.keys()
              and all(torch.equal(mine[k], theirs[k]) and mine[k].dtype == theirs[k].dtype
                      and mine[k].device == theirs[k].device for k in mine),
              f"workflow import {tag}: load_checkpoint's {len(mine)} leaves on the card "
              f"bit-equal to load_model's")
        x, days, lens = pad_request(trials[:B], model.cfg.n_days)
        with torch.inference_mode():
            model_forward(model, x, days, lens)  # warm-up, not counted
            want_lp, want_len, _ = model_forward(model, x, days, lens)
            torch.cuda.synchronize()
            reset_launches()
            got_lp, got_len, _ = model_forward(imported, x, days, lens)
            torch.cuda.synchronize()
        counted = read_launches()
        want = {k: 0 for k in KERNELS} | per_request
        bodies, want_bodies = launch_bodies(want)
        check(counted == want and bodies == want_bodies and torch.equal(got_lp, want_lp)
              and torch.equal(got_len, want_len),
              f"workflow import {tag}: a bf16 request of {B} through the kernels bit-equal to "
              f"load_model's; launched {counted} == {per_request}; by body {bodies}")
        for k, v in counted.items():
            launches[k] += v
        del model, imported
        print(f"workflow export {tag}: torch_export.main {export_s:.1f} s, torch.load "
              f"{load_s:.1f} s, load_checkpoint onto the card {import_s:.1f} s ({card})",
              flush=True)
    return launches


def workflow_phase(card: str) -> dict:
    """The research workflow (phase 18): (a) raw ``.mat`` sessions ->
    ``nsd-format-torch``'s ``format_competition_data`` -> a formatted
    pickle, (b) ``nsd-train-torch -m --jobs 2`` on it, the jobs alone, (c)
    the best job and phase 9's Conformer exported to the reference layout
    and imported back. Returns the launches of (b)'s two workers and of
    (c)."""
    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    WORKFLOW_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    pkl = workflow_format(card)
    print(f"workflow (a) format: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    t0 = time.perf_counter()
    best, launches = workflow_sweep(pkl, card)
    print(f"workflow (b) sweep: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    t0 = time.perf_counter()
    for k, n in workflow_interop(best, card).items():
        launches[k] += n
    print(f"workflow (c) export and import: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    shutil.rmtree(WORKFLOW_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------ data parallelism

DP_DIR = Path("runs") / "chip_smoke_dp"
DP_STEPS = {"a": 6, "b": 3, "c": 3}
# (b)/(c) against world size 1, float32: the ranks' halves sum the CTC
# means, the KL and the gradients in another order, then average them
DP_LOSS_TOL = (1e-5, 1e-4)  # step 0, later steps: relative
# final parameters: each leaf's two updates (p_final - p_initial) within
# DP_PARAM_TOL of each other in L2 relative to the one-rank update. Adam
# normalizes each entry's step, so an entry whose gradient is near Adam's
# eps moves by a visible part of lr on a rounding difference (the
# Conformer head's largest entry differed by 1.5e-2 of the steps' summed
# learning rates on the card): the L2 over the leaf weighs such entries by
# their count, a rank's missing or misplaced rows would move every entry
DP_PARAM_TOL = 1e-3
DP_CONFORMER_LAYERS = 2  # depth cut to hold the smoke's time


def dp_dataset() -> dict:
    """``train_model_phase``'s synthetic trials (400-1200 bins)."""
    return synthetic_dataset(seed=0, n_days=N_DAYS, trials_per_day=8, n_channels=C,
                             min_t=400, max_t=1200, min_u=20, max_u=U)


def dp_run_args(base: dict, out: Path, steps: int, ds: dict, **kw) -> dict:
    # cuda:0: one rank unless the group says otherwise ("cuda" would start a
    # rank a visible card)
    return {**base, "outputDir": str(out), "device": "cuda:0", "dataset": ds, "batchSize": B,
            "nBatch": steps, "evalEvery": 100, "checkpointEvery": 0,
            "wandb_mode": "offline", "dist_timeout_s": 600, **kw}


def dp_last_record(run_dir: Path) -> dict:
    return json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[-1])


def dp_rank_launches(run_dir: Path, rank: int) -> dict:
    pre = f"summary/rank{rank}/launches/"
    return {k[len(pre):]: int(v) for k, v in dp_last_record(run_dir).items()
            if k.startswith(pre)}


def dp_final_params(run_dir: Path, heads: int | None = None) -> dict:
    """A run's last parameters, whole; ``heads``: a tensor-parallel
    Conformer's, de-interleaved to the one-rank layout."""
    from neural_speech_decoder_tpu_torch.training.checkpoints import CheckpointManager

    params = CheckpointManager(str(run_dir)).restore("lastState", "cpu")["params"]
    return tree_items(params if heads is None else deinterleave_attention_params(params, heads))


def dp_compare(tag: str, ranks_dir: Path, one_dir: Path, steps: int,
               loss_tol: tuple = DP_LOSS_TOL, heads: int | None = None,
               prefix: str = "dp") -> float:
    """(b)/(c): the world-size-2 run's per-step losses and final parameters
    against the world-size-1 run's (``heads``: the two ranks' run is a
    tensor-parallel Conformer's, its qkv interleaved). Returns the
    parameters' error."""
    got, want = train_losses(ranks_dir), train_losses(one_dir)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]
    ok = (len(got) == len(want) == steps and rel[0] <= loss_tol[0]
          and all(r <= loss_tol[1] for r in rel[1:]))
    check(ok, f"{prefix} {tag}: {len(got)} per-step losses of 2 ranks against 1 rank, "
              f"relative errors {[f'{r:.3e}' for r in rel]} (step 0 <= {loss_tol[0]:g}, later "
              f"<= {loss_tol[1]:g}); first {got[:1]} / {want[:1]}")
    a, b = dp_final_params(ranks_dir, heads), dp_final_params(one_dir)
    args = load_args(str(one_dir))
    init = tree_items(build_model(args, int(args["nDays"]), "cuda:0",
                                  int(args.get("seed", 0))).params)
    reach = sum(lr_schedule(args)(i) for i in range(steps))
    errs, peak = {}, {}
    for k, want in b.items():
        want, got, p0 = want.double(), a[k].double(), init[k].detach().cpu().double()
        errs[k] = float((got - want).norm() / (want - p0).norm().clamp_min(1e-30))
        peak[k] = float((got - want).abs().max()) / reach
    worst, far = max(errs, key=errs.get), max(peak, key=peak.get)
    check(a.keys() == b.keys() == init.keys() and errs[worst] <= DP_PARAM_TOL,
          f"{prefix} {tag}: final parameters of 2 ranks against 1 rank, {len(errs)} leaves: the "
          f"updates' L2 difference over the one-rank update at most {errs[worst]:.3e} "
          f"({worst}; tolerance {DP_PARAM_TOL:g}); the largest entry's difference "
          f"{peak[far]:.3e} of the {steps} steps' summed learning rates {reach:.3g} ({far})")
    return errs[worst]


def dp_one_card_ranks(tag: str, args: dict, want: dict, bodies: dict, card: str) -> dict:
    """Two gloo ranks on ``cuda:0`` (``parallel/data_parallel.py::launch``
    with the caller's backend: each rank calls ``train_model`` in the group)
    against ``train_model`` alone; each rank's launches by body, from the
    run's last metrics record. Returns both ranks' launches."""
    one, ranks = DP_DIR / f"{tag}_world1", DP_DIR / f"{tag}_world2"
    t0 = time.perf_counter()
    train_model({**args, "outputDir": str(one)})
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    t0 = time.perf_counter()
    summaries = dp.launch(train_model, [({**args, "outputDir": str(ranks)},)] * 2,
                          devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    check(summaries[0] == summaries[1],
          f"dp {tag}: both ranks returned one summary ({summaries[0]})")
    err = dp_compare(tag, ranks, one, args["nBatch"])
    total = {k: 0 for k in COUNTED}
    for r in (0, 1):
        launches = dp_rank_launches(ranks, r)
        ran = {k: v for k, v in launches.items() if v}
        check(all(launches.get(k) == v for k, v in want.items()),
              f"dp {tag}: rank {r} launched {ran}; per rank {want} (bodies {bodies})")
        for k in COUNTED:
            total[k] += launches.get(k, 0)
    print(f"dp {tag}: 2 gloo ranks on one card {ranks_s:.1f} s (spawn, build load and "
          f"checkpoint included), 1 rank {one_s:.1f} s; updates within {err:.3e} "
          f"({card})", flush=True)
    return total


def dp_gru_want(steps: int, n_eval: int) -> tuple[dict, dict]:
    """A float32 GRU rank's launches at B/2 rows: per step each layer's
    gates-forward and backward scans and one CTC alpha and beta; per eval
    batch the frontend, each layer's inference scan and one alpha; by the
    bodies ``scan_plan``, ``frontend_plan`` and ``ctc_plan`` pick."""
    scan = f32_scan_body(H, B // 2)
    bodies = {"gru_scan_gates": scan, "gru_scan_bwd": scan, "gru_scan": scan,
              "ctc_alpha": CTC_BODY, "ctc_beta": CTC_BODY,
              "frontend": frontend_plan(torch.float32, C, 20)}
    counts = {"gru_scan_gates": 5 * steps, "gru_scan_bwd": 5 * steps,
              "ctc_alpha": steps + n_eval, "ctc_beta": steps, "frontend": n_eval,
              "gru_scan": 5 * n_eval, **NO_ATTENTION, **NO_GRU_FUSED}
    return counts | {f"{k}/{b}": counts[k] for k, b in bodies.items()}, bodies


def dp_conformer_want(steps: int, n_eval: int) -> tuple[dict, dict]:
    """A float32 fused Conformer rank's launches (2 blocks, so no InterCTC
    head: it needs 6): per step and eval batch 2 attention, 4 FF and 2 conv
    forwards and one CTC alpha; per step their backwards and one beta."""
    n, fwd = DP_CONFORMER_LAYERS, steps + n_eval
    bodies = {"mhsa_qkv": ATTN_BODY["float32"], "mhsa_qkv_bwd": ATTN_BODY["float32"],
              **{k: fused_body(k, "float32") for k in FUSED_BODIES}, "ctc_alpha": CTC_BODY,
              "ctc_beta": CTC_BODY}
    counts = {"mhsa_qkv": n * fwd, "mhsa_qkv_bwd": n * steps, "ffn": 2 * n * fwd,
              "ffn_bwd": 2 * n * steps, "conv_module": n * fwd, "conv_module_bwd": n * steps,
              "ctc_alpha": steps + n_eval, "ctc_beta": steps, **NO_GRU,
              **NO_GRU_FUSED}
    return counts | {f"{k}/{b}": counts[k] for k, b in bodies.items()}, bodies


def data_parallel_phase(card: str) -> dict:
    """Data parallelism (phase 19, lines start ``dp``): (a) the recipe's
    bf16 GRU, 6 steps, in a one-rank NCCL group (``multihost.initialize``)
    against no group, losses bit-equal; (b) the float32 GRU, 3 steps, two
    gloo ranks on the one card against one rank; (c) the float32 fused
    Conformer at full width, depth cut to 2 blocks, the kernels' dropout 0,
    the same; (d) with two cards or more, (b) over NCCL on two cards
    (``n_data_devices: 2``). Returns the ranks' launches."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    ds = dp_dataset()
    n_eval = -(-pack_days(ds["test"]).n_trials // B)
    launches = {k: 0 for k in COUNTED}

    # (a) a one-rank NCCL group against no group: bit-equal
    t0 = time.perf_counter()
    args = dp_run_args(BENCH_ARGS, DP_DIR / "a_nogroup", DP_STEPS["a"], ds)
    train_model(args)
    multihost.initialize("tcp://127.0.0.1:" + str(dp._free_port()), 1, 0, device="cuda:0")
    try:
        backend = torch.distributed.get_backend()
        train_model({**args, "outputDir": str(DP_DIR / "a_nccl1")})
    finally:
        torch.distributed.destroy_process_group()
    got, want = train_losses(DP_DIR / "a_nccl1"), train_losses(DP_DIR / "a_nogroup")
    check(backend == "nccl" and len(got) == DP_STEPS["a"] and got == want,
          f"dp (a): bf16 GRU, {len(got)} per-step losses in a one-rank {backend} group "
          f"bit-equal to no group ({got[:2]} ...)")
    for k, v in dp_rank_launches(DP_DIR / "a_nccl1", 0).items():
        if k in launches:
            launches[k] += v
    print(f"dp (a): {time.perf_counter() - t0:.1f} s ({card})", flush=True)

    # (b) the float32 GRU, two gloo ranks on the card
    args = dp_run_args(BENCH_ARGS, DP_DIR, DP_STEPS["b"], ds, compute_dtype="float32")
    want, bodies = dp_gru_want(DP_STEPS["b"], n_eval)
    print(f"dp (b): the bodies a rank's B={B // 2} float32 GRU runs on: {bodies}", flush=True)
    for k, v in dp_one_card_ranks("(b) gru f32", args, want, bodies, card).items():
        launches[k] += v

    # (c) the float32 Conformer, fused FF and conv, kernels' dropout 0
    args = dp_run_args({**CONFORMER_ARGS, **FUSED_FLAGS["conformer"]}, DP_DIR, DP_STEPS["c"],
                       ds, compute_dtype="float32", transformer_dropout=0.0,
                       transformer_num_layers=DP_CONFORMER_LAYERS)
    want, bodies = dp_conformer_want(DP_STEPS["c"], n_eval)
    for k, v in dp_one_card_ranks("(c) conformer f32", args, want, bodies, card).items():
        launches[k] += v

    # (d) two cards over NCCL
    if torch.cuda.device_count() >= 2:
        args = dp_run_args(BENCH_ARGS, DP_DIR / "d_world2", DP_STEPS["b"], ds,
                           compute_dtype="float32", device="cuda", n_data_devices=2)
        t0 = time.perf_counter()
        train_model(args)
        print(f"dp (d): 2 NCCL ranks on 2 cards {time.perf_counter() - t0:.1f} s ({card})",
              flush=True)
        dp_compare("(d) gru f32 nccl", DP_DIR / "d_world2", DP_DIR / "(b) gru f32_world1",
                   DP_STEPS["b"])
    else:
        print(f"dp (d): not run: {torch.cuda.device_count()} card visible, data parallelism "
              f"across cards needs 2", flush=True)
    shutil.rmtree(DP_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------ tensor parallelism

TP_DIR = Path("runs") / "chip_smoke_tp"
TP_STEPS = 3
TP_BATCH = 16  # rows a step and an eval batch
TP_GRU_LAYERS = 2  # depth cut to hold the smoke's time
TP_CONFORMER_LAYERS = 2
# (a)/(b) against one rank, float32: the model group sums each row-parallel
# product's two halves (and the GRU's layer 0 its two channel halves) in
# another order; nothing else differs (the recurrence runs whole). Step 0
# sees that order alone; a later step also the updates it moved, and every
# forward since differs at rounding level (not only the sum of the
# gradients, as under data parallelism): the float32 GRU's step 2 came
# 2.03e-05 from one rank's on an H100 80GB HBM3 at 700 W, so later steps take data
# parallelism's bound
TP_LOSS_TOL = (1e-6, DP_LOSS_TOL[1])  # step 0, later steps: relative
# (c) against one rank, bfloat16: a sum in another order rounds to bf16
# the other way (2**-8 relative) and the steps carry it on
TP_BF16_LOSS_TOL = 2e-2


def tp_rank_runs(runs: list[dict]) -> list[dict]:
    """Each of ``runs`` in turn, ``train_model`` in this rank of the
    caller's group."""
    return [train_model(args) for args in runs]


def tp_gru_want(steps: int, n_eval: int) -> tuple[dict, dict]:
    """A float32 GRU model rank's launches (2 layers, ``use_pallas_matmul``
    and ``fused_optimizer``): per step each layer's gates-forward and
    backward scans on the whole recurrence, layer 1's projection on the
    rank's contraction rows (forward, dX, dW), one CTC alpha and beta and
    one Adam over the rank's leaves; per eval batch the frontend, each
    layer's inference scan, layer 1's forward product and one alpha."""
    scan = f32_scan_body(H, TP_BATCH)
    n = TP_GRU_LAYERS
    bodies = {"gru_scan_gates": scan, "gru_scan_bwd": scan, "gru_scan": scan,
              "ctc_alpha": CTC_BODY, "ctc_beta": CTC_BODY,
              "frontend": frontend_plan(torch.float32, C, 20), "tiled_matmul": MM_BODY["float32"]}
    counts = {"gru_scan_gates": n * steps, "gru_scan_bwd": n * steps, "gru_scan": n * n_eval,
              "ctc_alpha": steps + n_eval, "ctc_beta": steps, "frontend": n_eval,
              "tiled_matmul": (n - 1) * (3 * steps + n_eval), "adam_update": steps,
              **NO_ATTENTION}
    return counts | {f"{k}/{b}": counts[k] for k, b in bodies.items()}, bodies


def tp_conformer_want(steps: int, n_eval: int, dtype: str) -> tuple[dict, dict]:
    """A Conformer model rank's launches with ``fused_conv`` (2 blocks, so
    no InterCTC head): per step and eval batch 2 attention forwards on the
    rank's 4 heads and 2 conv forwards (replicated), one CTC alpha; per
    step their backwards and one beta; the FFs unfused (``fused_ffn`` is
    refused under tensor parallelism)."""
    n, fwd = TP_CONFORMER_LAYERS, steps + n_eval
    bodies = {"mhsa_qkv": ATTN_BODY[dtype], "mhsa_qkv_bwd": ATTN_BODY[dtype],
              "conv_module": fused_body("conv_module", dtype),
              "conv_module_bwd": fused_body("conv_module_bwd", dtype), "ctc_alpha": CTC_BODY,
              "ctc_beta": CTC_BODY}
    counts = {"mhsa_qkv": n * fwd, "mhsa_qkv_bwd": n * steps, "conv_module": n * fwd,
              "conv_module_bwd": n * steps, "ffn": 0, "ffn_bwd": 0,
              "ctc_alpha": steps + n_eval, "ctc_beta": steps, **NO_GRU}
    return counts | {f"{k}/{b}": counts[k] for k, b in bodies.items()}, bodies


def tensor_parallel_phase(card: str) -> dict:
    """Tensor parallelism (phase 20, lines start ``tp``), at full width on
    ``train_model_phase``'s synthetic trials, two gloo ranks on the one
    card (``n_model_devices: 2, n_data_devices: 1``: each rank calls
    ``train_model`` in the group, all three runs in one launch) against one
    rank: (a) the float32 GRU, 2 layers, ``use_pallas_matmul`` and
    ``fused_optimizer``; (b) the float32 Conformer, 2 blocks, ``fused_conv``,
    the kernels' dropout 0, 4 heads a rank; (c) the same in bfloat16; 3
    steps of B=16 each. (a)/(b): losses within ``TP_LOSS_TOL``, each leaf's
    update within ``DP_PARAM_TOL`` in L2 (the ranks' whole checkpoint,
    de-interleaved); (c): losses within ``TP_BF16_LOSS_TOL``; every rank's
    launches by body exact. (d) with two cards or more, (a) over nccl on
    two cards; else one line saying it did not run. Returns the ranks'
    launches."""
    shutil.rmtree(TP_DIR, ignore_errors=True)
    ds = dp_dataset()
    n_eval = -(-pack_days(ds["test"]).n_trials // TP_BATCH)
    base = dict(batchSize=TP_BATCH, compute_dtype="float32")
    conformer = {**CONFORMER_ARGS, "fused_conv": True, "transformer_dropout": 0.0,
                 "transformer_num_layers": TP_CONFORMER_LAYERS}
    heads = conformer.get("transformer_n_heads", 8)
    cells = {
        "a": (dp_run_args({**BENCH_ARGS, **FUSED_FLAGS["gru"]}, TP_DIR, TP_STEPS, ds,
                          nLayers=TP_GRU_LAYERS, **base), tp_gru_want(TP_STEPS, n_eval)),
        "b": (dp_run_args(conformer, TP_DIR, TP_STEPS, ds, **base),
              tp_conformer_want(TP_STEPS, n_eval, "float32")),
        "c": (dp_run_args(conformer, TP_DIR, TP_STEPS, ds, **{**base,
                                                               "compute_dtype": "bfloat16"}),
              tp_conformer_want(TP_STEPS, n_eval, "bfloat16")),
    }
    print(f"tp: bodies a rank runs: (a) {cells['a'][1][1]}; (b) {cells['b'][1][1]}; "
          f"(c) {cells['c'][1][1]}; attention on {heads // 2} of {heads} heads a rank",
          flush=True)
    one_s = {}
    for k, (args, _) in cells.items():
        t0 = time.perf_counter()
        train_model({**args, "outputDir": str(TP_DIR / f"{k}_one")})
        one_s[k] = time.perf_counter() - t0
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    runs = [{**args, "outputDir": str(TP_DIR / f"{k}_tp"), "n_model_devices": 2,
             "n_data_devices": 1} for k, (args, _) in cells.items()]
    t0 = time.perf_counter()
    summaries = dp.launch(tp_rank_runs, [(runs,)] * 2, devices=["cuda:0", "cuda:0"],
                          backend="gloo", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    check(summaries[0] == summaries[1],
          f"tp: both model ranks returned the same summaries ({summaries[0]})")
    launches = {k: 0 for k in COUNTED}
    for k, (args, (want, bodies)) in cells.items():
        tag = f"({k}) {'gru' if k == 'a' else 'conformer'} {args['compute_dtype']}"
        one, tp = TP_DIR / f"{k}_one", TP_DIR / f"{k}_tp"
        if k == "c":
            got, ref = train_losses(tp), train_losses(one)
            rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref)]
            check(len(got) == len(ref) == TP_STEPS and max(rel) <= TP_BF16_LOSS_TOL,
                  f"tp {tag}: {len(got)} per-step losses of 2 model ranks against 1 rank, "
                  f"relative errors {[f'{r:.3e}' for r in rel]} (<= {TP_BF16_LOSS_TOL:g})")
        else:
            err = dp_compare(tag, tp, one, TP_STEPS, TP_LOSS_TOL,
                             heads=heads if k == "b" else None, prefix="tp")
            print(f"tp {tag}: updates within {err:.3e} of one rank's ({card})", flush=True)
        for r in (0, 1):
            got = dp_rank_launches(tp, r)
            ran = {n: v for n, v in got.items() if v}
            check(all(got.get(n) == v for n, v in want.items()),
                  f"tp {tag}: model rank {r} launched {ran}; per rank {want} (bodies {bodies})")
            for n in COUNTED:
                launches[n] += got.get(n, 0)
    alone = ", ".join(f"({k}) {v:.1f}" for k, v in one_s.items())
    print(f"tp: 2 gloo model ranks on one card {ranks_s:.1f} s for (a)-(c) (spawn, build "
          f"load and checkpoints included), 1 rank {alone} s ({card})", flush=True)

    # (d) two cards over NCCL
    if torch.cuda.device_count() >= 2:
        args = {**cells["a"][0], "outputDir": str(TP_DIR / "d_nccl"), "device": "cuda",
                "n_model_devices": 2, "n_data_devices": 1}
        t0 = time.perf_counter()
        train_model(args)
        print(f"tp (d): 2 NCCL model ranks on 2 cards {time.perf_counter() - t0:.1f} s "
              f"({card})", flush=True)
        dp_compare("(d) gru float32 nccl", TP_DIR / "d_nccl", TP_DIR / "a_one", TP_STEPS,
                   TP_LOSS_TOL, prefix="tp")
    else:
        print(f"tp (d): not run: {torch.cuda.device_count()} card visible, tensor "
              f"parallelism across cards needs 2", flush=True)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------ tensor-parallel rescoring

TPLLM_BATCHES = 8  # batches of LLM_BATCH sentences scored on the 1x2 grid
TPLLM_DIGEST_CHUNK = 64 << 20  # bytes of a leaf copied to the host at a time
TPLLM_MODEL = 2  # model ranks
TPLLM_TAGS = {"bf16": False, "int8": True}


def leaf_digest(t: torch.Tensor, dim: int | None = None, tp: ModelShard | None = None) -> str:
    """sha256 of a leaf's bytes in C order, or of model rank ``tp``'s slice
    of it along ``dim`` (never 0 in the engine's table), copied to the host
    a few leading rows at a time."""
    if dim is not None and tp is not None:
        per = t.shape[dim] // tp.count
        start = tp.index * per
    row_bytes = max(t[0].numel() * t.element_size(), 1) if t.dim() > 1 else t.element_size()
    step = max(1, TPLLM_DIGEST_CHUNK // row_bytes)
    h = hashlib.sha256()
    for i in range(0, t.shape[0], step):
        piece = t[i: i + step]
        if dim is not None and tp is not None:
            piece = piece.narrow(dim, start, per)
        h.update(piece.contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def tree_digests(tree: dict, dims: dict | None = None, tp: ModelShard | None = None) -> dict:
    """``{path: sha256}`` of every leaf of an engine tree (or of rank
    ``tp``'s slices of a whole tree, ``dims`` being ``llm_shardings``'),
    hashed on 8 host threads."""
    jobs = []
    for k, v in tree.items():
        if isinstance(v, dict):
            jobs += [(f"{k}.{n}", t, None if dims is None else dims[k].get(n))
                     for n, t in v.items()]
        else:
            jobs.append((k, v, None if dims is None else dims.get(k)))
    with ThreadPoolExecutor(8) as pool:
        digests = pool.map(lambda job: leaf_digest(job[1], job[2], tp), jobs)
        return dict(zip((job[0] for job in jobs), digests))


def tpllm_rank(sentences: list[str]) -> dict:
    """Phase 21 in a rank of the caller's 1x2 group, bf16 then int8: this
    rank's shards drawn by ``synth_params_on_device(shardings=, mesh=)`` at
    OPT-6.7B shapes (seconds, peak memory, sha256 per leaf), then
    ``params_scorer(mesh=)``'s log-probs of ``sentences`` and their
    seconds."""
    mesh = make_mesh(n_model=TPLLM_MODEL,
                     device=torch.device("cuda", torch.cuda.current_device()))
    spec = llm_engine.opt_spec(LLM_SIZE)
    out = {"m": mesh.m}
    for tag, quantize in TPLLM_TAGS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shards = llm_engine.synth_params_on_device(
            spec, seed=0, quantize=quantize, shardings=llm_engine.llm_shardings(spec, mesh),
            mesh=mesh)
        torch.cuda.synchronize()
        draw_s, draw_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        digests = tree_digests(shards)
        digest_s = time.perf_counter() - t0
        score = llm_engine.params_scorer(shards, spec, id_tokenizer, batch_size=LLM_BATCH,
                                         mesh=mesh)
        lp, score_s = timed_scores(score, sentences)
        out[tag] = {"draw_s": draw_s, "draw_peak": draw_peak, "digest_s": digest_s,
                    "bytes": tree_bytes(shards), "digests": digests, "lp": lp,
                    "score_s": score_s, "peak": torch.cuda.max_memory_allocated()}
        del shards, score
    return out


def tpllm_scores_check(tag: str, got: np.ndarray, ref: np.ndarray, how: str) -> None:
    rel = np.abs(got - ref) / np.abs(ref)
    lists = len(ref) // LLM_HYPS
    top_got = got[: lists * LLM_HYPS].reshape(lists, LLM_HYPS).argmax(1)
    top_ref = ref[: lists * LLM_HYPS].reshape(lists, LLM_HYPS).argmax(1)
    check(bool(np.isfinite(got).all()) and bool((rel <= LLM_TOL).all()),
          f"tpllm ({tag}) {how} against one rank's engine on the same weights, "
          f"{len(ref)} sentences: max |diff| / |log-prob| {rel.max():.3e} <= {LLM_TOL:g}, "
          f"max |diff| {np.abs(got - ref).max():.3e}; top-1 equal on "
          f"{int((top_got == top_ref).sum())} of {lists} whole n-best lists")


def tpllm_dryrun_want(name: str, steps: int = 1) -> dict:
    """A dryrun rank's launches in a stage (float32: the scans on the body
    ``scan_plan`` picks, the CTC recursions on the prefetch body, the
    attention forward and backward on the f32 body): a GRU step's 2
    layers' gates-forward and backward scans and one alpha and beta; a
    Conformer step's 2 attention forwards and backwards on the rank's heads
    and one alpha and beta. The GRU stages' widths: nUnits 128 on 16 rows a rank
    (``+pallas``), else 64 (any batch of up to 128 rows plans alike at that
    width)."""
    if name.startswith("gru_baseline"):
        body = f32_scan_body(128 if "+pallas" in name else 64, 16)
        want = {"gru_scan_gates": 2, f"gru_scan_gates/{body}": 2, "gru_scan_bwd": 2,
                f"gru_scan_bwd/{body}": 2}
    else:
        want = {"mhsa_qkv": 2, "mhsa_qkv/f32": 2, "mhsa_qkv_bwd": 2, "mhsa_qkv_bwd/f32": 2}
    want |= {"ctc_alpha": 1, "ctc_alpha/prefetch": 1, "ctc_beta": 1, "ctc_beta/prefetch": 1}
    return {k: v * steps for k, v in want.items()}


def tpllm_dryrun(card: str) -> dict:
    """(d) ``dryrun_multichip(2)`` on the card: the OK lines, every rank's
    launches by body in every stage exact; returns the launches summed over
    the ranks and stages."""
    t0 = time.perf_counter()
    res = dryrun_multichip(2, "cuda", timeout_s=600)
    launches = {k: 0 for k in COUNTED}
    for r in res:
        for st in r["stages"]:
            steps = len(st.get("losses", [0]))
            runs = [("", st["launches"])]
            if "one_rank_launches" in st:
                runs.append((" (its one-rank steps)", st["one_rank_launches"]))
                rel = max(abs(a - b) / abs(b) for a, b in zip(st["losses"],
                                                              st["one_rank_losses"]))
                print(f"tpllm (d) rank {r['rank']} {st['name']}: {steps} per-step losses "
                      f"within {rel:.3e} relative of one rank's", flush=True)
            for what, got in runs:
                want = tpllm_dryrun_want(st["name"], steps)
                check(got == want,
                      f"tpllm (d) dryrun rank {r['rank']} {st['name']}{what} on "
                      f"mesh={st['mesh']}: launches by body {got} == {want}")
                for k in COUNTED:
                    launches[k] += got.get(k, 0)
    print(f"tpllm (d): dryrun_multichip(2) on {torch.cuda.device_count()} card(s), "
          f"{len(res[0]['lines'])} stages, {time.perf_counter() - t0:.1f} s (spawn included) "
          f"({card})", flush=True)
    return launches


def tpllm_phase(card: str) -> dict:
    """Tensor-parallel rescoring and the multichip dryrun (phase 21, lines
    start ``tpllm``): the engine at OPT-6.7B shapes, random weights drawn
    on the card, two gloo model ranks on the one card (a 1x2 grid) against
    this process's one-rank engine on the same weights, bf16 and int8: (a)
    each rank's shards drawn with ``shardings=``, their sha256 per leaf
    equal to those of the same slices of the one-rank tree, seconds and
    peak memory per rank; (b) bf16 and (c) int8 log-probs of
    ``TPLLM_BATCHES`` batches of ``LLM_BATCH`` sentences within ``LLM_TOL``
    relative of one rank's, the largest difference, the top-1 agreement
    over the whole n-best lists scored, seq/s (through gloo over host
    memory: not a target); (d) ``dryrun_multichip(2)`` on the card, the
    ranks' launches by body exact; (e) with two cards or more, (b) over
    nccl on two cards, else one line saying it did not run. Returns the
    dryrun's launches."""
    spec = llm_engine.opt_spec(LLM_SIZE)
    sentences = llm_sentences(np.random.default_rng(21), spec.vocab)[
        : TPLLM_BATCHES * LLM_BATCH]
    dims = llm_engine.llm_shardings(spec, ModelShard(0, TPLLM_MODEL))
    ref, want, one_s = {}, {}, {}
    for tag, quantize in TPLLM_TAGS.items():
        params = synth_llm(spec, quantize, card)
        t0 = time.perf_counter()
        want[tag] = [tree_digests(params, dims, ModelShard(m, TPLLM_MODEL))
                     for m in range(TPLLM_MODEL)]
        print(f"tpllm (a) {tag}: sha256 of both ranks' slices of the one-rank tree in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        score = llm_engine.params_scorer(params, spec, id_tokenizer, batch_size=LLM_BATCH)
        ref[tag], one_s[tag] = timed_scores(score, sentences)
        del params, score
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dp.launch(tpllm_rank, [(sentences,)] * TPLLM_MODEL,
                      devices=["cuda:0"] * TPLLM_MODEL, backend="gloo", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    for tag in TPLLM_TAGS:
        for r in ranks:
            got, m = r[tag], r["m"]
            same = [k for k, v in want[tag][m].items() if got["digests"].get(k) == v]
            check(sorted(got["digests"]) == sorted(want[tag][m])
                  and len(same) == len(want[tag][m]),
                  f"tpllm (a) {tag} model rank {m}: sha256 of {len(same)} of "
                  f"{len(want[tag][m])} leaves equal to the one-rank tree's slices")
            print(f"tpllm (a) {tag} model rank {m}: drew {got['bytes'] / 1e9:.2f} GB in "
                  f"{got['draw_s']:.1f} s, peak {got['draw_peak'] / 2**30:.2f} GiB (drawing), "
                  f"{got['peak'] / 2**30:.2f} GiB (scoring); sha256 in "
                  f"{got['digest_s']:.1f} s ({card})", flush=True)
        lp = [r[tag]["lp"] for r in ranks]
        check(all(np.array_equal(lp[0], x) for x in lp),
              f"tpllm ({'b' if tag == 'bf16' else 'c'}) {tag}: both model ranks return the "
              f"same scores")
        tpllm_scores_check("b" if tag == "bf16" else "c", lp[0], ref[tag],
                           f"{tag}, 2 gloo model ranks on one card")
        n = len(sentences)
        print(f"tpllm ({'b' if tag == 'bf16' else 'c'}) {tag} OPT-{LLM_SIZE} shapes: {n} "
              f"sequences in {TPLLM_BATCHES} batches of {LLM_BATCH}: 1x2 grid "
              f"{ranks[0][tag]['score_s']:.2f} s, {n / ranks[0][tag]['score_s']:.1f} seq/s "
              f"(gloo through host memory); one rank {one_s[tag]:.2f} s, "
              f"{n / one_s[tag]:.1f} seq/s ({card})", flush=True)
    print(f"tpllm: the ranks' launch {ranks_s:.1f} s (spawn and both draws included) "
          f"({card})", flush=True)
    launches = tpllm_dryrun(card)

    # (e) two cards over NCCL
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        ranks = dp.launch(tpllm_rank, [(sentences,)] * TPLLM_MODEL,
                          devices=[f"cuda:{m}" for m in range(TPLLM_MODEL)], backend="nccl",
                          timeout_s=600)
        for tag in TPLLM_TAGS:
            tpllm_scores_check("e", ranks[0][tag]["lp"], ref[tag],
                               f"{tag}, 2 NCCL model ranks on 2 cards")
            print(f"tpllm (e) {tag}: {ranks[0][tag]['score_s']:.2f} s for "
                  f"{len(sentences)} sequences over nccl ({card})", flush=True)
        print(f"tpllm (e): {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    else:
        print(f"tpllm (e): not run: {torch.cuda.device_count()} card visible, tensor-"
              f"parallel rescoring across cards needs 2", flush=True)
    return launches


# ------------------------------------------------------------------ export

EXPORT_DIR = Path("runs") / "chip_smoke_export"
EXPORT_REQUESTS = 21  # timed requests a server: seven rounds of REQUEST_SIZES


def serve_request(server, trials, days, k: int, stages: dict):
    """Request ``k % 3`` of ``REQUEST_SIZES`` through ``server``
    (``pad_batch`` -> call -> ``decode``), a sync after each stage; appends
    each stage's host ms to ``stages`` and returns ``(log_probs, out_lens,
    decoded)``."""
    offsets = np.cumsum((0,) + REQUEST_SIZES)
    k %= len(REQUEST_SIZES)
    lo, m = int(offsets[k]), REQUEST_SIZES[k]
    t0 = time.perf_counter()
    x, dd, lens = server.pad_batch(trials[lo: lo + m], days[lo: lo + m])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    log_probs, out_lens = server(x, dd, lens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decoded = server.decode(log_probs, out_lens)
    t3 = time.perf_counter()
    for stage, ms in zip(("pad", "forward", "decode"), (t1 - t0, t2 - t1, t3 - t2)):
        stages.setdefault(stage, []).append(ms * 1e3)
    return log_probs, out_lens, decoded


def split_line(stages: dict) -> str:
    return ", ".join(f"{k} {statistics.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                     for k, v in stages.items())


def export_request_check(tag: str, run_dir: Path, per_request: dict, card: str) -> dict:
    """``nsd-export-torch`` of a run directory at B=64, T=1280, then the
    three serving requests through the artifact against the eager
    ``InferenceModel`` of the same run (log-probs and lengths bit-equal,
    else within ``LOGITS_TOL``), the artifact's launches (``per_request`` a
    request and no other kernel, on the bodies of the bf16 recipe), and both
    servers' request times split into pad, forward and decode."""
    art = EXPORT_DIR / tag
    t0 = time.perf_counter()
    serve_cli.main([str(run_dir), str(art), "--batch-size", str(B), "--t-max", str(T)])
    export_s = time.perf_counter() - t0
    exported = load_exported(str(art))
    load_s = time.perf_counter() - t0 - export_s
    model, _ = load_model(str(run_dir), device="cuda")
    eager = InferenceModel(model.params, model.cfg, "cuda", batch_size=B, t_max=T)
    del model
    trials, days = serving_trials()
    for server in (exported, eager):
        serve_request(server, trials, days, 0, {})  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    n = len(REQUEST_SIZES)
    got = [serve_request(exported, trials, days, k, {}) for k in range(n)]
    launches = read_launches()
    want = {k: 0 for k in KERNELS} | {k: v * n for k, v in per_request.items()}
    bodies, want_bodies = launch_bodies(want)
    check(launches == want and bodies == want_bodies,
          f"exported {tag}: {n} requests launched {launches} == {per_request} a request "
          f"and no other kernel; by body {bodies}")
    ref = [serve_request(eager, trials, days, k, {}) for k in range(n)]
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
               for a, b in zip(got, ref))
    err = max((a[0] - b[0]).abs().max().item() for a, b in zip(got, ref))
    lens_equal = all(torch.equal(a[1], b[1]) for a, b in zip(got, ref))
    for (log_probs, out_lens, decoded), m in zip(got, REQUEST_SIZES):
        check_request(f"exported {tag}", m, log_probs, out_lens, decoded)
    check(same or (err <= LOGITS_TOL and lens_equal),
          f"exported {tag} vs the eager InferenceModel over {n} requests: "
          f"{'bit-equal' if same else f'log-probs max abs err {err:.3e} <= {LOGITS_TOL:g}'}"
          f", out_lens equal {lens_equal}")
    # the two servers in turns (exported, eager, eager, exported, ...), so
    # that the host's noise falls on both
    times_e, times_i = {}, {}
    for k in range(EXPORT_REQUESTS):
        turns = ((exported, times_e), (eager, times_i))
        for server, stages in turns if k % 2 == 0 else turns[::-1]:
            serve_request(server, trials, days, k, stages)
    print(f"export {tag} B={B} T={T}: nsd-export-torch {export_s:.1f} s, load {load_s:.1f} s; "
          f"{EXPORT_REQUESTS} requests each in turns, host ms median (range): exported "
          f"{split_line(times_e)}; eager InferenceModel {split_line(times_i)} ({card})",
          flush=True)
    return launches


def export_stream_check(kind: str, card: str) -> None:
    """The bf16 B=1 streaming cell exported with its beam programs (one
    frame a chunk), driven by ``ExportedStreamer`` over one utterance in
    4-bin chunks against the live streamer (CUDA graphs on): outputs
    bit-equal, else within ``BF16_LOGITS_FACTOR`` x the live bf16 stream's
    distance from its float32 twin; greedy and beam decodes equal; no hand
    kernel launched; the host p50 of a chunk beside the live graph's."""
    cfg, params = stream_model(kind, torch.bfloat16)
    art = str(EXPORT_DIR / f"stream_{kind}")
    t0 = time.perf_counter()
    export = export_streaming_params if kind == "gru" else export_streaming_conformer_params
    export(params, cfg, art, batch=1, frames_per_chunk=1, device="cuda")
    export_beam(art, batch=1, n_classes=cfg.n_out, beam_width=BEAM_WIDTH, device="cuda")
    export_s = time.perf_counter() - t0
    exp = load_exported_streamer(art)
    load_s = time.perf_counter() - t0 - export_s
    live = make_streamer(kind, cfg, params, 1)
    live32 = make_streamer(kind, dataclasses.replace(cfg, compute_dtype=torch.float32),
                           params, 1, graphs=False)
    t = STREAM_BINS[kind]
    x = np.random.default_rng(13).standard_normal((1, t, C)).astype(np.float32)
    chunks = [x[:, i: i + STREAM_CHUNK] for i in range(0, t, STREAM_CHUNK)]
    reset_launches()
    outs = {"exported": [], "live": [], "float32": []}
    greedy = {"exported": [], "live": []}
    for i in range(len(chunks) + 1):
        e = exp.feed(chunks[i]) if i < len(chunks) else exp.flush()
        lv = live.process(chunks[i]) if i < len(chunks) else live.flush()
        outs["float32"].append(live32.process(chunks[i]) if i < len(chunks)
                               else live32.flush())
        outs["exported"].append(e)
        outs["live"].append(lv)
        greedy["exported"] += exp.decode_greedy(e)[0]
        greedy["live"] += live.decode_greedy(lv)[0]
        beam_e = exp.decode_beam(e)
        beam_l = [a.cpu().numpy() for a in live.decode_beam(lv, beam_width=BEAM_WIDTH)]
    torch.cuda.synchronize()
    check_no_launches(f"exported {kind} stream")
    e, lv, f32 = (np.concatenate(outs[k], axis=1) for k in ("exported", "live", "float32"))
    err = float(np.abs(e - lv).max()) if e.shape == lv.shape else math.inf
    dist = float(np.abs(lv - f32).max())
    score_err = float(np.abs(beam_e[2] - beam_l[2]).max())
    # a beam score sums one log-softmax entry a frame: each moves by at most
    # twice the outputs' error
    score_tol = BEAM_TOL + 2 * e.shape[1] * err
    n = (t - 32) // 4
    check(e.shape[1] == n and (err == 0 or err <= BF16_LOGITS_FACTOR * dist)
          and greedy["exported"] == greedy["live"]
          and np.array_equal(beam_e[0], beam_l[0]) and np.array_equal(beam_e[1], beam_l[1])
          and score_err <= score_tol,
          f"exported {kind} bf16 stream of {t} bins in 4-bin chunks vs the live streamer "
          f"({live._fast.replays} chunks replayed as CUDA graphs): {e.shape[1]} frames == "
          f"{n}; outputs {'bit-equal' if err == 0 else f'max abs err {err:.3e}'} (limit "
          f"{BF16_LOGITS_FACTOR:g} x the live bf16 stream's distance {dist:.3e} from "
          f"float32); greedy decodes equal ({len(greedy['live'])} labels); beam W="
          f"{BEAM_WIDTH} prefixes and lens equal, scores max abs err {score_err:.3e} <= "
          f"{score_tol:.3g}")
    exp.reset()
    live.reset()
    for c in chunks[:30]:
        exp.feed(c)
        live.process(c)
    torch.cuda.synchronize()
    lat = {"exported": [], "live": []}
    for i in range(100):  # the two in turns
        turns = (("exported", exp.feed), ("live", live.process))
        for name, feed in turns if i % 2 == 0 else turns[::-1]:
            t1 = time.perf_counter()
            feed(chunks[30 + i % 60])
            lat[name].append((time.perf_counter() - t1) * 1e3)
    print(f"export stream {kind} bf16 B=1: export {export_s:.1f} s, load {load_s:.1f} s; host "
          f"p50 a chunk (100 chunks each in turns, host data to host output) exported "
          f"{statistics.median(lat['exported']):.4f} ms ({min(lat['exported']):.4f}-"
          f"{max(lat['exported']):.4f}), live CUDA graph {statistics.median(lat['live']):.4f} "
          f"ms ({min(lat['live']):.4f}-{max(lat['live']):.4f}) ({card})", flush=True)


def export_phase(card: str) -> dict:
    """The serving artifacts (``serving/export.py``): the GRU of
    ``cli_phase``'s run and the Conformer of ``conformer_train_model_phase``'s
    run, as trained and with both fused flags in a copy of its args, each
    against the eager ``InferenceModel``; then both streaming cells with
    their beam programs against the live streamers. Removes the run
    directories. Returns the launches of the exported requests."""
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    fused_run = EXPORT_DIR / "conformer_fused_run"
    shutil.copytree(CONFORMER_RUN, fused_run)
    args = load_args(str(fused_run))
    save_args(str(fused_run), {**args, **FUSED_FLAGS["conformer"]})
    launches = {k: 0 for k in KERNELS}
    for tag, run_dir, per_request in (
            # the run's use_pallas_matmul: layers 1-4's projections on the kernel
            ("gru", CLI_RUN / "run", {"frontend": 1, "gru_scan": 5, "tiled_matmul": 4}),
            ("conformer", CONFORMER_RUN, {"mhsa_qkv": CONFORMER_LAYERS}),
            ("conformer_fused", fused_run, {"mhsa_qkv": CONFORMER_LAYERS,
                                            "ffn": 2 * CONFORMER_LAYERS,
                                            "conv_module": CONFORMER_LAYERS})):
        for k, v in export_request_check(tag, run_dir, per_request, card).items():
            launches[k] += v
    for kind in ("gru", "conformer"):
        export_stream_check(kind, card)
    for path in (EXPORT_DIR, CLI_RUN, CONFORMER_RUN):
        shutil.rmtree(path, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    # Full float32 in the plain versions' products and convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(line.strip(), flush=True)

    t0 = time.perf_counter()
    rows = dict(zip(("frontend", "gru_scan", "frontend_f32"), kernel_phase()))
    launches = serving_phase(card)
    print(f"phase serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows.update(train_kernel_phase())
    print(f"phase train kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    step_launches, gru_median = train_step_phase(card)
    launches.update(step_launches)
    print(f"phase train step: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_model_phase(card)
    print(f"phase train_model: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows.update(attention_kernel_phase())
    print(f"phase attention kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    conformer_launches, conformer_median = conformer_train_step_phase(card)
    launches.update(conformer_launches)
    print(f"phase conformer train step: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    attn_f32, conformer32_median = conformer_float32_steps_phase(card)
    for k, n in attn_f32.items():
        launches[k] += n
    print(f"phase float32 conformer train steps: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    conformer_train_model_phase(card)
    print(f"phase conformer train_model: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows.update(fused_kernel_phase())
    print(f"phase fused FF and conv kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(fused_conformer_phase(card, conformer_median, conformer32_median))
    print(f"phase fused conformer: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows["tiled_matmul"] = matmul_kernel_phase()
    rows["adam_update"] = adam_kernel_phase()
    print(f"phase GRU opt-in kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(gru_fused_step_phase(card, gru_median))
    print(f"phase flagged GRU train step: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gru_float32_steps_phase(card)
    print(f"phase float32 GRU train steps: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cli_phase(card)
    print(f"phase nsd-train: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    streaming_phase(card)
    print(f"phase streaming: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in competition_phase(card).items():
        launches[k] += n
    print(f"phase competition decode: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in workflow_phase(card).items():
        launches[k] += n
    print(f"phase research workflow: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in data_parallel_phase(card).items():
        launches[k] += n
    print(f"phase data parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in tensor_parallel_phase(card).items():
        launches[k] += n
    print(f"phase tensor parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in tpllm_phase(card).items():
        launches[k] += n
    print(f"phase tensor-parallel rescoring: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, n in export_phase(card).items():
        launches[k] += n
    print(f"phase export: {time.perf_counter() - t0:.1f} s", flush=True)
    # every kernel of the main paths ran there (the mask hooks excepted: the
    # attention and FF kernels draw their masks themselves)
    idle = [k for k in COUNTED if k not in HOOKS and not launches[k]]
    check(not idle, f"every kernel of the main paths launched there; idle: {idle}")
    out = []
    for name in KERNELS + tuple(F32_ROWS):
        count = F32_ROWS.get(name, name)
        source, replaces = SOURCES[count.split("/")[0]]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[count],
                    **rows[name]})
    print(json.dumps({"kernels": out}), flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
