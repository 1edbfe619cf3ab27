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
   (``body="fma"``, also held against the plain version), whose float32
   row and bound the kernels line keeps. The
   bfloat16 scan runs on the persistent body (reruns bit-equal), timed in
   turns with its plain version, beside the step body at the same
   shapes and cuDNN's bidirectional layer (``torch.nn.GRU``, context: it
   also does the input projection).
3. Serving: ``InferenceModel`` answers 3 float32 requests of random
   trials (pad -> forward -> greedy decode); checks finite log-probs, empty
   decodes for padded rows, the kernels' launch counts, and the float32
   logits against the same model run through the plain versions; prints
   the median request latency and sequences per second. Then one request
   in the recipe's bfloat16 compute, with the same checks.
4. Training kernels: the gates-storing scan, the scan's backward and the
   CTC alpha and beta recursions against their plain versions at the train
   step's shapes (L=313, B=64, H=1024, U=64), in float32 and bfloat16, with
   errors, tolerances and times; ``F.ctc_loss`` timed as the CTC rows'
   library call; the CTC recursions run on the prefetch body, bit for bit
   equal to PR 2's block body (``body="block"``, also held against the
   plain versions and timed beside it). The bfloat16 scans run on the persistent bodies (reruns
   bit-equal); the backward's dW_hh contraction alone on the tensor cores
   against its plain version; the step bodies and
   cuDNN's layer forward + backward timed beside them.
5. Train step: ``make_train_step`` at bench.py's shapes and ``GRU_ARGS``
   (B=64, T=1280, U=64, bfloat16, dropout and noise on): 2 warm-up and 10
   timed steps, the median step time and seq/s, a finite loss, moved
   parameters, the launches per step; then one float32 step without noise
   and dropout whose every gradient leaf is checked against the plain path,
   and one bf16 step and one eval batch each with ``use_pallas: false`` and
   ``ctc_use_kernel: false`` held against the default path (the switched
   kernels launch no time).
6. ``train_model`` at full width on the port's synthetic dataset (20 steps,
   evals and checkpoints every 10), then ``load_model``, an eval pass
   (checked to launch the frontend, the inference scan and alpha, and not
   beta) and a greedy decode.
7. Attention kernels: the forward, the backward (dqkv) and the dropout masks
   against their plain versions at B=64, T'=313, H=8, dh=128 in float32 and
   bfloat16, at dropout rates 0 and 0.3 (masks bit-equal), and once each
   with a band (``left_context=128``), interleaved qkv columns, T'=1250 and
   a row of length 0, forward reruns bit-equal; times of kernel, plain
   version and ``F.scaled_dot_product_attention`` (forward and backward) as
   the library yardstick, in both dtypes. The bfloat16 forward and backward
   run on the tensor cores (every bf16 forward launch counted on the ``tc``
   body), and their rows in the kernels line report bfloat16.
8. Conformer train step at ``CONFORMER_ARGS`` (8 blocks, D=1024, bfloat16,
   label smoothing, InterCTC, AdamW; B=64, T=1280, U=64): 2 warm-up and 10
   timed steps, median and seq/s, 8 attention forward (on the ``tc`` body)
   and backward, 2 CTC alpha and beta launches per step; one float32 step (dropout, DropPath,
   SpecAugment and noise on: both paths draw the same bits) whose every
   gradient leaf is checked against the plain path; two bf16 runs of two
   steps from one seed, bit-equal.
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
    wgmma), every float32 one on the tile body; the bf16 sm90 reruns
    bit-equal; the sha256 of the bf16 sm90 backwards' outputs on
    numpy-seeded inputs pinned; the bf16 tile body (``body="tile"``) at
    rate 0.3, centred and causal conv, forward and backward, against the
    plain versions at the same tolerance; the tile body timed beside the
    sm90 one, the device time of one call of each by kernel and by stage
    (``training/profile.py::device_split``), and, as context, the products
    of each forward and backward as ``torch.mm(out_dtype=float32)`` at their
    shapes. The forwards' and backwards' rows in the kernels line report
    bfloat16.
11. The bf16 Conformer train step with both fused flags: 2 warm-up and 10
    timed steps, median and seq/s beside phase 8's default step, 16 FF and 8
    conv forward and backward launches per step (every one on the sm90
    body); one float32 step (randomness on) checked leaf by leaf against the
    plain path (its forwards and backwards on the tile body); two bf16 runs
    of 2 steps from one seed bit-equal; one eval forward launching 16 FF and
    8 conv forwards on the sm90 body and no backward.
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
    and 5 timed steps each, the flagged one's 12 projections a step on the
    f32 body), with their medians and ratio.
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
The default GRU and Conformer phases check that the fused kernels and the
GRU's opt-in kernels launch no time there. Every GRU phase checks the scan
launches by body: all bfloat16 scans at full width on the persistent body,
all float32 ones on the step body; every phase that counts launches checks
the frontend's (``tc`` for bfloat16, ``fma`` for float32) and every CTC
recursion's (the prefetch body). Each phase prints its seconds.

Run from the repository root:  python3 chip_smoke.py
It imports no jax. It exits non-zero without a result when there is no
CUDA device or any check fails; otherwise its last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from neural_speech_decoder_tpu_torch.data.batching import choose_envelope
from neural_speech_decoder_tpu_torch.data.batching import eval_batches, sample_batch
from neural_speech_decoder_tpu_torch.data.dataset import pack_days
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
from neural_speech_decoder_tpu_torch.ops.ctc import ctc_loss
from neural_speech_decoder_tpu_torch.ops.decode import greedy_decode
from neural_speech_decoder_tpu_torch.ops.kernels import _build
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
from neural_speech_decoder_tpu_torch.ops.kernels.ffn import (
    ffn,
    ffn_bwd,
    ffn_bwd_plain,
    ffn_dropout_masks,
    ffn_dropout_masks_plain,
    ffn_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    bwd_recurrence_plain,
    gru_sequence,
    gru_sequence_bwd,
    gru_sequence_bwd_plain,
    gru_sequence_gates,
    gru_sequence_gates_plain,
    gru_sequence_plain,
    dw_contraction,
    hh_grads_plain,
    scan_backward,
    scan_forward,
)
from neural_speech_decoder_tpu_torch.ops.kernels.matmul import (
    tiled_matmul,
    tiled_matmul_plain,
)
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
from neural_speech_decoder_tpu_torch.training.optim import FusedAdam, make_optimizer
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
    # float32 (PR 1's FMA body): x read and the output written once, every
    # day's matrix and bias read once; the product and the 20-tap smoothing
    f32_bound = bound_ms(nbytes(x, x, day_w, day_b, day),
                         2 * B * T * C * C + 2 * fe["kernel_size"] * B * T * C, "float32")
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
    front.update(ms=k, plain_ms=p, fma_ms=fma_ms, f32_ms=front["ms"],
                 f32_plain_ms=front["plain_ms"], f32_bound_ms=f32_bound[0],
                 max_abs_err=err_tc, dtype="bfloat16")
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
                max_abs_err=(y1.float() - y_ref.float()).abs().max().item())
    # xp, W_hh, b_hh read once, ys written once; h @ W_hh every step
    scan["bound_ms"], scan["bound_by"] = bound_ms(
        nbytes(xb, w_hh.to(torch.bfloat16), b_hh) + xb.numel() // 3 * 2, scan_flops(),
        "bfloat16")
    front["library_ms"] = None
    # no single PyTorch call computes the scan on these inputs: cuDNN's GRU
    # takes the layer input, not the projections xp (its time is context)
    scan["library_ms"] = None
    scan["dtype"] = "bfloat16"
    return [front, scan]


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
# the serving frontend ("tc" for bfloat16, "fma" for float32) and the CTC
# recursions ("prefetch" for S <= 256, "block" beyond), counted by body
BY_BODY = ("frontend", "ctc_alpha", "ctc_beta")
CTC_BODY = "prefetch"  # ctc_plan(2 * U + 1)


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for counts in (tiled_matmul.launches_by_body, mhsa_qkv.launches_by_body,
                   *(WRAPPERS[k].launches_by_body for k in SCANS + FUSED_BODIES + BY_BODY)):
        for body in counts:
            counts[body] = 0


def read_launches(names=KERNELS) -> dict:
    return {k: WRAPPERS[k].launches for k in names}


def check_scan_bodies(tag: str, body: str) -> None:
    """Every GRU scan launch since the last reset ran on ``body``
    (``"persistent"`` for bfloat16 at full width, ``"step"`` for float32),
    and there was one."""
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in SCANS}
    ok = (all(n == 0 for c in bodies.values() for b, n in c.items() if b != body)
          and any(c[body] for c in bodies.values()))
    check(ok, f"{tag}: GRU scan launches by body {bodies}, all on the {body} body")


def check_front_ctc_bodies(tag: str, tc: int = 0, fma: int = 0, alpha: int = 0,
                           beta: int = 0) -> None:
    """The frontend and CTC launches since the last reset, by body: ``tc``
    bfloat16 and ``fma`` float32 frontends, and every CTC recursion on the
    prefetch body."""
    bodies = {k: dict(WRAPPERS[k].launches_by_body) for k in BY_BODY}
    want = {"frontend": {"tc": tc, "fma": fma},
            "ctc_alpha": {CTC_BODY: alpha, "block": 0},
            "ctc_beta": {CTC_BODY: beta, "block": 0}}
    check(bodies == want, f"{tag}: frontend and CTC launches by body {bodies} == {want}")


def cudnn_gru_ms(backward: bool) -> float:
    """cuDNN's bidirectional bf16 GRU layer (``torch.nn.GRU``, input 2H ->
    H, L steps, B rows): the input projection and the recurrence, with
    ``backward`` also their gradients. A superset of a scan's work, timed
    as context for the scan rows, never called by the port."""
    g = torch.Generator(device="cuda").manual_seed(5)
    gru = torch.nn.GRU(2 * H, H, bidirectional=True).cuda().to(torch.bfloat16)
    x = torch.randn((L, B, 2 * H), generator=g, device="cuda").to(torch.bfloat16)
    if not backward:
        with torch.inference_mode():
            return time_ms(lambda: gru(x), 5)
    x.requires_grad_()
    gy = torch.randn((L, B, 2 * H), generator=g, device="cuda").to(torch.bfloat16)

    def fwd_bwd():
        y, _ = gru(x)
        y.backward(gy)

    return time_ms(fwd_bwd, 5)


REQUEST_SIZES = (B, 41, B)  # the second request leaves 23 padded rows


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
    check_scan_bodies("float32 serving", "step")
    check_front_ctc_bodies("float32 serving", fma=3)
    want = {k: 0 for k in KERNELS} | {"frontend": 3, "gru_scan": 15}
    check(launches == want,
          f"launches over 3 requests {launches} == 1 frontend and "
          f"{cfg.num_layers} scans per request, no other kernel")
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
        if name == "bfloat16":
            # PR 1-2's step bodies, kept for the shapes the persistent body
            # cannot hold, against the plain versions as before
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
        tol_y = TRAIN_TOL[("gru_scan_gates", name)]
        tol_g = TRAIN_TOL[("gru_scan_gates.gates", name)]
        check(err_y <= tol_y and err_g <= tol_g,
              f"gru_scan_gates {name}: max abs err ys {err_y:.3e} <= {tol_y:.3g}, "
              f"gates {err_g:.3e} <= {tol_g:.3g}")
        errs = {k: rel_err(a, b) for k, a, b in (
            ("dxp", dxp, dxp_p), ("dW_hh", dw, dw_p), ("db_hh", db, db_p))}
        tol = TRAIN_TOL[("gru_scan_bwd", name)]
        check(max(errs.values()) <= tol,
              f"gru_scan_bwd {name}: max abs err / max |ref| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" <= {tol:.3g}")
        if name == "bfloat16":
            rows["gru_scan_gates"]["max_abs_err"] = max(err_y, err_g)
            rows["gru_scan_bwd"]["max_abs_err"] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in ((dxp, dxp_p), (dw, dw_p), (db, db_p)))
            with torch.inference_mode():
                ys2, gates2 = gru_sequence_gates(x, w_hh, b_hh)
                again = gru_sequence_bwd(gates_p, w_hh, ys_p, dy)
            torch.cuda.synchronize()
            check(torch.equal(ys, ys2) and torch.equal(gates, gates2)
                  and all(torch.equal(a, b) for a, b in zip((dxp, dw, db), again)),
                  "gru_scan_gates and gru_scan_bwd bfloat16: reruns bit-equal")
    for name in ("float32", "bfloat16"):
        x, dy, gates_p, ys_p = inputs[name]
        with torch.inference_mode():
            fg = time_turns(lambda: gru_sequence_gates(x, w_hh, b_hh),
                            lambda: gru_sequence_gates_plain(x, w_hh, b_hh), 3, 2)
            fb = time_turns(lambda: gru_sequence_bwd(gates_p, w_hh, ys_p, dy),
                            lambda: gru_sequence_bwd_plain(gates_p, w_hh, ys_p, dy),
                            3, 2)
        for key, (k, p, turns) in (("gru_scan_gates", fg), ("gru_scan_bwd", fb)):
            print(f"time  {key} {name}: kernel {turns[0]:.4f}/{turns[1]:.4f} ms, "
                  f"plain {turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
            if name == "bfloat16":
                rows[key].update(ms=k, plain_ms=p)
    # bfloat16: the step bodies at the same shapes, the contraction
    # alone against its plain version, and cuDNN's layer forward + backward
    x, dy, gates_p, ys_p = inputs["bfloat16"]
    with torch.inference_mode():
        step_fwd = time_ms(lambda: scan_forward(x, w_hh, b_hh, gates=True, plan="step"), 3)
        step_bwd = time_ms(lambda: scan_backward(gates_p, w_hh, ys_p, dy, plan="step"), 3)
        dxp_r, dhp_n_r = bwd_recurrence_plain(gates_p, w_hh, ys_p, dy)
        dw_c = dw_contraction(ys_p, dxp_r, dhp_n_r)
        dw_c2 = dw_contraction(ys_p, dxp_r, dhp_n_r)
        dw_cp = hh_grads_plain(ys_p, dxp_r, dhp_n_r)[0]
    torch.cuda.synchronize()
    # exact products of bf16 values summed in float32 in another order
    tol = TRAIN_TOL[("gru_scan_bwd", "float32")]
    err = rel_err(dw_c, dw_cp)
    check(err <= tol and torch.equal(dw_c, dw_c2),
          f"gru_scan_bwd bfloat16 dW_hh contraction alone (tensor cores): {err:.3e} <= "
          f"{tol:.3g} of max |ref|; reruns bit-equal")
    with torch.inference_mode():
        kc, pc, turns = time_turns(lambda: dw_contraction(ys_p, dxp_r, dhp_n_r),
                                   lambda: hh_grads_plain(ys_p, dxp_r, dhp_n_r), 10, 3)
    contraction_flops = 2 * D * L * B * H * 3 * H
    print(f"time  gru_scan_bwd bfloat16 contraction: tensor cores {turns[0]:.4f}/"
          f"{turns[1]:.4f} ms ({contraction_flops / kc / 1e9:.1f} TFLOP/s), plain "
          f"{turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
    del dxp_r, dhp_n_r
    cudnn_ms = cudnn_gru_ms(backward=True)
    print(f"time  bfloat16 step bodies (a launch a step): gates forward {step_fwd:.4f} ms, backward "
          f"{step_bwd:.4f} ms; cuDNN's bidirectional layer forward + backward "
          f"(torch.nn.GRU, 2H -> H, projection included) {cudnn_ms:.4f} ms", flush=True)
    rows["gru_scan_gates"]["step_ms"] = step_fwd
    rows["gru_scan_bwd"].update(step_ms=step_bwd, contraction_ms=kc,
                                cudnn_layer_fwd_bwd_ms=cudnn_ms)
    w16 = w_hh.to(torch.bfloat16)
    rows["gru_scan_gates"]["bound_ms"], rows["gru_scan_gates"]["bound_by"] = bound_ms(
        nbytes(x, w16, b_hh, ys_p, gates_p), scan_flops(), "bfloat16")
    # gates, W_hh, ys, dys read once, dxp, dW_hh, db_hh written once; the
    # step products dhp @ W^T and the dW_hh contraction, each as many
    # flops as the forward's products
    rows["gru_scan_bwd"]["bound_ms"], rows["gru_scan_bwd"]["bound_by"] = bound_ms(
        nbytes(gates_p, w16, ys_p, dy, x) + 4 * (D * H * 3 * H + D * 3 * H),
        2 * scan_flops(), "bfloat16")

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
            check_scan_bodies("float32 train step", "step")
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
# dh=128 (D=1024).
A_HEADS, A_DH = 8, 128
# Kernel vs plain, max abs error relative to the output's largest entry.
# Float32: the same float32 sums in another order (T-long softmax sums and
# 128- or T-long products). Bfloat16: p and dS are rounded to bf16 before
# their products, and the outputs too; a rounding that falls the other way
# moves an entry by one bf16 step (2**-8 relative), and up to four such
# steps of the largest entry are allowed.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
# The forward's body each dtype takes (mhsa_qkv.launches_by_body): the
# tensor cores in bf16, FMAs in float32.
ATTN_FWD_BODY = {"float32": "fma", "bfloat16": "tc"}
# One float32 Conformer train step, kernel path vs plain path, every
# gradient leaf relative to its largest entry: 8 blocks of attention whose
# sums run in other orders, the CTC recursions, and 128M parameters' worth
# of products shared by both paths.
CONFORMER_GRAD_TOL = 5e-4
CONFORMER_LAYERS = 8


def attention_inputs(g, b, t, dtype, lens=None):
    d = A_HEADS * A_DH
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


def attention_check(tag, qkv, gout, lens, seed, **kw) -> tuple[float, float]:
    """Forward and dqkv, kernel vs plain; returns their abs errors."""
    kw = dict(num_heads=A_HEADS, **kw)
    name = "float32" if qkv.dtype == torch.float32 else "bfloat16"
    body = ATTN_FWD_BODY[name]
    before = mhsa_qkv.launches_by_body[body]
    with torch.inference_mode():
        out, ref = mhsa_qkv(qkv, lens, seed, **kw), mhsa_qkv_plain(qkv, lens, seed, **kw)
        again = mhsa_qkv(qkv, lens, seed, **kw)
        dq, dref = (mhsa_qkv_bwd(qkv, lens, seed, gout, **kw),
                    mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw))
    torch.cuda.synchronize()
    took = mhsa_qkv.launches_by_body[body] - before
    e_f, e_b = rel_err(out, ref), rel_err(dq, dref)
    dead = lens <= 0
    zero_rows = not bool(out[dead].any()) if bool(dead.any()) else True
    same = torch.equal(out, again)
    tol = ATTN_TOL[name]
    check(e_f <= tol and e_b <= tol and zero_rows and same and took == 2,
          f"attention {tag} {name}: max abs err / max |ref| forward {e_f:.3e}, "
          f"dqkv {e_b:.3e} <= {tol:.3g}; rows of length 0 are zero {zero_rows}; "
          f"forward rerun bit-equal {same}; {took} of 2 forward launches on the "
          f"{body} body")
    return ((out.float() - ref.float()).abs().max().item(),
            (dq.float() - dref.float()).abs().max().item())


def attention_flops(lens, t, n_products) -> float:
    """Each of ``n_products`` [T x keys x dh] products per (batch, head),
    over the keys each row's length lets in."""
    keys = lens.clamp(0, t).sum().item()
    return n_products * 2.0 * A_DH * A_HEADS * t * keys


# The dtype each attention row of the kernels line reports: the forward's and
# the backward's bf16 bodies (tensor cores) are the ones the recipe runs; the
# mask hook reports float32.
ROW_DTYPE = {"mhsa_qkv": "bfloat16", "mhsa_qkv_bwd": "bfloat16", "dropout_masks": "float32"}


def attention_kernel_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    t = L
    rows = {"mhsa_qkv": {}, "mhsa_qkv_bwd": {}, "dropout_masks": {}}
    inputs = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qkv, gout, lens, seed = attention_inputs(g, B, t, dt)
        inputs[name] = (qkv, gout, lens, seed)
        for rate in (0.0, 0.3):
            errs = attention_check(f"B={B} T'={t} rate {rate}", qkv, gout, lens,
                                   seed, rate=rate)
            if rate > 0 and name == ROW_DTYPE["mhsa_qkv"]:
                rows["mhsa_qkv"]["max_abs_err"] = errs[0]
            if rate > 0 and name == ROW_DTYPE["mhsa_qkv_bwd"]:
                rows["mhsa_qkv_bwd"]["max_abs_err"] = errs[1]
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
        zq, zg, zl, zs = attention_inputs(g, 4, t, dt, lens=[t, 0, 17, 0])
        attention_check("with rows of length 0", zq, zg, zl, zs, rate=0.3)
        lq, lg, ll, ls = attention_inputs(g, 4, 1250, dt, lens=[1250, 1000, 700, 1249])
        attention_check("T'=1250", lq, lg, ll, ls, rate=0.3)
        attention_check("T'=1250 band", lq, lg, ll, ls, rate=0.3, left_context=128)
        del zq, zg, lq, lg

    for name in ("float32", "bfloat16"):
        qkv, gout, lens, seed = inputs[name]
        kw = dict(num_heads=A_HEADS, rate=0.3)
        with torch.inference_mode():
            ff = time_turns(lambda: mhsa_qkv(qkv, lens, seed, **kw),
                            lambda: mhsa_qkv_plain(qkv, lens, seed, **kw), 10, 3)
            fb = time_turns(lambda: mhsa_qkv_bwd(qkv, lens, seed, gout, **kw),
                            lambda: mhsa_qkv_bwd_plain(qkv, lens, seed, gout, **kw),
                            10, 3)
            fm = time_turns(lambda: dropout_masks(B * A_HEADS, t, seed, 0.3),
                            lambda: dropout_masks_plain(B * A_HEADS, t, seed, 0.3),
                            10, 3)
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
        for key, (kt, pt, turns), lib in (("mhsa_qkv", ff, lib_f),
                                          ("mhsa_qkv_bwd", fb, lib_b),
                                          ("dropout_masks", fm, None)):
            print(f"time  {key} {name} B={B} T'={t} rate 0.3: kernel "
                  f"{turns[0]:.4f}/{turns[1]:.4f} ms, plain {turns[2]:.4f}/"
                  f"{turns[3]:.4f} ms" + (f", F.scaled_dot_product_attention "
                  f"{'forward' if key == 'mhsa_qkv' else 'backward'} {lib:.4f} ms "
                  f"(kernel / SDPA {kt / lib:.2f})" if lib is not None else ""), flush=True)
            if name == ROW_DTYPE[key]:
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
        if name == ROW_DTYPE["mhsa_qkv"]:
            rows["mhsa_qkv"]["bound_ms"], rows["mhsa_qkv"]["bound_by"] = fwd_b
        if name == ROW_DTYPE["dropout_masks"]:
            # one bool written per entry; the hash's integer work is not
            # counted (the table of peaks has no integer rate)
            rows["dropout_masks"]["bound_ms"], rows["dropout_masks"]["bound_by"] = (
                bound_ms(B * A_HEADS * t * t + 4, 0, name))
        if name == ROW_DTYPE["mhsa_qkv_bwd"]:
            rows["mhsa_qkv_bwd"]["bound_ms"], rows["mhsa_qkv_bwd"]["bound_by"] = bwd_b
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
    fwd_bodies = dict(mhsa_qkv.launches_by_body)
    check_front_ctc_bodies(f"{n} bf16 Conformer train steps (InterCTC)", alpha=2 * n,
                           beta=2 * n)
    check(launches == want and fwd_bodies == {"tc": CONFORMER_LAYERS * n, "fma": 0},
          f"launches over {n} bf16 Conformer train steps {launches} == per step 8 "
          f"attention forward (by body {fwd_bodies}: all on the tensor cores), 8 "
          f"backward, 2 alpha, 2 beta (main and InterCTC heads), no fused FF or conv "
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
    return {k: launches[k] for k in ("mhsa_qkv", "mhsa_qkv_bwd", "dropout_masks")}, med


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
# the mask hook keeps its float32 row.
FUSED_ROW_DTYPE = {"ffn": "bfloat16", "ffn_bwd": "bfloat16", "ffn_dropout_masks": "float32",
                   "conv_module": "bfloat16", "conv_module_bwd": "bfloat16"}
# The body each dtype's forwards and backwards take at these shapes
# (ops/kernels/ffn.py::bwd_plan).
FUSED_BODY = {"float32": "tile", "bfloat16": "sm90"}
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


def fused_bwd_digests() -> dict:
    """The sha256 of each bf16 sm90 backward's outputs at rate 0.3 (the
    conv centred and causal) on numpy-seeded inputs at the recipe's
    shapes."""
    rng = np.random.default_rng(10)
    d, f, bf = A_HEADS * A_DH, F_FF, torch.bfloat16

    def r(*s, sc=1.0, dt=torch.float32):
        return (sc * torch.from_numpy(rng.standard_normal(s, dtype=np.float32))).cuda().to(dt)

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    x, gout = r(B, L, d, dt=bf), r(B, L, d, dt=bf)
    ff = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, f, sc=d**-0.5, dt=bf), r(f, sc=0.1),
          r(f, d, sc=f**-0.5, dt=bf))
    conv = (1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, 2 * d, sc=d**-0.5, dt=bf),
            r(2 * d, sc=0.1), r(KW, d, sc=KW**-0.5), r(d, sc=0.1), 1.0 + r(d, sc=0.1),
            r(d, sc=0.1), r(d, d, sc=d**-0.5, dt=bf))
    seed = torch.tensor([20251017], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        out = {"ffn_bwd": digest(ffn_bwd(x, *ff, seed, gout, rate=0.3, body="sm90"))}
        for causal in (False, True):
            out["conv_module_bwd" + (" causal" if causal else "")] = digest(conv_module_bwd(
                x, *conv, seed, gout, rate=0.3, causal=causal, body="sm90"))
    return out


def fused_products(ff, conv) -> dict:
    """The products of each forward (two) and backward (five) at its shapes
    (bf16 operands, M = B*T' rows), each as one ``torch.mm(out_dtype=
    float32)`` call: context for the kernels' times, never called by the
    port."""
    m, d, f = B * L, A_HEADS * A_DH, F_FF
    g = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    mm = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)  # noqa: E731
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


def fused_tile_check(key, tag, call, plain, names) -> None:
    """One bf16 call of a forward or backward forced onto the tile body
    (``body="tile"``, the body ``bwd_plan`` still picks where TMA cannot
    read a shape) against its plain version at ``FUSED_TOL["bfloat16"]``
    (``call`` and ``plain`` return tuples of outputs); its one launch
    counted on the tile body."""
    before = dict(WRAPPERS[key].launches_by_body)
    with torch.inference_mode():
        grads, refs = call(body="tile"), plain()
    torch.cuda.synchronize()
    took = {b: n - before[b] for b, n in WRAPPERS[key].launches_by_body.items()}
    tol = FUSED_TOL["bfloat16"]
    errs = {k: rel_err(a, b) for k, a, b in zip(names, grads, refs)}
    dtypes = all(a.dtype == b.dtype for a, b in zip(grads, refs))
    check(max(errs.values()) <= tol and dtypes and took["tile"] == 1
          and sum(took.values()) == 1,
          f"{key} bfloat16 {tag} on the tile body: max abs err / max |ref| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" <= {tol:.3g}; dtypes equal "
          f"{dtypes}; launches by body {took}")


def fused_bodies(x, gout, ff, conv, seed) -> None:
    """The bf16 forwards and backwards at rate 0.3: the tile body against the
    plain version (centred and causal conv), reruns bit-equal, the
    backwards' sha256 pins, one call of each body by kernel and by stage,
    the tile body timed beside the sm90 one, and the products of each as
    ``torch.mm`` as context."""
    kw = dict(rate=0.3)
    tag = f"B={B} T'={L} rate 0.3"
    fused_tile_check("ffn", tag, lambda **b: (ffn(x, *ff, seed, **kw, **b),),
                     lambda: (ffn_plain(x, *ff, seed, **kw),), ("out",))
    fused_tile_check("ffn_bwd", tag, lambda **b: ffn_bwd(x, *ff[:5], seed, gout, **kw, **b),
                     lambda: ffn_bwd_plain(x, *ff[:5], seed, gout, **kw), FF_NAMES)
    for causal in (False, True):
        ck = dict(rate=0.3, causal=causal)
        ctag = tag + (" causal" if causal else "")
        fused_tile_check("conv_module", ctag,
                         lambda **b: (conv_module(x, *conv, seed, **ck, **b),),
                         lambda: (conv_module_plain(x, *conv, seed, **ck),), ("out",))
        fused_tile_check(
            "conv_module_bwd", ctag,
            lambda **b: conv_module_bwd(x, *conv[:9], seed, gout, **ck, **b),
            lambda: conv_module_bwd_plain(x, *conv[:9], seed, gout, **ck), CONV_NAMES)
    digests = fused_bwd_digests()
    check(digests == FUSED_BWD_SHA256, f"sha256 of the bf16 sm90 backwards' outputs "
          f"{digests} == the pinned {FUSED_BWD_SHA256}")
    calls = {"ffn": lambda **b: (ffn(x, *ff, seed, **kw, **b),),
             "conv_module": lambda **b: (conv_module(x, *conv, seed, **kw, **b),),
             "ffn_bwd": lambda **b: ffn_bwd(x, *ff[:5], seed, gout, **kw, **b),
             "conv_module_bwd": lambda **b: conv_module_bwd(x, *conv[:9], seed, gout,
                                                            **kw, **b)}
    products = fused_products(ff, conv)
    with torch.inference_mode():
        for key, call in calls.items():
            one, two = call(), call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            check(same, f"{key} bfloat16 {tag} on the sm90 body: reruns bit-equal {same}")
            del one, two
            for body in ("sm90", "tile"):
                split = device_split(lambda: call(body=body))
                for name, n, ms in split:
                    print(f"  split {key} {body}: {ms:9.4f} ms {n:3d}x  {name[:100]}")
                stages = by_stage(split)
                print(f"split {key} bfloat16 {body} body, one call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in stages.items())
                    + f"; device total {sum(stages.values()):.4f} ms", flush=True)
            t1 = time_ms(lambda: call(body="tile"), 3)
            s1 = time_ms(call, 5)
            s2 = time_ms(call, 5)
            t2 = time_ms(lambda: call(body="tile"), 3)
            mm_ms = {k: time_ms(fn, 5) for k, fn in products[key].items()}
            print(f"time  {key} bfloat16 {tag}: sm90 body {s1:.4f}/{s2:.4f} "
                  f"ms, tile body {t1:.4f}/{t2:.4f} ms (turns tile, sm90, sm90, tile); "
                  f"context, its products as torch.mm(out_dtype=float32): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in mm_ms.items())
                  + f" = {sum(mm_ms.values()):.4f} ms", flush=True)


def fused_kernel_phase() -> dict:
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {k: {} for k in NO_FUSED}
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
                    if FUSED_ROW_DTYPE[key] == name:
                        rows[key]["max_abs_err"] = err
            if name == "float32":
                m1, m2 = ffn_dropout_masks(B, L, d, f, seed, rate)
                r1, r2 = ffn_dropout_masks_plain(B, L, d, f, seed, rate)
                same = torch.equal(m1, r1) and torch.equal(m2, r2)
                check(same, f"ffn_dropout_masks {B}x{L}x({f}, {d}) rate {rate}: "
                      f"bit-equal to the plain version {same}")
                rows["ffn_dropout_masks"]["max_abs_err"] = 0.0 if same else 1.0
        body = FUSED_BODY[name]
        ran = {k: {b: n - by_body[k][b] for b, n in WRAPPERS[k].launches_by_body.items()}
               for k in FUSED_BODIES}
        check(all(c[body] > 0 and sum(c.values()) == c[body] for c in ran.values()),
              f"{name} fused forwards' and backwards' launches by body {ran}: all on the "
              f"{body} body")
        if name == "bfloat16":
            fused_bodies(x, gout, ff, conv, seed)

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
            print(f"time  {key} {name} B={B} T'={L} rate 0.3: kernel {turns[0]:.4f}/"
                  f"{turns[1]:.4f} ms, plain {turns[2]:.4f}/{turns[3]:.4f} ms", flush=True)
            if FUSED_ROW_DTYPE[key] == name:
                rows[key].update(ms=kt, plain_ms=pt, library_ms=None)
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
            if FUSED_ROW_DTYPE[key] == name:
                rows[key]["bound_ms"], rows[key]["bound_by"] = bt, by
        del x, gout, ff, conv
    for key, row in rows.items():
        row["dtype"] = FUSED_ROW_DTYPE[key]
    return rows


FUSED_ARGS = {**CONFORMER_ARGS, **FUSED_FLAGS["conformer"]}


def fused_conformer_phase(card: str, default_median: float) -> dict:
    """The bf16 Conformer train step with the fused FF and conv modules,
    beside the default step's median (``default_median``, phase 8); one
    float32 step against the plain path; two seeded runs bit-equal; one
    eval forward."""
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
    want_bodies = {k: {"sm90": per_step[k] * n, "tile": 0} for k in FUSED_BODIES}
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
          and ev_bodies == {k: {"sm90": want_ev[k], "tile": 0} for k in FUSED_FWDS},
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
    check(launch_k == per_step and not any(launch_p.values())
          and all(c["sm90"] == 0 and c["tile"] > 0 for c in bodies32.values()),
          f"float32 fused Conformer step launches: kernel path {launch_k} (forwards and "
          f"backwards by body {bodies32}: all on the tile body), plain path {launch_p}")
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
    return {k: launches[k] for k in NO_FUSED}


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
            check_scan_bodies("float32 flagged GRU step", "step")
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


def gru_float32_steps_phase(card: str) -> None:
    """The float32 GRU train step at full width (``BENCH_ARGS`` in float32,
    the JAX trainer's default dtype), default and with both flags, timed one
    after the other: the flagged step's 12 projections on the f32 body."""
    batch = batch_tensors(bench_batch(B, T, U), torch.device("cuda"))
    n = 5
    medians = {}
    for tag, args in (("default", BENCH_ARGS), ("flagged", GRU_FUSED_ARGS)):
        model, losses, times, launches = train_steps(
            {**args, "compute_dtype": "float32"}, 0, batch, 2, n)
        del model
        check_scan_bodies(f"{n} {tag} float32 GRU train steps", "step")
        by_body = dict(tiled_matmul.launches_by_body)
        mm = 12 * n if tag == "flagged" else 0
        check(launches["tiled_matmul"] == mm and by_body == {"sm90": 0, "f32": mm, "tile": 0}
              and all(math.isfinite(v) for v in losses),
              f"{n} {tag} float32 GRU train steps: projection matmul launches by body "
              f"{by_body}; losses finite {', '.join(f'{v:.4f}' for v in losses)}")
        medians[tag] = statistics.median(times)
        print(f"train step float32 {tag} B={B} T={T} U={U}: steps "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms, median "
              f"{medians[tag] * 1e3:.2f} ms, {B / medians[tag]:.2f} seq/s ({card})", flush=True)
    print(f"train step float32: flagged / default {medians['flagged'] / medians['default']:.3f}",
          flush=True)


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
        check_scan_bodies("float32 unidirectional offline forward", "step")
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
                   "frontend": {"tc": want["frontend"], "fma": 0},
                   "gru_scan": {"persistent": want["gru_scan"], "step": 0},
                   "ffn": {"sm90": want["ffn"], "tile": 0},
                   "conv_module": {"sm90": want["conv_module"], "tile": 0},
                   "mhsa_qkv": {"tc": want["mhsa_qkv"], "fma": 0}}
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
    prons = {f"p_{p.lower()}": (p,) for p in PHONE_DEF}
    prons |= {f"p_{p.lower()}_{q.lower()}": (p, q) for p in PHONE_DEF for q in PHONE_DEF}
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


def time_scorer(tag: str, params, spec, sentences, card: str) -> np.ndarray:
    score = llm_engine.params_scorer(params, spec, id_tokenizer, batch_size=LLM_BATCH)
    score(sentences[:LLM_BATCH])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = np.asarray(score(sentences))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
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
    rows = dict(zip(("frontend", "gru_scan"), kernel_phase()))
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
    conformer_train_model_phase(card)
    print(f"phase conformer train_model: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows.update(fused_kernel_phase())
    print(f"phase fused FF and conv kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(fused_conformer_phase(card, conformer_median))
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
    for k, n in export_phase(card).items():
        launches[k] += n
    print(f"phase export: {time.perf_counter() - t0:.1f} s", flush=True)
    # every kernel of the main paths ran there (the mask hooks excepted: the
    # attention and FF kernels draw their masks themselves)
    idle = [k for k in KERNELS if k not in HOOKS and not launches[k]]
    check(not idle, f"every kernel of the main paths launched there; idle: {idle}")
    out = []
    for name in KERNELS:
        source, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
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
