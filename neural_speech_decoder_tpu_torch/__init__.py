"""neural_speech_decoder_tpu_torch — the PyTorch/CUDA port of
``neural_speech_decoder_tpu`` for one NVIDIA H100.

It imports torch and never jax; the JAX package is the reference each part
is tested against. Its layout mirrors the JAX package's:

  ops/           smoothing, day affine, unfold, noise, CTC loss, greedy
                 decode
  ops/kernels/   the hand-written CUDA kernels' wrappers, each beside its
                 plain PyTorch version, their autograd Functions, their
                 build (``_build.py``) and the serving ones as operators
                 (``library.py``)
  csrc/          the CUDA C++ sources (sm_90a) and the host C++ beam
                 decoder (``ctc_beam.cpp``)
  models/        the GRU decoder (``gru.py``), the Conformer
                 (``conformer.py``), their model interface (``api.py``),
                 weight conversion from/to JAX (``convert.py``) and the
                 reference's state-dict layout (``torch_export.py``,
                 ``torch_import.py``)
  data/          the port's copies of the numpy-only data modules and the
                 offline formatter (``formatter.py``: ``nsd-format-torch``)
  parallel/      data-parallel training, a process per device over
                 torch.distributed (``mesh.py``, ``multihost.py``,
                 ``data_parallel.py``), and hyperparameter sweeps over
                 worker processes (``sweep.py``)
  training/      optimizer, trainer, checkpoints, train-step profile, the
                 CLI (``nsd-train-torch``, ``-m`` sweeps)
  utils/         metric logging, greedy collapse, the device check
  streaming/     the GRU and causal-Conformer streamers
  decoding/      the on-device prefix beam; the competition stack: the
                 lexicon + n-gram beam (Python oracle and native engine),
                 LLM rescoring (``torch_lm.py``, ``llm_engine.py``,
                 ``bigram_opt.py``) and ``eval_competition.py``
                 (``nsd-eval-competition-torch``)
  serving/       batch inference of either family (``model.py``), the
                 exported artifacts (``export.py``, ``streaming.py``,
                 ``cli.py``: ``nsd-export-torch``)
"""

__version__ = "0.1.0"
