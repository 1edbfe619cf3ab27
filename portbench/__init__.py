"""The benchmark of ``neural_speech_decoder_tpu_torch`` (the PyTorch/CUDA
port) on NVIDIA H100s.

Run one cell from the repository's root:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/README.md`` for the layout: configurations, traffic mixes,
cells and per-layer metrics are files of their own, found by the names in
the root ``BENCHMARK.json``.
"""
