"""Small sizes of the benchmark's cells for CPU tests: the same files and
code paths, the widths and lengths cut so that a run takes seconds (the
port's kernel wrappers run their plain versions on a CPU tensor)."""

import time

from portbench import harness

MIX = {"batch": 4, "t_min": 40, "t_max": 80, "t_envelope": 96, "u_min": 3, "u_max": 8,
       "u_envelope": 8, "pool": 4}
GRU = {"config": {"args": {"nInputFeatures": 16, "nUnits": 32, "nLayers": 2, "kernelLen": 8}},
       "mix": MIX}
CONFORMER = {"config": {"args": {
    "nInputFeatures": 16, "frontend_dim": 32, "latent_dim": 32, "autoencoder_hidden_dim": 16,
    "transformer_num_layers": 6, "transformer_n_heads": 2, "transformer_dim_ff": 64,
    "temporal_kernel": 8, "spec_augment_freq_mask": 8, "spec_augment_time_mask": 4}},
    "mix": MIX}


def overrides(cell: str, extra: dict | None = None) -> dict:
    base = GRU if cell.startswith("gru") else CONFORMER
    return harness.merged(base, extra)


def run(cell: str, seed: int = 2**33 + 5, seconds: float = 0.5, trace: bool = False,
        extra: dict | None = None, bench: dict | None = None) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, started=time.perf_counter(),
                            device="cpu", overrides=overrides(cell, extra), bench=bench)
