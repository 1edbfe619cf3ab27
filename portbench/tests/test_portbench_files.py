"""BENCHMARK.json against the benchmark's contract and its files, the
configurations against what the port makes of them, and a new cell added
by adding files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_and_configs_have_their_files():
    used = set()
    for w in BENCH["workloads"]:
        cell, config, mix = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert w["chips"] == cell["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = harness.load_json(harness.ROOT / c["file"])
        assert c["file"].startswith("portbench/") and data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"] and len(c["source"]) <= 200


def test_metrics_match_their_readers_and_every_cell_reports_enough():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        reports = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reports and len(reports) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in reports for m in layer)


@pytest.mark.parametrize("cell", ["gru_train_f32", "conformer_train_f32"])
def test_the_port_reads_the_configuration_as_the_reference_does(cell):
    import torch
    from neural_speech_decoder_tpu_torch.models.api import build_model, config_from_args
    from neural_speech_decoder_tpu_torch.training.optim import make_optimizer

    _, cfg, _ = harness.load_cell(cell)
    a, opt = cfg["args"], cfg["optimizer"]
    pc = config_from_args(a, cfg["n_days"])
    assert pc.compute_dtype == torch.float32 and cfg["dtype"] == "float32"
    if "reference" in cfg:
        assert pc.head_dropout == cfg["reference"]["head_dropout"]
        assert pc.use_interctc == cfg["reference"]["interctc"]
        assert pc.interctc_layer == a["transformer_num_layers"] // 2
        assert pc.fused_ffn and pc.fused_conv
    else:
        assert pc.gaussian_kernel_size == cfg["gaussian_taps"]
        assert not pc.use_pallas_matmul
    small = dict(a, nUnits=8, nInputFeatures=8, latent_dim=16, frontend_dim=16,
                 transformer_dim_ff=16, autoencoder_hidden_dim=8, transformer_n_heads=2)
    model = build_model(small, cfg["n_days"], "cpu")
    o, _ = make_optimizer(small, model.parameters())
    g = o.param_groups[0]
    assert (g["lr"] == pytest.approx(opt["lr"] if opt["schedule"] == "linear"
                                     else opt["lr"] / opt["warmup_steps"]))
    assert tuple(g["betas"]) == tuple(opt["betas"]) and g["eps"] == opt["eps"]
    assert g["weight_decay"] == opt["weight_decay"]
    assert isinstance(o, torch.optim.AdamW) == (opt["decay"] == "decoupled")


NEW_CELL = """
import json, sys, time
sys.path.insert(0, ".")
from portbench import harness
from portbench.tests import _tiny
r = harness.run_cell("gru_decode_short", 5, 0.3, True, started=time.perf_counter(),
                     device="cpu", overrides=_tiny.overrides("gru", {"mix": {"t_min": 20,
                     "t_max": 40, "t_envelope": 48}, "config": {"args": {"nUnits": 16}}}))
print(json.dumps(r))
"""


def test_a_cell_mix_config_and_metric_are_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads(json.dumps(BENCH))
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    mix = json.loads((pb / "traffic" / "decode_batch.json").read_text())
    (pb / "traffic" / "decode_short.json").write_text(json.dumps(dict(mix, t_min=100, t_max=400)))
    cfg = json.loads((pb / "configs" / "gru_baseline_f32.json").read_text())
    (pb / "configs" / "gru_small_f32.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "gru_decode_short.json").write_text(json.dumps(
        {"config": "gru_small_f32", "traffic": "decode_short", "chips": 1,
         "limits": {"lens_mismatch": 0, "decode_mismatch": 0, "logprob_gap": 1e-4,
                    "token_gap": 1e-4}}))
    (pb / "metrics" / "requests.decode.py").write_text(
        "def read(run):\n    return run.units\n")
    bench["configs"].append(dict(bench["configs"][0], name="gru_small_f32",
                                 file="portbench/configs/gru_small_f32.json"))
    bench["workloads"].append({"name": "gru_decode_short", "config": "gru_small_f32",
                               "traffic": "decode_short", "chips": 1, "why": "short trials"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "gru_decode_f32" in m["workloads"]:
            m["workloads"].append("gru_decode_short")
    bench["per_layer"].append({"name": "requests.decode", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "whole step or request",
                               "moves": "decode_trials_per_s",
                               "workloads": ["gru_decode_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "neural_speech_decoder_tpu_torch").symlink_to(
        harness.ROOT / "neural_speech_decoder_tpu_torch")
    out = subprocess.run([sys.executable, "-c", NEW_CELL], cwd=root, check=True,
                         capture_output=True, text=True, timeout=600)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["requests.decode"]["value"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gru_train_f32",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
