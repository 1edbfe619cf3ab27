"""Loading the harness and the reference, and running a cell, leaves no
top-level module ``jax``, ``jaxlib``, ``flax`` or ``neural_speech_decoder_tpu``
in ``sys.modules`` (names compared whole: the port's name begins with the
JAX package's); the reference loads nothing of the port."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys
from portbench import harness, judge, generate, readings, run, trace, weights
from portbench.reference import common, conformer, gru, hashrng
from portbench.tests import _tiny
for name in harness.benchmark()["per_layer"]:
    harness.metric_reader(name["name"])
_tiny.run("gru_decode_f32", seconds=0.2)
print(json.dumps(run.forbidden_modules()))
"""

REF = """
import json, sys
from portbench.reference import common, conformer, gru, hashrng
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _python(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    assert _python(RUN) == []


def test_the_reference_loads_nothing_of_the_port():
    top = set(_python(REF))
    assert "neural_speech_decoder_tpu_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "neural_speech_decoder_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "neural_speech_decoder_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neural_speech_decoder_tpu.ops", sys)
    assert run.forbidden_modules() == ["neural_speech_decoder_tpu"]
