"""The port's sweep driver and ``nsd-train-torch -m`` against the JAX
package's, on the CPU.

``neural_speech_decoder_tpu_torch/parallel/{sweep,_optuna_shim}.py`` and
``training/cli.py``'s multirun: the parameter spaces and the shim's draws
equal JAX's for the same seed; ``slice_env`` pins a slot to its cards with
``CUDA_VISIBLE_DEVICES``; ``run_sweep`` in this process at a tiny width
(``device=cpu``, 2 steps) records done, SIGTERM-preempted and failed
trials under JAX's summary keys, ranked by best CER; the CLI runs two jobs
in a spawn pool (``--jobs 2``) under JAX's override dirnames, each job's
per-step losses bit-equal to the same overrides run alone in this process
(one torch thread on both sides), each job's last metrics record holding
its steps' wall-clock span and its kernel launches (none on the CPU);
comma-swept values without ``-m`` and a
sweep whose every job fails raise ``SystemExit``. A worker that dies inside
its trial fails that trial alone (``BrokenProcessPool``) and the sweep
reports the others; a ``<stdin>`` main is refused; trials of two gloo
ranks each (``n_data_devices: 2``) train in the workers, their losses
those of one rank within 1e-5. And the kernel build
lock: two processes that build at once with a stub compiler share one
library, compiled once.
"""

import json
import os
import pickle
import queue
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoder_tpu.parallel import _optuna_shim as jax_shim
from neural_speech_decoder_tpu.parallel import sweep as jax_sweep
from neural_speech_decoder_tpu.utils import config as jax_config
from neural_speech_decoder_tpu_torch.data.synthetic import synthetic_dataset
from neural_speech_decoder_tpu_torch.ops.kernels import launch_counts
from neural_speech_decoder_tpu_torch.parallel import _optuna_shim as shim
from neural_speech_decoder_tpu_torch.parallel import sweep
from neural_speech_decoder_tpu_torch.training import cli
from neural_speech_decoder_tpu_torch.training import trainer

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "neural_speech_decoder_tpu/configs/gru_baseline.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small CPU ops gain nothing from more, the
    suite's parallel workers would otherwise oversubscribe the cores, and
    the spawned workers (``OMP_NUM_THREADS=1``) sum as this process does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset():
    return synthetic_dataset(seed=3, n_days=2, trials_per_day=6, n_channels=8, min_t=24,
                             max_t=40, min_u=2, max_u=4)


def _base_args(**kw):
    return {"device": "cpu", "dataset": _dataset(), "batchSize": 4, "lrStart": 0.01,
            "lrEnd": 0.01, "l2_decay": 0.0, "nBatch": 2, "evalEvery": 1,
            "whiteNoiseSD": 0.1, "constantOffsetSD": 0.0, "gaussianSmoothWidth": 2.0,
            "nUnits": 8, "nLayers": 1, "nInputFeatures": 8, "nClasses": 40, "dropout": 0.0,
            "strideLen": 2, "kernelLen": 4, "bidirectional": True, "seed": 0,
            "wandb_mode": "disabled", "time_multiple": 16} | kw


def _cli_config(tmp_path) -> str:
    """A YAML config of ``_base_args`` with the dataset pickled beside it,
    so that the sweep's only overrides are the swept ones and outputDir."""
    data = tmp_path / "data.pkl"
    data.write_bytes(pickle.dumps(_dataset()))
    cfg = {k: v for k, v in _base_args(wandb_mode="offline").items() if k != "dataset"}
    cfg["datasetPath"] = str(data)
    path = tmp_path / "cfg.yaml"
    path.write_text("".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                            for k, v in cfg.items()))
    return str(path)


def _losses(run_dir: Path) -> list[float]:
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["train/loss"] for r in recs if "train/loss" in r]


def test_spaces_match_jax():
    grid = {"lrStart": [0.01, 0.005], "nUnits": [8, 16, 32], "dropout": [0.0]}
    assert sweep.grid_space(grid) == jax_sweep.grid_space(grid)
    space = {"lrStart": lambda r: float(10 ** r.uniform(-4, -1)),
             "nUnits": lambda r: int(r.choice([256, 512, 1024])),
             "dropout": lambda r: float(r.uniform(0.0, 0.5))}
    for seed in (0, 7):
        assert sweep.random_space(space, 5, seed) == jax_sweep.random_space(space, 5, seed)


def test_optuna_shim_draws_match_jax():
    """The same studies (direction, seed, objective with every suggest kind
    and pruning) give the same trials on both shims."""
    def objective(mod):
        def f(trial):
            x = trial.suggest_float("x", 1e-4, 1e-1, log=True)
            y = trial.suggest_float("y", -1.0, 1.0)
            n = trial.suggest_int("n", 2, 5)
            c = trial.suggest_categorical("c", ["a", "b", "c"])
            if c == "c":
                raise mod.TrialPruned()
            return x * n + y
        return f

    for direction, seed in (("minimize", 0), ("maximize", 3)):
        ours = shim.create_study(direction=direction, seed=seed)
        theirs = jax_shim.create_study(direction=direction, seed=seed)
        ours.optimize(objective(shim), n_trials=25)
        theirs.optimize(objective(jax_shim), n_trials=25)
        assert [(t.number, t.value, t.params, t.state) for t in ours.trials] == \
            [(t.number, t.value, t.params, t.state) for t in theirs.trials]
        assert ours.best_params == theirs.best_params and ours.best_value == theirs.best_value
    with pytest.raises(ValueError):
        shim.create_study(direction="sideways")


def test_slice_env_pins_cuda_visible_devices(monkeypatch):
    assert sweep.slice_env(0, 2) == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert sweep.slice_env(1, 2) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    assert sweep.slice_env(3, 1) == {"CUDA_VISIBLE_DEVICES": "3"}
    seen = set()
    for slot in range(4):
        cards = set(sweep.slice_env(slot, 2)["CUDA_VISIBLE_DEVICES"].split(","))
        assert not cards & seen
        seen |= cards
    # the pool initializer claims a slot and pins the worker to it ...
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(sweep, "_WORKER_INIT_ERROR", None)
    slots = queue.Queue()
    slots.put(1)
    sweep._worker_init({"x": 1}, slots, 2)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3" and sweep._WORKER_BASE_ARGS == {"x": 1}
    # ... but not once CUDA is initialized: the worker's trials fail instead
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    slots.put(0)
    sweep._worker_init({}, slots, 2)
    assert "first CUDA call" in sweep._WORKER_INIT_ERROR
    t = sweep._worker(sweep.Trial(0, {}, "unused"))
    assert t.status == "failed" and "first CUDA call" in t.error


def test_run_sweep_in_process_statuses_match_jax_keys(tmp_path, monkeypatch):
    """Done, preempted (SIGTERM during training) and failed trials; the
    summary ranked by best CER under JAX's keys; the trial's cards."""
    real = trainer._train_model_impl

    def preempt_at_0_02(args, stop):
        if args["lrStart"] == 0.02:
            signal.raise_signal(signal.SIGTERM)  # the trainer's handler sets stop
        return real(args, stop)

    monkeypatch.setattr(trainer, "_train_model_impl", preempt_at_0_02)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    overrides = [{"lrStart": 0.01}, {"lrStart": 0.02},
                 {"dataset": None, "datasetPath": str(tmp_path / "missing.pkl")}]
    trials = sweep.run_sweep(_base_args(), overrides, str(tmp_path / "sweep"),
                             array_parallelism=1, use_processes=False,
                             chips_per_trial=1, total_chips=2)
    assert [t.status for t in trials] == ["done", "preempted", "failed"]
    assert np.isfinite(trials[0].best_cer) and trials[1].best_cer == float("inf")
    assert "FileNotFoundError" in trials[2].error
    assert all(t.chips == "0" for t in trials)
    assert (tmp_path / "sweep" / "trial_0001" / "lastState").is_file()  # resumable
    summary = json.loads((tmp_path / "sweep" / "sweep_summary.json").read_text())
    assert [s["status"] for s in summary] == ["done", "preempted", "failed"]
    # JAX's summary keys, from a JAX sweep of one trial that fails at once
    jax_trials = jax_sweep.run_sweep({"datasetPath": str(tmp_path / "missing.pkl")}, [{}],
                                     str(tmp_path / "jax_sweep"), use_processes=False)
    assert jax_trials[0].status == "failed"
    jax_summary = json.loads((tmp_path / "jax_sweep" / "sweep_summary.json").read_text())
    assert [set(s) for s in summary] == [set(jax_summary[0])] * 3


class _ExitOnLoad:
    """Unpickling it ends the process at once with code 3 (``os._exit``)."""

    def __reduce__(self):
        return os._exit, (3,)


def test_dead_worker_fails_its_trial_and_the_sweep_goes_on(tmp_path, monkeypatch):
    """The middle trial's dataset pickle kills its worker: that trial is
    ``failed`` with the ``BrokenProcessPool`` error, its slot restarts, and
    the trials before and after it finish."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dead = tmp_path / "exit.pkl"
    dead.write_bytes(pickle.dumps(_ExitOnLoad()))
    overrides = [{"lrStart": 0.01}, {"dataset": None, "datasetPath": str(dead)},
                 {"lrStart": 0.02}, {"lrStart": 0.005}]
    trials = sweep.run_sweep(_base_args(), overrides, str(tmp_path / "sweep"),
                             array_parallelism=2)
    status = {t.trial_id: t.status for t in trials}
    assert status == {0: "done", 1: "failed", 2: "done", 3: "done"}
    failed = next(t for t in trials if t.trial_id == 1)
    assert "BrokenProcessPool" in failed.error
    assert all(np.isfinite(t.best_cer) for t in trials if t.status == "done")
    summary = json.loads((tmp_path / "sweep" / "sweep_summary.json").read_text())
    assert len(summary) == 4


def test_stdin_main_is_refused(tmp_path, monkeypatch):
    """A parent read from ``<stdin>`` (``python -``) cannot spawn workers:
    the sweep refuses it before it starts one."""
    class Main:
        __file__ = "<stdin>"

    monkeypatch.setitem(sys.modules, "__main__", Main)
    with pytest.raises(RuntimeError, match="stdin"):
        sweep.run_sweep(_base_args(), [{}, {}], str(tmp_path / "sweep"), array_parallelism=2)
    assert not (tmp_path / "sweep" / "sweep_summary.json").exists()


def test_trials_train_over_two_ranks_in_the_workers(tmp_path, monkeypatch):
    """Two trials, each ``device: cpu, n_data_devices: 2``, in two workers:
    each worker starts the trial's two gloo ranks (the workers are not
    daemonic), and each trial's per-step losses are those of its overrides
    at one rank, within 1e-5."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    overrides = [{"lrStart": lr, "n_data_devices": 2, "nBatch": 4, "dist_timeout_s": 60,
                  "wandb_mode": "offline"}
                 for lr in (0.01, 0.02)]
    trials = sweep.run_sweep(_base_args(), overrides, str(tmp_path / "sweep"),
                             array_parallelism=2)
    assert [t.status for t in trials] == ["done", "done"], [t.error for t in trials]
    for t in trials:
        alone = tmp_path / f"alone_{t.trial_id}"
        trainer.train_model({**_base_args(), **t.overrides, "n_data_devices": 1,
                             "outputDir": str(alone)})
        ranks, one = _losses(Path(t.output_dir)), _losses(alone)
        assert len(ranks) == len(one) == 4
        np.testing.assert_allclose(ranks, one, rtol=1e-5)
        last = json.loads((Path(t.output_dir) / "metrics.jsonl").read_text().splitlines()[-1])
        assert {"summary/rank0/steps_wall_end", "summary/rank1/steps_wall_end"} <= set(last)


@pytest.mark.parametrize("lr_start, lr_end", [(0.01, 0.02), (0.02, 0.01), (0.02, 0.02)])
def test_linear_schedule_matches_jax_rising_or_falling(lr_start, lr_end):
    """Sweeping lrStart below the recipe's lrEnd makes the schedule rise:
    torch's LinearLR refuses that, the port's closed form follows JAX's
    linear schedule (within float32 rounding, 1e-6 relative)."""
    from neural_speech_decoder_tpu.training.optim import make_optimizer as jax_make_optimizer
    from neural_speech_decoder_tpu_torch.training.optim import make_optimizer

    args = {"nBatch": 10, "lrStart": lr_start, "lrEnd": lr_end, "l2_decay": 0.0}
    opt, sched = make_optimizer(args, [torch.nn.Parameter(torch.zeros(3))])
    _, jax_schedule = jax_make_optimizer(args)
    for count in range(13):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jax_schedule(count)),
                                   rtol=1e-6, err_msg=str(count))
        opt.step()
        sched.step()


def test_optuna_sweep_runs_on_the_shim(tmp_path):
    def suggest(trial):
        lr = trial.suggest_float("lrStart", 1e-3, 2e-2, log=True)
        return {"lrStart": lr, "lrEnd": lr}

    with pytest.warns(UserWarning, match="shim"):
        study = sweep.run_optuna_sweep(_base_args(), suggest, str(tmp_path / "optuna"),
                                       n_trials=2)
    assert [t.state for t in study.trials] == ["COMPLETE"] * 2
    assert 1e-3 <= study.best_params["lrStart"] <= 2e-2
    assert (tmp_path / "optuna" / "trial_0001" / "trainingStats").is_file()


def test_cli_multirun_jobs_2_in_a_spawn_pool(tmp_path, monkeypatch):
    """``-m lrStart=0.01,0.02 --jobs 2``: two spawned workers, each job under
    JAX's override dirname, and each job's per-step losses bit-equal to its
    overrides run alone here without ``-m``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers' torch threads
    cfg = _cli_config(tmp_path)
    overrides = [f"outputDir={tmp_path / 'sweep'}", "lrStart=0.01,0.02"]
    res = cli.main(["--config", cfg, "-m", "--jobs", "2", *overrides])
    names = [jax_config.override_dirname(ov) for ov in jax_config.expand_multirun(overrides)]
    assert names == ["lrStart=0.01", "lrStart=0.02"]
    jobs = {str(tmp_path / "sweep" / n) for n in names}
    assert res["jobs"] == {j: "done" for j in jobs} and res["n_failed"] == 0
    assert res["best_dir"] in jobs and np.isfinite(res["summary/best_cer"])
    summary = json.loads((tmp_path / "sweep" / "sweep_summary.json").read_text())
    cers = [s["best_cer"] for s in summary]
    assert cers == sorted(cers) and {s["outputDir"] for s in summary} == jobs
    assert summary[0]["outputDir"] == res["best_dir"]
    for name in names:
        lr = name.partition("=")[2]
        with open(tmp_path / "sweep" / name / "args", "rb") as f:
            assert pickle.load(f)["lrStart"] == float(lr)
        alone = tmp_path / f"alone_{lr}"
        cli.main(["--config", cfg, f"outputDir={alone}", f"lrStart={lr}"])
        swept_losses = _losses(tmp_path / "sweep" / name)
        assert len(swept_losses) == 2 and _losses(alone) == swept_losses
        # the worker's record of its steps and launches (CPU tensors launch nothing)
        rec = json.loads((tmp_path / "sweep" / name / "metrics.jsonl").read_text()
                         .splitlines()[-1])
        assert 0 < rec["summary/steps_wall_start"] <= rec["summary/steps_wall_end"]
        launches = {k.removeprefix("summary/launches/"): v for k, v in rec.items()
                    if k.startswith("summary/launches/")}
        assert launches == dict.fromkeys(launch_counts(), 0.0)
        assert {"gru_scan_gates/persistent", "ctc_alpha/prefetch", "frontend/tc"} <= set(launches)


def test_cli_multirun_names_and_errors(tmp_path):
    """Only excluded overrides: one job named ``job_0``; comma-swept values
    without ``-m`` and a sweep whose every job fails raise ``SystemExit``."""
    cfg = _cli_config(tmp_path)
    out = f"outputDir={tmp_path / 'sweep'}"
    assert jax_config.override_dirname([out]) == ""
    res = cli.main(["--config", cfg, "-m", out])
    assert res["jobs"] == {str(tmp_path / "sweep" / "job_0"): "done"}
    with pytest.raises(SystemExit, match="need -m"):
        cli.main(["--config", cfg, out, "lrStart=0.01,0.02"])
    with pytest.raises(SystemExit, match="all 2 multirun jobs failed"):
        cli.main(["--config", cfg, "-m", out, "lrStart=0.01,0.02",
                  f"datasetPath={tmp_path / 'missing.pkl'}"])
    with pytest.raises(SystemExit, match="outputDir must be set"):
        cli.main(["--config", cfg, "-m", "lrStart=0.01,0.02"])


_BUILD = """
import sys
from pathlib import Path
from neural_speech_decoder_tpu_torch.ops.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._nvcc = lambda: sys.argv[2]
print(_build.build())
"""

# a stand-in for nvcc: logs each call, takes a while, writes its -o file
_STUB = """#!{python}
import sys, time
from pathlib import Path
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
Path(out).write_text("lib" if "-shared" in sys.argv else "obj")
"""


def test_concurrent_kernel_builds_share_one_library(tmp_path):
    """Two processes that start the kernel build at once: one compiles every
    source and links once, the other waits on the lock and returns the same
    library."""
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(stub)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    libs = {o[0].strip() for o in outs}
    assert len(libs) == 1 and sorted(build.glob("*.so")) == [Path(libs.pop())]
    calls = log.read_text().splitlines()
    n_sources = len(list((REPO / "neural_speech_decoder_tpu_torch/csrc").glob("*.cu")))
    assert sum("-shared" in c for c in calls) == 1 and len(calls) == n_sources + 1
    assert (build / "libnsd_kernels.lock").exists()
