"""The plain reference against the port's CPU twins at a small size, and
the comparison that decides ``correct`` seen to fail: the lower-precision
control and each fault a cell can have."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.kinds import decode, train
from portbench.readings import half_batch, overrides_for
from portbench.reference import conformer as ref_conformer
from portbench.reference import gru as ref_gru
from portbench.tests import _tiny

CELLS = ["gru_train_f32", "conformer_train_f32", "gru_decode_f32", "conformer_decode_f32"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = _tiny.run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(cell):
    r = _tiny.run(cell, extra=overrides_for("control"))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["gru_train_f32", "conformer_train_f32"])
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    real = train.program

    def frozen(ctx, params):
        model, opt, step = real(ctx, params)

        def step_frozen(batch, generator):
            saved = [p.detach().clone() for p in model.parameters()]
            out = step(batch, generator)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return out

        return model, opt, step_frozen

    monkeypatch.setattr(train, "program", frozen)
    r = _tiny.run(cell)
    assert not r["correct"] and r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gru_train_f32", "conformer_train_f32"])
def test_half_batch_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(train, "program", half_batch(train.program))
    assert not _tiny.run(cell)["correct"]


@pytest.mark.parametrize("cell", ["gru_decode_f32", "conformer_decode_f32"])
def test_half_batch_decode_is_not_correct(cell, monkeypatch):
    real = decode.program

    class Half:
        def __init__(self, model):
            self.model = model

        def pad_batch(self, trials, days):
            return self.model.pad_batch(trials, days)

        def __call__(self, x, days, lens):
            rows = x.shape[0] // 2
            lp, ol = self.model(torch.cat([x[:rows], x[:rows]]), torch.cat([days[:rows]] * 2),
                                torch.cat([lens[:rows]] * 2))
            return lp, ol

        def decode(self, lp, ol):
            return self.model.decode(lp, ol)

    monkeypatch.setattr(decode, "program", lambda ctx, params: Half(real(ctx, params)))
    assert not _tiny.run(cell)["correct"]


@pytest.mark.parametrize("cell", ["gru_decode_f32", "conformer_decode_f32"])
def test_altered_token_is_not_correct(cell, monkeypatch):
    real = decode.serve

    def serve(model, request, spans, sync):
        lp, ol, out = real(model, request, spans, sync)
        out[0] = out[0][:-1] + [(out[0][-1] % 40) + 1] if out[0] else [1]
        return lp, ol, out

    monkeypatch.setattr(decode, "serve", serve)
    r = _tiny.run(cell)
    assert not r["correct"] and r["checks"]["decode_mismatch"]["value"] >= 1


def _eval_pair(family, cell):
    """The port's eval forward and the reference's on one drawn tree."""
    from neural_speech_decoder_tpu_torch.models.api import config_from_args, forward_params
    from portbench import generate, harness

    _, cfg, mix = harness.load_cell(cell, _tiny.overrides(cell))
    fam = ref_gru if family == "gru" else ref_conformer
    params = weights.draw(fam.leaf_specs(cfg), 11, "cpu")
    a = cfg["args"]
    b = generate.make_batches(mix, a["nInputFeatures"], a["nClasses"], cfg["n_days"], 3)[0]
    x, days, lens = (torch.from_numpy(b[k]) for k in ("x", "days", "x_lens"))
    with torch.no_grad():
        lp_p, ol_p, _ = forward_params(config_from_args(a, cfg["n_days"]), params, x, days, lens)
        lp_r, ol_r = fam.forward(params, cfg, x, days, lens)[:2]
    return lp_p, ol_p, lp_r, ol_r


@pytest.mark.parametrize("family,cell", [("gru", "gru_decode_f32"),
                                         ("conformer", "conformer_decode_f32")])
def test_reference_forward_agrees_with_the_port_on_the_cpu(family, cell):
    lp_p, ol_p, lp_r, ol_r = _eval_pair(family, cell)
    np.testing.assert_array_equal(ol_p.numpy(), ol_r.numpy())
    assert (lp_p - lp_r).abs().max().item() < 1e-4


def test_weights_take_the_ports_layout():
    from neural_speech_decoder_tpu_torch.models.api import build_model
    from portbench import harness

    for cell, fam in (("gru_train_f32", ref_gru), ("conformer_train_f32", ref_conformer)):
        _, cfg, _ = harness.load_cell(cell, _tiny.overrides(cell))
        ours = dict(weights.leaf_paths(weights.draw(fam.leaf_specs(cfg), 1, "cpu")))
        theirs = build_model(cfg["args"], cfg["n_days"], "cpu").params
        theirs = {p: t for p, t in weights.leaf_paths(theirs)}
        assert ours.keys() == theirs.keys()
        assert all(ours[p].shape == theirs[p].shape for p in ours)
