"""The port's offline data formatter (``nsd-format-torch``) against the JAX
package's, on the CPU.

``neural_speech_decoder_tpu_torch/data/formatter.py`` is host code (numpy,
scipy) copied from ``neural_speech_decoder_tpu/data/formatter.py``: every
function is run on the same synthetic ``.mat`` sessions (made from a numpy
seed: ``tx1`` and ``spikePow`` wider than 128 columns, contiguous blocks,
punctuated transcriptions) with the same stub g2p on both sides, and the
results must be equal: arrays bit for bit, and the pickles that
``format_competition_data`` and ``main`` write byte for byte. ``g2p_en``
is absent, so ``make_g2p`` raises ``ImportError`` on both.
"""

import pickle
import sys
import warnings

import numpy as np
import pytest
import scipy.io
import torch

from neural_speech_decoder_tpu.data import formatter as jax_formatter
from neural_speech_decoder_tpu_torch.data import formatter
from neural_speech_decoder_tpu_torch.data.dataset import pack_days

SESSIONS = ("t12.2022.05.05", "t12.2022.05.17")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other test modules (torch is
    imported for the packed dataset only)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stub_g2p(text):
    """g2p_en's form: phones with stress digits, ``" "`` between words; each
    word's phones depend on its letters."""
    phones = ["B1", "AE0", "T", "IY2", "K", "S", "ER1"]
    out = []
    for i, w in enumerate(text.split(" ")):
        if i:
            out.append(" ")
        out.extend(phones[(len(w) + j) % len(phones)] for j in range(len(w) % 4 + 1))
    return out


def write_mat(path, rng, n_trials=6, blocks=(3, 3, 3, 5, 5, 7)):
    tx1, spike_pow = np.empty((1, n_trials), object), np.empty((1, n_trials), object)
    for i in range(n_trials):
        t = int(rng.integers(20, 40))
        tx1[0, i] = rng.poisson(2.0 + blocks[i], size=(t, 192)).astype(np.float64)
        spike_pow[0, i] = rng.gamma(2.0, 3.0 * blocks[i], size=(t, 192))
    text = np.array(["Go home now.", "It's fine!", "yes", "no -- way", "A1B2 c3d?",
                     "What's up, doc"][:n_trials])
    scipy.io.savemat(str(path), {"tx1": tx1, "spikePow": spike_pow, "sentenceText": text,
                                 "blockIdx": np.array(blocks).reshape(-1, 1)})
    return str(path)


@pytest.fixture
def data_dir(tmp_path):
    """Two sessions in train/ and test/, the first also in competitionHoldOut/."""
    rng = np.random.default_rng(0)
    for split, names in (("train", SESSIONS), ("test", SESSIONS),
                         ("competitionHoldOut", SESSIONS[:1])):
        (tmp_path / split).mkdir()
        for name in names:
            write_mat(tmp_path / split / f"{name}.mat", rng)
    return tmp_path


def assert_equal(a, b):
    """Equal values and types, arrays bit for bit with their dtypes."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_session_names_and_clean_transcription_match_jax():
    assert formatter.SESSION_NAMES == jax_formatter.SESSION_NAMES
    assert len(formatter.SESSION_NAMES) == 24
    for text in ("It's fine!", "Go -- home.", "A1B2C3", "  Hello, World  "):
        assert formatter.clean_transcription(text) == jax_formatter.clean_transcription(text)


def test_load_features_and_normalize_matches_jax(data_dir):
    path = str(data_dir / "train" / f"{SESSIONS[0]}.mat")
    got = formatter.load_features_and_normalize(path)
    assert_equal(got, jax_formatter.load_features_and_normalize(path))
    assert got["inputFeatures"][0].shape[1] == 256
    # blocks 3 (trials 0-2) and 5 (3-4) are z-scored over their own spans
    for idx in ([0, 1, 2], [3, 4]):
        span = np.concatenate([got["inputFeatures"][i] for i in idx])
        np.testing.assert_allclose(span.mean(0), 0.0, atol=1e-9)
        np.testing.assert_allclose(span.std(0), 1.0, atol=1e-6)


@pytest.mark.parametrize("inter_word", [True, False])
def test_phonemize_matches_jax(inter_word):
    for text in ("go home now", "yes", "its fine", ""):
        got = formatter.phonemize(text, stub_g2p, add_inter_word_symbol=inter_word)
        assert got == jax_formatter.phonemize(text, stub_g2p,
                                              add_inter_word_symbol=inter_word)
    assert formatter.phonemize("go home", stub_g2p)[-1] == "SIL"


@pytest.mark.parametrize("n", [0, 3, 498, 499, 500, 600])
def test_labels_from_phonemes_matches_jax(n):
    """The 500-slot int32 buffer with the +1 offset; from 500 phones on,
    truncated to 499 with a warning on both sides."""
    phones = (["B", "AE", "SIL"] * 200)[:n]
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = formatter.labels_from_phonemes(phones)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_formatter.labels_from_phonemes(phones)
    assert_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (500,)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert bool(got_w) == (n >= 500)
    if n >= 500:
        assert "truncated to 499" in str(got_w[0].message) and got[499] == 0


def test_format_session_matches_jax(data_dir):
    path = str(data_dir / "test" / f"{SESSIONS[1]}.mat")
    day = formatter.format_session(path, stub_g2p)
    assert_equal(day, jax_formatter.format_session(path, stub_g2p))
    assert day["phonePerTime"].dtype == np.float32
    ds = pack_days([day])
    assert ds.n_trials == 6 and ds.n_channels == 256


def test_format_competition_data_pickle_matches_jax(data_dir, tmp_path):
    """The {train, test, competition} pickles byte for byte; competition
    holds only the session with a competitionHoldOut file."""
    ours, theirs = tmp_path / "ours.pkl", tmp_path / "theirs.pkl"
    got = formatter.format_competition_data(str(data_dir), str(ours), SESSIONS, g2p=stub_g2p)
    want = jax_formatter.format_competition_data(str(data_dir), str(theirs), SESSIONS,
                                                 g2p=stub_g2p)
    assert_equal(got, want)
    assert [len(got[k]) for k in ("train", "test", "competition")] == [2, 2, 1]
    assert ours.read_bytes() == theirs.read_bytes()
    assert_equal(pickle.loads(ours.read_bytes()), got)


def test_main_matches_jax(tmp_path, monkeypatch):
    """``nsd-format-torch`` (``main``) over all 24 sessions, with the g2p
    patched in on both sides: the same pickle as ``nsd-format``'s."""
    rng = np.random.default_rng(1)
    data = tmp_path / "competitionData"
    for split, names in (("train", formatter.SESSION_NAMES), ("test", formatter.SESSION_NAMES),
                         ("competitionHoldOut", formatter.SESSION_NAMES[3:4])):
        (data / split).mkdir(parents=True)
        for name in names:
            write_mat(data / split / f"{name}.mat", rng, n_trials=2, blocks=(1, 2))
    ours, theirs = tmp_path / "ours.pkl", tmp_path / "theirs.pkl"
    for mod, out in ((formatter, ours), (jax_formatter, theirs)):
        monkeypatch.setattr(mod, "make_g2p", lambda: stub_g2p)
        monkeypatch.setattr(sys, "argv", ["nsd-format", "--data-dir", str(data),
                                          "--out", str(out)])
        mod.main()
    assert ours.read_bytes() == theirs.read_bytes()
    got = pickle.loads(ours.read_bytes())
    assert [len(got[k]) for k in ("train", "test", "competition")] == [24, 24, 1]


def test_make_g2p_raises_without_g2p_en(monkeypatch):
    monkeypatch.setitem(sys.modules, "g2p_en", None)
    with pytest.raises(ImportError):
        formatter.make_g2p()
    with pytest.raises(ImportError):
        jax_formatter.make_g2p()
