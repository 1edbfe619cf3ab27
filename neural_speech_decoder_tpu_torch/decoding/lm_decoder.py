"""ctypes interface to the native CTC beam decoder (``csrc/ctc_beam.cpp``).

The port's counterpart of ``neural_speech_decoder_tpu/decoding/lm_decoder.py``.
API mirrors the surface the reference uses from the upstream
``lmDecoderUtils`` (``eval_competition.py:88-116``):
  * ``build_lm_decoder(lang_dir_or_paths, acoustic_scale, nbest, beam)``
  * ``lm_decode(decoder, logits, blankPenalty=..., returnNBest=...)``
plus ``rearrange_speech_logits`` for the blank-last layout conversion.

The shared library is the port's own copy of the C++ source
(``neural_speech_decoder_tpu_torch/csrc/ctc_beam.cpp``), compiled at first
use with ``g++ -O3 -std=c++17 -fPIC -fopenmp -shared`` into the package's
git-ignored ``_build/`` directory under a name that carries the hash of the
source and the flags. The build runs under an exclusive file lock
(``fcntl.flock``) and lands by an atomic rename, so processes that start it
at once share one library. There is no silent fallback: when the library
cannot be built or loaded, ``build_lm_decoder`` raises. The pure-Python
oracle (``decoding/beam.py``, identical semantics) serves only a decoder
built with ``force_python=True``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .beam import Hypothesis, beam_search
from .lexicon import ArpaLM, Lexicon

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ctc_beam.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fopenmp", "-shared")

# Must match ctcb_abi_version() in csrc/ctc_beam.cpp: a library that lacks
# the symbol or returns another number is refused rather than called
# through mismatched signatures.
_ABI_VERSION = 3


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libctcbeam_{h.hexdigest()[:16]}.so"


def compilers() -> list[str]:
    """The C++ compilers to try, in order: ``$CXX``, then each ``g++`` and
    ``c++`` on ``PATH`` and in ``/usr/bin`` (a toolchain may put a ``g++``
    without OpenMP's runtime ahead of the system's)."""
    cands = [shutil.which(os.environ["CXX"])] if os.environ.get("CXX") else []
    for d in os.environ.get("PATH", "").split(os.pathsep) + ["/usr/bin"]:
        cands += [os.path.join(d, n) for n in ("g++", "c++")]
    found = {}
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            found.setdefault(os.path.realpath(c), c)
    return list(found.values())


def build() -> Path:
    """Compile the decoder unless the library for this source exists, with
    the first of ``compilers()`` that builds it (OpenMP included).

    The lock serializes concurrent builders (test workers, a CLI started
    twice); the one that takes it second finds the library and returns."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libctcbeam.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so
            errors = []
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                tmp = Path(work) / "lib.so"
                for cxx in compilers():
                    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    if proc.returncode == 0:
                        os.replace(tmp, so)  # atomic: a loader sees all or nothing
                        return so
                    errors.append(f"{' '.join(cmd)} ({proc.returncode}):\n"
                                  f"{proc.stdout}{proc.stderr}")
            raise RuntimeError("building the native decoder failed: "
                               + ("\n".join(errors) or "no C++ compiler found"))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load_lib() -> ctypes.CDLL:
    so = build()
    lib = ctypes.CDLL(str(so))
    try:
        version = lib.ctcb_abi_version()
    except AttributeError:
        version = None
    if version != _ABI_VERSION:
        raise RuntimeError(
            f"{so} has ABI version {version}, expected {_ABI_VERSION}")
    lib.ctcb_create.restype = ctypes.c_void_p
    lib.ctcb_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    lib.ctcb_decode.restype = ctypes.c_int
    lib.ctcb_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ctcb_decode_batch.restype = ctypes.c_int
    lib.ctcb_decode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_char), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ctcb_free.argtypes = [ctypes.c_void_p]
    lib.ctcb_session_start.restype = ctypes.c_void_p
    lib.ctcb_session_start.argtypes = [ctypes.c_void_p]
    lib.ctcb_session_feed.restype = ctypes.c_int
    lib.ctcb_session_feed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
    ]
    lib.ctcb_session_nbest.restype = ctypes.c_int
    lib.ctcb_session_nbest.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ctcb_session_free.argtypes = [ctypes.c_void_p]
    return lib


# Sentinel matching kOovDisabled in csrc/ctc_beam.cpp.
_OOV_DISABLED = 1e30


_LIB: ctypes.CDLL | None = None


def native_library() -> ctypes.CDLL:
    """The native engine, built and loaded at first call; raises when it
    cannot be."""
    global _LIB
    if _LIB is None:
        _LIB = _load_lib()
    return _LIB


def native_available() -> bool:
    """Whether the native engine is loaded or can be built and loaded."""
    try:
        native_library()
    except (OSError, RuntimeError):
        return False
    return True


@dataclass
class LMDecoder:
    handle: int | None  # native handle (None = the Python engine)
    lexicon_path: str | None
    arpa_path: str | None
    acoustic_scale: float
    nbest: int
    beam: float
    max_active: int
    lm_weight: float
    word_ins_penalty: float
    top_k_tokens: int
    oov_cost: float | None = None
    boundary_free: bool = False
    _py_lexicon: Lexicon | None = None
    _py_lm: ArpaLM | None = None

    def __del__(self):  # pragma: no cover
        try:
            if self.handle and _LIB is not None:
                _LIB.ctcb_free(ctypes.c_void_p(self.handle))
        except Exception:
            pass  # interpreter shutdown: ctypes internals may be gone


def build_lm_decoder(
    lexicon_path: str | None = None,
    arpa_path: str | None = None,
    acoustic_scale: float = 0.5,
    nbest: int = 100,
    beam: float = 18.0,
    *,
    max_active: int = 200,
    lm_weight: float = 1.0,
    word_ins_penalty: float = 0.0,
    top_k_tokens: int = 12,
    oov_cost: float | None = None,
    boundary_free: bool = False,
    force_python: bool = False,
) -> LMDecoder:
    """Create a decoder. Parameter names/defaults mirror the reference call
    ``build_lm_decoder(lmDir, acoustic_scale=0.5, nbest=100, beam=18)``.

    ``oov_cost`` (typically negative, e.g. -4.0) enables the OOV fallback
    track: out-of-lexicon words decode phone-by-phone at that score per
    phone and surface as ``<unk>``. ``boundary_free`` lets words commit
    eagerly without SIL delimiters (SIL-free models/lexicons).

    The native engine decodes unless ``force_python`` asks for the Python
    oracle; when the native library cannot be built or loaded this raises.
    """
    handle = None
    if not force_python:
        handle = native_library().ctcb_create(
            lexicon_path.encode() if lexicon_path else None,
            arpa_path.encode() if arpa_path else None,
            acoustic_scale, nbest, beam, max_active, lm_weight,
            word_ins_penalty, top_k_tokens,
            _OOV_DISABLED if oov_cost is None else oov_cost,
            int(boundary_free),
        )
        if not handle:
            raise RuntimeError(
                f"native decoder failed to load {lexicon_path} / {arpa_path}"
            )
    dec = LMDecoder(
        handle=handle,
        lexicon_path=lexicon_path,
        arpa_path=arpa_path,
        acoustic_scale=acoustic_scale,
        nbest=nbest,
        beam=beam,
        max_active=max_active,
        lm_weight=lm_weight,
        word_ins_penalty=word_ins_penalty,
        top_k_tokens=top_k_tokens,
        oov_cost=oov_cost,
        boundary_free=boundary_free,
    )
    if handle is None:
        dec._py_lexicon = (
            Lexicon.from_file(lexicon_path) if lexicon_path else None
        )
        dec._py_lm = ArpaLM.from_file(arpa_path) if arpa_path else None
    return dec


def lm_decode(
    decoder: LMDecoder,
    log_probs: np.ndarray,
    *,
    blank_penalty: float = 0.0,
    return_nbest: bool = True,
) -> list[Hypothesis]:
    """Decode one utterance's ``[T, K]`` log-probs (blank at index 0)."""
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    t, k = lp.shape
    if decoder.handle is None:
        hyps = beam_search(
            lp,
            lexicon=decoder._py_lexicon,
            lm=decoder._py_lm,
            acoustic_scale=decoder.acoustic_scale,
            blank_penalty=blank_penalty,
            lm_weight=decoder.lm_weight,
            word_insertion_penalty=decoder.word_ins_penalty,
            beam=decoder.beam,
            max_active=decoder.max_active,
            nbest=decoder.nbest,
            top_k_tokens=decoder.top_k_tokens,
            oov_cost=decoder.oov_cost,
            boundary_free=decoder.boundary_free,
        )
        return hyps if return_nbest else hyps[:1]

    hyps = _run_native_nbest(
        decoder.nbest,
        t,
        lambda out_phones, out_lens, words_buf, scores, ac, lm: _LIB.ctcb_decode(
            ctypes.c_void_p(decoder.handle),
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, k,
            blank_penalty,
            out_phones.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            words_buf, len(words_buf),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ),
    )
    return hyps if return_nbest else hyps[:1]


def _parse_hyps(count, out_phones, out_lens, words_raw, scores, ac, lm):
    """Shared native-output parsing (one wire format, one parser)."""
    raw_words = words_raw.split(b"\x1e")
    hyps = []
    for i in range(count):
        wtxt = raw_words[i].decode() if i < len(raw_words) else ""
        hyps.append(
            Hypothesis(
                phones=list(out_phones[i, : out_lens[i]]),
                words=[w for w in wtxt.split("\n") if w],
                score=float(scores[i]),
                ac_score=float(ac[i]),
                lm_score=float(lm[i]),
            )
        )
    return hyps


def _run_native_nbest(n, phones_stride, invoke):
    """Allocate output buffers, call ``invoke`` (returning the hypothesis
    count or a negative error), parse. The words buffer starts small (the
    common case is a few hundred bytes) and retries larger on the engine's
    -2 overflow code — the per-chunk streaming peek stays allocation-light
    instead of churning a 4 MB buffer per call."""
    words_cap = 256 * max(n, 1)
    while True:
        out_phones = np.zeros((n, phones_stride), np.int32)
        out_lens = np.zeros((n,), np.int32)
        words_buf = ctypes.create_string_buffer(words_cap)
        scores = np.zeros((n,), np.float32)
        ac = np.zeros((n,), np.float32)
        lm = np.zeros((n,), np.float32)
        count = invoke(out_phones, out_lens, words_buf, scores, ac, lm)
        if count == -2 and words_cap < (64 << 20):
            words_cap *= 4
            continue
        if count < 0:
            raise RuntimeError(f"native decode failed (code {count})")
        return _parse_hyps(
            count, out_phones, out_lens, words_buf.raw, scores, ac, lm
        )


def lm_decode_batch(
    decoder: LMDecoder,
    log_probs: np.ndarray,
    t_lens: np.ndarray | None = None,
    *,
    blank_penalty: float = 0.0,
    n_threads: int = 0,
    words_stride: int | None = None,
) -> list[list[Hypothesis]]:
    """Decode ``[N, T_max, K]`` log-probs, OpenMP-parallel over utterances.

    ``t_lens[i]`` gives each utterance's real frame count (None = all
    T_max). ``n_threads=0`` uses all cores. A ``force_python`` decoder
    decodes serially on the Python oracle.

    The per-utterance words buffer starts small (``256 * nbest`` bytes —
    generous for word transcriptions) and the whole batch retries with a
    4x stride on the engine's -2 overflow code, mirroring
    ``_run_native_nbest``; a fixed 1 MB/utterance would transiently
    allocate ~1 GB on a 1,000-utterance eval set for data that typically
    needs a few hundred bytes per utterance.
    """
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    n, t_max, k = lp.shape
    lens = (
        np.full((n,), t_max, np.int32)
        if t_lens is None
        else np.ascontiguousarray(t_lens, dtype=np.int32)
    )
    if decoder.handle is None:
        return [
            lm_decode(decoder, lp[i, : lens[i]], blank_penalty=blank_penalty)
            for i in range(n)
        ]

    nb = decoder.nbest
    stride = words_stride or 256 * max(nb, 1)
    while True:
        out_phones = np.zeros((n, nb, t_max), np.int32)
        out_lens = np.zeros((n, nb), np.int32)
        out_counts = np.zeros((n,), np.int32)
        words_buf = ctypes.create_string_buffer(n * stride)
        scores = np.zeros((n, nb), np.float32)
        ac = np.zeros((n, nb), np.float32)
        lm = np.zeros((n, nb), np.float32)
        rc = _LIB.ctcb_decode_batch(
            ctypes.c_void_p(decoder.handle),
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, t_max, k, blank_penalty, n_threads,
            out_phones.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.cast(words_buf, ctypes.POINTER(ctypes.c_char)), stride,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc < 0:
            raise RuntimeError(f"native batch decode failed (code {rc})")
        if any(int(c) == -2 for c in out_counts) and stride < (16 << 20):
            stride *= 4
            continue
        break
    results: list[list[Hypothesis]] = []
    for i in range(n):
        count = int(out_counts[i])
        if count < 0:
            raise RuntimeError(
                f"utterance {i}: words buffer overflow (code {count})"
            )
        raw = words_buf.raw[i * stride : (i + 1) * stride]
        results.append(
            _parse_hyps(
                count, out_phones[i], out_lens[i], raw, scores[i], ac[i],
                lm[i],
            )
        )
    return results


class LMStream:
    """Incremental native lexicon+LM decode session (one utterance).

    Feed per-frame log-probs as the model emits them; ``nbest()`` returns
    the current n-best at any point — partial word hypotheses mid-stream,
    the final result after the last chunk — without disturbing the beam
    (the upstream real-time WFST decoders stream the same way; the
    offline ``lm_decode`` is exactly one feed + nbest of this session,
    same C++ code path). Use via ``open_stream(decoder)``; context
    manager supported. Native engine only.
    """

    def __init__(self, decoder: LMDecoder):
        if decoder.handle is None:
            raise RuntimeError(
                "streaming decode requires the native engine "
                "(a decoder built without force_python)"
            )
        self._decoder = decoder
        self._sess = _LIB.ctcb_session_start(
            ctypes.c_void_p(decoder.handle)
        )
        if not self._sess:
            raise RuntimeError("ctcb_session_start failed")
        self._frames = 0

    def feed(self, log_probs, blank_penalty: float = 0.0) -> None:
        """``log_probs``: [T_chunk, K] per-frame log-probs (blank at 0)."""
        if not self._sess:
            raise RuntimeError("stream is closed")
        lp = np.ascontiguousarray(log_probs, np.float32)
        t, k = lp.shape
        if t == 0:
            return
        rc = _LIB.ctcb_session_feed(
            ctypes.c_void_p(self._sess),
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, k,
            blank_penalty,
        )
        if rc != 0:
            raise RuntimeError(f"session feed failed (code {rc})")
        self._frames += t

    def nbest(self) -> list[Hypothesis]:
        """Current n-best (partial mid-stream, final after the last feed).

        May legitimately be empty mid-word: the engine only finalizes
        states at a word boundary (or with a completable word), so peeks
        taken while every surviving beam is inside a word return ``[]``.
        """
        if not self._sess:
            raise RuntimeError("stream is closed")
        stride = max(self._frames, 1)
        return _run_native_nbest(
            self._decoder.nbest,
            stride,
            lambda out_phones, out_lens, words_buf, scores, ac, lm:
                _LIB.ctcb_session_nbest(
                    ctypes.c_void_p(self._sess), stride,
                    out_phones.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)),
                    out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    words_buf, len(words_buf),
                    scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    lm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ),
        )

    def close(self) -> None:
        if self._sess:
            _LIB.ctcb_session_free(ctypes.c_void_p(self._sess))
            self._sess = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


def open_stream(decoder: LMDecoder) -> LMStream:
    """Start an incremental decode session on the native engine."""
    return LMStream(decoder)


def rearrange_speech_logits(logits: np.ndarray, *, blank_last: bool = True):
    """Convert between blank-first (framework) and blank-last (upstream
    decoder) logit layouts (``eval_competition.py:106-109``)."""
    if blank_last:
        return np.concatenate([logits[..., 1:], logits[..., :1]], axis=-1)
    return np.concatenate([logits[..., -1:], logits[..., :-1]], axis=-1)
