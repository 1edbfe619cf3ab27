"""Config handling: YAML config files and hydra-style ``key=value`` overrides.

The port's own copy of ``neural_speech_decoder_tpu/utils/config.py``
(``load_yaml_config``, ``apply_overrides``, ``expand_multirun``,
``override_dirname``), with one difference: it reads YAML with a small
reader of its own instead of PyYAML, which the machines the port runs on
need not have. The reader takes the subset the repository's configs and
command lines use, with PyYAML's ``safe_load`` meaning (YAML 1.1):

- a file is a flat mapping, one ``key: value`` per line at column 0, with
  ``#`` comments and blank lines;
- a value is a plain scalar — null (``~``, ``null``, nothing), a bool
  (``true``/``false``, ``yes``/``no``, ``on``/``off`` in three cases), a
  decimal int, a float (``1.0e-3``, ``.5``, ``.inf``, ``.nan``; ``1e-3``
  without a dot is a string to YAML 1.1) or a string — a quoted string
  without escapes, or a flow list ``[a, b]`` of plain scalars.

Anything else (nesting, anchors, tags, block lists, octal, hex or
sexagesimal numbers, dates, escapes) raises ``ValueError`` instead of being
read otherwise than PyYAML would read it.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Sequence

_BOOL = {w: v for words, v in (("yes true on", True), ("no false off", False))
         for word in words.split() for w in (word, word.capitalize(), word.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF_NAN = re.compile(r"[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# what YAML 1.1 reads as something this reader does not take: other ints
# (binary, octal, hex, sexagesimal), sexagesimal floats, dates, merge keys
_OTHER = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|<<|=")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INDICATORS = tuple("-?:,[]{}#&*!|>'\"%@`")


def _unsupported(text: str, why: str) -> ValueError:
    return ValueError(f"YAML value {text!r}: {why}; this reader takes flat "
                      f"'key: scalar' configs only")


def parse_scalar(text: str) -> Any:
    """One YAML value (a plain or quoted scalar, or a flow list of plain
    scalars) as PyYAML's ``safe_load`` reads it."""
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        items = [c.strip() for c in inner.split(",")]
        if any(not c or c.startswith(("[", "{", "'", '"')) for c in items):
            raise _unsupported(text, "a nested, quoted or empty list item")
        return [parse_scalar(c) for c in items]
    if len(s) >= 2 and s[0] == s[-1] == "'":
        body = s[1:-1]
        if "'" in body.replace("''", ""):
            raise _unsupported(text, "a stray quote")
        return body.replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        body = s[1:-1]
        if "\\" in body or '"' in body:
            raise _unsupported(text, "an escape")
        return body
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INF_NAN.fullmatch(s):
        return float(s.replace(".", ""))
    if _INT.fullmatch(s):
        return int(s.replace("_", ""))
    if _FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    if _OTHER.fullmatch(s):
        raise _unsupported(text, "a number form or tag other than decimal")
    if s.startswith(_INDICATORS) and not (s[0] in "-?:" and len(s) > 1 and s[1] != " "):
        raise _unsupported(text, "an indicator character")
    if ": " in s or s.endswith(":") or " #" in s:
        raise _unsupported(text, "a mapping or comment inside a value")
    return s


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start, or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_yaml_config(path: str) -> dict[str, Any]:
    """A flat ``key: value`` YAML file as a dict (see the module docstring)."""
    cfg: dict[str, Any] = {}
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line:
                continue
            key, sep, value = line.partition(":")
            if (not sep or not _KEY.fullmatch(key)
                    or (value and not value.startswith((" ", "\t")))):
                raise ValueError(f"{path}:{n}: not a flat 'key: value' line: {raw!r}")
            if key in cfg:
                raise ValueError(f"{path}:{n}: duplicate key {key!r}")
            cfg[key] = parse_scalar(value)
    return cfg


_SCI_NOTATION = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+")


def apply_overrides(cfg: dict[str, Any], overrides: Sequence[str]) -> dict:
    """Apply ``a.b.c=value`` overrides in place; values read as YAML, and
    scientific notation without a dot (a string to YAML 1.1) as a float."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, _, raw = ov.partition("=")
        value = parse_scalar(raw) if raw != "" else None
        if isinstance(value, str) and _SCI_NOTATION.fullmatch(value):
            value = float(value)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if nxt is None:  # an empty section ("model:") reads as None
                nxt = node[p] = {}
            if not isinstance(nxt, dict):
                raise ValueError(f"cannot override through non-dict at {p}")
            node = nxt
        node[parts[-1]] = value
    return cfg


def expand_multirun(overrides: Sequence[str]) -> list[list[str]]:
    """Hydra-multirun expansion: a comma in an override value sweeps it.
    ``["lrStart=0.01,0.02", "nUnits=512"]`` expands to
    ``[["lrStart=0.01", "nUnits=512"], ["lrStart=0.02", "nUnits=512"]]``;
    bracketed lists (``key=[1,2]``) and quoted values are single values."""
    per_key: list[list[str]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, _, raw = ov.partition("=")
        if "," in raw and not raw.strip().startswith(("[", "{", "'", '"')):
            choices = [c.strip() for c in raw.split(",")]
            if any(c == "" for c in choices):
                raise ValueError(f"empty choice in sweep override: {ov!r}")
            per_key.append([f"{key}={c}" for c in choices])
        else:
            per_key.append([ov])
    return [list(combo) for combo in itertools.product(*per_key)]


def override_dirname(
    overrides: Sequence[str],
    exclude_keys: Sequence[str] = ("outputDir", "datasetPath"),
    sep: str = ",",
) -> str:
    """Hydra's ``${hydra.job.override_dirname}``: the overrides sorted by
    key and joined with ``sep``, minus ``exclude_keys``, values verbatim."""
    return sep.join(sorted(ov for ov in overrides
                           if ov.partition("=")[0] not in exclude_keys))
