"""Minimal Caffe prototxt parser.

A copy of ``videoquery/nn/prototxt.py`` (jax-free), held to it by
tests/test_torch_copies.py.

Just enough of the protobuf text format to read the reference's BN-Inception
deploy definitions (src/features_GPU_compute/models/ucf101/*.prototxt) and
drive the architecture/weight converter — no protobuf schema needed.

Parses the text format into nested dicts: repeated fields become lists,
enum/bool tokens stay strings, numbers become int/float.
"""

from __future__ import annotations

import re
from typing import Any

_TOKEN = re.compile(
    r"""
    (?P<brace_open>\{)
  | (?P<brace_close>\})
  | (?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)?
  | (?P<string>"[^"]*")
  | (?P<number>-?\d+\.?\d*(?:[eE][-+]?\d+)?)
  | (?P<comment>\#[^\n]*)
  | (?P<ws>\s+)
    """,
    re.X,
)


def _tokens(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"prototxt parse error at {text[pos:pos+40]!r}")
        pos = m.end()
        if m.group("key") is not None:
            yield "key", m.group("key")
            continue
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group(0)


def _coerce(raw: str) -> Any:
    if raw.startswith('"'):
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        if re.fullmatch(r"-?\d+", raw):
            return int(raw)
        return float(raw)
    except ValueError:
        return raw


def parse(text: str) -> dict:
    """Parse prototxt text into a dict-of-lists message tree."""
    stack: list[dict] = [{}]
    pending_key: str | None = None
    for kind, raw in _tokens(text):
        if kind == "brace_open":
            child: dict = {}
            _append(stack[-1], pending_key, child)
            stack.append(child)
            pending_key = None
        elif kind == "brace_close":
            stack.pop()
        elif kind == "key":
            if pending_key is not None:
                # bare enum/bool value for the previous key (`pool: MAX`,
                # `frozen: true`)
                _append(stack[-1], pending_key, _coerce(raw))
                pending_key = None
            else:
                pending_key = raw
        else:  # string / number value
            _append(stack[-1], pending_key, _coerce(raw))
            pending_key = None
    return stack[0]


def _append(msg: dict, key: str | None, value: Any) -> None:
    if key is None:
        raise ValueError("value without a key in prototxt")
    if key in msg:
        if not isinstance(msg[key], list):
            msg[key] = [msg[key]]
        msg[key].append(value)
    else:
        msg[key] = value


def as_list(value) -> list:
    if value is None:
        return []
    return value if isinstance(value, list) else [value]


def load_net(path: str) -> dict:
    """Parse a deploy prototxt; returns the message with `layer` as a list."""
    with open(path) as f:
        msg = parse(f.read())
    msg["layer"] = as_list(msg.get("layer"))
    return msg
