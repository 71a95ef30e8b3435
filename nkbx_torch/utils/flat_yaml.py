"""A reader of the flat YAML subset that ultralytics data files use, for
machines without PyYAML.

Top-level ``key: value`` lines; a value is a scalar (int, float, bool,
null, a quoted or bare string), a flow list ``[a, b]`` or a flow mapping
``{0: cat, 1: dog}``; a key with no value takes the indented lines under
it, either ``i: name`` entries (a mapping) or ``- item`` entries (a list).
Comments (``#`` at the start or after a space) are dropped. Anything else
raises ValueError rather than being read wrongly.
"""

from __future__ import annotations

import re

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    return text


def _value(text: str):
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    if text.startswith("{") and text.endswith("}"):
        inner = text[1:-1].strip()
        return dict(_pair(v) for v in inner.split(",")) if inner else {}
    if text[:1] in "[{":
        raise ValueError(f"unsupported YAML value (a flow collection over lines?): {text!r}")
    return _scalar(text)


def _pair(text: str):
    key, sep, value = text.partition(":")
    if not sep:
        raise ValueError(f"unsupported YAML mapping entry: {text!r}")
    return _scalar(key), _scalar(value)


def parse_flat_yaml(text: str) -> dict:
    """The mapping of a flat YAML document (see the module docstring)."""
    out, key = {}, None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        body = line.strip()
        if line[0] in " \t":
            if key is None or (out[key] is not None and not isinstance(out[key], (list, dict))):
                raise ValueError(f"unsupported YAML line (indented under a scalar): {raw!r}")
            if body.startswith("- ") or body == "-":
                if out[key] is None:
                    out[key] = []
                out[key].append(_scalar(body[1:]))
            else:
                if out[key] is None:
                    out[key] = {}
                k, v = _pair(body)
                out[key][k] = v
            continue
        k, sep, v = body.partition(":")
        if not sep or not k.strip():
            raise ValueError(f"unsupported YAML line: {raw!r}")
        key = k.strip()
        out[key] = _value(v) if v.strip() else None
    return out


def load_yaml(path) -> dict:
    """A data YAML: through PyYAML's ``safe_load`` where it imports, else
    :func:`parse_flat_yaml`."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return parse_flat_yaml(text)
    return yaml.safe_load(text)
