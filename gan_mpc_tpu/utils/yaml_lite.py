"""Reader and writer for the YAML subset the configs use.

The subset: block mappings and block sequences (a sequence may sit at
its key's own indentation, and its items may be mappings), flow
sequences ``[a, b]`` and flow mappings ``{k: v}`` that may span lines,
comments, single- and double-quoted strings, and plain scalars resolved
as YAML 1.1 resolves them (PyYAML's ``safe_load``): null, bool, int,
float, else string. Anchors, tags, multi-line strings and multiple
documents are not part of it and raise ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Any

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(
    r"[-+]?(0|[1-9][0-9_]*)$|[-+]?0b[01_]+$|[-+]?0x[0-9a-fA-F_]+$|[-+]?0[0-7_]+$"
)
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|[-+]?\.(inf|Inf|INF)$|\.(nan|NaN|NAN)$"
)


def _scalar(text: str) -> Any:
    """A plain scalar, resolved as YAML 1.1 does."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith("nan"):
            return math.nan
        return float(t)
    if text[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML syntax: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is outside quotes and starts the line or
    follows whitespace."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent parser for one flow node or plain scalar."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def parse_all(self) -> Any:
        value = self.node(top=True)
        self._skip()
        if self.pos != len(self.text):
            raise ValueError(f"trailing text in YAML value {self.text!r}")
        return value

    def node(self, top=False) -> Any:
        self._skip()
        ch = self.text[self.pos] if self.pos < len(self.text) else ""
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            return self._quoted(ch)
        stop = "" if top else ",]}"
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in stop:
            if not top and self.text.startswith(": ", self.pos):
                break
            self.pos += 1
        return _scalar(self.text[start:self.pos].strip())

    def _quoted(self, q: str) -> str:
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise ValueError(f"unterminated string in {self.text!r}")
            ch = self.text[self.pos]
            if ch == q:
                if q == "'" and self.text.startswith("''", self.pos):
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                nxt = self.text[self.pos + 1]
                out.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
                self.pos += 2
                continue
            out.append(ch)
            self.pos += 1

    def _expect(self, ch: str):
        self._skip()
        if not self.text.startswith(ch, self.pos):
            raise ValueError(f"expected {ch!r} in YAML value {self.text!r}")
        self.pos += 1

    def _seq(self) -> list:
        self.pos += 1
        out = []
        self._skip()
        if self.text.startswith("]", self.pos):
            self.pos += 1
            return out
        while True:
            out.append(self.node())
            self._skip()
            if self.text.startswith("]", self.pos):
                self.pos += 1
                return out
            self._expect(",")

    def _map(self) -> dict:
        self.pos += 1
        out = {}
        self._skip()
        if self.text.startswith("}", self.pos):
            self.pos += 1
            return out
        while True:
            key = self.node()
            self._skip()
            if self.text.startswith(":", self.pos):
                self.pos += 1
                out[key] = self.node()
            else:
                out[key] = None
            self._skip()
            if self.text.startswith("}", self.pos):
                self.pos += 1
                return out
            self._expect(",")


def _value(text: str) -> Any:
    return _Flow(text).parse_all()


def _split_key(text: str):
    """``key: value`` -> (key, value); None when ``text`` is no mapping
    entry."""
    if text[0] in "'\"":
        flow = _Flow(text)
        key = flow._quoted(text[0])
        rest = text[flow.pos:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"([^'\"{\[#][^#]*?):(\s+|$)", text)
    if not m:
        return None
    return _scalar(m.group(1).strip()), text[m.end():].strip()


def _logical_lines(text: str):
    """(indent, content) per line, comments dropped, flow collections
    that span lines joined into one."""
    lines = []
    pending, depth = None, 0
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            raise ValueError("multiple YAML documents are not supported")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if pending is not None:
            pending[1] += " " + line.strip()
        else:
            pending = [len(line) - len(line.lstrip(" ")), line.strip()]
        depth += sum(line.count(c) for c in "[{") - sum(
            line.count(c) for c in "]}"
        )
        if depth <= 0:
            lines.append(tuple(pending))
            pending, depth = None, 0
    if pending is not None:
        raise ValueError("unterminated flow collection")
    return lines


class _Block:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else (-1, "")

    def node(self, indent: int) -> Any:
        ind, text = self.peek()
        if ind < indent or ind == -1:
            return None
        if text == "-" or text.startswith("- "):
            return self.seq(ind)
        if _split_key(text) is not None:
            return self.map(ind)
        self.i += 1
        return _value(text)

    def map(self, indent: int) -> dict:
        out = {}
        while True:
            ind, text = self.peek()
            if ind != indent or text == "-" or text.startswith("- "):
                if ind > indent:
                    raise ValueError(f"bad indentation at {text!r}")
                return out
            entry = _split_key(text)
            if entry is None:
                raise ValueError(f"expected 'key: value', got {text!r}")
            key, rest = entry
            self.i += 1
            if rest:
                out[key] = _value(rest)
                continue
            nind, ntext = self.peek()
            if nind > indent:
                out[key] = self.node(nind)
            elif nind == indent and (ntext == "-" or ntext.startswith("- ")):
                out[key] = self.seq(indent)
            else:
                out[key] = None

    def seq(self, indent: int) -> list:
        out = []
        while True:
            ind, text = self.peek()
            if ind != indent or not (text == "-" or text.startswith("- ")):
                return out
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                nind, _ = self.peek()
                out.append(self.node(nind) if nind > indent else None)
                continue
            # "- key: v" opens a mapping whose entries sit under the key
            item_indent = indent + len(text) - len(rest)
            self.lines[self.i] = (item_indent, rest)
            out.append(self.node(item_indent))


def load(text: str) -> Any:
    """Parse a YAML document of the supported subset."""
    lines = _logical_lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise ValueError(f"unparsed YAML from {lines[block.i][1]!r}")
    return value


# -- writer ---------------------------------------------------------------


def _format_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            mantissa, exp = text.split("e")
            text = f"{mantissa}.0e{exp}"
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(value, str):
        plain_ok = (
            value
            and value == value.strip()
            and isinstance(_scalar_or_none(value), str)
            and not re.search(r"[:#,\[\]{}'\"\n]|^[-?&*!|>%@`]", value)
        )
        return value if plain_ok else "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _scalar_or_none(text: str):
    try:
        return _scalar(text)
    except ValueError:
        return None


def _dump(value: Any, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_format_scalar(key)}:"
            if isinstance(item, (dict, list)) and item:
                out.append(head)
                _dump(item, indent + 2, out)
            else:
                out.append(f"{head} {_flow(item)}")
    elif isinstance(value, list):
        for item in value:
            if isinstance(item, (dict, list)) and item:
                sub: list = []
                _dump(item, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_flow(item)}")
    else:
        out.append(pad + _format_scalar(value))


def _flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{}" if not value else "{" + ", ".join(
            f"{_format_scalar(k)}: {_flow(v)}" for k, v in value.items()
        ) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    return _format_scalar(value)


def dump(value: Any) -> str:
    """Block-style YAML that ``load`` (and PyYAML) read back to ``value``."""
    out: list = []
    if isinstance(value, (dict, list)) and value:
        _dump(value, 0, out)
    else:
        out.append(_flow(value))
    return "\n".join(out) + "\n"
