"""The port's own YAML reader and writer, for the subset the repo's configs use.

The card's machine has no PyYAML, so ``BaseConfig.from_yaml``, ``save_yaml``,
``ConfigManager`` and the cost profiler's write-back read and write YAML here.
:func:`load` gives what ``yaml.safe_load`` gives on:

- block mappings and block sequences (of scalars, of mappings, of sequences;
  a sequence may sit at its key's indentation, as ``stages:`` in
  ``configs/cascade.yaml`` does);
- flow sequences on one line (``[2, 3]``, nested, ``[]``) and the empty flow
  mapping ``{}``;
- plain, single-quoted and double-quoted scalars on one line;
- comments;
- YAML 1.1 typing of plain scalars as PyYAML's resolver does it: null, bool
  (``yes``/``no``/``on``/``off`` included), int (binary, octal, hex,
  underscores, base 60) and float (a dot is required: ``1e5`` is a string).

Anything else (anchors, aliases, tags, block scalars ``|`` and ``>``,
multi-line scalars, flow mappings with entries, complex keys, merge keys,
timestamps, documents markers, directives, tabs in indentation) raises
:class:`~adaptive_sd_tpu_torch.core.exceptions.ConfigurationError` naming the
line; the reader never guesses. :func:`dump` writes what :func:`load` and
``yaml.safe_load`` both read back equal (tuples as sequences).
"""

from __future__ import annotations

import math
import re
from typing import Any

from ..core.exceptions import ConfigurationError

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1), written out.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
                        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
                        r":[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$")
# characters PyYAML accepts in a stream (reader.py NON_PRINTABLE's complement)
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010FFFF]")
_BOOL_VALUES = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these (``-``, ``?`` and ``:`` only before a space)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_FLOW_STOP = set(",[]{}")


def _error(lineno: int, msg: str) -> ConfigurationError:
    return ConfigurationError(f"YAML line {lineno}: {msg}", details={"line": lineno})


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _resolve_plain(text: str, lineno: int = 0) -> Any:
    """The value of a plain scalar, typed as PyYAML types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        try:
            if v == "0":
                return 0
            if v.startswith("0b"):
                return sign * int(v[2:], 2)
            if v.startswith("0x"):
                return sign * int(v[2:], 16)
            if v[0] == "0":
                return sign * int(v, 8)
            if ":" in v:
                return sign * _sexagesimal(v, int)
            return sign * int(v)
        except ValueError as exc:
            raise _error(lineno, f"bad integer {text!r}") from exc
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise _error(lineno, f"timestamps are outside the supported subset: {text!r}")
    if text in ("=", "<<"):
        raise _error(lineno, f"{text!r} (a YAML 1.1 value or merge key) is outside the subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no, self.indent, self.text = no, indent, text


def _lines(text: str) -> list:
    out = []
    if text.startswith("\ufeff"):
        text = text[1:]
    for no, raw in enumerate(re.split(r"\r\n|\r|\n", text), start=1):
        bad = _NON_PRINTABLE.search(raw)
        if bad:
            raise _error(no, f"non-printable character {bad.group()!r}")
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise _error(no, "a tab in the indentation")
        if indent == 0 and (re.match(r"(?:---|\.\.\.)(?:\s|$)", body) or body[0] == "%"):
            raise _error(no, "document markers and directives are outside the subset")
        out.append(_Line(no, indent, body.rstrip(" \t")))
    return out


# -- scalars on one line -------------------------------------------------------


def _quoted(s: str, pos: int, no: int) -> tuple:
    """The quoted scalar starting at ``s[pos]``: (text, position after it)."""
    quote, i, out = s[pos], pos + 1, []
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s.startswith("''", i):
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= len(s):
                raise _error(no, "a double-quoted scalar continues on the next line")
            e = s[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise _error(no, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise _error(no, f"unknown escape \\{e}")
            continue
        out.append(c)
        i += 1
    raise _error(no, "a quoted scalar continues on the next line (outside the subset)")


def _check_plain_start(s: str, pos: int, no: int) -> None:
    c = s[pos]
    nxt = s[pos + 1] if pos + 1 < len(s) else " "
    if c in _INDICATORS and not (c in "-?:" and nxt not in " \t"):
        raise _error(no, f"{c!r} cannot start a plain scalar here (outside the subset)")


def _plain_end(s: str, pos: int, flow: bool) -> int:
    """Where a plain scalar starting at ``pos`` ends: before ``: ``, `` #``,
    the end of the line, or (in a flow sequence) a flow indicator."""
    i = pos
    while i < len(s):
        c = s[i]
        if c == ":" and (i + 1 == len(s) or s[i + 1] in " \t" or (flow and s[i + 1] in _FLOW_STOP)):
            return i
        if c == "#" and s[i - 1] in " \t":
            return i
        if flow and c in _FLOW_STOP:
            return i
        i += 1
    return i


def _skip(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] in " \t":
        pos += 1
    return pos


def _end_of_line(s: str, pos: int, no: int) -> None:
    """Only blanks and a comment may follow a complete value."""
    j = _skip(s, pos)
    if j < len(s) and s[j] != "#":
        raise _error(no, f"unexpected {s[j:]!r} after a value")


def _flow(s: str, pos: int, no: int) -> tuple:
    """The flow collection starting at ``s[pos]``: ``[...]`` (nested, of
    scalars) or ``{}``. Returns (value, position after it)."""
    if s[pos] == "{":
        j = _skip(s, pos + 1)
        if j < len(s) and s[j] == "}":
            return {}, j + 1
        raise _error(no, "flow mappings with entries are outside the subset")
    items, i = [], _skip(s, pos + 1)
    while True:
        if i >= len(s):
            raise _error(no, "a flow sequence continues on the next line (outside the subset)")
        if s[i] == "]":
            return items, i + 1
        if s[i] in "[{":
            item, i = _flow(s, i, no)
        elif s[i] in "'\"":
            item, i = _quoted(s, i, no)
        else:
            if s[i] in ",#":
                raise _error(no, "an empty entry in a flow sequence")
            _check_plain_start(s, i, no)
            end = _plain_end(s, i, flow=True)
            text = s[i:end].rstrip(" \t")
            if (end < len(s) and s[end] in ":#") or "?" in text:
                raise _error(no, "mappings, '?' and comments inside a flow sequence are "
                                 "outside the subset")
            item, i = _resolve_plain(text, no), end
        items.append(item)
        i = _skip(s, i)
        if i < len(s) and s[i] == ",":
            i = _skip(s, i + 1)
        elif i < len(s) and s[i] != "]":
            raise _error(no, f"expected ',' or ']' in a flow sequence, got {s[i:]!r}")


def _inline_value(s: str, pos: int, no: int) -> Any:
    """A value that fills the rest of its line."""
    c = s[pos]
    if c in "[{":
        value, end = _flow(s, pos, no)
    elif c in "'\"":
        value, end = _quoted(s, pos, no)
    else:
        _check_plain_start(s, pos, no)
        end = _plain_end(s, pos, flow=False)
        if end < len(s) and s[end] == ":":
            raise _error(no, "a mapping value is not allowed here")
        value = _resolve_plain(s[pos:end].rstrip(" \t"), no)
    _end_of_line(s, end, no)
    return value


def _entry(s: str, no: int):
    """(key, position of the value) when the line is a mapping entry, else None."""
    if s[0] in "'\"":
        key, end = _quoted(s, 0, no)
        j = _skip(s, end)
        if j < len(s) and s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \t"):
            return key, j + 1
        return None
    if s[0] in "[{" or (s[0] == "?" and s[1:2] in ("", " ")):
        return None
    end = _plain_end(s, 0, flow=False)
    if end == len(s) or s[end] != ":":
        return None
    if end == 0:
        raise _error(no, "an empty key is outside the subset")
    _check_plain_start(s, 0, no)
    return _resolve_plain(s[:end].rstrip(" \t"), no), end + 1


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


# -- blocks --------------------------------------------------------------------


class _Parser:
    def __init__(self, lines: list) -> None:
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        """The block node whose first line is the current line, at ``indent``."""
        line = self.peek()
        if _is_seq_item(line.text):
            return self.sequence(indent)
        if _entry(line.text, line.no) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _inline_value(line.text, 0, line.no)
        nxt = self.peek()
        if nxt is not None and nxt.indent >= indent:
            raise _error(nxt.no, "a multi-line scalar is outside the subset")
        return value

    def nested(self, parent: _Line, allow_same_indent_seq: bool) -> Any:
        """The value of a key or dash with nothing after it on its line."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt.indent > parent.indent:
            return self.node(nxt.indent)
        if allow_same_indent_seq and nxt.indent == parent.indent and _is_seq_item(nxt.text):
            return self.sequence(nxt.indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            entry = _entry(line.text, line.no)
            if entry is None:
                raise _error(line.no, "expected a 'key: value' entry")
            key, pos = entry
            try:
                hash(key)
            except TypeError:
                raise _error(line.no, "unhashable key") from None
            self.i += 1
            pos = _skip(line.text, pos)
            if pos == len(line.text) or line.text[pos] == "#":
                out[key] = self.nested(line, allow_same_indent_seq=True)
            else:
                if _is_seq_item(line.text[pos:]):
                    raise _error(line.no, "a block sequence cannot start after a key on one line")
                out[key] = _inline_value(line.text, pos, line.no)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise _error(nxt.no, "a multi-line value is outside the subset")

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if not _is_seq_item(line.text):
                if _entry(line.text, line.no) is not None:
                    return out    # the mapping that holds this sequence goes on
                raise _error(line.no, "expected a '- ' sequence entry")
            rest = line.text[1:]
            pos = _skip(rest, 0)
            if pos == len(rest) or rest[pos] == "#":
                self.i += 1
                out.append(self.nested(line, allow_same_indent_seq=False))
                continue
            # the entry's content starts a block of its own at its column
            col = line.indent + 1 + pos
            self.lines[self.i] = _Line(line.no, col, rest[pos:])
            out.append(self.node(col))


def load(text: str) -> Any:
    """``yaml.safe_load`` of ``text`` for documents of the subset above;
    raises ConfigurationError (with the line) for anything else."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    value = p.node(lines[0].indent)
    if p.peek() is not None:
        raise _error(p.peek().no, "unexpected content after the document")
    return value


# -- writing -------------------------------------------------------------------

_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_./()+$^~=<][A-Za-z0-9_./()+$^~=<> -]*$")


def _quote(s: str) -> str:
    out = ['"']
    for c in s:
        if c == '"' or c == "\\":
            out.append("\\" + c)
        elif c in "\n\t\r":
            out.append({"\n": "\\n", "\t": "\\t", "\r": "\\r"}[c])
        elif _NON_PRINTABLE.match(c) or c in "\x85\u2028\u2029\ufeff":
            n = ord(c)
            out.append(f"\\x{n:02x}" if n < 0x100 else f"\\u{n:04x}" if n < 0x10000
                       else f"\\U{n:08x}")
        else:
            out.append(c)
    out.append('"')
    return "".join(out)


def _plain_is_str(v: str) -> bool:
    """Whether ``v`` written plain reads back as the same string."""
    if not _SAFE_PLAIN.match(v) or v.endswith(" ") or v.startswith("-"):
        return False
    if _TIMESTAMP.match(v) or v in ("=", "<<"):
        return False
    return isinstance(_resolve_plain(v), str)


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:   # 1e-05 -> 1.0e-05: PyYAML's float needs a dot
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        return v if _plain_is_str(v) else _quote(v)
    raise ConfigurationError(f"cannot write a {type(v).__name__} as YAML")


def _dump(v: Any, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _scalar(k)
            if isinstance(item, dict) and item:
                out.append(f"{pad}{key}:")
                _dump(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(f"{pad}{key}:")
                _dump(item, indent, out)      # a sequence at its key's indentation
            else:
                out.append(f"{pad}{key}: {_inline(item)}")
    else:
        for item in v:
            if isinstance(item, (dict, list, tuple)) and item:
                sub: list = []
                _dump(item, indent + 2, sub)
                sub[0] = f"{pad}- {sub[0][indent + 2:]}"
                out.extend(sub)
            else:
                out.append(f"{pad}- {_inline(item)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(value: Any) -> str:
    """YAML text of ``value`` (dicts in their order, lists and tuples as
    sequences, scalars) that :func:`load` and ``yaml.safe_load`` both read
    back equal."""
    if isinstance(value, (dict, list, tuple)) and value:
        out: list = []
        _dump(value, 0, out)
        return "\n".join(out) + "\n"
    return _inline(value) + "\n"
