"""A reader for the YAML subset that the repository's configs use.

The card machines have no ``pyyaml``, so the port's CLIs read their configs
with this module. The subset:

- block mappings (``key: value``, ``key:`` followed by a more indented block,
  or by a block sequence at the key's own indentation);
- block sequences of scalars (``- value``);
- the empty flow list ``[]``;
- comments (whole lines, and `` #`` after a value) and blank lines;
- plain, single-quoted and double-quoted scalars.

Plain scalars resolve as PyYAML's ``safe_load`` resolves them, in the forms
the configs use: ``null`` and the empty value, ``true`` and ``false``, decimal
integers and floats with a dot (``1.0e-05`` is a float). Every other plain
form that ``safe_load`` would not load as a string (``yes``, ``~``, octal,
``.inf``, ``1e-05``, timestamps, ...) raises, as does anything outside the
subset — anchors, aliases, tags, flow mappings, flow sequences other than
``[]``, block scalars, multi-line scalars, escapes in double-quoted scalars,
document markers, directives, sequences of mappings. The error names the
line, so the reader never returns something that differs from ``safe_load``.
"""

import re
from typing import Any, List, Optional, Tuple

_CONSTANTS = {"": None, "null": None, "true": True, "false": False}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# A superset of the other plain forms that PyYAML's resolvers (yaml/resolver.py)
# turn into something else than a string: other numbers, .inf/.nan, timestamps,
# the YAML 1.1 booleans and nulls, the merge and value keys.
_REFUSED = re.compile(r"^(?:[-+]?\.?[0-9].*|[-+]?\.(?:inf|nan)|yes|no|on|off|true|false"
                      r"|null|~|<<|=)$", re.IGNORECASE)


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _error(line_number: int, message: str) -> ValueError:
    return ValueError(f"line {line_number}: {message} (outside the YAML subset that "
                      f"artspeech_tpu_torch.cli.config_file reads)")


def _plain(text: str, number: int) -> Any:
    """A plain scalar, resolved as ``yaml.safe_load`` resolves it."""
    if text in _CONSTANTS:
        return _CONSTANTS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _REFUSED.match(text):
        raise _error(number, f"the scalar {text!r} would not load as a string")
    if text[0] in "-?:,[]{}#&*!|>'\"%@`" and not (text[0] in "-?:" and len(text) > 1
                                                  and text[1] != " "):
        raise _error(number, f"a plain scalar cannot start with {text[0]!r}")
    if ": " in text or text.endswith(":") or " #" in text or "\t" in text:
        raise _error(number, f"unexpected ':' or '#' in the scalar {text!r}")
    return text


def _quoted(text: str, number: int) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text``; returns (value, rest)."""
    quote = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if ch == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == "\\":
            raise _error(number, "escapes in a double-quoted scalar")
        out.append(ch)
        i += 1
    raise _error(number, "a quoted scalar must end on its line")


def _strip_comment(text: str) -> str:
    """Drop a trailing `` # comment`` (the text holds no quotes)."""
    at = text.find(" #")
    return (text[:at] if at >= 0 else text).rstrip()


def _value(text: str, number: int) -> Any:
    """The scalar (or ``[]``) that makes up the rest of a line."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, number)
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            raise _error(number, f"text after a quoted scalar: {rest!r}")
        return value
    text = _strip_comment(text)
    if text.startswith("[") or text.startswith("{"):
        if re.fullmatch(r"\[\s*\]", text):
            return []
        raise _error(number, f"flow collection {text!r} (only the empty list [] is read)")
    if text[:1] in ("&", "*", "!"):
        raise _error(number, "anchors, aliases and tags")
    if text[:1] in ("|", ">"):
        raise _error(number, "block scalars")
    return _plain(text, number)


def _split_key(text: str, number: int) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (key, rest); None when the line is not a mapping entry."""
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, number)
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:].strip()
        return None
    match = re.match(r"^([^#]*?):(?: |$)", text)
    if match is None:
        return None
    key_text = match.group(1).rstrip()
    if not key_text or key_text[0] in "?&*!|>[]{},%@`":
        raise _error(number, f"complex or decorated key {key_text!r}")
    return _plain(key_text, number), text[match.end():].strip()


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.pos = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if line.text.startswith("- ") or line.text == "-":
            return self.sequence(line.indent)
        if _split_key(line.text, line.number) is not None:
            return self.mapping(line.indent)
        self.pos += 1
        value = _value(line.text, line.number)
        following = self.peek()
        if following is not None and following.indent > indent:
            raise _error(following.number, "a scalar continued on the next line")
        return value

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return items
            if line.indent > indent:
                raise _error(line.number, "unexpected indentation")
            if not (line.text.startswith("- ") or line.text == "-"):
                return items
            self.pos += 1
            rest = line.text[1:].strip()
            if rest.startswith("-") and (len(rest) == 1 or rest[1] == " ") \
                    or _split_key(rest, line.number) is not None:
                raise _error(line.number, "sequences of sequences or of mappings")
            if not rest or rest.startswith("#"):
                following = self.peek()
                if following is not None and following.indent > indent:
                    raise _error(following.number, "block collections inside a sequence")
                items.append(None)
            else:
                items.append(_value(rest, line.number))
                following = self.peek()
                if following is not None and following.indent > indent:
                    raise _error(following.number, "a scalar continued on the next line")

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.number, "unexpected indentation")
            if line.text.startswith("- ") or line.text == "-":
                raise _error(line.number, "a sequence entry inside a mapping")
            entry = _split_key(line.text, line.number)
            if entry is None:
                raise _error(line.number, f"expected 'key: value', got {line.text!r}")
            key, rest = entry
            self.pos += 1
            if rest and not rest.startswith("#"):
                out[key] = _value(rest, line.number)
                following = self.peek()
                if following is not None and following.indent > indent:
                    raise _error(following.number, "a scalar continued on the next line")
                continue
            following = self.peek()
            if following is None or following.indent < indent:
                out[key] = None
            elif following.indent > indent:
                out[key] = self.block(following.indent)
            elif following.text.startswith("- ") or following.text == "-":
                out[key] = self.sequence(indent)  # "key:" then "- item" at the same indent
            else:
                out[key] = None


def loads(text: str) -> Any:
    """Parse a config's text; ``yaml.safe_load(text)`` for the subset."""
    lines = []
    for number, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            raise _error(number, "tabs in indentation")
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith(("---", "...", "%")):
            raise _error(number, "document markers and directives")
        lines.append(_Line(number, len(raw) - len(raw.lstrip(" ")), stripped))
    if not lines:
        return None
    parser = _Parser(lines)
    result = parser.block(lines[0].indent)
    leftover = parser.peek()
    if leftover is not None:
        raise _error(leftover.number, "text after the document's top-level block")
    return result


def load(path: str) -> Any:
    """Read the config file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
