"""The subset of YAML that the dataset configs use, parsed without PyYAML.

    block maps nested by indentation (spaces only)
    scalars: decimal ints, floats with a dot (exponent with a sign, as in
        `1.5e-3`), `.inf` / `.nan`, single- or double-quoted strings, bare
        strings, true / false, null / ~ / an empty value
    `#` comments, whole-line or after a space
    one-line flow lists of scalars, `[a, b, c]`

Values come out as yaml.full_load gives them (YAML 1.1 rules). Anything
outside the subset raises ValueError naming the line, and so does a token
that YAML 1.1 reads in a way a reader may not expect (`1e-5` and `010` are
strings and an octal int there, `yes` / `on` booleans): the parser never
guesses.
"""
from __future__ import annotations

import re

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"([-+]?[0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
                  ".Inf": float("inf"), "+.Inf": float("inf"), "-.Inf": float("-inf"),
                  ".INF": float("inf"), "+.INF": float("inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False}
_NULL = ("null", "Null", "NULL", "~", "")
# Tokens YAML 1.1 reads as booleans (yes/no/on/off), as numbers of another
# base or form (0b.., 0x.., 010, 1_000, 1:30), or as strings that look like
# numbers (1e-5, 1.0e5, 08, -.5).
_AMBIGUOUS = re.compile(
    r"(y|Y|yes|Yes|YES|n|N|no|No|NO|on|On|ON|off|Off|OFF"
    r"|[-+]?0b[01_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"
    r"|[-+]?[0-9_]*\.?[0-9_]*([eE][-+]?[0-9]+)?)$")
_DOUBLE_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


def _err(lineno: int, msg: str):
    return ValueError(f"yaml_subset: line {lineno}: {msg}")


def _strip_comment(text: str) -> str:
    """The line without its comment: `#` at the start or after whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _quoted(tok: str, lineno: int) -> str:
    q = tok[0]
    if len(tok) < 2 or tok[-1] != q:
        raise _err(lineno, f"unterminated quoted string {tok!r}")
    body = tok[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _err(lineno, f"stray quote in {tok!r}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise _err(lineno, f"stray quote in {tok!r}")
        if ch == "\\":
            esc = body[i + 1: i + 2]
            if esc not in _DOUBLE_ESCAPES:
                raise _err(lineno, f"unsupported escape \\{esc} in {tok!r}")
            out.append(_DOUBLE_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(tok: str, lineno: int):
    tok = tok.strip()
    if tok[:1] in ("'", '"'):
        return _quoted(tok, lineno)
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if tok in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _AMBIGUOUS.match(tok):
        raise _err(lineno, f"{tok!r} is a boolean, a number of another form or a string "
                           "in YAML 1.1; quote it or write it plainly")
    if tok[0] in "&*!|>{}[]%@`,?:" or tok.startswith("- "):
        raise _err(lineno, f"unsupported construct {tok!r}")
    if ": " in tok or tok.endswith(":") or " #" in tok:
        raise _err(lineno, f"unsupported plain scalar {tok!r}")
    return tok


def _flow_list(tok: str, lineno: int) -> list:
    if not tok.endswith("]"):
        raise _err(lineno, f"a flow list must close on its line: {tok!r}")
    body = tok[1:-1].strip()
    if not body:
        return []
    items, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch in "[]{}":
            raise _err(lineno, f"nested flow collections are not supported: {tok!r}")
        elif ch == ",":
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    items.append("".join(cur))
    if any(not it.strip() for it in items):
        raise _err(lineno, f"empty item in flow list {tok!r}")
    return [_scalar(it, lineno) for it in items]


def _split_key(content: str, lineno: int):
    """(key, value text) of a `key: value` line."""
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] == " "):
            key = content[:i].strip()
            if not key:
                raise _err(lineno, "empty key")
            return _scalar(key, lineno), content[i + 1:].strip()
    raise _err(lineno, f"expected `key: value`, got {content!r}")


def _lines(text: str):
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise _err(lineno, "tab in indentation")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        indent = len(content) - len(content.lstrip(" "))
        content = content.strip()
        if content in ("---", "...") or content.startswith(("- ", "%")) or content == "-":
            raise _err(lineno, f"unsupported construct {content!r} (block sequences, "
                               "documents and directives are outside the subset)")
        out.append((lineno, indent, content))
    return out


def _parse_map(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _err(lineno, f"unexpected indentation {ind} (expected {indent})")
        key, rest = _split_key(content, lineno)
        if key in out:
            raise _err(lineno, f"duplicate key {key!r}")
        pos += 1
        if rest:
            out[key] = _flow_list(rest, lineno) if rest.startswith("[") else _scalar(rest, lineno)
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _parse_map(lines, pos, lines[pos][1])
        else:
            out[key] = None
    return out, pos


def loads(text: str) -> dict:
    lines = _lines(text)
    if not lines:
        raise ValueError("yaml_subset: empty document")
    if lines[0][1] != 0:
        raise _err(lines[0][0], "the top-level map must start at column 0")
    out, pos = _parse_map(lines, 0, 0)
    if pos != len(lines):
        raise _err(lines[pos][0], "unexpected indentation")
    return out


def load(path: str) -> dict:
    with open(path, "r") as f:
        try:
            return loads(f.read())
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
