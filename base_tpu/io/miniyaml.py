"""Reader and writer for the YAML subset the run configurations use.

Supported: nested block maps (indentation by spaces), plain and quoted
scalars, flow lists of scalars (`[U, B, V]`), `{}` and `[]`, and `#`
comments.  Scalars resolve like YAML 1.1 (PyYAML's safe loader) for
null, booleans, decimal integers, floats with a dot, `.inf` and `.nan`;
anything else is a string.  Block lists (`- item`), anchors, tags and
multi-document streams are refused with the line number.
"""
from __future__ import annotations

import math
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$"
)
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return (tok[1:-1].replace('\\"', '"').replace("\\n", "\n")
                .replace("\\\\", "\\"))
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    m = _INF.match(tok)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(tok):
        return math.nan
    return tok


def _split_outside_quotes(text: str, sep: str) -> list[str]:
    parts, cur, quote = [], [], None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == sep:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str, lineno: int):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"line {lineno}: unterminated flow list")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = _split_outside_quotes(inner, ",")
        if any(i.strip()[:1] in ("[", "{") for i in items):
            raise ValueError(f"line {lineno}: nested flow collections")
        return [_scalar(i) for i in items]
    if text.startswith("{"):
        if text.replace(" ", "") != "{}":
            raise ValueError(f"line {lineno}: only empty flow maps ({{}})")
        return {}
    if text[:1] in ("&", "*", "!", "|", ">"):
        raise ValueError(f"line {lineno}: unsupported YAML syntax {text!r}")
    return _scalar(text)


def _split_key(text: str, lineno: int) -> tuple[str, str]:
    quote = None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].strip()
            if key[:1] in ("'", '"'):
                key = _scalar(key)
            return key, text[i + 1:].strip()
    raise ValueError(f"line {lineno}: expected 'key: value', got {text!r}")


def _block(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines):
        ind, text, lineno = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: unexpected indentation")
        if text.startswith("- ") or text == "-":
            raise ValueError(
                f"line {lineno}: block lists are not supported; "
                f"write [a, b, c]"
            )
        key, rest = _split_key(text, lineno)
        pos += 1
        if rest:
            out[key] = _value(rest, lineno)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def loads(text: str):
    """Parse a document; None when it holds no content."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip() or body.strip() == "---":
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise ValueError(f"line {lineno}: tabs are not indentation")
        lines.append((len(body) - len(stripped), stripped, lineno))
    if not lines:
        return None
    doc, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][2]}: unexpected dedent")
    return doc


def _plain_ok(s: str) -> bool:
    return (
        bool(s) and s == s.strip() and isinstance(_scalar(s), str)
        and not any(c in s for c in ":#[]{},'\"&*!|>%@`")
        and not s.startswith("-")
    )


def _dump_scalar(v) -> str:
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
        if "e" in r and "." not in r:
            r = r.replace("e", ".0e")
        return r
    s = str(v)
    return s if _plain_ok(s) else "'" + s.replace("'", "''") + "'"


def dumps(doc: dict, indent: int = 0) -> str:
    """Block-map document; lists are written as flow lists."""
    out = []
    pad = " " * indent
    for k, v in doc.items():
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:\n" + dumps(v, indent + 2))
        elif isinstance(v, dict):
            out.append(f"{pad}{k}: {{}}\n")
        elif isinstance(v, (list, tuple)):
            items = ", ".join(_dump_scalar(x) for x in v)
            out.append(f"{pad}{k}: [{items}]\n")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)
