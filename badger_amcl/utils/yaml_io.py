"""A small YAML reader and writer for the documents this system uses.

The node reads flat launch configs (examples/amcl_2d.yaml, amcl_3d.yaml)
and reads and writes the saved-pose document (node/persistence.py),
including the reference's legacy `state:` layout. Those need block
mappings and sequences, one-line or wrapped flow collections (`[a, b]`,
`{k: v}`), comments, quoted strings and the YAML 1.1 scalar types (null,
bool, int, float with .inf/.nan; an exponent without a dot, `1e-3`, is a
float, as in YAML 1.2 and yaml-cpp, where PyYAML reads a string). Node
tags (`!!python/object/...`, as old Python dumps of ROS messages carry)
are read and ignored, as the reference's yaml-cpp reader ignores them. Anchors, aliases, block scalars
(`|`, `>`) and multi-document streams are rejected with `YAMLError`.

`dumps` writes block style that this reader, PyYAML and yaml-cpp all read
back to the same values.
"""

from __future__ import annotations

import math
import re


class YAMLError(ValueError):
    """Malformed or unsupported YAML."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(
    r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
_UNSUPPORTED_START = set("&*|>%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\"}


def _plain(text: str):
    """Resolve a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text[0] in _UNSUPPORTED_START:
        raise YAMLError(f"unsupported YAML construct: {text!r}")
    return text


def _strip_tag(text: str) -> str:
    if text.startswith("!"):
        return text.split(" ", 1)[1].lstrip() if " " in text else ""
    return text


class _Flow:
    """Parser for one flow value (scalar, [sequence] or {mapping})."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def _peek(self):
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse_all(self):
        value = self.value(in_flow=False)
        if self._peek():
            raise YAMLError(f"trailing text after value: {self.s!r}")
        return value

    def value(self, in_flow=True, is_key=False):
        c = self._peek()
        if c == "!":
            end = self.s.find(" ", self.i)
            self.i = len(self.s) if end < 0 else end
            c = self._peek()
        if c == "[":
            self.i += 1
            out = []
            while self._peek() != "]":
                if not self._peek():
                    raise YAMLError(f"unclosed flow sequence: {self.s!r}")
                out.append(self.value())
                if self._peek() == ",":
                    self.i += 1
                elif self._peek() != "]":
                    raise YAMLError(f"expected ',' or ']': {self.s!r}")
            self.i += 1
            return out
        if c == "{":
            self.i += 1
            out = {}
            while self._peek() != "}":
                if not self._peek():
                    raise YAMLError(f"unclosed flow mapping: {self.s!r}")
                key = self.value(is_key=True)
                if self._peek() != ":":
                    raise YAMLError(f"expected ':' in flow mapping: {self.s!r}")
                self.i += 1
                out[key] = None if self._peek() in (",", "}") else self.value()
                if self._peek() == ",":
                    self.i += 1
                elif self._peek() != "}":
                    raise YAMLError(f"expected ',' or '}}': {self.s!r}")
            self.i += 1
            return out
        if c in ("'", '"'):
            return self.quoted(c)
        return self.plain(in_flow, is_key)

    def quoted(self, q):
        s, i, out = self.s, self.i + 1, []
        while True:
            if i >= len(s):
                raise YAMLError(f"unclosed quoted string: {s!r}")
            ch = s[i]
            if q == "'" and ch == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            if q == '"' and ch == '"':
                break
            if q == '"' and ch == "\\":
                esc = s[i + 1:i + 2]
                if esc in ("x", "u", "U"):
                    width = {"x": 2, "u": 4, "U": 8}[esc]
                    try:
                        out.append(chr(int(s[i + 2:i + 2 + width], 16)))
                    except ValueError:
                        raise YAMLError(f"bad escape in {s!r}") from None
                    i += 2 + width
                    continue
                if esc not in _ESCAPES:
                    raise YAMLError(f"bad escape in {s!r}")
                out.append(_ESCAPES[esc])
                i += 2
                continue
            out.append(ch)
            i += 1
        self.i = i + 1
        return "".join(out)

    def plain(self, in_flow, is_key):
        s, start, i = self.s, self.i, self.i
        while i < len(s):
            ch = s[i]
            if in_flow and ch in ",[]{}":
                break
            if ch == ":" and (i + 1 == len(s) or s[i + 1] == " "
                              or (in_flow and s[i + 1] in ",[]{}")):
                if is_key:
                    break
                raise YAMLError(f"mapping value not allowed here: {s!r}")
            i += 1
        self.i = i
        text = s[start:i].strip()
        if not text and in_flow:
            raise YAMLError(f"empty flow entry: {s!r}")
        return _plain(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(content: str):
    """'key: rest' -> (key, rest), or None when content is not a mapping
    entry."""
    flow = _Flow(content)
    if content[0] in "[{":
        return None
    try:
        key = flow.value(in_flow=False, is_key=True)
    except YAMLError:
        return None
    if flow.i >= len(content) or content[flow.i] != ":":
        # quoted keys end at the quote; allow spaces before ':'
        flow._ws()
        if flow.i >= len(content) or content[flow.i] != ":":
            return None
    rest = content[flow.i + 1:]
    if rest and rest[0] != " ":
        return None
    return key, rest.strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Block:
    def __init__(self, text: str):
        self.lines = []
        ended = False
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs are not allowed in indentation")
            line = _strip_comment(raw).rstrip()
            content = line.lstrip(" ")
            if not content:
                continue
            if ended or (content == "---" and self.lines):
                raise YAMLError("multi-document streams are unsupported")
            if content in ("---", "...") and not raw.startswith(" "):
                ended = content == "..."
                continue
            self.lines.append([len(line) - len(content), content])
        # a tag alone on the document's first line names the root's type
        if self.lines and self.lines[0][1].startswith("!") \
                and " " not in self.lines[0][1]:
            self.lines.pop(0)

    def parse(self):
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0][0])
        if i != len(self.lines):
            raise YAMLError(f"bad indentation at {self.lines[i][1]!r}")
        return value

    def block(self, i, indent):
        content = self.lines[i][1]
        if _is_item(content):
            return self.sequence(i, indent)
        if _split_key(content) is None:
            value, i = self.inline(i, content)
            return value, i
        return self.mapping(i, indent)

    def inline(self, i, text):
        """A value that starts on line i: a scalar, or a flow collection
        that may continue over the following lines."""
        text = _strip_tag(text)
        if text[:1] in ("[", "{"):
            depth = _depth(text)
            while depth > 0 and i + 1 < len(self.lines):
                i += 1
                more = self.lines[i][1]
                text += " " + more
                depth += _depth(more)
        return _Flow(text).parse_all(), i + 1

    def nested(self, i, indent, text):
        """The value of an entry whose text after ':' or '-' is `text`."""
        text = _strip_tag(text)
        if text:
            return self.inline(i, text)
        nxt = i + 1
        if nxt < len(self.lines) and self.lines[nxt][0] > indent:
            return self.block(nxt, self.lines[nxt][0])
        return None, nxt

    def sequence(self, i, indent):
        out = []
        while i < len(self.lines) and self.lines[i][0] == indent \
                and _is_item(self.lines[i][1]):
            content = self.lines[i][1]
            rest = content[1:].lstrip(" ")
            col = indent + len(content) - len(rest)
            if rest and (_is_item(rest) or _split_key(rest) is not None):
                # compact nested block: "- - a" or "- key: value"
                self.lines[i] = [col, rest]
                value, i = self.block(i, col)
            else:
                value, i = self.nested(i, indent, rest)
            out.append(value)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise YAMLError(f"bad indentation at {self.lines[i][1]!r}")
        return out, i

    def mapping(self, i, indent):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            kv = _split_key(self.lines[i][1])
            if kv is None:
                raise YAMLError(f"expected 'key: value', got {self.lines[i][1]!r}")
            key, rest = kv
            nxt = i + 1
            if not _strip_tag(rest) and nxt < len(self.lines) \
                    and self.lines[nxt][0] == indent \
                    and _is_item(self.lines[nxt][1]):
                value, i = self.sequence(nxt, indent)  # "key:\n- a"
            else:
                value, i = self.nested(i, indent, rest)
            try:
                out[key] = value  # last one wins, as in PyYAML
            except TypeError:
                raise YAMLError(f"unhashable mapping key {key!r}") from None
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise YAMLError(f"bad indentation at {self.lines[i][1]!r}")
        return out, i


def _depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def loads(text: str):
    """Parse one YAML document. Raises YAMLError on malformed input."""
    return _Block(text).parse()


def load_file(path: str):
    with open(path) as f:
        return loads(f.read())


# --------------------------------------------------------------- writing


def _scalar(v) -> str:
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
        text = repr(float(v)).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # read back as float by all
        return text
    if isinstance(v, str):
        try:
            plain_ok = _plain(v) == v and v == v.strip() \
                and v[0] not in "-?:,[]{}#'\"!" \
                and ": " not in v and " #" not in v and not v.endswith(":") \
                and all(ch.isprintable() for ch in v)
        except (YAMLError, IndexError):
            plain_ok = False
        if plain_ok:
            return v
        return '"' + "".join(_escape(ch) for ch in v) + '"'
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _escape(ch: str) -> str:
    if ch in ('"', "\\"):
        return "\\" + ch
    if ch.isprintable():
        return ch
    return f"\\u{ord(ch):04x}" if ord(ch) <= 0xFFFF else f"\\U{ord(ch):08x}"


def _lines(v, indent: int):
    pad = " " * indent
    if isinstance(v, dict):
        if not v:
            return [pad + "{}"]
        out = []
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, (dict, list)) and x:
                out.append(f"{pad}{key}:")
                out.extend(_lines(x, indent + 2))
            else:
                out.append(f"{pad}{key}: {_inline(x)}")
        return out
    if isinstance(v, (list, tuple)):
        if not v:
            return [pad + "[]"]
        out = []
        for x in v:
            if isinstance(x, (dict, list, tuple)) and x:
                sub = _lines(x, indent + 2)
                sub[0] = pad + "- " + sub[0][indent + 2:]
                out.extend(sub)
            else:
                out.append(f"{pad}- {_inline(x)}")
        return out
    return [pad + _scalar(v)]


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dumps(obj) -> str:
    """Block-style YAML for nested dicts/lists of None, bool, int, float and
    str."""
    return "\n".join(_lines(obj, 0)) + "\n"
