"""A reader for the YAML subset that the repo's configs (``tools/cfgs/``) use.

The subset: block mappings and block sequences (a sequence may sit at its
parent key's indentation), ``#`` comments, flow sequences ``[...]`` and
flow mappings ``{k: v}`` (nested, over several lines, with a trailing
comma), and plain and quoted scalars. Plain scalars resolve as
``yaml.safe_load`` resolves them: booleans (YAML 1.1's ``True``, ``yes``,
``off``, ...), null (``~``, ``null``, nothing), decimal ints, decimal
floats (a dot is required, as in YAML 1.1: ``1e-5`` stays a string) and
strings otherwise. Everything else raises ``YAMLSubsetError``, the reader
does not guess: anchors, aliases, tags, block scalars, directives,
documents, complex and merge keys, multi-line plain scalars, escapes in
double quotes, and the scalars that YAML 1.1 reads as radix, sexagesimal
or ``_``-separated numbers, ``.inf``/``.nan`` or timestamps.
"""

from __future__ import annotations

import re

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
# a superset of the other scalars that YAML 1.1 does not read as strings
_OTHER = re.compile(r"[-+]?\.?[0-9].*[_:]|[-+]?0[0-9bx]|[0-9]{4}-|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)$")
_INDICATORS = "&*!|>%@`?"


class YAMLSubsetError(ValueError):
    """The text uses YAML outside the subset this reader implements."""


def resolve_plain(text):
    """A plain scalar as yaml.safe_load resolves it."""
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _OTHER.match(text) or text in ("<<", "="):
        raise YAMLSubsetError(f"scalar {text!r} is outside the subset (a radix, sexagesimal "
                              "or '_'-separated number, .inf/.nan, a timestamp or a merge key)")
    if text[0] in _INDICATORS or text.startswith(("- ", ": ")) or text in ("-", ":"):
        raise YAMLSubsetError(f"scalar {text!r} starts with an indicator outside the subset")
    return text


# ---------------------------------------------------------------------------
# scalars and flow collections
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, text, where):
        self.text, self.pos, self.where = text, 0, where

    def error(self, msg):
        return YAMLSubsetError(f"{self.where}: {msg} at column {self.pos} of {self.text!r}")

    def skip_space(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""


def _quoted(cur):
    """The quoted scalar at the cursor (the cursor ends after it)."""
    q = cur.peek()
    cur.pos += 1
    out = []
    while True:
        if cur.pos >= len(cur.text):
            raise cur.error("unterminated quoted scalar")
        c = cur.text[cur.pos]
        if c == "\n":
            raise cur.error("multi-line quoted scalar")
        if q == "'" and c == "'":
            if cur.text[cur.pos + 1:cur.pos + 2] == "'":
                out.append("'")
                cur.pos += 2
                continue
            cur.pos += 1
            return "".join(out)
        if q == '"' and c == '"':
            cur.pos += 1
            return "".join(out)
        if q == '"' and c == "\\":
            raise cur.error("escapes are outside the subset")
        out.append(c)
        cur.pos += 1


def _flow_plain(cur):
    start = cur.pos
    while cur.pos < len(cur.text):
        c = cur.text[cur.pos]
        if c in ",[]{}\n":
            break
        if c == ":" and cur.text[cur.pos + 1:cur.pos + 2] in (" ", ",", "]", "}", "\n", ""):
            break
        if c == "#" and cur.text[cur.pos - 1] in " \t":
            raise cur.error("comment inside a flow collection")
        cur.pos += 1
    text = cur.text[start:cur.pos].strip()
    if not text:
        raise cur.error("empty flow entry")
    return resolve_plain(text)


def _flow_node(cur):
    cur.skip_space()
    c = cur.peek()
    if c == "[":
        return _flow_seq(cur)
    if c == "{":
        return _flow_map(cur)
    if c in "'\"":
        return _quoted(cur)
    return _flow_plain(cur)


def _flow_seq(cur):
    cur.pos += 1
    out = []
    while True:
        cur.skip_space()
        if cur.peek() == "]":
            cur.pos += 1
            return out
        item = _flow_node(cur)
        cur.skip_space()
        if cur.peek() == ":":
            raise cur.error("single-pair mapping in a flow sequence")
        out.append(item)
        cur.skip_space()
        c = cur.peek()
        if c == ",":
            cur.pos += 1
        elif c != "]":
            raise cur.error("expected ',' or ']'")


def _flow_map(cur):
    cur.pos += 1
    out = {}
    while True:
        cur.skip_space()
        if cur.peek() == "}":
            cur.pos += 1
            return out
        key = _flow_node(cur)
        cur.skip_space()
        if cur.peek() != ":":
            raise cur.error("flow mapping entry without ':'")
        cur.pos += 1
        cur.skip_space()
        if cur.peek() in (",", "}"):
            value = None
        else:
            value = _flow_node(cur)
        if isinstance(key, (list, dict)):
            raise cur.error("complex mapping key")
        out[key] = value
        cur.skip_space()
        c = cur.peek()
        if c == ",":
            cur.pos += 1
        elif c != "}":
            raise cur.error("expected ',' or '}'")


def _value(text, where):
    """A value written on one (joined) line: flow collection, quoted or
    plain scalar."""
    cur = _Cursor(text, where)
    c = cur.peek()
    if c in "[{'\"":
        v = _flow_node(cur)
        cur.skip_space()
        if cur.pos != len(cur.text):
            raise cur.error("text after a flow collection or quoted scalar")
        return v
    return resolve_plain(text)


# ---------------------------------------------------------------------------
# block structure
# ---------------------------------------------------------------------------


def _strip_comment(line):
    """``line`` without its comment (a '#' at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text):
    """(key text, value text) when ``text`` is a ``key: value`` entry, else
    None. The separator is the first ':' outside quotes and brackets that
    ends the text or precedes a blank."""
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
            continue
        if c in "'\"" and i == 0:
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


class _Lines:
    def __init__(self, text, name):
        self.name = name
        self.items = []  # (line number, indent, content)
        for no, raw in enumerate(text.splitlines(), 1):
            line = _strip_comment(raw)
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
                raise YAMLSubsetError(f"{name}:{no}: tab in indentation")
            if body.startswith(("---", "...", "%")) and (len(body) == 3 or body[3:4] in " "):
                raise YAMLSubsetError(f"{name}:{no}: document markers and directives "
                                      "are outside the subset")
            self.items.append((no, len(line) - len(body), body))
        self.i = 0

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None

    def where(self, no):
        return f"{self.name}:{no}"


def _join_flow(lines, no, text):
    """``text`` plus the following lines until its brackets balance."""
    def balance(s):
        depth, quote = 0, None
        for c in s:
            if quote:
                if c == quote:
                    quote = None
            elif c in "'\"":
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
        return depth

    while balance(text) > 0:
        nxt = lines.peek()
        if nxt is None:
            raise YAMLSubsetError(f"{lines.where(no)}: unterminated flow collection")
        text = text + "\n" + nxt[2]
        lines.i += 1
    return text


def _inline_value(lines, no, text):
    if text[:1] in _INDICATORS:
        raise YAMLSubsetError(f"{lines.where(no)}: {text[:1]!r} (anchor, alias, tag, block "
                              "scalar or reserved indicator) is outside the subset")
    if text[:1] in "[{":
        text = _join_flow(lines, no, text)
    elif text[:1] not in "'\"" and (": " in text or text.endswith(":")):
        raise YAMLSubsetError(f"{lines.where(no)}: a mapping value is not allowed here")
    return _value(text, lines.where(no))


def _check_no_deeper(lines, indent):
    nxt = lines.peek()
    if nxt is not None and nxt[1] > indent:
        raise YAMLSubsetError(f"{lines.where(nxt[0])}: unexpected indentation (multi-line "
                              "plain scalars are outside the subset)")


def _key(lines, no, text):
    if text.startswith("? ") or text == "?":
        raise YAMLSubsetError(f"{lines.where(no)}: complex keys are outside the subset")
    key = _value(text, lines.where(no))
    if isinstance(key, (list, dict)):
        raise YAMLSubsetError(f"{lines.where(no)}: complex mapping key")
    return key


def _block(lines, indent):
    """The block node whose lines start at column ``indent``."""
    no, ind, body = lines.peek()
    if body == "-" or body.startswith("- "):
        return _sequence(lines, ind)
    return _mapping(lines, ind)


def _entry_value(lines, indent, no, text):
    """The value of a mapping entry at ``indent`` whose inline text is
    ``text`` (may be empty: then the block below, a sequence at the key's
    own indentation, or null)."""
    if text:
        v = _inline_value(lines, no, text)
        _check_no_deeper(lines, indent)
        return v
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[1] > indent:
        return _block(lines, nxt[1])
    if nxt[1] == indent and (nxt[2] == "-" or nxt[2].startswith("- ")):
        return _sequence(lines, indent)
    return None


def _mapping(lines, indent, first=None):
    """A block mapping at column ``indent``; ``first`` is an entry already
    taken off a ``- key: value`` sequence line."""
    out = {}
    while True:
        if first is not None:
            no, body = first
            first = None
        else:
            item = lines.peek()
            if item is None or item[1] < indent:
                return out
            no, ind, body = item
            if ind > indent:
                raise YAMLSubsetError(f"{lines.where(no)}: unexpected indentation")
            if body == "-" or body.startswith("- "):
                return out  # a sequence at the parent key's indentation ends here
            lines.i += 1
        kv = _split_key(body)
        if kv is None:
            raise YAMLSubsetError(f"{lines.where(no)}: expected 'key: value', got {body!r}")
        key = _key(lines, no, kv[0])
        out[key] = _entry_value(lines, indent, no, kv[1])


def _sequence(lines, indent):
    out = []
    while True:
        item = lines.peek()
        if item is None or item[1] < indent:
            return out
        no, ind, body = item
        if ind > indent:
            raise YAMLSubsetError(f"{lines.where(no)}: unexpected indentation")
        if not (body == "-" or body.startswith("- ")):
            return out
        lines.i += 1
        rest = body[1:].lstrip(" ")
        col = ind + len(body) - len(rest)
        if not rest:
            nxt = lines.peek()
            out.append(_block(lines, nxt[1]) if nxt is not None and nxt[1] > ind else None)
        elif rest == "-" or rest.startswith("- "):
            raise YAMLSubsetError(f"{lines.where(no)}: nested compact sequences are "
                                  "outside the subset")
        elif rest[:1] not in "[{'\"" and _split_key(rest) is not None:
            out.append(_mapping(lines, col, first=(no, rest)))
        else:
            out.append(_inline_value(lines, no, rest))
            _check_no_deeper(lines, ind)


def loads(text, name="<string>"):
    """The document in ``text`` (``None`` when it holds no node)."""
    lines = _Lines(text, name)
    first = lines.peek()
    if first is None:
        return None
    no, ind, body = first
    if body == "-" or body.startswith("- ") or _split_key(body) is not None:
        node = _block(lines, ind)
    else:
        lines.i += 1
        node = _inline_value(lines, no, body)
    rest = lines.peek()
    if rest is not None:
        raise YAMLSubsetError(f"{lines.where(rest[0])}: text after the document's root node")
    return node


def load_file(path):
    with open(path, "r") as f:
        return loads(f.read(), name=str(path))
