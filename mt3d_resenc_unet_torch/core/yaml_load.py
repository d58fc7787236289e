"""The port's YAML reader: ``safe_load`` for task files, with no pyyaml.

``safe_load(text_or_stream)`` returns what PyYAML 6's ``yaml.safe_load``
returns, in value and in Python type, for every document it accepts. It
follows the same YAML 1.1 rules:

* the scanner's: simple keys, indentation, plain scalars over several
  lines, single- and double-quoted scalars with escapes and line folding,
  ``|`` and ``>`` block scalars with chomping and indentation indicators,
  flow collections nested and across lines, comments, ``---`` / ``...``
  and the ``%YAML`` directive;
* the implicit resolver's, quirks included: ``yes`` / ``on`` are booleans
  and ``y`` is a string, ``1e-3`` is a string but ``1.0e-3`` a float,
  ``017`` is octal and ``08`` a string, ``1:30`` is sexagesimal,
  ``2024-01-02`` a date, ``~`` / ``Null`` null and ``none`` a string;
* the safe constructor's: anchors and aliases (one object for a node),
  the ``<<`` merge key, and the last of duplicate keys winning.

It refuses, with ``ValueError`` that names the line and the column, what
it does not implement: tags other than the standard scalar ones that
``yaml.safe_dump`` writes (``!!str``, ``!!int``, ``!!float``, ``!!bool``,
``!!null``), the ``%TAG`` directive, complex (``?``) keys and input that
is not UTF-8. Whatever PyYAML refuses raises ``ValueError`` too. It imports nothing outside the standard
library, so a machine without pyyaml reads the same files as one with it.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["safe_load"]

_BREAKS = "\r\n\x85\u2028\u2029"
_END_OR_BREAK = "\0" + _BREAKS
_BLANK = "\0 \t" + _BREAKS             # a blank, a line break or the end
_BLANK_NO_TAB = "\0 " + _BREAKS
_WORD = re.compile(r"[0-9A-Za-z_-]*")
_NOT_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010FFFF]")
_PAD = "\0" * 10                        # lookahead past the last character

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0A", "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}

_TAG = "tag:yaml.org,2002:"
_STR, _SEQ, _MAP = _TAG + "str", _TAG + "seq", _TAG + "map"
_MERGE, _VALUE = _TAG + "merge", _TAG + "value"


def _fail(problem: str, mark: Tuple[int, int]) -> ValueError:
    return ValueError(f"YAML: {problem} at line {mark[0] + 1}, column "
                      f"{mark[1] + 1}")


class _Token:
    __slots__ = ("kind", "mark", "value", "plain")

    def __init__(self, kind, mark, value=None, plain=False):
        self.kind, self.mark, self.value, self.plain = kind, mark, value, plain


class _Scanner:
    """Characters -> tokens, by the rules of PyYAML's scanner."""

    def __init__(self, text: str):
        bad = _NOT_PRINTABLE.search(text)
        if bad:
            head = text[:bad.start()]
            line = head.count("\n")
            raise _fail(f"special character {bad.group()!r} is not allowed",
                        (line, bad.start() - (head.rfind("\n") + 1)))
        self.s = text + _PAD
        self.i = self.line = self.col = 0
        self.flow = 0
        self.indent, self.indents = -1, []
        self.allow_key = True
        # flow level -> (token number, required, index, line, column)
        self.keys: Dict[int, tuple] = {}
        self.tokens: List[_Token] = [_Token("STREAM_START", (0, 0))]
        self.taken = 0
        self.done = False

    # ------------------------------------------------------- characters
    def ch(self, k: int = 0) -> str:
        return self.s[self.i + k]

    def forward(self, n: int = 1) -> None:
        s = self.s
        for _ in range(n):
            c = s[self.i]
            self.i += 1
            if c in "\n\x85\u2028\u2029" or (c == "\r" and s[self.i] != "\n"):
                self.line += 1
                self.col = 0
            elif c != "\uFEFF":
                self.col += 1

    def take(self, n: int) -> str:
        out = self.s[self.i:self.i + n]
        self.forward(n)
        return out

    def mark(self) -> Tuple[int, int]:
        return (self.line, self.col)

    def line_break(self) -> str:
        """Consumes one line break: CR LF, CR, LF and NEL read as LF."""
        c = self.ch()
        if c in "\r\n\x85":
            self.forward(2 if self.s[self.i:self.i + 2] == "\r\n" else 1)
            return "\n"
        if c in "\u2028\u2029":
            self.forward()
            return c
        return ""

    def at_document_marker(self) -> bool:
        """``---`` or ``...`` and a blank at the start of a line."""
        return (self.col == 0 and self.s[self.i:self.i + 3] in ("---", "...")
                and self.ch(3) in _BLANK)

    # ----------------------------------------------------------- tokens
    def peek(self) -> _Token:
        while self._need_more():
            self._fetch()
        return self.tokens[0]

    def get(self) -> _Token:
        tok = self.peek()
        del self.tokens[0]
        self.taken += 1
        return tok

    def check(self, *kinds: str) -> bool:
        return self.peek().kind in kinds

    def _need_more(self) -> bool:
        if self.done:
            return False
        if not self.tokens:
            return True
        self._stale_keys()
        return bool(self.keys) and min(
            k[0] for k in self.keys.values()) == self.taken

    def _add(self, kind: str, mark=None, **kw) -> None:
        self.tokens.append(_Token(kind, mark or self.mark(), **kw))

    # ------------------------------------------------------ simple keys
    def _stale_keys(self) -> None:
        for level, key in list(self.keys.items()):
            if key[3] != self.line or self.i - key[2] > 1024:
                if key[1]:
                    raise _fail("could not find expected ':' after a simple "
                                "key", (key[3], key[4]))
                del self.keys[level]

    def _save_key(self) -> None:
        required = not self.flow and self.indent == self.col
        if self.allow_key:
            self._remove_key()
            self.keys[self.flow] = (self.taken + len(self.tokens), required,
                                    self.i, self.line, self.col)

    def _remove_key(self) -> None:
        key = self.keys.pop(self.flow, None)
        if key is not None and key[1]:
            raise _fail("could not find expected ':' after a simple key",
                        (key[3], key[4]))

    # ------------------------------------------------------ indentation
    def _unwind(self, col: int) -> None:
        if self.flow:
            return
        while self.indent > col:
            self.indent = self.indents.pop()
            self._add("BLOCK_END")

    def _add_indent(self, col: int) -> bool:
        if self.indent < col:
            self.indents.append(self.indent)
            self.indent = col
            return True
        return False

    # ---------------------------------------------------------- fetching
    def _skip_to_token(self) -> None:
        if self.i == 0 and self.ch() == "\uFEFF":
            self.forward()
        while True:
            while self.ch() == " ":
                self.forward()
            if self.ch() == "#":
                while self.ch() not in _END_OR_BREAK:
                    self.forward()
            if self.line_break():
                if not self.flow:
                    self.allow_key = True
            else:
                return

    def _fetch(self) -> None:
        self._skip_to_token()
        self._stale_keys()
        self._unwind(self.col)
        c, nxt = self.ch(), self.ch(1)
        if c == "\0":
            return self._stream_end()
        if c == "%" and self.col == 0:
            return self._directive()
        if c in "-." and self.at_document_marker():
            return self._document_marker(
                "DOCUMENT_START" if c == "-" else "DOCUMENT_END")
        if c in "[{":
            self._save_key()
            self.flow += 1
            self.allow_key = True
            mark = self.mark()
            self.forward()
            return self._add("FLOW_SEQ_START" if c == "[" else "FLOW_MAP_START",
                             mark)
        if c in "]}":
            self._remove_key()
            self.flow = max(self.flow - 1, 0) if self.flow else 0
            self.allow_key = False
            mark = self.mark()
            self.forward()
            return self._add("FLOW_SEQ_END" if c == "]" else "FLOW_MAP_END",
                             mark)
        if c == ",":
            self.allow_key = True
            self._remove_key()
            mark = self.mark()
            self.forward()
            return self._add("FLOW_ENTRY", mark)
        if c == "-" and nxt in _BLANK:
            return self._block_entry()
        if c == "?" and (self.flow or nxt in _BLANK):
            raise _fail("complex keys ('?') are not supported", self.mark())
        if c == ":" and (self.flow or nxt in _BLANK):
            return self._value()
        if c in "*&":
            self._save_key()
            self.allow_key = False
            return self._anchor(c)
        if c == "!":
            self._save_key()
            self.allow_key = False
            return self._tag()
        if c in "|>" and not self.flow:
            self.allow_key = True
            self._remove_key()
            return self._block_scalar(c == ">")
        if c in "'\"":
            self._save_key()
            self.allow_key = False
            return self._flow_scalar(c == '"')
        if (c not in _BLANK + "-?:,[]{}#&*!|>'\"%@`"
                or (nxt not in _BLANK
                    and (c == "-" or (not self.flow and c in "?:")))):
            self._save_key()
            self.allow_key = False
            return self._plain()
        raise _fail(f"found character {c!r} that cannot start any token",
                    self.mark())

    def _stream_end(self) -> None:
        self._unwind(-1)
        self._remove_key()
        self.allow_key = False
        self.keys = {}
        self._add("STREAM_END")
        self.done = True

    def _document_marker(self, kind: str) -> None:
        self._unwind(-1)
        self._remove_key()
        self.allow_key = False
        mark = self.mark()
        self.forward(3)
        self._add(kind, mark)

    def _block_entry(self) -> None:
        if not self.flow:
            if not self.allow_key:
                raise _fail("sequence entries are not allowed here",
                            self.mark())
            if self._add_indent(self.col):
                self._add("BLOCK_SEQ_START")
        self.allow_key = True
        self._remove_key()
        mark = self.mark()
        self.forward()
        self._add("BLOCK_ENTRY", mark)

    def _value(self) -> None:
        key = self.keys.pop(self.flow, None)
        if key is not None:
            at = key[0] - self.taken
            self.tokens.insert(at, _Token("KEY", (key[3], key[4])))
            if not self.flow and self._add_indent(key[4]):
                self.tokens.insert(at, _Token("BLOCK_MAP_START",
                                              (key[3], key[4])))
            self.allow_key = False
        else:
            if not self.flow:
                if not self.allow_key:
                    raise _fail("mapping values are not allowed here",
                                self.mark())
                if self._add_indent(self.col):
                    self._add("BLOCK_MAP_START")
            self.allow_key = not self.flow
            self._remove_key()
        mark = self.mark()
        self.forward()
        self._add("VALUE", mark)

    # ---------------------------------------------------------- scanners
    def _directive(self) -> None:
        self._unwind(-1)
        self._remove_key()
        self.allow_key = False
        mark = self.mark()
        self.forward()
        name = self._word("directive")
        if self.ch() not in _BLANK_NO_TAB:
            raise _fail(f"expected alphabetic or numeric character, but "
                        f"found {self.ch()!r}", self.mark())
        value = None
        if name == "YAML":
            while self.ch() == " ":
                self.forward()
            major = self._digits()
            if self.ch() != ".":
                raise _fail(f"expected a digit or '.', but found "
                            f"{self.ch()!r}", self.mark())
            self.forward()
            value = (major, self._digits())
            if self.ch() not in _BLANK_NO_TAB:
                raise _fail(f"expected a digit or ' ', but found "
                            f"{self.ch()!r}", self.mark())
        elif name == "TAG":
            raise _fail("%TAG directives are not supported", mark)
        else:
            while self.ch() not in _END_OR_BREAK:
                self.forward()
        while self.ch() == " ":
            self.forward()
        if self.ch() == "#":
            while self.ch() not in _END_OR_BREAK:
                self.forward()
        if self.ch() not in _END_OR_BREAK:
            raise _fail(f"expected a comment or a line break, but found "
                        f"{self.ch()!r}", self.mark())
        self.line_break()
        self._add("DIRECTIVE", mark, value=(name, value))

    def _word(self, what: str) -> str:
        n = _WORD.match(self.s, self.i).end() - self.i
        if not n:
            raise _fail(f"expected alphabetic or numeric character in the "
                        f"{what}, but found {self.ch()!r}", self.mark())
        return self.take(n)

    def _digits(self) -> int:
        n = 0
        while "0" <= self.ch(n) <= "9":
            n += 1
        if not n:
            raise _fail(f"expected a digit, but found {self.ch()!r}",
                        self.mark())
        return int(self.take(n))

    def _anchor(self, indicator: str) -> None:
        mark = self.mark()
        self.forward()
        name = self._word("alias" if indicator == "*" else "anchor")
        if self.ch() not in _BLANK + "?:,]}%@`":
            raise _fail(f"expected alphabetic or numeric character, but "
                        f"found {self.ch()!r}", self.mark())
        self._add("ALIAS" if indicator == "*" else "ANCHOR", mark, value=name)

    def _tag(self) -> None:
        mark = self.mark()
        n = 0
        while self.ch(n) not in _BLANK:
            n += 1
        text = self.take(n)
        name = None
        if text.startswith("!!"):
            name = text[2:]
        elif text.startswith("!<" + _TAG) and text.endswith(">"):
            name = text[len(_TAG) + 2:-1]
        if name not in ("str", "int", "float", "bool", "null"):
            raise _fail(f"the tag {text!r} is not supported", mark)
        self._add("TAG", mark, value=_TAG + name)

    def _block_scalar(self, folded: bool) -> None:
        mark = self.mark()
        self.forward()
        chomp, increment = None, None
        for _ in range(2):
            c = self.ch()
            if c in "+-" and chomp is None:
                chomp = c == "+"
                self.forward()
            elif c in "0123456789" and increment is None:
                if c == "0":
                    raise _fail("expected indentation indicator in the range "
                                "1-9, but found 0", self.mark())
                increment = int(c)
                self.forward()
        if self.ch() not in _BLANK_NO_TAB:
            raise _fail(f"expected chomping or indentation indicators, but "
                        f"found {self.ch()!r}", self.mark())
        while self.ch() == " ":
            self.forward()
        if self.ch() == "#":
            while self.ch() not in _END_OR_BREAK:
                self.forward()
        if self.ch() not in _END_OR_BREAK:
            raise _fail(f"expected a comment or a line break, but found "
                        f"{self.ch()!r}", self.mark())
        self.line_break()
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.ch() in " " + _BREAKS:
                if self.ch() != " ":
                    breaks.append(self.line_break())
                else:
                    self.forward()
                    max_indent = max(max_indent, self.col)
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self._block_breaks(indent)
        chunks, last_break = [], ""
        while self.col == indent and self.ch() != "\0":
            chunks.extend(breaks)
            leading_text = self.ch() not in " \t"
            n = 0
            while self.ch(n) not in _END_OR_BREAK:
                n += 1
            chunks.append(self.take(n))
            last_break = self.line_break()
            breaks = self._block_breaks(indent)
            if self.col == indent and self.ch() != "\0":
                if (folded and last_break == "\n" and leading_text
                        and self.ch() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(last_break)
            else:
                break
        if chomp is not False:
            chunks.append(last_break)
        if chomp is True:
            chunks.extend(breaks)
        self._add("SCALAR", mark, value="".join(chunks))

    def _block_breaks(self, indent: int) -> List[str]:
        chunks = []
        while self.col < indent and self.ch() == " ":
            self.forward()
        while self.ch() in _BREAKS:
            chunks.append(self.line_break())
            while self.col < indent and self.ch() == " ":
                self.forward()
        return chunks

    def _flow_scalar(self, double: bool) -> None:
        mark = self.mark()
        quote = self.ch()
        self.forward()
        chunks = self._quoted_text(double)
        while self.ch() != quote:
            chunks += self._quoted_spaces(double, mark)
            chunks += self._quoted_text(double)
        self.forward()
        self._add("SCALAR", mark, value="".join(chunks))

    def _quoted_text(self, double: bool) -> List[str]:
        chunks = []
        stop = "'\"\\\0 \t" + _BREAKS
        while True:
            n = 0
            while self.ch(n) not in stop:
                n += 1
            if n:
                chunks.append(self.take(n))
            c = self.ch()
            if not double and c == "'" and self.ch(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and c == "'") or (not double and c in '"\\'):
                chunks.append(c)
                self.forward()
            elif double and c == "\\":
                self.forward()
                c = self.ch()
                if c in _ESCAPES:
                    chunks.append(_ESCAPES[c])
                    self.forward()
                elif c in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[c]
                    self.forward()
                    digits = self.s[self.i:self.i + k]
                    if not re.fullmatch(r"[0-9A-Fa-f]{%d}" % k, digits):
                        raise _fail(f"expected escape sequence of {k} "
                                    "hexadecimal numbers", self.mark())
                    code = int(digits, 16)
                    if code > 0x10FFFF:
                        raise _fail(f"escape \\{c}{digits} is out of range",
                                    self.mark())
                    chunks.append(chr(code))
                    self.forward(k)
                elif c in _BREAKS:
                    self.line_break()
                    chunks += self._quoted_breaks()
                else:
                    raise _fail(f"found unknown escape character {c!r}",
                                self.mark())
            else:
                return chunks

    def _quoted_spaces(self, double: bool, start) -> List[str]:
        n = 0
        while self.ch(n) in " \t":
            n += 1
        spaces = self.take(n)
        c = self.ch()
        if c == "\0":
            raise _fail("found unexpected end of stream in a quoted scalar",
                        start)
        if c in _BREAKS:
            first = self.line_break()
            breaks = self._quoted_breaks()
            out = []
            if first != "\n":
                out.append(first)
            elif not breaks:
                out.append(" ")
            return out + breaks
        return [spaces]

    def _quoted_breaks(self) -> List[str]:
        chunks = []
        while True:
            if self.at_document_marker():
                raise _fail("found unexpected document separator in a "
                            "quoted scalar", self.mark())
            while self.ch() in " \t":
                self.forward()
            if self.ch() in _BREAKS:
                chunks.append(self.line_break())
            else:
                return chunks

    def _plain(self) -> None:
        mark = self.mark()
        indent = self.indent + 1
        chunks, spaces = [], []
        stop_colon = _BLANK + (",[]{}" if self.flow else "")
        while True:
            if self.ch() == "#":
                break
            n = 0
            while True:
                c = self.ch(n)
                if (c in _BLANK or (c == ":" and self.ch(n + 1) in stop_colon)
                        or (self.flow and c in ",?[]{}")):
                    break
                n += 1
            if not n:
                break
            self.allow_key = False
            chunks += spaces
            chunks.append(self.take(n))
            spaces = self._plain_spaces()
            if (not spaces or self.ch() == "#"
                    or (not self.flow and self.col < indent)):
                break
        self._add("SCALAR", mark, value="".join(chunks), plain=True)

    def _plain_spaces(self) -> Optional[List[str]]:
        n = 0
        while self.ch(n) == " ":
            n += 1
        spaces = self.take(n)
        if self.ch() in _BREAKS:
            first = self.line_break()
            self.allow_key = True
            if self.at_document_marker():
                return None
            breaks = []
            while self.ch() in " " + _BREAKS:
                if self.ch() == " ":
                    self.forward()
                else:
                    breaks.append(self.line_break())
                    if self.at_document_marker():
                        return None
            out = []
            if first != "\n":
                out.append(first)
            elif not breaks:
                out.append(" ")
            return out + breaks
        return [spaces] if spaces else []


# ------------------------------------------------------------------ nodes

class _Node:
    __slots__ = ("kind", "tag", "value", "mark")

    def __init__(self, kind, tag, value, mark):
        self.kind, self.tag, self.value, self.mark = kind, tag, value, mark


class _Parser:
    """Tokens -> the node graph of the stream's one document, by the rules
    of PyYAML's parser and composer."""

    def __init__(self, scanner: _Scanner):
        self.sc = scanner
        self.anchors: Dict[str, _Node] = {}

    def document(self) -> Optional[_Node]:
        sc = self.sc
        sc.get()                                   # STREAM_START
        if sc.check("STREAM_END"):
            return None
        if not sc.check("DIRECTIVE", "DOCUMENT_START"):
            node = self.node(block=True)
        else:
            self._directives()
            if not sc.check("DOCUMENT_START"):
                tok = sc.peek()
                raise _fail(f"expected '<document start>', but found "
                            f"{tok.kind}", tok.mark)
            sc.get()
            if sc.check("DIRECTIVE", "DOCUMENT_START", "DOCUMENT_END",
                        "STREAM_END"):
                node = self._empty(sc.peek().mark)
            else:
                node = self.node(block=True)
        if sc.check("DOCUMENT_END"):
            sc.get()
        while sc.check("DOCUMENT_END"):
            sc.get()
        if not sc.check("STREAM_END"):
            raise _fail("expected a single document in the stream",
                        sc.peek().mark)
        return node

    def _directives(self) -> None:
        seen = False
        while self.sc.check("DIRECTIVE"):
            tok = self.sc.get()
            name, value = tok.value
            if name == "YAML":
                if seen:
                    raise _fail("found duplicate YAML directive", tok.mark)
                seen = True
                if value[0] != 1:
                    raise _fail("found incompatible YAML document (version "
                                "1.* is required)", tok.mark)

    @staticmethod
    def _empty(mark, tag=None) -> _Node:
        return _Node("scalar", tag, ("", True), mark)

    def node(self, block: bool, indentless: bool = False) -> _Node:
        sc = self.sc
        if sc.check("ALIAS"):
            tok = sc.get()
            if tok.value not in self.anchors:
                raise _fail(f"found undefined alias {tok.value!r}", tok.mark)
            return self.anchors[tok.value]
        anchor = tag = None
        mark = sc.peek().mark
        for _ in range(2):
            if sc.check("ANCHOR") and anchor is None:
                anchor = sc.get()
            elif sc.check("TAG") and tag is None:
                tag = sc.get().value
        if anchor is not None:
            if anchor.value in self.anchors:
                raise _fail(f"found duplicate anchor {anchor.value!r}",
                            anchor.mark)
        name = anchor.value if anchor is not None else None
        tok = sc.peek()
        if indentless and tok.kind == "BLOCK_ENTRY":
            node = self._register(name, _Node("seq", tag, [], tok.mark))
            while sc.check("BLOCK_ENTRY"):
                entry = sc.get()
                if sc.check("BLOCK_ENTRY", "KEY", "VALUE", "BLOCK_END"):
                    node.value.append(self._empty(entry.mark))
                else:
                    node.value.append(self.node(block=True))
            return node
        if tok.kind == "SCALAR":
            sc.get()
            return self._register(name, _Node(
                "scalar", tag, (tok.value, tok.plain), tok.mark))
        if tok.kind == "FLOW_SEQ_START":
            return self._flow_seq(self._register(
                name, _Node("seq", tag, [], tok.mark)))
        if tok.kind == "FLOW_MAP_START":
            return self._flow_map(self._register(
                name, _Node("map", tag, [], tok.mark)))
        if block and tok.kind == "BLOCK_SEQ_START":
            return self._block_seq(self._register(
                name, _Node("seq", tag, [], tok.mark)))
        if block and tok.kind == "BLOCK_MAP_START":
            return self._block_map(self._register(
                name, _Node("map", tag, [], tok.mark)))
        if anchor is not None or tag is not None:
            return self._register(name, self._empty(mark, tag))
        raise _fail(f"expected the node content, but found {tok.kind}",
                    tok.mark)

    def _register(self, anchor, node: _Node) -> _Node:
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def _block_seq(self, node: _Node) -> _Node:
        sc = self.sc
        sc.get()
        while sc.check("BLOCK_ENTRY"):
            entry = sc.get()
            if sc.check("BLOCK_ENTRY", "BLOCK_END"):
                node.value.append(self._empty(entry.mark))
            else:
                node.value.append(self.node(block=True))
        tok = sc.peek()
        if tok.kind != "BLOCK_END":
            raise _fail(f"expected <block end> in a block sequence, but "
                        f"found {tok.kind}", tok.mark)
        sc.get()
        return node

    def _block_map(self, node: _Node) -> _Node:
        sc = self.sc
        sc.get()
        while True:
            if sc.check("KEY"):
                key_tok = sc.get()
                if sc.check("KEY", "VALUE", "BLOCK_END"):
                    key = self._empty(key_tok.mark)
                else:
                    key = self.node(block=True, indentless=True)
            elif sc.check("BLOCK_END"):
                sc.get()
                return node
            else:
                tok = sc.peek()
                raise _fail(f"expected <block end> in a block mapping, but "
                            f"found {tok.kind}", tok.mark)
            if sc.check("VALUE"):
                val_tok = sc.get()
                if sc.check("KEY", "VALUE", "BLOCK_END"):
                    value = self._empty(val_tok.mark)
                else:
                    value = self.node(block=True, indentless=True)
            else:
                value = self._empty(sc.peek().mark)
            node.value.append((key, value))

    def _flow_seq(self, node: _Node) -> _Node:
        sc = self.sc
        sc.get()
        first = True
        while not sc.check("FLOW_SEQ_END"):
            if not first:
                if not sc.check("FLOW_ENTRY"):
                    tok = sc.peek()
                    raise _fail(f"expected ',' or ']', but got {tok.kind}",
                                tok.mark)
                sc.get()
                if sc.check("FLOW_SEQ_END"):
                    break
            first = False
            if sc.check("KEY"):
                # a single pair: a mapping of one key
                key_tok = sc.get()
                pair = _Node("map", None, [], key_tok.mark)
                if sc.check("VALUE", "FLOW_ENTRY", "FLOW_SEQ_END"):
                    key = self._empty(key_tok.mark)
                else:
                    key = self.node(block=False)
                if sc.check("VALUE"):
                    val_tok = sc.get()
                    if sc.check("FLOW_ENTRY", "FLOW_SEQ_END"):
                        value = self._empty(val_tok.mark)
                    else:
                        value = self.node(block=False)
                else:
                    value = self._empty(sc.peek().mark)
                pair.value.append((key, value))
                node.value.append(pair)
            else:
                node.value.append(self.node(block=False))
        sc.get()
        return node

    def _flow_map(self, node: _Node) -> _Node:
        sc = self.sc
        sc.get()
        first = True
        while not sc.check("FLOW_MAP_END"):
            if not first:
                if not sc.check("FLOW_ENTRY"):
                    tok = sc.peek()
                    raise _fail(f"expected ',' or '}}', but got {tok.kind}",
                                tok.mark)
                sc.get()
                if sc.check("FLOW_MAP_END"):
                    break
            first = False
            if sc.check("KEY"):
                key_tok = sc.get()
                if sc.check("VALUE", "FLOW_ENTRY", "FLOW_MAP_END"):
                    key = self._empty(key_tok.mark)
                else:
                    key = self.node(block=False)
                if sc.check("VALUE"):
                    val_tok = sc.get()
                    if sc.check("FLOW_ENTRY", "FLOW_MAP_END"):
                        value = self._empty(val_tok.mark)
                    else:
                        value = self.node(block=False)
                else:
                    value = self._empty(sc.peek().mark)
            else:
                key = self.node(block=False)
                value = self._empty(sc.peek().mark)
            node.value.append((key, value))
        sc.get()
        return node


# --------------------------------------------------------------- resolver

_RESOLVERS = [
    (_TAG + "bool", "yYnNtTfFoO", re.compile(
        r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
        r"|on|On|ON|off|Off|OFF)$")),
    (_TAG + "float", "-+0123456789.", re.compile(
        r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
        r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
        r"|[-+]?\.(?:inf|Inf|INF)"
        r"|\.(?:nan|NaN|NAN))$")),
    (_TAG + "int", "-+0123456789", re.compile(
        r"^(?:[-+]?0b[0-1_]+"
        r"|[-+]?0[0-7_]+"
        r"|[-+]?(?:0|[1-9][0-9_]*)"
        r"|[-+]?0x[0-9a-fA-F_]+"
        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")),
    (_MERGE, "<", re.compile(r"^(?:<<)$")),
    (_TAG + "null", "~nN", re.compile(r"^(?:~|null|Null|NULL|)$")),
    (_TAG + "timestamp", "0123456789", re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")),
    (_VALUE, "=", re.compile(r"^(?:=)$")),
]


def _resolve(value: str) -> str:
    """The tag of a plain scalar without one (the YAML 1.1 resolver)."""
    first = value[:1]
    for tag, starts, regexp in _RESOLVERS:
        if (first in starts if first else tag == _TAG + "null") \
                and regexp.match(value):
            return tag
    return _STR


def _node_tag(node: _Node) -> str:
    if node.tag is not None:
        return node.tag
    if node.kind == "scalar":
        text, plain = node.value
        return _resolve(text) if plain else _STR
    return _SEQ if node.kind == "seq" else _MAP


# ----------------------------------------------------------- constructors

_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
_TIMESTAMP = re.compile(
    r"^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)"
    r"-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])"
    r":(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")


def _sexagesimal(parts, zero):
    total, base = zero, 1
    for digit in reversed(parts):
        total += digit * base
        base *= 60
    return total


def _to_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal([int(p) for p in text.split(":")], 0)
    return sign * int(text)


def _to_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal([float(p) for p in text.split(":")], 0.0)
    return sign * float(text)


def _to_timestamp(text: str):
    m = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = int((m["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]),
                                   minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]),
                             int(m["minute"]), int(m["second"]), fraction,
                             tzinfo=tz)


_SCALARS = {
    _STR: str,
    _TAG + "int": _to_int,
    _TAG + "float": _to_float,
    _TAG + "bool": lambda text: _BOOLS[text.lower()],
    _TAG + "null": lambda text: None,
    _TAG + "timestamp": _to_timestamp,
}


class _Constructor:
    """Nodes -> Python objects, as PyYAML's safe constructor builds them:
    one object per node, so an alias is the anchored object itself."""

    def __init__(self):
        self.built: Dict[int, Any] = {}

    def build(self, node: _Node) -> Any:
        if id(node) in self.built:
            return self.built[id(node)]
        tag = _node_tag(node)
        if tag in _SCALARS:
            if node.kind != "scalar":
                raise _fail(f"expected a scalar node for {tag}, but found a "
                            f"{node.kind}", node.mark)
            try:
                out = _SCALARS[tag](node.value[0])
            except (ValueError, KeyError, IndexError, AttributeError,
                    OverflowError) as exc:
                raise _fail(f"cannot read {node.value[0]!r} as {tag} "
                            f"({exc!r})", node.mark) from None
            self.built[id(node)] = out
            return out
        if tag == _SEQ and node.kind == "seq":
            out = self.built[id(node)] = []
            out.extend(self.build(item) for item in node.value)
            return out
        if tag == _MAP and node.kind == "map":
            out = self.built[id(node)] = {}
            self._flatten(node)
            for key_node, value_node in node.value:
                key = self.build(key_node)
                try:
                    hash(key)
                except TypeError:
                    raise _fail("found unhashable key", key_node.mark) \
                        from None
                out[key] = self.build(value_node)
            return out
        raise _fail(f"could not determine a constructor for the tag {tag!r}"
                    f" on a {node.kind}", node.mark)

    def _flatten(self, node: _Node) -> None:
        """The ``<<`` merge: merged pairs first, so the mapping's own keys
        win, and of a list of mappings the earlier one."""
        merge = []
        index = 0
        while index < len(node.value):
            key_node, value_node = node.value[index]
            tag = _node_tag(key_node)
            if tag == _MERGE:
                del node.value[index]
                if value_node.kind == "map":
                    self._flatten(value_node)
                    merge.extend(value_node.value)
                elif value_node.kind == "seq":
                    parts = []
                    for sub in value_node.value:
                        if sub.kind != "map":
                            raise _fail("expected a mapping for merging, but "
                                        f"found a {sub.kind}", sub.mark)
                        self._flatten(sub)
                        parts.append(sub.value)
                    for part in reversed(parts):
                        merge.extend(part)
                else:
                    raise _fail("expected a mapping or list of mappings for "
                                f"merging, but found a {value_node.kind}",
                                value_node.mark)
            else:
                if tag == _VALUE:
                    key_node.tag = _STR
                index += 1
        if merge:
            node.value[:0] = merge


def _text(stream) -> str:
    data = stream.read() if hasattr(stream, "read") else stream
    if isinstance(data, (bytes, bytearray)):
        try:
            data = bytes(data).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise ValueError(f"YAML: the input is not UTF-8 ({exc})") \
                from None
    if not isinstance(data, str):
        raise TypeError(f"safe_load takes text, bytes or a stream, not "
                        f"{type(data).__name__}")
    return data


def safe_load(stream) -> Any:
    """The one document of ``stream`` (a str, bytes or a file object) as
    ``yaml.safe_load`` builds it; ``None`` for an empty stream. Raises
    ``ValueError`` with the line and column where the input is not YAML or
    uses what this reader does not implement."""
    node = _Parser(_Scanner(_text(stream))).document()
    return None if node is None else _Constructor().build(node)
