"""Self-contained Jinja template engine for HF chat templates.

The port's own copy of the JAX package's ``data/jinja.py`` (standard
library only): it runs the ``chat_template`` strings shipped in
``tokenizer_config.json`` (Qwen/LLaMA/DeepSeek/Mistral families) without
the ``jinja2`` package, with HF's environment semantics
(``trim_blocks=True, lstrip_blocks=True``, the
``raise_exception``/``strftime_now`` globals, namespace()).

Implemented subset (what real chat templates use):
- ``{{ expr }}``, ``{% stmt %}``, ``{# comment #}`` with ``-``
  whitespace control on either end
- statements: if/elif/else/endif, for (with loop.*, for-else, an
  inline ``if`` filter), set (incl. ``ns.attr`` targets and block
  form {% set x %}..{% endset %}), macro/endmacro, break/continue
- expressions: literals (str/int/float/list/tuple/dict/bool/none),
  or/and/not, comparisons (incl. in / not in, is-tests), + - * / // %,
  ~ concat, ** power, unary -, conditional ``a if c else b``,
  attribute/index/slice access, calls, filters ``|name(args)``
- filters: trim lower upper title capitalize length count first last
  join default d list string int float replace tojson map select
  reject selectattr rejectattr items unique sort reverse abs round
  min max sum safe e escape striptags indent rstrip lstrip
- tests: defined, undefined, none, string, mapping, number, sequence,
  iterable, boolean, true, false, odd, even, eq/equalto, ne, lt, gt

Unknown filters/tests and syntax errors raise ``TemplateError`` loudly
(no silent fallback).
"""
from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, List, Optional, Tuple


class TemplateError(Exception):
    pass


# ---------------------------------------------------------------------------
# runtime values
# ---------------------------------------------------------------------------

class Undefined:
    """jinja2-default-Undefined semantics: prints as "", is falsy,
    attribute/index access stays undefined, == is False, arithmetic and
    iteration raise."""

    def __init__(self, name: str = ""):
        self._name = name

    def __str__(self):
        return ""

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, Undefined)

    def __ne__(self, other):
        return not isinstance(other, Undefined)

    def __iter__(self):
        raise TemplateError(f"'{self._name}' is undefined (iteration)")

    def __len__(self):
        raise TemplateError(f"'{self._name}' is undefined (length)")

    def __hash__(self):
        return 0


class Namespace:
    """jinja namespace() — attribute bag assignable from inside loops."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Macro:
    def __init__(self, name, argnames, defaults, body, interp):
        self.name, self.argnames, self.defaults = name, argnames, defaults
        self.body, self.interp = body, interp

    def __call__(self, *args, **kw):
        scope = {}
        n_req = len(self.argnames) - len(self.defaults)
        for i, an in enumerate(self.argnames):
            if i < len(args):
                scope[an] = args[i]
            elif an in kw:
                scope[an] = kw[an]
            elif i >= n_req:
                scope[an] = self.defaults[i - n_req]
            else:
                scope[an] = Undefined(an)
        out: List[str] = []
        self.interp._push(scope)
        try:
            self.interp._exec_nodes(self.body, out)
        finally:
            self.interp._pop()
        return "".join(out)


class _LoopVar:
    def __init__(self, index0: int, length: int, seq: list):
        self.index0 = index0
        self.index = index0 + 1
        self.length = length
        self.first = index0 == 0
        self.last = index0 == length - 1
        self.revindex = length - index0
        self.revindex0 = length - index0 - 1
        self.previtem = seq[index0 - 1] if index0 > 0 else Undefined("loop.previtem")
        self.nextitem = seq[index0 + 1] if index0 + 1 < length else Undefined("loop.nextitem")

    def cycle(self, *vals):
        return vals[self.index0 % len(vals)]


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


# ---------------------------------------------------------------------------
# lexer — template splitter
# ---------------------------------------------------------------------------

_TAG_RE = re.compile(r"(\{\{-?.*?-?\}\}|\{%-?.*?-?%\}|\{#-?.*?-?#\})", re.S)


def _split_template(src: str) -> List[Tuple[str, str]]:
    """→ [(kind, payload)]; kind in {text, expr, stmt}. Applies whitespace
    control (- markers) and HF's trim_blocks/lstrip_blocks."""
    parts = _TAG_RE.split(src)

    def payload(tag: str) -> str:
        body = tag[2:-2]
        # the whitespace-control "-" is only the first/last char of the body
        if body.startswith("-"):
            body = body[1:]
        if body.endswith("-"):
            body = body[:-1]
        return body.strip()

    raw: List[Tuple[str, str, str]] = []   # (kind, payload, rawtag)
    for p in parts:
        if not p:
            continue
        if p.startswith("{{"):
            raw.append(("expr", payload(p), p))
        elif p.startswith("{%"):
            raw.append(("stmt", payload(p), p))
        elif p.startswith("{#"):
            raw.append(("comment", "", p))
        else:
            raw.append(("text", p, p))
    for i, (kind, payload, tag) in enumerate(raw):
        if kind != "text":
            continue
        txt = payload
        # previous tag's right side
        if i > 0:
            pk, _, ptag = raw[i - 1]
            if pk != "text":
                if ptag[-3:-2] == "-":
                    txt = txt.lstrip()
                elif pk in ("stmt", "comment"):
                    # trim_blocks: remove the first newline after a block tag
                    if txt.startswith("\r\n"):
                        txt = txt[2:]
                    elif txt.startswith("\n"):
                        txt = txt[1:]
        # next tag's left side
        if i + 1 < len(raw):
            nk, _, ntag = raw[i + 1]
            if nk != "text":
                if ntag[2:3] == "-":
                    txt = txt.rstrip()
                elif nk in ("stmt", "comment"):
                    # lstrip_blocks: strip whitespace between a line start
                    # and the tag — only when the run begins a line (after
                    # a '\n' in this segment, or the segment IS the
                    # template start and all-whitespace)
                    if "\n" in txt:
                        txt = re.sub(r"(?<=\n)[ \t]+\Z", "", txt)
                    elif i == 0:
                        txt = re.sub(r"\A[ \t]+\Z", "", txt)
        raw[i] = (kind, txt, tag)
    return [(k, p) for (k, p, _) in raw if k != "comment" and not (k == "text" and p == "")]


# ---------------------------------------------------------------------------
# expression tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\*\*|//|==|!=|<=|>=|\||~|[+\-*/%<>=(),\[\]{}.:])
""", re.X)

_STR_ESC = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"'}


def _tokenize(src: str) -> List[Tuple[str, Any]]:
    toks: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise TemplateError(f"bad token at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        val = m.group()
        if kind == "ws":
            continue
        if kind == "float":
            toks.append(("num", float(val)))
        elif kind == "int":
            toks.append(("num", int(val)))
        elif kind == "str":
            body = val[1:-1]
            s, i = [], 0
            while i < len(body):
                c = body[i]
                if c == "\\" and i + 1 < len(body):
                    s.append(_STR_ESC.get(body[i + 1], "\\" + body[i + 1]))
                    i += 2
                else:
                    s.append(c)
                    i += 1
            toks.append(("str", "".join(s)))
        elif kind == "name":
            toks.append(("name", val))
        else:
            toks.append(("op", val))
    toks.append(("end", None))
    return toks


# ---------------------------------------------------------------------------
# expression parser → nested tuples (op, ...)
# ---------------------------------------------------------------------------

class _ExprParser:
    def __init__(self, toks: List[Tuple[str, Any]]):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None):
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            return self.next()
        return None

    def expect(self, kind, val=None):
        t = self.accept(kind, val)
        if t is None:
            raise TemplateError(
                f"expected {val or kind}, got {self.peek()!r}")
        return t

    # precedence climbing -------------------------------------------------
    def parse(self):
        e = self.parse_ternary()
        self.expect("end")
        return e

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        e = self.parse_or()
        if self.accept("name", "if"):
            cond = self.parse_or()
            if self.accept("name", "else"):
                other = self.parse_ternary()
            else:
                other = ("const", Undefined("cond-else"))
            return ("cond", cond, e, other)
        return e

    def parse_or(self):
        e = self.parse_and()
        while self.accept("name", "or"):
            e = ("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept("name", "and"):
            e = ("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.accept("name", "not"):
            return ("not", self.parse_not())
        return self.parse_compare()

    def parse_compare(self):
        e = self.parse_concat()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                e = ("cmp", v, e, self.parse_concat())
            elif k == "name" and v == "in":
                self.next()
                e = ("in", e, self.parse_concat())
            elif k == "name" and v == "not" and \
                    self.toks[self.i + 1] == ("name", "in"):
                self.next(); self.next()
                e = ("not", ("in", e, self.parse_concat()))
            elif k == "name" and v == "is":
                self.next()
                neg = bool(self.accept("name", "not"))
                tname = self.expect("name")[1]
                args = []
                if self.accept("op", "("):
                    if not self.accept("op", ")"):
                        args.append(self.parse_expr())
                        while self.accept("op", ","):
                            args.append(self.parse_expr())
                        self.expect("op", ")")
                elif self.peek()[0] in ("num", "str"):
                    args.append(("const", self.next()[1]))
                t = ("test", tname, e, args)
                e = ("not", t) if neg else t
            else:
                break
        return e

    def parse_concat(self):
        e = self.parse_add()
        while self.accept("op", "~"):
            e = ("concat", e, self.parse_add())
        return e

    def parse_add(self):
        e = self.parse_mul()
        while True:
            if self.accept("op", "+"):
                e = ("add", e, self.parse_mul())
            elif self.accept("op", "-"):
                e = ("sub", e, self.parse_mul())
            else:
                return e

    def parse_mul(self):
        e = self.parse_unary()
        while True:
            if self.accept("op", "*"):
                e = ("mul", e, self.parse_unary())
            elif self.accept("op", "/"):
                e = ("div", e, self.parse_unary())
            elif self.accept("op", "//"):
                e = ("floordiv", e, self.parse_unary())
            elif self.accept("op", "%"):
                e = ("mod", e, self.parse_unary())
            elif self.accept("op", "**"):
                e = ("pow", e, self.parse_unary())
            else:
                return e

    def parse_unary(self):
        if self.accept("op", "-"):
            return ("neg", self.parse_unary())
        if self.accept("op", "+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_atom()
        while True:
            if self.accept("op", "."):
                name = self.expect("name")[1]
                e = ("attr", e, name)
            elif self.accept("op", "["):
                e = ("index", e, self._parse_subscript())
                self.expect("op", "]")
            elif self.accept("op", "("):
                args, kwargs = self._parse_args()
                e = ("call", e, args, kwargs)
            elif self.accept("op", "|"):
                fname = self.expect("name")[1]
                args, kwargs = [], []
                if self.accept("op", "("):
                    args, kwargs = self._parse_args()
                e = ("filter", fname, e, args, kwargs)
            else:
                return e

    def _parse_subscript(self):
        # slice support a[1:], a[:-1], a[::2]
        start = stop = step = None
        if self.peek() != ("op", ":"):
            start = self.parse_expr()
        if self.accept("op", ":"):
            if self.peek()[1] not in (":", "]"):
                stop = self.parse_expr()
            if self.accept("op", ":"):
                if self.peek()[1] != "]":
                    step = self.parse_expr()
            return ("slice", start, stop, step)
        return start

    def _parse_args(self):
        args, kwargs = [], []
        if self.accept("op", ")"):
            return args, kwargs
        while True:
            k, v = self.peek()
            if k == "name" and self.toks[self.i + 1] == ("op", "="):
                self.next(); self.next()
                kwargs.append((v, self.parse_expr()))
            else:
                args.append(self.parse_expr())
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        return args, kwargs

    def parse_atom(self):
        k, v = self.peek()
        if k == "num" or k == "str":
            self.next()
            return ("const", v)
        if k == "name":
            if v in ("true", "True"):
                self.next(); return ("const", True)
            if v in ("false", "False"):
                self.next(); return ("const", False)
            if v in ("none", "None", "null"):
                self.next(); return ("const", None)
            self.next()
            return ("var", v)
        if self.accept("op", "("):
            e = self.parse_expr()
            if self.accept("op", ","):      # tuple
                items = [e]
                while self.peek() != ("op", ")"):
                    items.append(self.parse_expr())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                return ("tuple", items)
            self.expect("op", ")")
            return e
        if self.accept("op", "["):
            items = []
            while self.peek() != ("op", "]"):
                items.append(self.parse_expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", "]")
            return ("list", items)
        if self.accept("op", "{"):
            pairs = []
            while self.peek() != ("op", "}"):
                key = self.parse_expr()
                self.expect("op", ":")
                pairs.append((key, self.parse_expr()))
                if not self.accept("op", ","):
                    break
            self.expect("op", "}")
            return ("dict", pairs)
        raise TemplateError(f"unexpected token {self.peek()!r}")


def _parse_expr_str(src: str):
    return _ExprParser(_tokenize(src)).parse()


# ---------------------------------------------------------------------------
# statement parser — nested node tree
# ---------------------------------------------------------------------------

def _parse_nodes(pieces: List[Tuple[str, str]], i: int, until: tuple,
                 ) -> Tuple[list, int, Optional[str]]:
    """Parse until one of `until` keywords; returns (nodes, next_i, kw)."""
    nodes: list = []
    while i < len(pieces):
        kind, payload = pieces[i]
        if kind == "text":
            nodes.append(("text", payload))
            i += 1
        elif kind == "expr":
            nodes.append(("emit", _parse_expr_str(payload)))
            i += 1
        else:  # stmt
            head = payload.split(None, 1)
            kw = head[0] if head else ""
            rest = head[1] if len(head) > 1 else ""
            if kw in until:
                return nodes, i, payload
            i += 1
            if kw == "if":
                branches = []
                cond = _parse_expr_str(rest)
                while True:
                    body, i, stop = _parse_nodes(
                        pieces, i, ("elif", "else", "endif"))
                    branches.append((cond, body))
                    skw = stop.split(None, 1)
                    i += 1
                    if skw[0] == "elif":
                        cond = _parse_expr_str(skw[1])
                        continue
                    if skw[0] == "else":
                        ebody, i, _ = _parse_nodes(pieces, i, ("endif",))
                        i += 1
                        nodes.append(("if", branches, ebody))
                        break
                    nodes.append(("if", branches, []))
                    break
            elif kw == "for":
                m = re.match(r"(.+?)\s+in\s+(.+)", rest, re.S)
                if not m:
                    raise TemplateError(f"bad for: {rest!r}")
                targets = [t.strip() for t in m.group(1).split(",")]
                seq_src = m.group(2)
                cond = None
                mm = re.search(r"\s+if\s+(.+)\Z", seq_src, re.S)
                if mm and not re.search(r"\s+else\s+", seq_src):
                    cond = _parse_expr_str(mm.group(1))
                    seq_src = seq_src[: mm.start()]
                seq = _parse_expr_str(seq_src)
                body, i, stop = _parse_nodes(pieces, i, ("endfor", "else"))
                ebody = []
                if stop.split()[0] == "else":
                    i += 1
                    ebody, i, _ = _parse_nodes(pieces, i, ("endfor",))
                i += 1
                nodes.append(("for", targets, seq, cond, body, ebody))
            elif kw == "set":
                if "=" in rest:
                    tgt, _, val = rest.partition("=")
                    nodes.append(("set", tgt.strip(), _parse_expr_str(val)))
                else:   # block form {% set x %}...{% endset %}
                    body, i, _ = _parse_nodes(pieces, i, ("endset",))
                    i += 1
                    nodes.append(("setblock", rest.strip(), body))
            elif kw == "macro":
                m = re.match(r"([A-Za-z_]\w*)\s*\((.*)\)\s*\Z", rest, re.S)
                if not m:
                    raise TemplateError(f"bad macro: {rest!r}")
                name = m.group(1)
                argnames, defaults = [], []
                if m.group(2).strip():
                    for a in m.group(2).split(","):
                        if "=" in a:
                            an, _, dv = a.partition("=")
                            argnames.append(an.strip())
                            defaults.append(_parse_expr_str(dv))
                        else:
                            argnames.append(a.strip())
                body, i, _ = _parse_nodes(pieces, i, ("endmacro",))
                i += 1
                nodes.append(("macro", name, argnames, defaults, body))
            elif kw == "break":
                nodes.append(("break",))
            elif kw == "continue":
                nodes.append(("continue",))
            elif kw == "filter":
                fname = rest.strip()
                body, i, _ = _parse_nodes(pieces, i, ("endfilter",))
                i += 1
                nodes.append(("filterblock", fname, body))
            else:
                raise TemplateError(f"unknown statement {kw!r}")
    return nodes, i, None


# ---------------------------------------------------------------------------
# filters & tests
# ---------------------------------------------------------------------------

def _to_json(v, ensure_ascii=False, indent=None, separators=None,
             sort_keys=False):
    """Matches HF transformers' tojson override (chat_template_utils.py),
    NOT stock jinja2's HTML-escaping filter."""
    return json.dumps(v, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _f_default(v, d="", boolean=False):
    if isinstance(v, Undefined) or (boolean and not v):
        return d
    return v


def _attr_of(item, name):
    if isinstance(item, dict):
        return item.get(name, Undefined(name))
    return getattr(item, name, Undefined(name))


def _f_join(v, sep="", attribute=None):
    if attribute is not None:
        v = [_attr_of(x, attribute) for x in v]
    return sep.join(str(x) for x in v)


def _f_map(v, *args, **kw):
    if "attribute" in kw:
        dflt = kw.get("default", Undefined("map"))
        out = []
        for x in v:
            a = _attr_of(x, kw["attribute"])
            out.append(dflt if isinstance(a, Undefined) and "default" in kw else a)
        return out
    if args:   # map('filter')
        fname = args[0]
        f = FILTERS.get(fname)
        if f is None:
            raise TemplateError(f"unknown filter in map: {fname}")
        return [f(x, *args[1:]) for x in v]
    return list(v)


def _apply_test(tname, val, args):
    t = TESTS.get(tname)
    if t is None:
        raise TemplateError(f"unknown test {tname!r}")
    return t(val, *args)


def _f_select(v, *args):
    if not args:
        return [x for x in v if x]
    return [x for x in v if _apply_test(args[0], x, list(args[1:]))]


def _f_reject(v, *args):
    if not args:
        return [x for x in v if not x]
    return [x for x in v if not _apply_test(args[0], x, list(args[1:]))]


def _f_selectattr(v, attr, *args):
    if not args:
        return [x for x in v if _attr_of(x, attr)]
    return [x for x in v if _apply_test(args[0], _attr_of(x, attr),
                                        list(args[1:]))]


def _f_rejectattr(v, attr, *args):
    if not args:
        return [x for x in v if not _attr_of(x, attr)]
    return [x for x in v if not _apply_test(args[0], _attr_of(x, attr),
                                            list(args[1:]))]


def _f_sort(v, reverse=False, case_sensitive=False, attribute=None):
    key = None
    if attribute is not None:
        key = lambda x: _attr_of(x, attribute)  # noqa: E731
    elif not case_sensitive:
        key = lambda x: x.lower() if isinstance(x, str) else x  # noqa: E731
    return sorted(v, key=key, reverse=reverse)


def _f_indent(s, width=4, first=False, blank=False):
    pad = " " * width if isinstance(width, int) else width
    lines = s.split("\n")
    out = []
    for i, ln in enumerate(lines):
        if i == 0 and not first:
            out.append(ln)
        elif not ln and not blank:
            out.append(ln)
        else:
            out.append(pad + ln)
    return "\n".join(out)


FILTERS = {
    "trim": lambda v, chars=None: str(v).strip(chars),
    "rstrip": lambda v, chars=None: str(v).rstrip(chars),
    "lstrip": lambda v, chars=None: str(v).lstrip(chars),
    "lower": lambda v: str(v).lower(),
    "upper": lambda v: str(v).upper(),
    "title": lambda v: str(v).title(),
    "capitalize": lambda v: str(v).capitalize(),
    "length": len,
    "count": len,
    "first": lambda v: next(iter(v), Undefined("first")),
    "last": lambda v: (list(v) or [Undefined("last")])[-1],
    "join": _f_join,
    "default": _f_default,
    "d": _f_default,
    "list": list,
    "string": str,
    "int": lambda v, default=0: int(v) if str(v).lstrip("-").isdigit() else (int(v) if isinstance(v, (int, float)) else default),
    "float": lambda v, default=0.0: float(v),
    "abs": abs,
    "round": lambda v, p=0: round(v, p),
    "replace": lambda v, a, b, count=-1: str(v).replace(a, b, count),
    "tojson": _to_json,
    "safe": lambda v: v,
    "e": lambda v: (str(v).replace("&", "&amp;").replace("<", "&lt;")
                    .replace(">", "&gt;").replace("'", "&#39;")
                    .replace('"', "&#34;")),
    "map": _f_map,
    "select": _f_select,
    "reject": _f_reject,
    "selectattr": _f_selectattr,
    "rejectattr": _f_rejectattr,
    "items": lambda v: list(v.items()),
    "unique": lambda v: list(dict.fromkeys(v)),
    "sort": _f_sort,
    "reverse": lambda v: list(reversed(v)),
    "min": min,
    "max": max,
    "sum": lambda v, start=0: sum(v, start),
    "indent": _f_indent,
    "striptags": lambda v: re.sub(r"<[^>]*>", "", str(v)),
}
FILTERS["escape"] = FILTERS["e"]

TESTS = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, dict),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "sequence": lambda v: hasattr(v, "__len__"),
    "iterable": lambda v: hasattr(v, "__iter__"),
    "boolean": lambda v: isinstance(v, bool),
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
    "eq": lambda v, o: v == o,
    "equalto": lambda v, o: v == o,
    "ne": lambda v, o: v != o,
    "lt": lambda v, o: v < o,
    "le": lambda v, o: v <= o,
    "gt": lambda v, o: v > o,
    "ge": lambda v, o: v >= o,
    "in": lambda v, seq: v in seq,
    "sameas": lambda v, o: v is o,
    "lower": lambda v: str(v).islower(),
    "upper": lambda v: str(v).isupper(),
    "divisibleby": lambda v, n: v % n == 0,
}


def _raise_exception(msg=""):
    raise TemplateError(str(msg))


def _strftime_now(fmt):
    return time.strftime(fmt)


# ---------------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------------

class Template:
    def __init__(self, source: str):
        pieces = _split_template(source)
        self.nodes, _, _ = _parse_nodes(pieces, 0, ())

    def render(self, **ctx) -> str:
        interp = _Interp(ctx)
        out: List[str] = []
        interp._exec_nodes(self.nodes, out)
        return "".join(out)


class _Interp:
    def __init__(self, ctx: Dict[str, Any]):
        g = {
            "range": range,
            "namespace": Namespace,
            "raise_exception": _raise_exception,
            "strftime_now": _strftime_now,
            "dict": dict,
        }
        g.update(ctx)
        self.scopes: List[Dict[str, Any]] = [g]

    def _push(self, scope):
        self.scopes.append(scope)

    def _pop(self):
        self.scopes.pop()

    def lookup(self, name):
        for s in reversed(self.scopes):
            if name in s:
                return s[name]
        return Undefined(name)

    def assign(self, name, val):
        # jinja set writes into the nearest scope that has the name, else
        # the current (innermost) scope — close enough for templates
        for s in reversed(self.scopes):
            if name in s:
                s[name] = val
                return
        self.scopes[-1][name] = val

    # -- statements ------------------------------------------------------
    def _exec_nodes(self, nodes, out: List[str]):
        for n in nodes:
            op = n[0]
            if op == "text":
                out.append(n[1])
            elif op == "emit":
                v = self.eval(n[1])
                out.append(self._stringify(v))
            elif op == "if":
                done = False
                for cond, body in n[1]:
                    if self._truthy(self.eval(cond)):
                        self._exec_nodes(body, out)
                        done = True
                        break
                if not done:
                    self._exec_nodes(n[2], out)
            elif op == "for":
                self._exec_for(n, out)
            elif op == "set":
                self._exec_set(n[1], self.eval(n[2]))
            elif op == "setblock":
                sub: List[str] = []
                self._exec_nodes(n[2], sub)
                self._exec_set(n[1], "".join(sub))
            elif op == "macro":
                _, name, argnames, defaults, body = n
                dvals = [self.eval(d) for d in defaults]
                self.scopes[0][name] = _Macro(name, argnames, dvals, body, self)
            elif op == "break":
                raise _Break()
            elif op == "continue":
                raise _Continue()
            elif op == "filterblock":
                sub = []
                self._exec_nodes(n[2], sub)
                f = FILTERS.get(n[1])
                if f is None:
                    raise TemplateError(f"unknown filter {n[1]!r}")
                out.append(self._stringify(f("".join(sub))))
            else:
                raise TemplateError(f"bad node {op}")

    def _exec_set(self, target: str, val):
        if "." in target:
            base, _, attr = target.partition(".")
            obj = self.lookup(base)
            if isinstance(obj, Undefined):
                raise TemplateError(f"set on undefined {base!r}")
            if isinstance(obj, dict):
                obj[attr] = val
            else:
                setattr(obj, attr, val)
        elif "," in target:
            names = [t.strip() for t in target.split(",")]
            vals = list(val)
            for nm, vv in zip(names, vals):
                self.assign(nm, vv)
        else:
            self.assign(target, val)

    def _exec_for(self, n, out):
        _, targets, seq_e, cond, body, ebody = n
        seq = self.eval(seq_e)
        if isinstance(seq, Undefined):
            raise TemplateError("iterating undefined value in for")
        if isinstance(seq, dict):
            seq = list(seq.items()) if len(targets) > 1 else list(seq)
        else:
            seq = list(seq)
        scope: Dict[str, Any] = {}
        self._push(scope)
        try:
            if cond is not None:
                filtered = []
                for item in seq:
                    self._bind_targets(scope, targets, item)
                    if self._truthy(self.eval(cond)):
                        filtered.append(item)
                seq = filtered
            if not seq:
                self._pop()
                try:
                    self._exec_nodes(ebody, out)
                finally:
                    self._push(scope)
                return
            n_items = len(seq)
            for idx, item in enumerate(seq):
                self._bind_targets(scope, targets, item)
                scope["loop"] = _LoopVar(idx, n_items, seq)
                try:
                    self._exec_nodes(body, out)
                except _Continue:
                    continue
                except _Break:
                    break
        finally:
            self._pop()

    def _bind_targets(self, scope, targets, item):
        if len(targets) == 1:
            scope[targets[0]] = item
        else:
            vals = list(item)
            for t, v in zip(targets, vals):
                scope[t] = v

    @staticmethod
    def _truthy(v):
        if isinstance(v, Undefined):
            return False
        return bool(v)

    @staticmethod
    def _stringify(v) -> str:
        if v is None:
            return "None"
        if v is True:
            return "True"
        if v is False:
            return "False"
        if isinstance(v, (dict, list, tuple)):
            return repr(v)
        return str(v)

    # -- expressions -----------------------------------------------------
    def eval(self, e):
        op = e[0]
        if op == "const":
            return e[1]
        if op == "var":
            return self.lookup(e[1])
        if op == "list":
            return [self.eval(x) for x in e[1]]
        if op == "tuple":
            return tuple(self.eval(x) for x in e[1])
        if op == "dict":
            return {self.eval(k): self.eval(v) for k, v in e[1]}
        if op == "or":
            l = self.eval(e[1])
            return l if self._truthy(l) else self.eval(e[2])
        if op == "and":
            l = self.eval(e[1])
            return self.eval(e[2]) if self._truthy(l) else l
        if op == "not":
            return not self._truthy(self.eval(e[1]))
        if op == "cond":
            return self.eval(e[2]) if self._truthy(self.eval(e[1])) \
                else self.eval(e[3])
        if op == "cmp":
            a, b = self.eval(e[2]), self.eval(e[3])
            sym = e[1]
            try:
                if sym == "==":
                    return a == b
                if sym == "!=":
                    return a != b
                if isinstance(a, Undefined) or isinstance(b, Undefined):
                    raise TemplateError("comparison with undefined")
                return {"<": a < b, "<=": a <= b, ">": a > b,
                        ">=": a >= b}[sym]
            except TypeError as ex:
                raise TemplateError(str(ex))
        if op == "in":
            a, b = self.eval(e[1]), self.eval(e[2])
            if isinstance(b, Undefined):
                raise TemplateError("'in' on undefined")
            return a in b
        if op == "test":
            return _apply_test(e[1], self.eval(e[2]),
                               [self.eval(a) for a in e[3]])
        if op == "concat":
            return self._stringify(self.eval(e[1])) + \
                self._stringify(self.eval(e[2]))
        if op in ("add", "sub", "mul", "div", "floordiv", "mod", "pow"):
            a, b = self.eval(e[1]), self.eval(e[2])
            if isinstance(a, Undefined) or isinstance(b, Undefined):
                raise TemplateError(f"arithmetic on undefined ({op})")
            try:
                return {"add": lambda: a + b, "sub": lambda: a - b,
                        "mul": lambda: a * b, "div": lambda: a / b,
                        "floordiv": lambda: a // b, "mod": lambda: a % b,
                        "pow": lambda: a ** b}[op]()
            except TypeError as ex:
                raise TemplateError(str(ex))
        if op == "neg":
            return -self.eval(e[1])
        if op == "attr":
            return self._getattr(self.eval(e[1]), e[2])
        if op == "index":
            return self._getindex(self.eval(e[1]), e[2])
        if op == "call":
            fn = self.eval(e[1])
            if isinstance(fn, Undefined):
                raise TemplateError("call of undefined")
            args = [self.eval(a) for a in e[2]]
            kwargs = {k: self.eval(v) for k, v in e[3]}
            return fn(*args, **kwargs)
        if op == "filter":
            f = FILTERS.get(e[1])
            if f is None:
                raise TemplateError(f"unknown filter {e[1]!r}")
            val = self.eval(e[2])
            args = [self.eval(a) for a in e[3]]
            kwargs = {k: self.eval(v) for k, v in e[4]}
            return f(val, *args, **kwargs)
        raise TemplateError(f"bad expr {op}")

    def _getattr(self, obj, name):
        if isinstance(obj, Undefined):
            return Undefined(name)
        if isinstance(obj, dict):
            if name in obj:
                return obj[name]
            # dict methods (get/items/keys/values) still reachable
            if name in ("get", "items", "keys", "values") and hasattr(obj, name):
                return getattr(obj, name)
            return Undefined(name)
        if name.startswith("_"):
            raise TemplateError(f"attribute {name!r} not allowed")
        v = getattr(obj, name, None)
        if v is None and not hasattr(obj, name):
            return Undefined(name)
        return v

    def _getindex(self, obj, idx_e):
        if isinstance(idx_e, tuple) and idx_e and idx_e[0] == "slice":
            start = self.eval(idx_e[1]) if idx_e[1] is not None else None
            stop = self.eval(idx_e[2]) if idx_e[2] is not None else None
            step = self.eval(idx_e[3]) if idx_e[3] is not None else None
            if isinstance(obj, Undefined):
                raise TemplateError("slicing undefined")
            return obj[slice(start, stop, step)]
        idx = self.eval(idx_e)
        if isinstance(obj, Undefined):
            return Undefined(str(idx))
        if isinstance(obj, dict):
            return obj.get(idx, Undefined(str(idx)))
        try:
            return obj[idx]
        except (IndexError, KeyError, TypeError) as ex:
            raise TemplateError(str(ex))


def render_template(source: str, **ctx) -> str:
    """Render an HF chat template with HF's environment semantics."""
    return Template(source).render(**ctx)
