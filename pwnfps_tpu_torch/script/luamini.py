"""luamini: a small Lua 5.1 interpreter for game scripts.
Copied from pwnfps_tpu/script/luamini.py.

The reference embeds Lua 5.1 and runs game.lua against five C bindings
(script.h:71-102).  No Lua library is bundled, so we
provide a self-contained interpreter covering the game-logic subset of
Lua 5.1: numbers (doubles), strings, booleans, nil, tables (constructors,
indexing, '#' length), functions and closures, multiple assignment with
call expansion, local scoping, if/elseif/while/repeat/numeric-for/
generic-for (pairs/ipairs), operators (arith, %, ^, comparison, and/or/
not, ..), stdlib subset (math.*, string.format/len/sub/rep/upper/lower/
byte/char/reverse, the full Lua 5.1 pattern language (string.find/
match/gmatch/gsub with classes, sets, captures incl. position captures,
%1-%9 back-references, %bxy, %f[set], anchors, all four quantifiers),
coroutines (create/resume/yield/status/running/wrap; thread-backed,
one runner at a time), loadstring/load, os.time/clock/date/getenv,
io.write/read, table.insert/remove/concat/sort/getn/foreach(i), print, tostring,
tonumber,
type, pairs/ipairs, pcall, error, assert, unpack, select, raw*),
metatables
(set/getmetatable with the 5.1 core metamethods: __index/__newindex
chains, __call, __tostring, __eq/__lt/__le, __add/__sub/__mul/__div/
__mod/__pow/__unm/__concat, __metatable protection), ':'-method calls
and `function t:m()` definition sugar, and string methods via ':'
(strings index the string library, as stock 5.1's string metatable).

Deliberately out of scope (documented): goto/labels (5.2+ anyway),
require/module, io beyond write/read (files), os beyond
time/clock/date/getenv, string.dump, __len on tables (5.1 honours it
only for userdata), weak tables/__gc.  Scripts needing those belong
in the Python scripting frontend.
"""

from __future__ import annotations

import math
import re


class LuaError(RuntimeError):
    pass


# ----------------------------------------------------------------- lexer
_KEYWORDS = {"and", "break", "do", "else", "elseif", "end", "false",
             "for", "function", "if", "in", "local", "nil", "not", "or",
             "repeat", "return", "then", "true", "until", "while"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--\[\[.*?\]\]|--[^\n]*)
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>\.\.\.|\.\.|==|~=|<=|>=|[-+*/%^#<>=(){}\[\];:,.])
""", re.VERBOSE | re.DOTALL)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'",
            "\n": "\n"}


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            if n.isdigit():
                j = i + 1
                while j < len(s) and j < i + 4 and s[j].isdigit():
                    j += 1
                out.append(chr(int(s[i + 1:j])))
                i = j
                continue
            out.append(_ESCAPES.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(src: str):
    toks = []
    pos = 0
    line = 1
    # long strings [[...]] (rare; support at lexer level)
    while pos < len(src):
        if src.startswith("[[", pos):
            end = src.find("]]", pos + 2)
            if end < 0:
                raise LuaError(f"unterminated long string at line {line}")
            toks.append(("string", src[pos + 2:end], line))
            line += src.count("\n", pos, end)
            pos = end + 2
            continue
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise LuaError(f"unexpected char {src[pos]!r} at line {line}")
        kind = m.lastgroup
        text = m.group()
        line += text.count("\n")
        pos = m.end()
        if kind in ("ws", "comment"):
            continue
        if kind == "number":
            val = float(int(text, 16)) if text[:2].lower() == "0x" \
                else float(text)
            toks.append(("number", val, line))
        elif kind == "name":
            if text in _KEYWORDS:
                toks.append((text, text, line))
            else:
                toks.append(("name", text, line))
        elif kind == "string":
            toks.append(("string", _unescape(text[1:-1]), line))
        else:
            toks.append((text, text, line))
    toks.append(("eof", None, line))
    return toks


# ---------------------------------------------------------------- parser
class Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i][0]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise LuaError(f"expected {kind!r}, got {t[0]!r} "
                           f"(line {t[2]})")
        return t

    def accept(self, kind):
        if self.peek() == kind:
            return self.next()
        return None

    # -- statements ---------------------------------------------------------
    def parse_chunk(self, terminators=("eof",)):
        stmts = []
        while self.peek() not in terminators:
            if self.accept(";"):
                continue
            stmts.append(self.statement())
            if stmts[-1][0] in ("return", "break"):
                break
        return ("block", stmts)

    def statement(self):
        t = self.peek()
        if t == "local":
            self.next()
            if self.accept("function"):
                name = self.expect("name")[1]
                return ("localfunc", name, self.funcbody())
            names = [self.expect("name")[1]]
            while self.accept(","):
                names.append(self.expect("name")[1])
            exprs = []
            if self.accept("="):
                exprs = self.exprlist()
            return ("local", names, exprs)
        if t == "if":
            return self.if_stmt()
        if t == "while":
            self.next()
            cond = self.expr()
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("while", cond, body)
        if t == "repeat":
            self.next()
            body = self.parse_chunk(("until",))
            self.expect("until")
            cond = self.expr()
            return ("repeat", body, cond)
        if t == "for":
            return self.for_stmt()
        if t == "function":
            self.next()
            target, ismethod = self.funcname()
            fb = self.funcbody()
            if ismethod:
                fb = ("function", ["self"] + fb[1], fb[2], fb[3])
            return ("assignfunc", target, fb)
        if t == "return":
            self.next()
            exprs = []
            if self.peek() not in ("end", "eof", "else", "elseif",
                                   "until", ";"):
                exprs = self.exprlist()
            return ("return", exprs)
        if t == "break":
            self.next()
            return ("break",)
        if t == "do":
            self.next()
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("do", body)
        # expression statement or assignment
        e = self.suffixedexp()
        if self.peek() in ("=", ","):
            targets = [e]
            while self.accept(","):
                targets.append(self.suffixedexp())
            self.expect("=")
            exprs = self.exprlist()
            return ("assign", targets, exprs)
        return ("exprstat", e)

    def funcname(self):
        """-> (target expr, ismethod): `function a.b:c()` assigns to
        a.b.c with an implicit leading `self` parameter (Lua 5.1
        method-definition sugar)."""
        e = ("name", self.expect("name")[1])
        while self.accept("."):
            e = ("index", e, ("const", self.expect("name")[1]))
        if self.accept(":"):
            return ("index", e, ("const", self.expect("name")[1])), True
        return e, False

    def if_stmt(self):
        self.expect("if")
        cond = self.expr()
        self.expect("then")
        body = self.parse_chunk(("elseif", "else", "end"))
        clauses = [(cond, body)]
        orelse = ("block", [])
        while True:
            t = self.next()[0]
            if t == "elseif":
                c = self.expr()
                self.expect("then")
                b = self.parse_chunk(("elseif", "else", "end"))
                clauses.append((c, b))
            elif t == "else":
                orelse = self.parse_chunk(("end",))
                self.expect("end")
                break
            elif t == "end":
                break
        return ("if", clauses, orelse)

    def for_stmt(self):
        self.expect("for")
        name = self.expect("name")[1]
        if self.accept("="):
            start = self.expr()
            self.expect(",")
            stop = self.expr()
            step = self.expr() if self.accept(",") else ("const", 1.0)
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("fornum", name, start, stop, step, body)
        names = [name]
        while self.accept(","):
            names.append(self.expect("name")[1])
        self.expect("in")
        exprs = self.exprlist()
        self.expect("do")
        body = self.parse_chunk(("end",))
        self.expect("end")
        return ("forin", names, exprs, body)

    def funcbody(self):
        self.expect("(")
        params = []
        vararg = False
        if self.peek() != ")":
            while True:
                if self.accept("..."):
                    vararg = True
                    break
                params.append(self.expect("name")[1])
                if not self.accept(","):
                    break
        self.expect(")")
        body = self.parse_chunk(("end",))
        self.expect("end")
        return ("function", params, vararg, body)

    # -- expressions (precedence climbing) ------------------------------------
    _BINPRI = {"or": (1, 1), "and": (2, 2),
               "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
               "~=": (3, 3), "==": (3, 3),
               "..": (5, 4),  # right assoc
               "+": (6, 6), "-": (6, 6),
               "*": (7, 7), "/": (7, 7), "%": (7, 7),
               "^": (10, 9)}  # right assoc

    def exprlist(self):
        es = [self.expr()]
        while self.accept(","):
            es.append(self.expr())
        return es

    def expr(self, limit=0):
        t = self.peek()
        if t in ("not", "-", "#"):
            self.next()
            e = ("unop", t, self.expr(8))
        else:
            e = self.simpleexp()
        while True:
            op = self.peek()
            pri = self._BINPRI.get(op)
            if not pri or pri[0] <= limit:
                break
            self.next()
            rhs = self.expr(pri[1])
            e = ("binop", op, e, rhs)
        return e

    def simpleexp(self):
        t, v, line = self.toks[self.i]
        if t == "number":
            self.next()
            return ("const", v)
        if t == "string":
            self.next()
            return ("const", v)
        if t == "nil":
            self.next()
            return ("const", None)
        if t == "true":
            self.next()
            return ("const", True)
        if t == "false":
            self.next()
            return ("const", False)
        if t == "function":
            self.next()
            return self.funcbody()
        if t == "{":
            return self.tablector()
        if t == "...":
            self.next()
            return ("vararg",)
        return self.suffixedexp()

    def suffixedexp(self):
        t, v, line = self.toks[self.i]
        if t == "(":
            self.next()
            e = ("paren", self.expr())
            self.expect(")")
        elif t == "name":
            self.next()
            e = ("name", v)
        else:
            raise LuaError(f"unexpected {t!r} (line {line})")
        while True:
            t = self.peek()
            if t == ".":
                self.next()
                e = ("index", e, ("const", self.expect("name")[1]))
            elif t == "[":
                self.next()
                e = ("index", e, self.expr())
                self.expect("]")
            elif t == "(":
                self.next()
                args = [] if self.peek() == ")" else self.exprlist()
                self.expect(")")
                e = ("call", e, args)
            elif t == "string":
                e = ("call", e, [("const", self.next()[1])])
            elif t == "{":
                e = ("call", e, [self.tablector()])
            elif t == ":":
                self.next()
                m = self.expect("name")[1]
                self.expect("(")
                args = [] if self.peek() == ")" else self.exprlist()
                self.expect(")")
                e = ("methcall", e, m, args)
            else:
                return e

    def tablector(self):
        self.expect("{")
        items = []   # ("item", expr) | ("kv", kexpr, vexpr)
        while self.peek() != "}":
            if self.peek() == "[":
                self.next()
                k = self.expr()
                self.expect("]")
                self.expect("=")
                items.append(("kv", k, self.expr()))
            elif (self.toks[self.i][0] == "name"
                  and self.toks[self.i + 1][0] == "="):
                k = self.next()[1]
                self.next()
                items.append(("kv", ("const", k), self.expr()))
            else:
                items.append(("item", self.expr()))
            if not (self.accept(",") or self.accept(";")):
                break
        self.expect("}")
        return ("table", items)


# ------------------------------------------------------------- runtime
class LuaTable:
    __slots__ = ("hash", "mt")

    def __init__(self):
        self.hash = {}
        self.mt = None      # metatable (LuaTable) or None

    def get(self, k):
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        return self.hash.get(k)

    def set(self, k, v):
        if k is None:
            raise LuaError("table index is nil")
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        if v is None:
            self.hash.pop(k, None)
        else:
            self.hash[k] = v

    def length(self):
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return float(n)


class LuaFunction:
    __slots__ = ("params", "vararg", "body", "env")

    def __init__(self, params, vararg, body, env):
        self.params = params
        self.vararg = vararg
        self.body = body
        self.env = env


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return None


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return str(int(v))
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):x}"
    return f"function: 0x{id(v):x}"


def _stdlib():
    mt = LuaTable()
    for n in ("sin", "cos", "tan", "asin", "acos", "exp", "sqrt",
              "floor", "ceil"):
        mt.set(n, (lambda f: lambda x: float(f(x)))(getattr(math, n)))
    mt.set("atan", lambda y, x=None:
           math.atan(y) if x is None else math.atan2(y, x))
    mt.set("log", lambda x, b=None:
           math.log(x) if b is None else math.log(x, b))
    mt.set("fmod", lambda a, b: float(math.fmod(a, b)))
    mt.set("abs", lambda x: float(abs(x)))
    mt.set("max", lambda *a: float(max(a)))
    mt.set("min", lambda *a: float(min(a)))
    mt.set("pow", lambda a, b: float(a) ** float(b))
    mt.set("pi", math.pi)
    mt.set("huge", math.inf)
    mt.set("random", _math_random)
    mt.set("randomseed", lambda x: _rng.seed(int(x)))

    st = LuaTable()
    st.set("format", _string_format)
    st.set("len", lambda s: float(len(s)))
    st.set("sub", lambda s, i, j=-1.0: _string_sub(s, i, j))
    st.set("rep", lambda s, n: s * int(n))
    st.set("upper", lambda s: s.upper())
    st.set("lower", lambda s: s.lower())
    st.set("byte", lambda s, i=1.0: float(ord(s[int(i) - 1])))
    st.set("char", lambda *a: "".join(chr(int(c)) for c in a))
    st.set("reverse", lambda s: s[::-1])
    st.set("find", _string_find)
    st.set("match", _string_match)
    st.set("gmatch", _string_gmatch)
    # string.gsub is installed by Interp (function repls need _call)

    ot = LuaTable()
    ot.set("time", lambda t=None: float(int(_time.time())))
    ot.set("clock", lambda: float(_time.process_time()))
    ot.set("date", lambda fmt="%c", t=None: _time.strftime(
        lua_tostring(fmt).lstrip("*!"),
        _time.localtime(None if t is None else float(t))))
    ot.set("getenv", lambda n: _os_mod.environ.get(lua_tostring(n)))

    it = LuaTable()
    it.set("write", _io_write)
    it.set("read", _io_read)

    tt = LuaTable()
    tt.set("insert", _table_insert)
    tt.set("remove", _table_remove)
    tt.set("concat", _table_concat)
    tt.set("getn", lambda t: float(t.length()))
    # table.sort is installed by Interp (comparators need _call)

    g = {
        "math": mt, "string": st, "table": tt, "os": ot, "io": it,
        "print": lambda *a: print("\t".join(lua_tostring(x) for x in a)),
        "tostring": lua_tostring,
        "tonumber": _tonumber,
        "type": _lua_type,
        "pairs": _pairs,
        "ipairs": _ipairs,
        "error": _lua_error,
        "assert": _lua_assert,
        "pcall": None,  # installed by Interp (needs evaluator)
        "unpack": _unpack,
        "rawget": _rawget,
        "rawset": _rawset,
        "rawequal": lambda a, b: (a is b) or _lua_eq(a, b)
        if not (isinstance(a, LuaTable) and isinstance(b, LuaTable))
        else a is b,
        "select": _select,
        # setmetatable/getmetatable/tostring/print are installed by
        # Interp (they need the evaluator for metamethod dispatch)
    }
    return g


def _rawget(t, k):
    if not isinstance(t, LuaTable):
        raise LuaError("bad argument #1 to 'rawget' (table expected)")
    return t.get(k)


def _rawset(t, k, v):
    if not isinstance(t, LuaTable):
        raise LuaError("bad argument #1 to 'rawset' (table expected)")
    t.set(k, v)
    return t


def _select(n, *args):
    if n == "#":
        return float(len(args))
    i = int(n)
    if i < 0:
        i += len(args) + 1
    if i < 1:
        raise LuaError("bad argument #1 to 'select' (index out of "
                       "range)")
    return tuple(args[i - 1:])


import random as _random_mod  # noqa: E402
import os as _os_mod          # noqa: E402
import sys as _sys_mod        # noqa: E402
import time as _time          # noqa: E402

_rng = _random_mod.Random(0)


def _io_write(*args):
    for a in args:
        if not isinstance(a, (str, float, int)):
            raise LuaError("bad argument to 'write' (string expected)")
        _sys_mod.stdout.write(lua_tostring(a))


def _io_read(fmt="*l"):
    fmt = lua_tostring(fmt).lstrip("*")
    if fmt == "a":
        return _sys_mod.stdin.read()
    line = _sys_mod.stdin.readline()
    if not line:
        return None
    if fmt == "n":
        v = _tonumber(line.strip())
        return v
    return line.rstrip("\n")


def _math_random(m=None, n=None):
    if m is None:
        return _rng.random()
    if n is None:
        return float(_rng.randint(1, int(m)))
    return float(_rng.randint(int(m), int(n)))


def _string_format(fmt, *args):
    out = []
    ai = 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            j = i + 1
            while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                j += 1
            spec = fmt[i:j + 1]
            k = fmt[j]
            a = args[ai] if ai < len(args) else None
            ai += 1
            if k in "di":
                out.append((spec[:-1] + "d") % int(a))
            elif k in "fgGeE":
                out.append((spec) % float(a))
            elif k == "s":
                out.append((spec) % lua_tostring(a))
            elif k == "x" or k == "X":
                out.append((spec) % int(a))
            elif k == "%":
                out.append("%")
                ai -= 1
            else:
                raise LuaError(f"bad format spec {spec!r}")
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _string_sub(s, i, j):
    i, j = int(i), int(j)
    n = len(s)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = n + j + 1
    elif j > n:
        j = n
    return s[i - 1:j] if i <= j else ""


# ------------------------------------------------ Lua 5.1 patterns
# Backtracking matcher implementing the Lua 5.1 pattern language
# (classes, sets, ranges, captures incl. position captures, %1-%9
# back-references, %bxy balanced match, %f[set] frontier, anchors,
# and the four quantifiers * + - ?).  Byte-oriented like the
# reference's embedded Lua (script.h:75-77 opens the full stdlib);
# standard public semantics, implemented from the language spec.

_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _cls_match(ch, cl):
    o = ord(ch)
    low = cl.lower()
    if low == "a":
        r = (65 <= o <= 90) or (97 <= o <= 122)
    elif low == "c":
        r = o < 32 or o == 127
    elif low == "d":
        r = 48 <= o <= 57
    elif low == "l":
        r = 97 <= o <= 122
    elif low == "p":
        r = ch in _PUNCT
    elif low == "s":
        r = ch in " \t\n\r\f\v"
    elif low == "u":
        r = 65 <= o <= 90
    elif low == "w":
        r = (48 <= o <= 57) or (65 <= o <= 90) or (97 <= o <= 122)
    elif low == "x":
        r = ch in "0123456789abcdefABCDEF"
    elif low == "z":
        r = o == 0
    else:
        return ch == cl          # escaped literal (%., %%, %( ...)
    return r if cl.islower() else not r


def _cls_end(p, pi):
    """Index just past the single class starting at p[pi]."""
    c = p[pi]
    if c == "%":
        if pi + 1 >= len(p):
            raise LuaError("malformed pattern (ends with '%')")
        return pi + 2
    if c == "[":
        pi += 1
        if pi < len(p) and p[pi] == "^":
            pi += 1
        if pi < len(p) and p[pi] == "]":   # first ']' is literal
            pi += 1
        while pi < len(p) and p[pi] != "]":
            pi += 2 if p[pi] == "%" else 1
        if pi >= len(p):
            raise LuaError("malformed pattern (missing ']')")
        return pi + 1
    return pi + 1


def _set_match(ch, p, pi, ep):
    """Match ch against the set p[pi:ep] ('[...]')."""
    pi += 1
    neg = False
    if p[pi] == "^":
        neg = True
        pi += 1
    r = False
    while pi < ep - 1:
        if p[pi] == "%":
            if _cls_match(ch, p[pi + 1]):
                r = True
            pi += 2
        elif pi + 2 < ep - 1 and p[pi + 1] == "-":
            if p[pi] <= ch <= p[pi + 2]:
                r = True
            pi += 3
        else:
            if p[pi] == ch:
                r = True
            pi += 1
    return r != neg


def _single_match(ch, p, pi, ep):
    c = p[pi]
    if c == ".":
        return True
    if c == "%":
        return _cls_match(ch, p[pi + 1])
    if c == "[":
        return _set_match(ch, p, pi, ep)
    return ch == c


def _pat_match(s, si, p, pi, caps):
    """Match p[pi:] against s[si:]; returns the end index or None.
    caps: list of [start, len] (len -1 = position capture,
    -2 = unclosed)."""
    while True:
        if pi >= len(p):
            return si
        c = p[pi]
        if c == "(":
            if pi + 1 < len(p) and p[pi + 1] == ")":
                caps.append([si, -1])
                r = _pat_match(s, si, p, pi + 2, caps)
                if r is None:
                    caps.pop()
                return r
            caps.append([si, -2])
            r = _pat_match(s, si, p, pi + 1, caps)
            if r is None:
                caps.pop()
            return r
        if c == ")":
            for cap in reversed(caps):
                if cap[1] == -2:
                    cap[1] = si - cap[0]
                    r = _pat_match(s, si, p, pi + 1, caps)
                    if r is None:
                        cap[1] = -2
                    return r
            raise LuaError("invalid pattern capture")
        if c == "$" and pi + 1 == len(p):
            return si if si == len(s) else None
        if c == "%" and pi + 1 < len(p):
            nc = p[pi + 1]
            if nc == "b":
                if pi + 3 >= len(p):
                    raise LuaError("missing arguments to '%b'")
                x, y = p[pi + 2], p[pi + 3]
                if si >= len(s) or s[si] != x:
                    return None
                bal = 1
                i = si + 1
                while i < len(s):
                    if s[i] == y:
                        bal -= 1
                        if bal == 0:
                            si, pi = i + 1, pi + 4
                            break
                    elif s[i] == x:
                        bal += 1
                    i += 1
                else:
                    return None
                continue
            if nc == "f":
                if pi + 2 >= len(p) or p[pi + 2] != "[":
                    raise LuaError("missing '[' after '%f' in pattern")
                ep = _cls_end(p, pi + 2)
                prev = s[si - 1] if si > 0 else "\0"
                cur = s[si] if si < len(s) else "\0"
                if (not _single_match(prev, p, pi + 2, ep)
                        and _single_match(cur, p, pi + 2, ep)):
                    pi = ep
                    continue
                return None
            if nc.isdigit():
                idx = int(nc) - 1
                if idx >= len(caps) or caps[idx][1] < 0:
                    raise LuaError(f"invalid capture index %{nc}")
                cs, cl_ = caps[idx]
                sub = s[cs:cs + cl_]
                if s.startswith(sub, si):
                    si += len(sub)
                    pi += 2
                    continue
                return None
        ep = _cls_end(p, pi)
        m = si < len(s) and _single_match(s[si], p, pi, ep)
        q = p[ep] if ep < len(p) else None
        if q == "?":
            if m:
                r = _pat_match(s, si + 1, p, ep + 1, caps)
                if r is not None:
                    return r
            pi = ep + 1
            continue
        if q == "+":
            si += 1
            if not m:
                return None
            q = "*"       # fall through to greedy expansion
        if q == "*":
            n = 0
            while si + n < len(s) and _single_match(s[si + n], p, pi,
                                                    ep):
                n += 1
            while n >= 0:
                r = _pat_match(s, si + n, p, ep + 1, caps)
                if r is not None:
                    return r
                n -= 1
            return None
        if q == "-":
            while True:
                r = _pat_match(s, si, p, ep + 1, caps)
                if r is not None:
                    return r
                if si < len(s) and _single_match(s[si], p, pi, ep):
                    si += 1
                else:
                    return None
        if not m:
            return None
        si += 1
        pi = ep


def _cap_values(s, si, ei, caps):
    """Lua capture values; the whole match when there are none."""
    if not caps:
        return (s[si:ei],)
    out = []
    for cs, cl_ in caps:
        if cl_ == -1:                       # position capture
            out.append(float(cs + 1))
        elif cl_ < 0:
            raise LuaError("unfinished capture")
        else:
            out.append(s[cs:cs + cl_])
    return tuple(out)


def _pat_init(s, init):
    n = len(s)
    i = int(init)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    return min(i - 1, n)                    # 0-based start offset


def _pat_search(s, pat, si0):
    """First match of pat in s at/after si0: (si, ei, caps) or None."""
    anchored = pat.startswith("^")
    p0 = 1 if anchored else 0
    si = si0
    while True:
        caps = []
        r = _pat_match(s, si, pat, p0, caps)
        if r is not None:
            return si, r, caps
        si += 1
        if anchored or si > len(s):
            return None


def _string_find(s, pat, init=1.0, plain=None):
    s, pat = lua_tostring(s), lua_tostring(pat)
    si0 = _pat_init(s, init)
    if plain:
        k = s.find(pat, si0)
        if k < 0:
            return None
        return (float(k + 1), float(k + len(pat)))
    m = _pat_search(s, pat, si0)
    if m is None:
        return None
    si, ei, caps = m
    out = (float(si + 1), float(ei))
    return out + _cap_values(s, si, ei, caps) if caps else out


def _string_match(s, pat, init=1.0):
    s, pat = lua_tostring(s), lua_tostring(pat)
    m = _pat_search(s, pat, _pat_init(s, init))
    if m is None:
        return None
    si, ei, caps = m
    v = _cap_values(s, si, ei, caps)
    return v if len(v) > 1 else v[0]


def _string_gmatch(s, pat):
    s, pat = lua_tostring(s), lua_tostring(pat)
    pos = [0]

    def nxt(*_):
        while pos[0] <= len(s):
            caps = []
            r = _pat_match(s, pos[0], pat, 0, caps)
            if r is not None:
                si = pos[0]
                pos[0] = r + 1 if r == si else r   # empty match: step
                return _cap_values(s, si, r, caps)
            pos[0] += 1
        return None
    return nxt


def _string_gsub(call, s, pat, repl, n=None):
    """string.gsub; `call` is the interpreter's _call (function repls
    can be Lua closures)."""
    s, pat = lua_tostring(s), lua_tostring(pat)
    if isinstance(repl, (float, int)):     # 5.1 coerces number repls
        repl = lua_tostring(repl)
    limit = float("inf") if n is None else int(n)
    anchored = pat.startswith("^")
    p0 = 1 if anchored else 0
    out = []
    si = 0
    count = 0
    while count < limit:
        caps = []
        r = _pat_match(s, si, pat, p0, caps)
        if r is not None:
            count += 1
            whole = s[si:r]
            vals = _cap_values(s, si, r, caps)
            if isinstance(repl, str):
                rep = []
                i = 0
                while i < len(repl):
                    ch = repl[i]
                    if ch == "%" and i + 1 < len(repl):
                        d = repl[i + 1]
                        if d == "%":
                            rep.append("%")
                        elif d == "0":
                            rep.append(whole)
                        elif d.isdigit():
                            k = int(d) - 1
                            if k >= len(vals):
                                raise LuaError(
                                    f"invalid capture index %{d}")
                            rep.append(lua_tostring(vals[k]))
                        else:
                            raise LuaError(
                                "invalid use of '%' in replacement "
                                "string")
                        i += 2
                    else:
                        rep.append(ch)
                        i += 1
                out.append("".join(rep))
            else:
                if isinstance(repl, LuaTable):
                    v = repl.get(vals[0])
                else:
                    v = call(repl, list(vals))
                    if isinstance(v, tuple):
                        v = v[0] if v else None
                if v is None or v is False:
                    out.append(whole)
                elif isinstance(v, (str, float, int)):
                    out.append(lua_tostring(v))
                else:
                    raise LuaError("invalid replacement value (a "
                                   + _lua_type(v) + ")")
        if r is not None and r > si:
            si = r
        else:                       # empty match (or no match): step
            if si < len(s):
                out.append(s[si])
            si += 1
        if si > len(s) or anchored:
            break
    out.append(s[si:])
    return ("".join(out), float(count))


# ------------------------------------------------ coroutines
# Thread-backed Lua 5.1 coroutines: only one of (resumer, coroutine)
# runs at a time (hand-off via semaphores), so interpreter state is
# never concurrently touched; threads are daemonic so an abandoned
# suspended coroutine cannot hang the host process.
import threading as _threading   # noqa: E402

_CO_TLS = _threading.local()     # .current = running LuaCoroutine


class LuaCoroutine:
    __slots__ = ("fn", "call", "status", "_resume", "_yield", "_xfer",
                 "_err", "_thread")

    def __init__(self, fn, call):
        self.fn = fn
        self.call = call
        self.status = "suspended"
        self._resume = _threading.Semaphore(0)
        self._yield = _threading.Semaphore(0)
        self._xfer = ()
        self._err = None
        self._thread = None

    def _main(self):
        _CO_TLS.current = self           # this thread IS the coroutine
        self._resume.acquire()
        try:
            r = self.call(self.fn, list(self._xfer))
            self._xfer = (r if isinstance(r, tuple)
                          else () if r is None else (r,))
        except LuaError as e:
            self._err = str(e)
        self.status = "dead"
        self._yield.release()

    def resume(self, *args):
        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status != "suspended":
            return (False, "cannot resume non-suspended coroutine")
        self.status = "running"
        self._xfer = args
        if self._thread is None:
            self._thread = _threading.Thread(target=self._main,
                                             daemon=True)
            self._thread.start()
        self._resume.release()
        self._yield.acquire()            # block until yield or death
        if self.status == "dead" and self._err is not None:
            return (False, self._err)
        return (True,) + tuple(self._xfer)

    def do_yield(self, *args):
        self._xfer = args
        self.status = "suspended"
        self._yield.release()
        self._resume.acquire()
        self.status = "running"
        return tuple(self._xfer)


def _co_create(call):
    def create(fn):
        if not (isinstance(fn, LuaFunction) or callable(fn)):
            raise LuaError("bad argument #1 to 'create'")
        return LuaCoroutine(fn, call)
    return create


def _co_resume(co, *args):
    if not isinstance(co, LuaCoroutine):
        raise LuaError("bad argument #1 to 'resume' (coroutine "
                       "expected)")
    prev = getattr(_CO_TLS, "current", None)   # nested resume: the
    if prev is not None:                       # resumer goes "normal"
        prev.status = "normal"
    r = co.resume(*args)
    if prev is not None:
        prev.status = "running"
    return r


def _co_yield(*args):
    co = getattr(_CO_TLS, "current", None)
    if co is None or co.status != "running":
        raise LuaError("attempt to yield from outside a coroutine")
    return co.do_yield(*args)


def _co_status(co):
    if not isinstance(co, LuaCoroutine):
        raise LuaError("bad argument #1 to 'status'")
    cur = getattr(_CO_TLS, "current", None)
    return "running" if co is cur and co.status == "running" \
        else co.status


def _co_running():
    return getattr(_CO_TLS, "current", None)


def _co_wrap(call):
    create = _co_create(call)

    def wrap(fn):
        co = create(fn)

        def invoke(*args):
            r = _co_resume(co, *args)
            if r[0] is False:
                raise LuaError(lua_tostring(r[1]))
            return r[1:] if len(r) > 2 else (r[1] if len(r) == 2
                                             else None)
        return invoke
    return wrap


def _table_insert(t, a, b=None):
    if b is None:
        t.set(t.length() + 1, a)
    else:
        n = int(t.length())
        pos = int(a)
        for k in range(n, pos - 1, -1):
            t.set(k + 1, t.get(k))
        t.set(pos, b)


def _table_remove(t, pos=None):
    n = int(t.length())
    if n == 0:
        return None
    pos = n if pos is None else int(pos)
    v = t.get(pos)
    for k in range(pos, n):
        t.set(k, t.get(k + 1))
    t.set(n, None)
    return v


def _table_concat(t, sep=""):
    n = int(t.length())
    return sep.join(lua_tostring(t.get(k)) for k in range(1, n + 1))


def _table_foreach(call, t, f):
    """table.foreach (5.1-era, deprecated but common in 2014 scripts):
    call f(k, v) over all pairs; a non-nil return stops and returns."""
    for k, v in list(t.hash.items()):
        r = call(f, [float(k) if isinstance(k, int) else k, v])
        r = r[0] if isinstance(r, tuple) else r
        if r is not None:
            return r
    return None


def _table_foreachi(call, t, f):
    """table.foreachi: f(i, v) over 1..#t, stopping on non-nil."""
    n = int(t.length())
    for i in range(1, n + 1):
        r = call(f, [float(i), t.get(i)])
        r = r[0] if isinstance(r, tuple) else r
        if r is not None:
            return r
    return None


def _table_sort(call, t, comp=None):
    """table.sort (5.1): in-place ascending sort of the array part
    1..#t.  A comparator runs through the interpreter's _call (the
    string.gsub function-repl pattern); without one the default order
    is Lua's `<` (numbers, strings, or an element __lt metamethod),
    and mixed types raise like 5.1.  Unlike 5.1's quicksort this
    never raises 'invalid order function' on inconsistent
    comparators - Python's stable sort just produces some order."""
    import functools
    n = int(t.length())
    vals = [t.get(k) for k in range(1, n + 1)]

    def lt(a, b):
        if comp is not None:
            r = call(comp, [a, b])
            return _truthy(r[0] if isinstance(r, tuple) else r)
        for v in (a, b):
            if isinstance(v, LuaTable) and v.mt is not None:
                h = v.mt.get("__lt")
                if h is not None:
                    r = call(h, [a, b])
                    return _truthy(r[0] if isinstance(r, tuple) else r)
        if isinstance(a, str) and isinstance(b, str):
            return a < b
        if isinstance(a, float) and isinstance(b, float):
            return a < b
        raise LuaError("attempt to compare %s with %s"
                       % (_lua_type(a), _lua_type(b)))

    def cmp(a, b):
        if lt(a, b):
            return -1
        if lt(b, a):
            return 1
        return 0

    vals.sort(key=functools.cmp_to_key(cmp))
    for k, v in enumerate(vals):
        t.set(k + 1, v)


def _tonumber(v, base=None):
    try:
        if base is not None:
            return float(int(str(v), int(base)))
        if isinstance(v, float):
            return v
        return float(str(v).strip())
    except (TypeError, ValueError):
        return None


def _lua_type(v):
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if isinstance(v, LuaCoroutine):
        return "thread"
    return "function"


def _pairs(t):
    items = iter(list(t.hash.items()))

    def nxt(*_):
        try:
            k, v = next(items)
            return (float(k) if isinstance(k, int) else k, v)
        except StopIteration:
            return None
    return (nxt, t, None)


def _ipairs(t):
    def nxt(tt, i):
        i = (i or 0.0) + 1.0
        v = tt.get(i)
        return None if v is None else (i, v)
    return (nxt, t, 0.0)


def _lua_error(msg, _level=None):
    raise LuaError(lua_tostring(msg))


def _lua_assert(v, msg=None):
    if v is None or v is False:
        raise LuaError(lua_tostring(msg) if msg is not None
                       else "assertion failed!")
    return v


def _unpack(t, i=1.0, j=None):
    j = t.length() if j is None else j
    return tuple(t.get(k) for k in range(int(i), int(j) + 1))


class Interp:
    """Evaluator. `globals_` maps names to values; python callables are
    first-class Lua functions (args in, single value or tuple out)."""

    def __init__(self, bindings: dict | None = None):
        self.g = _stdlib()
        self.g["pcall"] = self._pcall
        self.g["setmetatable"] = self._setmetatable
        self.g["getmetatable"] = self._getmetatable
        self.g["tostring"] = self._tostring
        self.g["print"] = lambda *a: print(
            "\t".join(self._tostring(x) for x in a))
        self._strlib = self.g["string"]   # Lua 5.1 string metatable:
        # every string indexes into the string library (s:sub(...))
        self._strlib.set(
            "gsub", lambda s, p, r, n=None:
            _string_gsub(self._call, s, p, r, n))
        self.g["table"].set(
            "sort", lambda t, c=None: _table_sort(self._call, t, c))
        self.g["table"].set(
            "foreach", lambda t, f: _table_foreach(self._call, t, f))
        self.g["table"].set(
            "foreachi", lambda t, f: _table_foreachi(self._call, t, f))
        co = LuaTable()
        co.set("create", _co_create(self._call))
        co.set("resume", _co_resume)
        co.set("yield", _co_yield)
        co.set("status", _co_status)
        co.set("running", _co_running)
        co.set("wrap", _co_wrap(self._call))
        self.g["coroutine"] = co
        self.g["loadstring"] = self._loadstring
        self.g["load"] = self._loadstring
        if bindings:
            self.g.update(bindings)

    def _loadstring(self, src, chunkname=None):
        if callable(src) or isinstance(src, LuaFunction):
            parts = []
            while True:
                piece = self._call(src, [])
                if isinstance(piece, tuple):
                    piece = piece[0] if piece else None
                if piece is None or piece == "":
                    break
                parts.append(lua_tostring(piece))
            src = "".join(parts)
        try:
            ast = Parser(tokenize(lua_tostring(src))).parse_chunk()
        except LuaError as e:
            return (None, str(e))

        def chunk(*args):
            sc = Scope()
            sc.vars["..."] = tuple(args)
            try:
                self.exec_block(ast, sc)
            except _Return as r:
                vs = r.values
                return (tuple(vs) if len(vs) > 1
                        else vs[0] if vs else None)
            return None
        return chunk

    # -- metatables (Lua 5.1 subset: __index, __newindex, __call,
    # __tostring, __eq, and the binary arithmetic/compare/concat
    # metamethods; no __len on tables, __gc, __mode or coroutines -
    # matching the 5.1 core semantics game scripts use) --------------
    def _setmetatable(self, t, mt):
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument #1 to 'setmetatable' "
                           "(table expected)")
        if mt is not None and not isinstance(mt, LuaTable):
            raise LuaError("bad argument #2 to 'setmetatable' "
                           "(nil or table expected)")
        if t.mt is not None and t.mt.get("__metatable") is not None:
            raise LuaError("cannot change a protected metatable")
        t.mt = mt
        return t

    def _getmetatable(self, t):
        if isinstance(t, str):
            return self._strlib
        if not isinstance(t, LuaTable) or t.mt is None:
            return None
        prot = t.mt.get("__metatable")
        return prot if prot is not None else t.mt

    def _tostring(self, v):
        if isinstance(v, LuaTable) and v.mt is not None:
            h = v.mt.get("__tostring")
            if h is not None:
                r = self._call(h, [v])
                return r[0] if isinstance(r, tuple) else r
        return lua_tostring(v)

    # Lua 5.1 bounds gettable/settable metatable chains at 100 hops
    # ("loop in gettable") so a cyclic __index/__newindex chain errors
    # instead of hanging the host (r4 advisor finding).
    _MAX_MT_HOPS = 100

    def _index(self, t, k):
        """t[k] honouring __index chains; strings index the string
        library (the reference opens the stock 5.1 string metatable,
        script.h:75-77)."""
        for _ in range(self._MAX_MT_HOPS):
            if isinstance(t, LuaTable):
                v = t.get(k)
                if v is not None:
                    return v
                h = t.mt.get("__index") if t.mt is not None else None
                if h is None:
                    return None
                if isinstance(h, LuaTable):
                    t = h
                    continue
                r = self._call(h, [t, k])
                return r[0] if isinstance(r, tuple) else r
            if isinstance(t, str):
                return self._strlib.get(k)
            if t is None:
                raise LuaError("attempt to index a nil value")
            raise LuaError(f"attempt to index a {_lua_type(t)} value")
        raise LuaError("loop in gettable")

    def _newindex(self, t, k, v):
        """t[k] = v honouring __newindex chains."""
        for _ in range(self._MAX_MT_HOPS):
            if not isinstance(t, LuaTable):
                raise LuaError(
                    f"attempt to index a {_lua_type(t)} value")
            if t.get(k) is not None or t.mt is None:
                return t.set(k, v)
            h = t.mt.get("__newindex")
            if h is None:
                return t.set(k, v)
            if isinstance(h, LuaTable):
                t = h
                continue
            self._call(h, [t, k, v])
            return
        raise LuaError("loop in settable")

    _BIN_MM = {"+": "__add", "-": "__sub", "*": "__mul", "/": "__div",
               "%": "__mod", "^": "__pow", "..": "__concat"}

    def _binmm(self, o, a, b):
        """Binary metamethod for `a o b` (either operand a table), or
        None."""
        name = self._BIN_MM.get(o)
        if name is None:
            return None
        for v in (a, b):
            if isinstance(v, LuaTable) and v.mt is not None:
                h = v.mt.get(name)
                if h is not None:
                    r = self._call(h, [a, b])
                    return (r[0] if isinstance(r, tuple) else r,)
        return None

    # -- public ---------------------------------------------------------------
    def run(self, src: str, chunkname: str = "?"):
        ast = Parser(tokenize(src)).parse_chunk()
        try:
            self.exec_block(ast, Scope())
        except _Return:
            pass

    def call(self, fn, *args):
        return self._call(fn, list(args))

    # -- helpers ---------------------------------------------------------------
    def _pcall(self, fn, *args):
        try:
            r = self._call(fn, list(args))
            if isinstance(r, tuple):
                return (True,) + r
            return (True, r) if r is not None else (True,)
        except LuaError as e:
            return (False, str(e))

    def _call(self, fn, args):
        if isinstance(fn, LuaFunction):
            sc = Scope(fn.env)
            for i, p in enumerate(fn.params):
                sc.vars[p] = args[i] if i < len(args) else None
            if fn.vararg:
                sc.vars["..."] = tuple(args[len(fn.params):])
            try:
                self.exec_block(fn.body, sc)
            except _Return as r:
                vs = r.values
                if len(vs) == 0:
                    return None
                if len(vs) == 1:
                    return vs[0]
                return tuple(vs)
            return None
        if callable(fn):
            r = fn(*args)
            return r
        if isinstance(fn, LuaTable) and fn.mt is not None:
            h = fn.mt.get("__call")
            if h is not None:
                return self._call(h, [fn] + args)
        raise LuaError(f"attempt to call a {_lua_type(fn)} value")

    # -- statements -------------------------------------------------------------
    def exec_block(self, block, scope):
        for st in block[1]:
            self.exec_stmt(st, scope)

    def exec_stmt(self, st, scope):
        op = st[0]
        if op == "exprstat":
            self.eval(st[1], scope)
        elif op == "assign":
            vals = self._evallist(st[2], scope, len(st[1]))
            for tgt, v in zip(st[1], vals):
                self._settarget(tgt, v, scope)
        elif op == "local":
            vals = self._evallist(st[2], scope, len(st[1]))
            for name, v in zip(st[1], vals):
                scope.vars[name] = v
        elif op == "localfunc":
            scope.vars[st[1]] = None
            scope.vars[st[1]] = self.eval(st[2], scope)
        elif op == "assignfunc":
            self._settarget(st[1], self.eval(st[2], scope), scope)
        elif op == "if":
            for cond, body in st[1]:
                if _truthy(self.eval1(cond, scope)):
                    return self.exec_block(body, Scope(scope))
            return self.exec_block(st[2], Scope(scope))
        elif op == "while":
            while _truthy(self.eval1(st[1], scope)):
                try:
                    self.exec_block(st[2], Scope(scope))
                except _Break:
                    break
        elif op == "repeat":
            while True:
                sc = Scope(scope)
                try:
                    self.exec_block(st[1], sc)
                except _Break:
                    break
                if _truthy(self.eval1(st[2], sc)):
                    break
        elif op == "fornum":
            start = _num(self.eval1(st[2], scope))
            stop = _num(self.eval1(st[3], scope))
            step = _num(self.eval1(st[4], scope))
            i = start
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                sc = Scope(scope)
                sc.vars[st[1]] = i
                try:
                    self.exec_block(st[5], sc)
                except _Break:
                    break
                i += step
        elif op == "forin":
            vals = self._evallist(st[2], scope, 3)
            f, s, ctl = vals[0], vals[1], vals[2]
            while True:
                r = self._call(f, [s, ctl])
                if r is None:
                    break
                rs = r if isinstance(r, tuple) else (r,)
                if rs[0] is None:
                    break
                ctl = rs[0]
                sc = Scope(scope)
                for i, name in enumerate(st[1]):
                    sc.vars[name] = rs[i] if i < len(rs) else None
                try:
                    self.exec_block(st[3], sc)
                except _Break:
                    break
        elif op == "return":
            vals = self._evallist(st[1], scope, -1)
            raise _Return(vals)
        elif op == "break":
            raise _Break()
        elif op == "do":
            self.exec_block(st[1], Scope(scope))
        else:
            raise LuaError(f"unknown statement {op}")

    def _settarget(self, tgt, v, scope):
        if tgt[0] == "name":
            sc = scope.lookup(tgt[1])
            if sc is not None:
                sc.vars[tgt[1]] = v
            else:
                self.g[tgt[1]] = v
        elif tgt[0] == "index":
            t = self.eval1(tgt[1], scope)
            k = self.eval1(tgt[2], scope)
            self._newindex(t, k, v)
        else:
            raise LuaError("cannot assign to this expression")

    def _evallist(self, exprs, scope, want):
        """Evaluate an expression list; the last call/vararg expands."""
        vals = []
        for i, e in enumerate(exprs):
            v = self.eval(e, scope)
            if i == len(exprs) - 1 and isinstance(v, tuple):
                vals.extend(v)
            else:
                vals.append(v[0] if isinstance(v, tuple) and v else
                            (None if isinstance(v, tuple) else v))
        if want >= 0:
            while len(vals) < want:
                vals.append(None)
        return vals

    # -- expressions ---------------------------------------------------------
    def eval1(self, e, scope):
        v = self.eval(e, scope)
        if isinstance(v, tuple):
            return v[0] if v else None
        return v

    def eval(self, e, scope):
        op = e[0]
        if op == "const":
            v = e[1]
            return float(v) if isinstance(v, (int,)) and not \
                isinstance(v, bool) else v
        if op == "name":
            sc = scope.lookup(e[1])
            if sc is not None:
                return sc.vars[e[1]]
            return self.g.get(e[1])
        if op == "paren":
            return self.eval1(e[1], scope)
        if op == "index":
            t = self.eval1(e[1], scope)
            k = self.eval1(e[2], scope)
            return self._index(t, k)
        if op == "call":
            fn = self.eval1(e[1], scope)
            args = self._evallist(e[2], scope, -1)
            return self._call(fn, args)
        if op == "methcall":
            obj = self.eval1(e[1], scope)
            # __index-aware lookup; strings resolve via the string
            # library (s:sub(..), s:format(..) work as in stock 5.1)
            fn = self._index(obj, e[2])
            args = [obj] + self._evallist(e[3], scope, -1)
            return self._call(fn, args)
        if op == "function":
            return LuaFunction(e[1], e[2], e[3], scope)
        if op == "vararg":
            sc = scope.lookup("...")
            return sc.vars["..."] if sc else ()
        if op == "table":
            t = LuaTable()
            n = 0
            items = e[1]
            for i, it in enumerate(items):
                if it[0] == "kv":
                    t.set(self.eval1(it[1], scope),
                          self.eval1(it[2], scope))
                else:
                    v = self.eval(it[1], scope)
                    if i == len(items) - 1 and isinstance(v, tuple):
                        for x in v:
                            n += 1
                            t.set(float(n), x)
                    else:
                        if isinstance(v, tuple):
                            v = v[0] if v else None
                        n += 1
                        t.set(float(n), v)
            return t
        if op == "unop":
            v = self.eval1(e[2], scope)
            if e[1] == "not":
                return not _truthy(v)
            if e[1] == "-":
                if isinstance(v, LuaTable) and v.mt is not None:
                    h = v.mt.get("__unm")
                    if h is not None:
                        r = self._call(h, [v, v])
                        return r[0] if isinstance(r, tuple) else r
                return -_num(v)
            if e[1] == "#":
                if isinstance(v, str):
                    return float(len(v))
                if isinstance(v, LuaTable):
                    return v.length()
                raise LuaError("attempt to get length of a "
                               f"{_lua_type(v)} value")
        if op == "binop":
            o = e[1]
            if o == "and":
                lhs = self.eval1(e[2], scope)
                return self.eval1(e[3], scope) if _truthy(lhs) else lhs
            if o == "or":
                lhs = self.eval1(e[2], scope)
                return lhs if _truthy(lhs) else self.eval1(e[3], scope)
            a = self.eval1(e[2], scope)
            b = self.eval1(e[3], scope)
            if o in ("==", "~="):
                eq = _lua_eq(a, b)
                if (not eq and isinstance(a, LuaTable)
                        and isinstance(b, LuaTable)
                        and a.mt is not None and b.mt is not None):
                    # 5.1 dispatches __eq only when BOTH operands
                    # select the SAME handler (lvm.c luaV_equalval)
                    h = a.mt.get("__eq")
                    if h is not None and h is b.mt.get("__eq"):
                        r = self._call(h, [a, b])
                        eq = _truthy(r[0] if isinstance(r, tuple)
                                     else r)
                return eq if o == "==" else not eq
            if o == "..":
                mm = self._binmm(o, a, b)
                if mm is not None:
                    return mm[0]
                return _str_or_num(a) + _str_or_num(b)
            if o in ("<", ">", "<=", ">="):
                if isinstance(a, LuaTable) or isinstance(b, LuaTable):
                    # __lt / __le, operand order follows the op
                    x, y, name = {
                        "<": (a, b, "__lt"), ">": (b, a, "__lt"),
                        "<=": (a, b, "__le"), ">=": (b, a, "__le"),
                    }[o]
                    for v in (x, y):
                        if isinstance(v, LuaTable) and v.mt is not None:
                            h = v.mt.get(name)
                            if h is not None:
                                r = self._call(h, [x, y])
                                return _truthy(
                                    r[0] if isinstance(r, tuple)
                                    else r)
                    raise LuaError("attempt to compare "
                                   f"{_lua_type(a)} with "
                                   f"{_lua_type(b)}")
                if isinstance(a, str) and isinstance(b, str):
                    pass
                else:
                    a, b = _num(a), _num(b)
                return {"<": a < b, ">": a > b,
                        "<=": a <= b, ">=": a >= b}[o]
            mm = self._binmm(o, a, b)
            if mm is not None:
                return mm[0]
            a, b = _num(a), _num(b)
            if o == "+":
                return a + b
            if o == "-":
                return a - b
            if o == "*":
                return a * b
            if o == "/":
                return a / b if b != 0 else math.copysign(
                    math.inf, a) if a != 0 else math.nan
            if o == "%":
                return a - math.floor(a / b) * b if b != 0 else math.nan
            if o == "^":
                return float(a) ** float(b)
        raise LuaError(f"unknown expression {op}")


def _truthy(v):
    return v is not None and v is not False


def _num(v):
    if isinstance(v, float):
        return v
    if isinstance(v, bool) or v is None:
        raise LuaError(f"attempt to perform arithmetic on a "
                       f"{_lua_type(v)} value")
    if isinstance(v, str):
        n = _tonumber(v)
        if n is None:
            raise LuaError("attempt to perform arithmetic on a string")
        return n
    raise LuaError(f"attempt to perform arithmetic on a {_lua_type(v)}")


def _str_or_num(v):
    if isinstance(v, str):
        return v
    if isinstance(v, float):
        return lua_tostring(v)
    raise LuaError(f"attempt to concatenate a {_lua_type(v)} value")


def _lua_eq(a, b):
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    return a == b


class LuaScript:
    """Run a Lua game script against the engine bindings - the reference
    contract: top-level runs at load; on_tick(sec, dt) every frame,
    missing/failing on_tick is fatal (script.h:86-97, main.c:127-140)."""

    def __init__(self, api, path: str):
        from .api import ScriptError

        self._ScriptError = ScriptError
        bindings = {}
        for name, fn in api.bindings().items():
            bindings[name] = self._wrap(fn)
        self.interp = Interp(bindings)
        with open(path) as f:
            src = f.read()
        self.interp.run(src, path)
        if self.interp.g.get("on_tick") is None:
            raise ScriptError("on_tick not defined")

    @staticmethod
    def _wrap(fn):
        def wrapped(*args):
            r = fn(*args)
            if isinstance(r, int) and not isinstance(r, bool):
                return float(r)
            return r
        return wrapped

    def on_tick(self, sec: float, dt: float) -> None:
        try:
            self.interp.call(self.interp.g["on_tick"], float(sec),
                             float(dt))
        except LuaError as e:
            raise self._ScriptError(f"on_tick broke ({e})") from e
