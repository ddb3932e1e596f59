"""Rego-subset interpreter for user policies.

The reference evaluates user-supplied rego in two places: custom misconfig
checks (ref: pkg/iac/rego/scanner.go:46-60, OPA over the same input
document the builtin bundle sees) and ``--ignore-policy`` result filtering
(ref: pkg/result/filter.go applyPolicy, query ``data.trivy.ignore``). This
module lets those existing ``.rego`` files run unmodified on the common
shapes they actually use, with a clear :class:`RegoError` naming any
construct outside the subset.

Supported subset (chosen from a survey of published trivy ignore policies
and custom checks):

- ``package``/``import`` headers, ``default`` rules
- complete rules (``allow { ... }``, ``allow = v { ... }``, ``x := v``),
  partial set rules (``deny[msg] { ... }``) and the v1 forms
  (``deny contains msg if { ... }``, ``allow if { ... }``)
- bodies of expressions: comparisons, ``:=`` / ``=`` (with array/object
  destructuring), ``not``, ``some x [, y] in xs``, bare ``some``,
  membership ``x in xs``, builtin calls
- refs with constant, bound-var, unbound-var and ``_`` path elements
  (unbound elements iterate arrays/objects/sets)
- arithmetic (``+ - * / %``) and the common string/array/object/regex
  builtins (see ``_BUILTINS``)
- array/set comprehensions

Not supported (clear error): ``with``, ``every``, object comprehensions,
function definitions, recursive rules, ``walk``.
"""

from __future__ import annotations

import json
import re as _re
from dataclasses import dataclass, field

__all__ = ["RegoError", "RegoModule", "parse_module"]


class RegoError(ValueError):
    """Parse or evaluation failure, with line info where possible."""


# -- tokenizer ----------------------------------------------------------------

_TOKEN_RE = _re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*)
  | (?P<nl>\n)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<rawstring>`[^`]*`)
  | (?P<op>:=|==|!=|<=|>=|\||[{}\[\]();,.:<>=+\-*/%&])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    _re.VERBOSE,
)

_KEYWORDS = {
    "package", "import", "default", "not", "some", "in", "as", "with",
    "every", "contains", "if", "else", "true", "false", "null",
}


@dataclass
class Tok:
    kind: str  # op | ident | number | string | nl | eof
    text: str
    line: int


def _tokenize(src: str) -> list[Tok]:
    toks: list[Tok] = []
    line = 1
    pos = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise RegoError(f"line {line}: unexpected character {src[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws" or kind == "comment":
            continue
        if kind == "nl":
            line += 1
            if toks and toks[-1].kind != "nl":
                toks.append(Tok("nl", "\n", line))
            continue
        if kind == "rawstring":
            toks.append(Tok("string", json.dumps(text[1:-1]), line))
            continue
        if (
            kind == "number"
            and toks
            and toks[-1].kind == "op"
            and toks[-1].text == "-"
        ):
            # unary vs binary minus by previous-token context: `-` is a
            # sign only when what precedes it cannot end a value, so
            # `n-1` / `count(x)-1` stay subtraction while `x := -5` and
            # `[-1]` get negative literals
            prev = toks[-2] if len(toks) >= 2 else None
            ends_value = prev is not None and (
                prev.kind in ("number", "string")
                or (prev.kind == "ident" and prev.text not in _KEYWORDS)
                or (prev.kind == "op" and prev.text in (")", "]", "}"))
            )
            if not ends_value:
                toks[-1] = Tok("number", "-" + text, toks[-1].line)
                continue
        toks.append(Tok(kind, text, line))
    toks.append(Tok("eof", "", line))
    return toks


# -- AST ----------------------------------------------------------------------


@dataclass
class Term:
    pass


@dataclass
class Scalar(Term):
    value: object


@dataclass
class Var(Term):
    name: str


@dataclass
class Ref(Term):
    base: Term
    path: list  # of Term (Scalar for dotted names)


@dataclass
class ArrayT(Term):
    items: list


@dataclass
class ObjectT(Term):
    pairs: list  # (Term, Term)


@dataclass
class SetT(Term):
    items: list


@dataclass
class Call(Term):
    name: str
    args: list


@dataclass
class BinArith(Term):
    op: str
    lhs: Term
    rhs: Term


@dataclass
class Comprehension(Term):
    kind: str  # "array" | "set"
    head: Term
    body: list


@dataclass
class Expr:
    line: int = 0


@dataclass
class ExprTerm(Expr):
    term: Term = None
    negated: bool = False


@dataclass
class ExprBin(Expr):
    op: str = ""
    lhs: Term = None
    rhs: Term = None
    negated: bool = False


@dataclass
class ExprAssign(Expr):
    target: Term = None  # Var / ArrayT destructuring
    value: Term = None
    unify: bool = False  # '=' vs ':='


@dataclass
class ExprSome(Expr):
    names: list = field(default_factory=list)
    collection: Term = None  # None for bare `some x`


@dataclass
class ExprIn(Expr):
    needle: Term = None
    key: Term = None  # `k, v in xs`
    haystack: Term = None
    negated: bool = False


@dataclass
class RuleDef:
    name: str
    key: Term | None  # partial set key
    value: Term | None  # complete rule value
    body: list  # list[Expr]; empty body = unconditional
    line: int = 0


@dataclass
class RegoModule:
    package: tuple = ()
    rules: dict = field(default_factory=dict)  # name -> [RuleDef]
    defaults: dict = field(default_factory=dict)  # name -> value
    source: str = ""

    # -- public evaluation API ------------------------------------------

    def rule_names(self) -> list[str]:
        return sorted(set(self.rules) | set(self.defaults))

    def eval_rule(self, name: str, input=None):
        """Evaluate rule ``name``; returns its value (complete rules),
        the list of set members (partial rules), or None if undefined."""
        ev = _Evaluator(self, input)
        return ev.rule_value(name)

    def metadata(self) -> dict:
        """``__rego_metadata__`` value, or {} — the custom-check contract."""
        try:
            return self.eval_rule("__rego_metadata__") or {}
        except RegoError:
            return {}


# -- parser -------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: list[Tok], src: str):
        self.toks = toks
        self.i = 0
        self.src = src

    def peek(self, k=0) -> Tok:
        j = self.i + k
        return self.toks[min(j, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def skip_nl(self):
        while self.peek().kind == "nl":
            self.next()

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise RegoError(
                f"line {t.line}: expected {text!r}, found {t.text!r}"
            )
        return t

    def fail(self, what: str):
        t = self.peek()
        raise RegoError(f"line {t.line}: unsupported rego: {what}")

    # -- module ----------------------------------------------------------

    def module(self) -> RegoModule:
        self.skip_nl()
        self.expect("package")
        pkg = [self.next().text]
        while self.peek().text == ".":
            self.next()
            pkg.append(self.next().text)
        mod = RegoModule(package=tuple(pkg), source=self.src)
        self.skip_nl()
        while self.peek().kind != "eof":
            t = self.peek()
            if t.text == "import":
                while self.peek().kind not in ("nl", "eof"):
                    self.next()
                self.skip_nl()
                continue
            if t.text == "default":
                self.next()
                name = self.next().text
                eq = self.next().text
                if eq not in ("=", ":="):
                    raise RegoError(f"line {t.line}: malformed default rule")
                mod.defaults[name] = self.term()
                self.skip_nl()
                continue
            if t.text == "with" or t.text == "every":
                self.fail(f"'{t.text}'")
            self.rule(mod)
            self.skip_nl()
        return mod

    def rule(self, mod: RegoModule):
        t = self.next()
        if t.kind != "ident" or t.text in _KEYWORDS:
            raise RegoError(f"line {t.line}: expected rule name, found {t.text!r}")
        name = t.text
        key = None
        value = None
        if self.peek().text == "(":
            self.fail("function definitions")
        if self.peek().text == "[":  # partial set/object rule
            self.next()
            key = self.term()
            self.expect("]")
            if self.peek().text in ("=", ":="):
                self.fail("partial object rules")
        elif self.peek().text == "contains":  # v1: `deny contains msg if {..}`
            self.next()
            key = self.term()
        elif self.peek().text in ("=", ":="):
            self.next()
            value = self.term()
        if self.peek().text == "if":  # v1 keyword
            self.next()
        body: list = []
        if self.peek().text == "{":
            body = self.body_block()
        elif value is None and key is None:
            raise RegoError(f"line {t.line}: rule {name!r} has no body or value")
        if self.peek().text == "else":
            self.fail("'else' rule chains")
        mod.rules.setdefault(name, []).append(
            RuleDef(name=name, key=key, value=value, body=body, line=t.line)
        )

    def body_block(self) -> list:
        self.expect("{")
        exprs: list = []
        self.skip_nl()
        while self.peek().text != "}":
            exprs.append(self.expr())
            while self.peek().text == ";" or self.peek().kind == "nl":
                self.next()
        self.expect("}")
        return exprs

    # -- expressions -----------------------------------------------------

    def expr(self) -> Expr:
        t = self.peek()
        if t.text == "not":
            self.next()
            inner = self.expr()
            if isinstance(inner, (ExprTerm, ExprBin, ExprIn)):
                inner.negated = True
                return inner
            raise RegoError(f"line {t.line}: 'not' before unsupported expression")
        if t.text == "some":
            self.next()
            names = [self.next().text]
            while self.peek().text == ",":
                self.next()
                names.append(self.next().text)
            coll = None
            if self.peek().text == "in":
                self.next()
                coll = self.term()
            return ExprSome(line=t.line, names=names, collection=coll)
        if t.text in ("with", "every"):
            self.fail(f"'{t.text}'")
        lhs = self.term()
        op = self.peek().text
        if op in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            rhs = self.term()
            return ExprBin(line=t.line, op=op, lhs=lhs, rhs=rhs)
        if op == ":=" or op == "=":
            self.next()
            rhs = self.term()
            return ExprAssign(line=t.line, target=lhs, value=rhs,
                              unify=(op == "="))
        if op == "in":
            self.next()
            hay = self.term()
            return ExprIn(line=t.line, needle=lhs, haystack=hay)
        if self.peek().text == ",":  # `k, v in xs` membership
            self.next()
            v = self.term()
            self.expect("in")
            hay = self.term()
            return ExprIn(line=t.line, key=lhs, needle=v, haystack=hay)
        return ExprTerm(line=t.line, term=lhs)

    # -- terms -----------------------------------------------------------

    def term(self) -> Term:
        return self.arith()

    def arith(self) -> Term:
        # '|' stays out of the operator set: it separates comprehension
        # heads from bodies (set union is the `union`/`array.concat`
        # builtins in the supported subset)
        lhs = self.unary()
        while self.peek().text in ("+", "-", "*", "/", "%", "&"):
            op = self.next().text
            rhs = self.unary()
            lhs = BinArith(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def unary(self) -> Term:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.text) if "." in t.text else int(t.text)
            return self.postfix(Scalar(v))
        if t.kind == "string":
            self.next()
            try:
                return self.postfix(Scalar(json.loads(t.text)))
            except json.JSONDecodeError as e:
                raise RegoError(f"line {t.line}: bad string literal") from e
        if t.text in ("true", "false", "null"):
            self.next()
            return self.postfix(
                Scalar({"true": True, "false": False, "null": None}[t.text])
            )
        if t.text == "[":
            self.next()
            self.skip_nl()
            # array comprehension?
            save = self.i
            if self.peek().text != "]":
                head = self.term()
                if self.peek().text == "|":
                    self.next()
                    body = self.comp_body("]")
                    return self.postfix(
                        Comprehension(kind="array", head=head, body=body)
                    )
                self.i = save
            items = self.term_list("]")
            return self.postfix(ArrayT(items))
        if t.text == "{":
            self.next()
            self.skip_nl()
            if self.peek().text == "}":
                self.next()
                return self.postfix(ObjectT([]))
            save = self.i
            first = self.term()
            if self.peek().text == "|":  # set comprehension
                self.next()
                body = self.comp_body("}")
                return self.postfix(
                    Comprehension(kind="set", head=first, body=body)
                )
            if self.peek().text == ":":
                self.i = save
                return self.postfix(self.object_literal())
            self.i = save
            items = self.term_list("}")
            return self.postfix(SetT(items))
        if t.text == "(":
            self.next()
            inner = self.term()
            self.expect(")")
            return self.postfix(inner)
        if t.kind == "ident":
            if t.text in ("with", "every"):
                self.fail(f"'{t.text}'")
            self.next()
            name = t.text
            # dotted call like regex.match(...)
            if self.peek().text == "." and self.peek(2).text == "(":
                parts = [name]
                while self.peek().text == "." and self.peek(2).text == "(":
                    self.next()
                    parts.append(self.next().text)
                    if self.peek().text == "(":
                        break
                self.next()  # "("
                args = self.term_list(")")
                return self.postfix(Call(name=".".join(parts), args=args))
            if self.peek().text == "(":
                self.next()
                args = self.term_list(")")
                return self.postfix(Call(name=name, args=args))
            return self.postfix(Var(name))
        raise RegoError(f"line {t.line}: unexpected token {t.text!r}")

    def comp_body(self, closer: str) -> list:
        exprs = [self.expr()]
        while self.peek().text == ";" or self.peek().kind == "nl":
            self.next()
            self.skip_nl()
            if self.peek().text == closer:
                break
            exprs.append(self.expr())
        self.expect(closer)
        return exprs

    def object_literal(self) -> Term:
        pairs = []
        while True:
            self.skip_nl()
            if self.peek().text == "}":
                self.next()
                break
            k = self.term()
            self.expect(":")
            v = self.term()
            pairs.append((k, v))
            self.skip_nl()
            if self.peek().text == ",":
                self.next()
                continue
            self.skip_nl()
            self.expect("}")
            break
        return ObjectT(pairs)

    def term_list(self, closer: str) -> list:
        items = []
        self.skip_nl()
        if self.peek().text == closer:
            self.next()
            return items
        while True:
            items.append(self.term())
            self.skip_nl()
            if self.peek().text == ",":
                self.next()
                self.skip_nl()
                continue
            self.expect(closer)
            return items

    def postfix(self, base: Term) -> Term:
        while True:
            t = self.peek()
            if t.text == ".":
                if self.peek(1).kind != "ident":
                    return base
                self.next()
                name = self.next().text
                if self.peek().text == "(":  # method-style builtin on ref
                    self.fail("method call on reference")
                if isinstance(base, Ref):
                    base.path.append(Scalar(name))
                else:
                    base = Ref(base=base, path=[Scalar(name)])
                continue
            if t.text == "[":
                self.next()
                idx = self.term()
                self.expect("]")
                if isinstance(base, Ref):
                    base.path.append(idx)
                else:
                    base = Ref(base=base, path=[idx])
                continue
            return base


def parse_module(src: str) -> RegoModule:
    return _Parser(_tokenize(src), src).module()


# -- evaluator ----------------------------------------------------------------

_UNDEF = object()


def _sprintf(fmt: str, args) -> str:
    out = []
    i = 0
    ai = 0
    args = list(args)
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
            elif spec in "vdsfqx":
                a = args[ai] if ai < len(args) else ""
                ai += 1
                if spec == "q":
                    out.append(json.dumps(str(a)))
                elif spec == "d":
                    out.append(str(int(a)))
                elif spec == "f":
                    out.append(f"{float(a):f}")
                elif spec == "x":
                    out.append(format(int(a), "x"))
                else:
                    out.append(_to_str(a))
            else:
                out.append(c + spec)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _to_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _count(v):
    if isinstance(v, (list, dict, set, str, tuple)):
        return len(v)
    raise RegoError(f"count: not a collection: {v!r}")


_BUILTINS = {
    "startswith": lambda s, p: isinstance(s, str) and s.startswith(p),
    "endswith": lambda s, p: isinstance(s, str) and s.endswith(p),
    "contains": lambda s, sub: isinstance(s, str) and sub in s,
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "trim": lambda s, cut: s.strip(cut),
    "trim_space": lambda s: s.strip(),
    "trim_prefix": lambda s, p: s[len(p):] if s.startswith(p) else s,
    "trim_suffix": lambda s, p: s[: -len(p)] if p and s.endswith(p) else s,
    "replace": lambda s, old, new: s.replace(old, new),
    "split": lambda s, sep: s.split(sep),
    "concat": lambda sep, arr: sep.join(arr),
    "sprintf": lambda fmt, arr: _sprintf(fmt, arr),
    "format_int": lambda v, base: format(int(v), {2: "b", 8: "o", 10: "d", 16: "x"}[int(base)]),
    "count": _count,
    "sum": lambda arr: sum(arr),
    "max": lambda arr: max(arr),
    "min": lambda arr: min(arr),
    "abs": lambda v: abs(v),
    "to_number": lambda v: float(v) if isinstance(v, str) and "." in v else int(v) if isinstance(v, str) else v,
    "is_string": lambda v: isinstance(v, str),
    "is_number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "is_boolean": lambda v: isinstance(v, bool),
    "is_null": lambda v: v is None,
    "is_array": lambda v: isinstance(v, list),
    "is_object": lambda v: isinstance(v, dict),
    "is_set": lambda v: isinstance(v, set),
    "re_match": lambda pat, s: bool(_re.search(pat, s)),
    "regex.match": lambda pat, s: bool(_re.search(pat, s)),
    "regex.is_valid": lambda pat: _is_valid_re(pat),
    "array.concat": lambda a, b: list(a) + list(b),
    "array.slice": lambda a, lo, hi: a[int(lo):int(hi)],
    "object.get": lambda o, k, dflt: _object_get(o, k, dflt),
    "object.keys": lambda o: set(o.keys()),
    "json.marshal": lambda v: json.dumps(v),
    "json.unmarshal": lambda s: json.loads(s),
    "sort": lambda arr: sorted(arr),
}


def _is_valid_re(pat):
    try:
        _re.compile(pat)
        return True
    except _re.error:
        return False


def _object_get(o, k, dflt):
    if isinstance(k, list):
        cur = o
        for part in k:
            if not isinstance(cur, dict) or part not in cur:
                return dflt
            cur = cur[part]
        return cur
    return o.get(k, dflt) if isinstance(o, dict) else dflt


class _Evaluator:
    MAX_STEPS = 2_000_000

    def __init__(self, mod: RegoModule, input):
        self.mod = mod
        self.input = input
        self._rule_cache: dict[str, object] = {}
        self._in_progress: set[str] = set()
        self._steps = 0

    def _tick(self):
        self._steps += 1
        if self._steps > self.MAX_STEPS:
            raise RegoError("evaluation budget exceeded (possible loop)")

    # -- rules -----------------------------------------------------------

    def rule_value(self, name: str):
        if name in self._rule_cache:
            return self._rule_cache[name]
        if name in self._in_progress:
            raise RegoError(f"recursive rule {name!r} is not supported")
        defs = self.mod.rules.get(name, [])
        if not defs and name not in self.mod.defaults:
            return None
        self._in_progress.add(name)
        try:
            is_partial = any(d.key is not None for d in defs)
            if is_partial:
                members: list = []
                for d in defs:
                    for env in self._eval_body(d.body, {}):
                        for v, _env in self._eval_term(d.key, env):
                            if v is not _UNDEF and v not in members:
                                members.append(v)
                result: object = members
            else:
                result = _UNDEF
                for d in defs:
                    for env in self._eval_body(d.body, {}):
                        val = True
                        if d.value is not None:
                            got = next(
                                iter(self._eval_term(d.value, env)), None
                            )
                            if got is None or got[0] is _UNDEF:
                                continue
                            val = got[0]
                        result = val
                        break
                    if result is not _UNDEF:
                        break
                if result is _UNDEF:
                    dflt = self.mod.defaults.get(name)
                    if dflt is not None:
                        got = next(iter(self._eval_term(dflt, {})), None)
                        result = got[0] if got else None
                    else:
                        result = None
        finally:
            self._in_progress.discard(name)
        self._rule_cache[name] = result
        return result

    # -- bodies ----------------------------------------------------------

    def _eval_body(self, body: list, env: dict):
        if not body:
            yield env
            return
        yield from self._eval_exprs(body, 0, env)

    def _eval_exprs(self, body: list, i: int, env: dict):
        self._tick()
        if i >= len(body):
            yield env
            return
        for env2 in self._eval_expr(body[i], env):
            yield from self._eval_exprs(body, i + 1, env2)

    def _eval_expr(self, e: Expr, env: dict):
        self._tick()
        if isinstance(e, ExprTerm):
            gen = (
                env2
                for v, env2 in self._eval_term(e.term, env)
                if v is not _UNDEF and v is not False and v is not None
            )
            yield from self._negatable(gen, e.negated, env)
        elif isinstance(e, ExprBin):
            ops = {
                "==": lambda a, b: a == b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: a < b,
                "<=": lambda a, b: a <= b,
                ">": lambda a, b: a > b,
                ">=": lambda a, b: a >= b,
            }
            def gen():
                for lv, env1 in self._eval_term(e.lhs, env):
                    if lv is _UNDEF:
                        continue
                    for rv, env2 in self._eval_term(e.rhs, env1):
                        if rv is _UNDEF:
                            continue
                        try:
                            ok = ops[e.op](lv, rv)
                        except TypeError:
                            ok = False
                        if ok:
                            yield env2
            yield from self._negatable(gen(), e.negated, env)
        elif isinstance(e, ExprAssign):
            for v, env1 in self._eval_term(e.value, env):
                if v is _UNDEF:
                    continue
                env2 = self._unify(e.target, v, env1)
                if env2 is not None:
                    yield env2
        elif isinstance(e, ExprSome):
            if e.collection is None:
                # locality declaration: unbind the names
                env2 = dict(env)
                for nm in e.names:
                    env2.pop(nm, None)
                yield env2
            else:
                for coll, env1 in self._eval_term(e.collection, env):
                    if coll is _UNDEF:
                        continue
                    yield from self._iterate_some(e.names, coll, env1, e.line)
        elif isinstance(e, ExprIn):
            def gen():
                for nv, env1 in self._eval_term(e.needle, env):
                    for hv, env2 in self._eval_term(e.haystack, env1):
                        if hv is _UNDEF or nv is _UNDEF:
                            continue
                        if isinstance(hv, dict):
                            items = hv.items()
                            for k, v in items:
                                if v == nv:
                                    if e.key is not None:
                                        env3 = self._unify(e.key, k, env2)
                                        if env3 is not None:
                                            yield env3
                                    else:
                                        yield env2
                                        break
                        elif isinstance(hv, (list, set, tuple)):
                            if e.key is not None and isinstance(hv, list):
                                for idx, v in enumerate(hv):
                                    if v == nv:
                                        env3 = self._unify(e.key, idx, env2)
                                        if env3 is not None:
                                            yield env3
                            elif nv in hv:
                                yield env2
            yield from self._negatable(gen(), e.negated, env)
        else:
            raise RegoError(f"line {e.line}: unsupported expression")

    def _negatable(self, gen, negated: bool, env: dict):
        if not negated:
            yield from gen
            return
        for _ in gen:
            return  # succeeded -> not fails
        yield env

    def _iterate_some(self, names, coll, env, line):
        if isinstance(coll, list):
            for idx, v in enumerate(coll):
                if len(names) == 1:
                    env2 = self._unify(Var(names[0]), v, env)
                else:
                    env2 = self._unify(Var(names[0]), idx, env)
                    if env2 is not None:
                        env2 = self._unify(Var(names[1]), v, env2)
                if env2 is not None:
                    yield env2
        elif isinstance(coll, dict):
            for k, v in coll.items():
                if len(names) == 1:
                    env2 = self._unify(Var(names[0]), v, env)
                else:
                    env2 = self._unify(Var(names[0]), k, env)
                    if env2 is not None:
                        env2 = self._unify(Var(names[1]), v, env2)
                if env2 is not None:
                    yield env2
        elif isinstance(coll, (set, frozenset)):
            for v in coll:
                if len(names) != 1:
                    raise RegoError(f"line {line}: two-var some over a set")
                env2 = self._unify(Var(names[0]), v, env)
                if env2 is not None:
                    yield env2
        else:
            return

    # -- unification -----------------------------------------------------

    def _unify(self, target: Term, value, env: dict):
        """Bind target pattern to value; returns new env or None."""
        if isinstance(target, Var):
            if target.name == "_":
                return env
            if target.name in env:
                return env if env[target.name] == value else None
            bound = self.mod.rules.get(target.name) or (
                target.name in self.mod.defaults
            )
            if bound:
                rv = self.rule_value(target.name)
                return env if rv == value else None
            env2 = dict(env)
            env2[target.name] = value
            return env2
        if isinstance(target, ArrayT):
            if not isinstance(value, list) or len(value) != len(target.items):
                return None
            for t, v in zip(target.items, value):
                env = self._unify(t, v, env)
                if env is None:
                    return None
            return env
        if isinstance(target, ObjectT):
            if not isinstance(value, dict):
                return None
            for kt, vt in target.pairs:
                kv = next(iter(self._eval_term(kt, env)), None)
                if kv is None or kv[0] not in value:
                    return None
                env = self._unify(vt, value[kv[0]], env)
                if env is None:
                    return None
            return env
        # ground term: evaluate and compare
        got = next(iter(self._eval_term(target, env)), None)
        if got is None or got[0] is _UNDEF:
            return None
        return env if got[0] == value else None

    # -- terms -----------------------------------------------------------

    def _eval_term(self, t: Term, env: dict):
        self._tick()
        if isinstance(t, Scalar):
            yield t.value, env
        elif isinstance(t, Var):
            if t.name == "input":
                yield self.input, env
            elif t.name == "_":
                raise RegoError("'_' outside a reference")
            elif t.name in env:
                yield env[t.name], env
            elif t.name == "data":
                yield self._data_root(), env
            elif t.name in self.mod.rules or t.name in self.mod.defaults:
                v = self.rule_value(t.name)
                if v is not None:
                    yield v, env
            else:
                # unbound in value position: undefined (callers treat as
                # iteration via Ref, not here)
                yield _UNDEF, env
        elif isinstance(t, Ref):
            yield from self._eval_ref(t, env)
        elif isinstance(t, ArrayT):
            yield from self._eval_items(t.items, env, list)
        elif isinstance(t, SetT):
            for items, env2 in self._eval_items(t.items, env, list):
                yield set(items) if _hashable(items) else items, env2
        elif isinstance(t, ObjectT):
            yield from self._eval_object(t, env)
        elif isinstance(t, Call):
            yield from self._eval_call(t, env)
        elif isinstance(t, BinArith):
            for a, env1 in self._eval_term(t.lhs, env):
                for b, env2 in self._eval_term(t.rhs, env1):
                    if a is _UNDEF or b is _UNDEF:
                        continue
                    try:
                        if t.op == "+":
                            v = a + b if not isinstance(a, set) else a | b
                        elif t.op == "-":
                            v = a - b
                        elif t.op == "*":
                            v = a * b
                        elif t.op == "/":
                            v = a / b
                        elif t.op == "%":
                            v = a % b
                        elif t.op == "&":
                            v = a & b
                        elif t.op == "|":
                            v = a | b
                        else:
                            raise RegoError(f"operator {t.op!r}")
                    except TypeError as e:
                        raise RegoError(f"arithmetic on {type(a).__name__}/"
                                        f"{type(b).__name__}") from e
                    yield v, env2
        elif isinstance(t, Comprehension):
            out = []
            for env2 in self._eval_body(t.body, env):
                for v, _ in self._eval_term(t.head, env2):
                    if v is not _UNDEF and (t.kind == "array" or v not in out):
                        out.append(v)
            if t.kind == "set":
                yield (set(out) if _hashable(out) else out), env
            else:
                yield out, env
        else:
            raise RegoError(f"unsupported term {type(t).__name__}")

    def _data_root(self):
        """`data.<pkg...>` resolution happens in _eval_ref; the bare root
        is a nested dict placeholder."""
        return {"__data_root__": True}

    def _eval_items(self, items, env, ctor):
        def rec(i, env, acc):
            if i >= len(items):
                yield ctor(acc), env
                return
            for v, env2 in self._eval_term(items[i], env):
                if v is _UNDEF:
                    continue
                yield from rec(i + 1, env2, acc + [v])
        yield from rec(0, env, [])

    def _eval_object(self, t: ObjectT, env):
        def rec(i, env, acc):
            if i >= len(t.pairs):
                yield dict(acc), env
                return
            kt, vt = t.pairs[i]
            for k, env1 in self._eval_term(kt, env):
                for v, env2 in self._eval_term(vt, env1):
                    if k is _UNDEF or v is _UNDEF:
                        continue
                    yield from rec(i + 1, env2, acc + [(k, v)])
        yield from rec(0, env, [])

    def _eval_call(self, t: Call, env):
        if t.name in ("walk",):
            raise RegoError(f"builtin {t.name!r} is not supported")
        fn = _BUILTINS.get(t.name)
        if fn is None:
            raise RegoError(f"unknown builtin {t.name!r}")

        def rec(i, env, acc):
            if i >= len(t.args):
                try:
                    yield fn(*acc), env
                except RegoError:
                    raise
                except Exception:
                    yield _UNDEF, env
                return
            for v, env2 in self._eval_term(t.args[i], env):
                if v is _UNDEF:
                    continue
                yield from rec(i + 1, env2, acc + [v])
        yield from rec(0, env, [])

    def _eval_ref(self, t: Ref, env):
        # data.<package path>.<rule> collapses to a local rule reference
        if isinstance(t.base, Var) and t.base.name == "data":
            names = []
            for p in t.path:
                if isinstance(p, Scalar) and isinstance(p.value, str):
                    names.append(p.value)
                else:
                    break
            pkg = list(self.mod.package)
            if len(names) > len(pkg) and names[: len(pkg)] == pkg:
                rule_name = names[len(pkg)]
                rest = t.path[len(pkg) + 1 :]
                v = self.rule_value(rule_name)
                if v is None:
                    return
                yield from self._walk_path(v, rest, env)
                return
            raise RegoError(
                "cross-package data reference "
                f"data.{'.'.join(names)} is not supported"
            )
        for base, env1 in self._eval_term(t.base, env):
            if base is _UNDEF:
                continue
            yield from self._walk_path(base, t.path, env1)

    def _walk_path(self, value, path, env):
        self._tick()
        if not path:
            yield value, env
            return
        head, rest = path[0], path[1:]
        # constant key
        if isinstance(head, Scalar):
            for v2, env2 in self._index(value, head.value, env):
                yield from self._walk_path(v2, rest, env2)
            return
        if isinstance(head, Var):
            if head.name == "_":
                for k, v2 in self._enumerate(value):
                    yield from self._walk_path(v2, rest, env)
                return
            if head.name in env:
                for v2, env2 in self._index(value, env[head.name], env):
                    yield from self._walk_path(v2, rest, env2)
                return
            if head.name in self.mod.rules or head.name in self.mod.defaults:
                rv = self.rule_value(head.name)
                for v2, env2 in self._index(value, rv, env):
                    yield from self._walk_path(v2, rest, env2)
                return
            for k, v2 in self._enumerate(value):
                env2 = dict(env)
                env2[head.name] = k
                yield from self._walk_path(v2, rest, env2)
            return
        # computed key (call/arith/ref)
        for kv, env1 in self._eval_term(head, env):
            if kv is _UNDEF:
                continue
            for v2, env2 in self._index(value, kv, env1):
                yield from self._walk_path(v2, rest, env2)

    def _index(self, value, key, env):
        if isinstance(value, dict):
            if key in value:
                yield value[key], env
        elif isinstance(value, list):
            if isinstance(key, bool):
                return
            if isinstance(key, (int, float)) and 0 <= int(key) < len(value):
                yield value[int(key)], env
        elif isinstance(value, (set, frozenset)):
            if key in value:
                yield key, env
        # indexing a scalar: undefined, yields nothing

    def _enumerate(self, value):
        if isinstance(value, list):
            yield from enumerate(value)
        elif isinstance(value, dict):
            yield from value.items()
        elif isinstance(value, (set, frozenset)):
            for v in value:
                yield v, v


def _hashable(items) -> bool:
    try:
        set(items)
        return True
    except TypeError:
        return False
