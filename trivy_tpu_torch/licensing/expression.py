"""SPDX license-expression parser.

Grammar (SPDX spec annex D; ref: pkg/licensing/expression/ — the reference
uses a goyacc grammar, this is a recursive-descent equivalent):

    expression   := and-expr ( OR and-expr )*
    and-expr     := postfix ( AND postfix )*
    postfix      := primary ( WITH exception )?
    primary      := idstring '+'? | '(' expression ')'

``parse`` returns an Expr tree; ``normalize_expression`` re-renders the
expression with every leaf license name normalized to its SPDX id (used on
package metadata like "(MIT OR GPL-2.0+) AND Apache 2.0").
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from trivy_tpu_torch.licensing.normalize import normalize as normalize_name


class ExpressionError(ValueError):
    pass


@dataclass(frozen=True)
class License:
    name: str
    plus: bool = False
    exception: str | None = None

    def render(self) -> str:
        out = self.name + ("+" if self.plus else "")
        if self.exception:
            out += f" WITH {self.exception}"
        return out

    def leaves(self):
        yield self


@dataclass(frozen=True)
class Compound:
    op: str  # "AND" | "OR"
    left: "License | Compound"
    right: "License | Compound"

    def render(self) -> str:
        parts = []
        for side in (self.left, self.right):
            text = side.render()
            if isinstance(side, Compound) and side.op != self.op:
                text = f"({text})"
            parts.append(text)
        return f" {self.op} ".join(parts)

    def leaves(self):
        yield from self.left.leaves()
        yield from self.right.leaves()


_TOKEN = re.compile(
    r"\s*(?:(?P<lparen>\()|(?P<rparen>\))|(?P<op>AND|OR|WITH|and|or|with)(?=[\s(])"
    r"|(?P<id>[A-Za-z0-9.\-:+]+))"
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise ExpressionError(f"bad token at {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("lparen", "rparen", "op", "id"):
            val = m.group(kind)
            if val is not None:
                out.append((kind if kind != "op" else val.upper(), val))
                break
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def _peek(self) -> str | None:
        return self.toks[self.i][0] if self.i < len(self.toks) else None

    def _take(self) -> tuple[str, str]:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def parse(self):
        expr = self._or()
        if self.i != len(self.toks):
            raise ExpressionError(f"unexpected token {self.toks[self.i][1]!r}")
        return expr

    def _or(self):
        left = self._and()
        while self._peek() == "OR":
            self._take()
            left = Compound("OR", left, self._and())
        return left

    def _and(self):
        left = self._postfix()
        while self._peek() == "AND":
            self._take()
            left = Compound("AND", left, self._postfix())
        return left

    def _postfix(self):
        prim = self._primary()
        if self._peek() == "WITH":
            self._take()
            kind, val = self._take() if self.i < len(self.toks) else (None, None)
            if kind != "id":
                raise ExpressionError("WITH requires an exception id")
            if not isinstance(prim, License):
                raise ExpressionError("WITH applies to a single license")
            prim = License(prim.name, prim.plus, exception=val)
        return prim

    def _primary(self):
        if self._peek() == "lparen":
            self._take()
            expr = self._or()
            if self._peek() != "rparen":
                raise ExpressionError("missing )")
            self._take()
            return expr
        kind, val = self._take() if self.i < len(self.toks) else (None, "")
        if kind != "id":
            raise ExpressionError(f"expected license id, got {val!r}")
        plus = val.endswith("+")
        return License(val[:-1] if plus else val, plus)


def parse(text: str):
    """Parse an SPDX expression → Expr tree."""
    tokens = _tokenize(text)
    if not tokens:
        raise ExpressionError("empty expression")
    return _Parser(tokens).parse()


def normalize_expression(text: str) -> str:
    """Normalize every leaf of an SPDX expression; non-expressions fall back
    to single-name normalization (package metadata is messy)."""
    try:
        expr = parse(text)
    except ExpressionError:
        return normalize_name(text)

    def walk(node):
        if isinstance(node, License):
            rendered = normalize_name(node.name + ("+" if node.plus else ""))
            # re-split the rendered form ("GPL-2.0-or-later" stays one leaf)
            return License(rendered, False, node.exception)
        return Compound(node.op, walk(node.left), walk(node.right))

    return walk(expr).render()


def leaf_licenses(text: str) -> list[str]:
    """All leaf license names of an expression (normalized); a plain name
    yields itself normalized."""
    try:
        expr = parse(text)
    except ExpressionError:
        return [normalize_name(text)]
    return [normalize_name(l.name + ("+" if l.plus else "")) for l in expr.leaves()]
