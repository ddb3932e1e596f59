"""HCL2 recursive-descent parser producing a small expression AST
(independent implementation of the HCL2 syntax spec; the reference links
hashicorp/hcl/v2 — see pkg/iac/scanners/terraform/parser/).

The port of ``trivy_tpu/misconf/hcl/parser.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.misconf.hcl import lexer as L
from trivy_tpu_torch.misconf.hcl.lexer import HclSyntaxError, Token


# -- AST ---------------------------------------------------------------------

@dataclass
class Node:
    line: int = 0


@dataclass
class Literal(Node):
    value: object = None


@dataclass
class Template(Node):
    # parts: str literals or ("interp"|"directive", Node-or-raw, line)
    parts: list = field(default_factory=list)


@dataclass
class TupleExpr(Node):
    items: list = field(default_factory=list)


@dataclass
class ObjectExpr(Node):
    pairs: list = field(default_factory=list)  # [(key_node, value_node)]


@dataclass
class Var(Node):
    name: str = ""


@dataclass
class GetAttr(Node):
    obj: Node = None
    name: str = ""


@dataclass
class Index(Node):
    obj: Node = None
    key: Node = None


@dataclass
class Splat(Node):
    obj: Node = None
    rest: list = field(default_factory=list)  # [("attr", name)|("index", Node)]


@dataclass
class Call(Node):
    name: str = ""
    args: list = field(default_factory=list)
    expand_last: bool = False  # f(xs...)


@dataclass
class Unary(Node):
    op: str = ""
    operand: Node = None


@dataclass
class Binary(Node):
    op: str = ""
    left: Node = None
    right: Node = None


@dataclass
class Conditional(Node):
    cond: Node = None
    true: Node = None
    false: Node = None


@dataclass
class ForExpr(Node):
    key_var: str | None = None
    val_var: str = ""
    coll: Node = None
    key_expr: Node | None = None  # None => tuple-for
    val_expr: Node = None
    cond: Node | None = None
    group: bool = False


# -- structure ---------------------------------------------------------------

@dataclass
class Attribute:
    name: str
    expr: Node
    line: int
    end_line: int


@dataclass
class Block:
    type: str
    labels: list[str]
    body: "Body"
    line: int
    end_line: int


@dataclass
class Body:
    attrs: dict[str, Attribute] = field(default_factory=dict)
    blocks: list[Block] = field(default_factory=list)

    def blocks_of(self, btype: str) -> list[Block]:
        return [b for b in self.blocks if b.type == btype]


class Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.pos = 0

    # -- token helpers -------------------------------------------------------

    def peek(self, skip_nl: bool = False) -> Token:
        p = self.pos
        if skip_nl:
            while self.toks[p].kind == L.NEWLINE:
                p += 1
        return self.toks[p]

    def next(self, skip_nl: bool = False) -> Token:
        if skip_nl:
            while self.toks[self.pos].kind == L.NEWLINE:
                self.pos += 1
        t = self.toks[self.pos]
        if t.kind != L.EOF:
            self.pos += 1
        return t

    def expect_op(self, op: str, skip_nl: bool = True) -> Token:
        t = self.next(skip_nl)
        if t.kind != L.OP or t.value != op:
            raise HclSyntaxError(f"expected {op!r}, got {t.value!r}", t.line)
        return t

    def at_op(self, op: str, skip_nl: bool = False) -> bool:
        t = self.peek(skip_nl)
        return t.kind == L.OP and t.value == op

    def eat_op(self, op: str, skip_nl: bool = False) -> bool:
        if self.at_op(op, skip_nl):
            self.next(skip_nl)
            return True
        return False

    # -- body ----------------------------------------------------------------

    def parse_body(self, until: str | None = None) -> Body:
        body = Body()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == L.EOF:
                if until is not None:
                    raise HclSyntaxError(f"missing closing {until!r}", t.line)
                self.next(skip_nl=True)
                return body
            if until and t.kind == L.OP and t.value == until:
                self.next(skip_nl=True)
                return body
            if t.kind != L.IDENT:
                raise HclSyntaxError(f"expected attribute or block, got {t.value!r}", t.line)
            self._parse_statement(body)

    def _parse_statement(self, body: Body):
        name_tok = self.next(skip_nl=True)
        labels: list[str] = []
        while True:
            t = self.peek()
            if t.kind == L.OP and t.value == "=":
                self.next()
                expr = self.parse_expr()
                end = self.toks[self.pos - 1].line if self.pos else name_tok.line
                body.attrs[name_tok.value] = Attribute(
                    name_tok.value, expr, name_tok.line, max(end, name_tok.line)
                )
                return
            if t.kind in (L.STRING, L.IDENT) and not labels and t.kind == L.OP:
                pass  # unreachable; kept for clarity
            if t.kind == L.STRING or (t.kind == L.IDENT and not self._ident_is_block_open()):
                labels.append(self.next().value)
                continue
            if t.kind == L.TEMPLATE:
                raise HclSyntaxError("interpolation not allowed in block label", t.line)
            if t.kind == L.OP and t.value == "{":
                self.next()
                inner = self.parse_body(until="}")
                end_line = self.toks[self.pos - 1].line
                body.blocks.append(
                    Block(name_tok.value, labels, inner, name_tok.line, end_line)
                )
                return
            raise HclSyntaxError(
                f"expected '=', label or '{{' after {name_tok.value!r}", t.line
            )

    def _ident_is_block_open(self) -> bool:
        # an IDENT directly followed by '{' or a label is a block header part;
        # this helper is only consulted when current token is IDENT after the
        # block type, so it's always a label position — treat as label
        return False

    # -- expressions ---------------------------------------------------------

    def parse_expr(self) -> Node:
        return self._conditional()

    def _conditional(self) -> Node:
        cond = self._binary(0)
        if self.at_op("?", skip_nl=True):
            # avoid consuming newlines before '?' at statement end? HCL allows
            # the conditional on one logical line; real configs keep '?' inline
            self.next(skip_nl=True)
            t = self.parse_ternary_arm()
            self.expect_op(":")
            f = self.parse_ternary_arm()
            return Conditional(cond.line, cond, t, f)
        return cond

    def parse_ternary_arm(self) -> Node:
        return self._conditional()

    _PRECEDENCE = [
        ["||"],
        ["&&"],
        ["==", "!="],
        ["<", ">", "<=", ">="],
        ["+", "-"],
        ["*", "/", "%"],
    ]

    def _binary(self, level: int) -> Node:
        if level >= len(self._PRECEDENCE):
            return self._unary()
        left = self._binary(level + 1)
        while True:
            t = self.peek(skip_nl=False)
            if t.kind == L.OP and t.value in self._PRECEDENCE[level]:
                self.next()
                right = self._binary(level + 1)
                left = Binary(left.line, t.value, left, right)
            else:
                return left

    def _unary(self) -> Node:
        t = self.peek()
        if t.kind == L.OP and t.value in ("!", "-"):
            self.next()
            return Unary(t.line, t.value, self._unary())
        return self._postfix(self._primary())

    def _postfix(self, node: Node) -> Node:
        while True:
            t = self.peek()
            if t.kind == L.OP and t.value == ".":
                nxt = self.toks[self.pos + 1]
                if nxt.kind == L.OP and nxt.value == "*":
                    self.next(); self.next()
                    node = Splat(t.line, node)
                    node = self._splat_rest(node)
                    continue
                if nxt.kind == L.IDENT:
                    self.next()
                    name = self.next().value
                    node = GetAttr(t.line, node, name)
                    continue
                if nxt.kind == L.NUMBER and isinstance(nxt.value, int):
                    self.next()
                    node = Index(t.line, node, Literal(nxt.line, self.next().value))
                    continue
                raise HclSyntaxError("expected attribute name after '.'", t.line)
            if t.kind == L.OP and t.value == "[":
                nxt = self.toks[self.pos + 1]
                if nxt.kind == L.OP and nxt.value == "*":
                    self.next(); self.next()
                    self.expect_op("]")
                    node = Splat(t.line, node)
                    node = self._splat_rest(node)
                    continue
                self.next()
                key = self.parse_expr()
                self.expect_op("]")
                node = Index(t.line, node, key)
                continue
            if (
                t.kind == L.OP
                and t.value == "("
                and isinstance(node, (Var, GetAttr))
            ):
                name = self._callable_name(node)
                if name is None:
                    return node
                self.next()
                args, expand = self._call_args()
                node = Call(node.line, name, args, expand)
                continue
            return node

    def _splat_rest(self, splat: Splat) -> Splat:
        while True:
            t = self.peek()
            if t.kind == L.OP and t.value == "." and self.toks[self.pos + 1].kind == L.IDENT:
                self.next()
                splat.rest.append(("attr", self.next().value))
                continue
            if t.kind == L.OP and t.value == "[":
                self.next()
                key = self.parse_expr()
                self.expect_op("]")
                splat.rest.append(("index", key))
                continue
            return splat

    @staticmethod
    def _callable_name(node: Node) -> str | None:
        if isinstance(node, Var):
            return node.name
        if isinstance(node, GetAttr) and isinstance(node.obj, Var):
            # provider-namespaced function like provider::func — unsupported,
            # but core:: style rarely appears; treat a.b( as not-a-call
            return None
        return None

    def _call_args(self) -> tuple[list[Node], bool]:
        args: list[Node] = []
        expand = False
        if self.eat_op(")", skip_nl=True):
            return args, expand
        while True:
            self._skip_newlines()
            args.append(self.parse_expr())
            if self.eat_op("...", skip_nl=True):
                expand = True
            if self.eat_op(",", skip_nl=True):
                if self.eat_op(")", skip_nl=True):
                    return args, expand
                continue
            self.expect_op(")")
            return args, expand

    def _primary(self) -> Node:
        t = self.next(skip_nl=False)
        if t.kind == L.NEWLINE:
            # expressions never start with a newline at valid sites inside
            # brackets; at attribute level this is a syntax error
            raise HclSyntaxError("unexpected end of line in expression", t.line)
        if t.kind == L.NUMBER:
            return Literal(t.line, t.value)
        if t.kind == L.STRING:
            return Literal(t.line, t.value)
        if t.kind == L.HEREDOC:
            return _heredoc_node(t)
        if t.kind == L.TEMPLATE:
            parts = []
            for p in t.value:
                if isinstance(p, str):
                    parts.append(p)
                else:
                    kind, src, ln = p
                    parts.append((kind, src, ln))
            return Template(t.line, parts)
        if t.kind == L.IDENT:
            if t.value == "true":
                return Literal(t.line, True)
            if t.value == "false":
                return Literal(t.line, False)
            if t.value == "null":
                return Literal(t.line, None)
            return Var(t.line, t.value)
        if t.kind == L.OP and t.value == "(":
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if t.kind == L.OP and t.value == "[":
            return self._tuple_or_for(t)
        if t.kind == L.OP and t.value == "{":
            return self._object_or_for(t)
        raise HclSyntaxError(f"unexpected token {t.value!r}", t.line)

    def _at_for_keyword(self) -> bool:
        t = self.peek(skip_nl=True)
        return t.kind == L.IDENT and t.value == "for"

    def _tuple_or_for(self, open_tok: Token) -> Node:
        if self._at_for_keyword():
            return self._for_expr(open_tok, is_object=False)
        items: list[Node] = []
        if self.eat_op("]", skip_nl=True):
            return TupleExpr(open_tok.line, items)
        while True:
            self.peek(skip_nl=True)
            self._skip_newlines()
            items.append(self.parse_expr())
            if self.eat_op(",", skip_nl=True):
                if self.eat_op("]", skip_nl=True):
                    return TupleExpr(open_tok.line, items)
                continue
            if self.eat_op("]", skip_nl=True):
                return TupleExpr(open_tok.line, items)
            t = self.peek(skip_nl=True)
            raise HclSyntaxError(f"expected ',' or ']', got {t.value!r}", t.line)

    def _object_or_for(self, open_tok: Token) -> Node:
        if self._at_for_keyword():
            return self._for_expr(open_tok, is_object=True)
        pairs: list = []
        if self.eat_op("}", skip_nl=True):
            return ObjectExpr(open_tok.line, pairs)
        while True:
            self._skip_newlines()
            key_tok = self.peek()
            if key_tok.kind == L.IDENT:
                self.next()
                key: Node = Literal(key_tok.line, key_tok.value)
            elif key_tok.kind == L.STRING:
                self.next()
                key = Literal(key_tok.line, key_tok.value)
            elif key_tok.kind == L.TEMPLATE:
                self.next()
                key = Template(key_tok.line, list(key_tok.value))
            elif key_tok.kind == L.OP and key_tok.value == "(":
                self.next()
                key = self.parse_expr()
                self.expect_op(")")
            else:
                raise HclSyntaxError(f"bad object key {key_tok.value!r}", key_tok.line)
            t = self.next(skip_nl=True)
            if not (t.kind == L.OP and t.value in ("=", ":")):
                raise HclSyntaxError(f"expected '=' or ':' in object, got {t.value!r}", t.line)
            val = self.parse_expr()
            pairs.append((key, val))
            if self.eat_op(",", skip_nl=True):
                if self.eat_op("}", skip_nl=True):
                    return ObjectExpr(open_tok.line, pairs)
                continue
            # newline also separates object items
            had_nl = self.peek().kind == L.NEWLINE
            if self.eat_op("}", skip_nl=True):
                return ObjectExpr(open_tok.line, pairs)
            if had_nl:
                continue
            t = self.peek(skip_nl=True)
            raise HclSyntaxError(f"expected ',' or '}}', got {t.value!r}", t.line)

    def _for_expr(self, open_tok: Token, is_object: bool) -> Node:
        self.next(skip_nl=True)  # 'for'
        names = [self.next(skip_nl=True)]
        if self.eat_op(",", skip_nl=True):
            names.append(self.next(skip_nl=True))
        for nt in names:
            if nt.kind != L.IDENT:
                raise HclSyntaxError("bad for-expression variable", nt.line)
        in_tok = self.next(skip_nl=True)
        if not (in_tok.kind == L.IDENT and in_tok.value == "in"):
            raise HclSyntaxError("expected 'in' in for expression", in_tok.line)
        coll = self.parse_expr()
        self.expect_op(":")
        key_var = names[0].value if len(names) == 2 else None
        val_var = names[-1].value
        key_expr = None
        if is_object:
            key_expr = self.parse_expr()
            self.expect_op("=>")
        val_expr = self.parse_expr()
        group = False
        if self.eat_op("...", skip_nl=True):
            group = True
        cond = None
        t = self.peek(skip_nl=True)
        if t.kind == L.IDENT and t.value == "if":
            self.next(skip_nl=True)
            cond = self.parse_expr()
        self.expect_op("}" if is_object else "]")
        return ForExpr(
            open_tok.line,
            key_var=key_var,
            val_var=val_var,
            coll=coll,
            key_expr=key_expr,
            val_expr=val_expr,
            cond=cond,
            group=group,
        )

    def _skip_newlines(self):
        while self.toks[self.pos].kind == L.NEWLINE:
            self.pos += 1


def _heredoc_node(t: Token) -> Node:
    """Heredoc bodies may contain ${} interpolation."""
    text = t.value
    if "${" not in text and "%{" not in text:
        return Literal(t.line, text)
    parts: list = []
    i, n = 0, len(text)
    buf: list[str] = []
    while i < n:
        if text.startswith("$${", i) or text.startswith("%%{", i):
            buf.append(text[i] + "{")
            i += 3
            continue
        if text.startswith("${", i) or text.startswith("%{", i):
            kind = "interp" if text[i] == "$" else "directive"
            try:
                src, j = L._scan_braced(text, i + 2, t.line)
            except HclSyntaxError:
                buf.append(text[i])
                i += 1
                continue
            if buf:
                parts.append("".join(buf))
                buf = []
            parts.append((kind, src, t.line))
            i = j
            continue
        buf.append(text[i])
        i += 1
    if buf:
        parts.append("".join(buf))
    return Template(t.line, parts)


def parse(src: str) -> Body:
    """Parse HCL source into a Body."""
    return Parser(L.lex(src)).parse_body()


def parse_expression(src: str) -> Node:
    p = Parser(L.lex(src))
    node = p.parse_expr()
    return node
