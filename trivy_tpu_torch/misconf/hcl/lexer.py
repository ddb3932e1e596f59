"""HCL2 tokenizer (ref: the reference evaluates HCL via hashicorp/hcl/v2,
pkg/iac/scanners/terraform/parser/; this is an independent implementation of
the HCL2 syntax spec).

Produces a flat token stream; string templates (interpolation) are lexed as
single TEMPLATE tokens holding raw parts — the parser re-lexes embedded
``${...}`` expressions so nesting is handled naturally.

The port of ``trivy_tpu/misconf/hcl/lexer.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

# token kinds
IDENT = "IDENT"
NUMBER = "NUMBER"
STRING = "STRING"  # quoted string with no interpolation
TEMPLATE = "TEMPLATE"  # quoted string with ${}/%{} parts: value is list
HEREDOC = "HEREDOC"
OP = "OP"
NEWLINE = "NEWLINE"
EOF = "EOF"

_OPERATORS = [
    "&&", "||", "==", "!=", "<=", ">=", "=>", "...", "?", ":", ".", ",",
    "(", ")", "[", "]", "{", "}", "=", "+", "-", "*", "/", "%", "<", ">", "!",
]
_OPS_BY_LEN = sorted(_OPERATORS, key=len, reverse=True)

_ID_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_ID_CONT = _ID_START | set("0123456789-")


class HclSyntaxError(ValueError):
    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


@dataclass
class Token:
    kind: str
    value: object
    line: int

    def __repr__(self):
        return f"<{self.kind} {self.value!r} @{self.line}>"


def lex(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c in " \t\r":
            i += 1
            continue
        if c == "\n":
            toks.append(Token(NEWLINE, "\n", line))
            line += 1
            i += 1
            continue
        if c == "#" or src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise HclSyntaxError("unterminated block comment", line)
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if src.startswith("<<", i):
            tok, i, line = _lex_heredoc(src, i, line)
            toks.append(tok)
            continue
        if c == '"':
            tok, i, line = _lex_string(src, i, line)
            toks.append(tok)
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or
                             (src[j] in "+-" and src[j - 1] in "eE")):
                j += 1
            text = src[i:j]
            # trailing attribute access like 1.label: only consume a valid number
            while text and text[-1] in ".eE+-":
                text = text[:-1]
                j -= 1
            try:
                num = int(text)
            except ValueError:
                try:
                    num = float(text)
                except ValueError:
                    raise HclSyntaxError(f"bad number {text!r}", line) from None
            toks.append(Token(NUMBER, num, line))
            i = j
            continue
        if c in _ID_START:
            j = i + 1
            while j < n and src[j] in _ID_CONT:
                j += 1
            # trailing '-' is an operator, not part of the identifier
            while src[j - 1] == "-":
                j -= 1
            toks.append(Token(IDENT, src[i:j], line))
            i = j
            continue
        for op in _OPS_BY_LEN:
            if src.startswith(op, i):
                toks.append(Token(OP, op, line))
                i += len(op)
                break
        else:
            raise HclSyntaxError(f"unexpected character {c!r}", line)
    toks.append(Token(EOF, None, line))
    return toks


def _lex_string(src: str, i: int, line: int):
    """Quoted string. Returns STRING (plain str) or TEMPLATE (list of parts:
    str literals and ("interp"|"directive", raw_expr_source, line) tuples)."""
    assert src[i] == '"'
    i += 1
    parts: list = []
    buf: list[str] = []
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            i += 1
            if not parts:
                return Token(STRING, "".join(buf), line), i, line
            if buf:
                parts.append("".join(buf))
            return Token(TEMPLATE, parts, line), i, line
        if c == "\\":
            if i + 1 >= n:
                break
            esc = src[i + 1]
            mapping = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "r": "\r"}
            if esc in mapping:
                buf.append(mapping[esc])
                i += 2
                continue
            if esc == "u" and i + 6 <= n:
                buf.append(chr(int(src[i + 2 : i + 6], 16)))
                i += 6
                continue
            buf.append(esc)
            i += 2
            continue
        if src.startswith("$${", i) or src.startswith("%%{", i):
            buf.append(src[i] + "{")
            i += 3
            continue
        if src.startswith("${", i) or src.startswith("%{", i):
            kind = "interp" if c == "$" else "directive"
            expr_src, j = _scan_braced(src, i + 2, line)
            if buf:
                parts.append("".join(buf))
                buf = []
            parts.append((kind, expr_src, line))
            i = j
            continue
        if c == "\n":
            raise HclSyntaxError("newline in string", line)
        buf.append(c)
        i += 1
    raise HclSyntaxError("unterminated string", line)


def _scan_braced(src: str, i: int, line: int) -> tuple[str, int]:
    """Scan to the matching '}' honoring nesting and nested strings."""
    depth = 1
    start = i
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            # skip nested string
            i += 1
            while i < n and src[i] != '"':
                if src[i] == "\\":
                    i += 1
                i += 1
            i += 1
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return src[start:i], i + 1
        i += 1
    raise HclSyntaxError("unterminated interpolation", line)


def _lex_heredoc(src: str, i: int, line: int):
    j = i + 2
    indent = False
    if j < len(src) and src[j] == "-":
        indent = True
        j += 1
    k = j
    while k < len(src) and src[k] not in "\n\r":
        k += 1
    marker = src[j:k].strip()
    if not marker:
        raise HclSyntaxError("missing heredoc marker", line)
    body_start = k + 1 if k < len(src) and src[k] == "\n" else k
    lines_out = []
    pos = body_start
    cur_line = line + 1
    while True:
        eol = src.find("\n", pos)
        seg = src[pos:] if eol < 0 else src[pos:eol]
        if seg.strip() == marker:
            end = (len(src) if eol < 0 else eol)
            text = "\n".join(lines_out)
            if lines_out:
                text += "\n"
            if indent:
                # strip the minimal common leading whitespace (<<- semantics)
                body_lines = text.split("\n")
                pad = min(
                    (len(l) - len(l.lstrip()) for l in body_lines if l.strip()),
                    default=0,
                )
                text = "\n".join(l[pad:] if l.strip() else l for l in body_lines)
            return Token(HEREDOC, text, line), end, cur_line
        if eol < 0:
            raise HclSyntaxError(f"unterminated heredoc {marker}", line)
        lines_out.append(seg)
        pos = eol + 1
        cur_line += 1
