"""Template writer (ref: pkg/report/template.go), the port's copy of
``trivy_tpu/report/template.py``.

Renders a Go-template-subset over the report's JSON form (the same
PascalCase document ``--format json`` emits), so the common community
templates keep working:

- ``{{ .Field.Sub }}`` — lookup (``.`` is the report at top level,
  rebound inside range)
- ``{{ range .X }}...{{ end }}`` — iteration
- ``{{ if .X }}...{{ else }}...{{ end }}`` — truthiness conditional
- ``{{ len .X }}``, ``{{ . | toLower }}`` / ``toUpper`` / ``json`` /
  ``escapeXML`` pipes

``@path`` template arguments load the template from a file, as the
reference does. Sprig's full function set is intentionally not replicated.
"""

from __future__ import annotations

import json as json_mod
import re
from html import escape

from trivy_tpu_torch.types import Report

_TOKEN = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.S)

_FUNCS = {
    "toLower": lambda v: str(v).lower(),
    "toUpper": lambda v: str(v).upper(),
    "json": lambda v: json_mod.dumps(v),
    "escapeXML": lambda v: escape(str(v), quote=True),
}


class TemplateError(ValueError):
    pass


def _lookup(expr: str, dot):
    if expr == ".":
        return dot
    cur = dot
    for part in expr.lstrip(".").split("."):
        if not part:
            continue
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if cur is None:
            return None
    return cur


def _eval(expr: str, dot):
    parts = [p.strip() for p in expr.split("|")]
    head = parts[0]
    if head.startswith("len "):
        v = _lookup(head[4:].strip(), dot)
        val = len(v) if v is not None else 0
    elif head.startswith('"') and head.endswith('"'):
        val = head[1:-1]
    else:
        val = _lookup(head, dot)
    for fn in parts[1:]:
        f = _FUNCS.get(fn)
        if f is None:
            raise TemplateError(f"unsupported template function: {fn}")
        val = f(val)
    return val


def _parse(tokens: list, i: int, stop: tuple) -> tuple[list, int]:
    """-> (nodes, next_index); nodes are ('text', s) | ('expr', e) |
    ('range', e, body) | ('if', e, body, else_body)."""
    nodes: list = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
            continue
        action = val
        if action in stop:
            return nodes, i
        if action.startswith("range "):
            body, j = _parse(tokens, i + 1, ("end",))
            nodes.append(("range", action[6:].strip(), body))
            i = j + 1
        elif action.startswith("if "):
            body, j = _parse(tokens, i + 1, ("else", "end"))
            else_body: list = []
            if tokens[j][1] == "else":
                else_body, j = _parse(tokens, j + 1, ("end",))
            nodes.append(("if", action[3:].strip(), body, else_body))
            i = j + 1
        else:
            nodes.append(("expr", action))
            i += 1
    return nodes, i


def _render(nodes: list, dot, out: list) -> None:
    for node in nodes:
        if node[0] == "text":
            out.append(node[1])
        elif node[0] == "expr":
            v = _eval(node[1], dot)
            out.append("" if v is None else str(v))
        elif node[0] == "range":
            seq = _eval(node[1], dot) or []
            for item in seq:
                _render(node[2], item, out)
        elif node[0] == "if":
            v = _eval(node[1], dot)
            _render(node[2] if v else node[3], dot, out)


def render(template: str, context) -> str:
    tokens: list = []
    pos = 0
    for m in _TOKEN.finditer(template):
        if m.start() > pos:
            tokens.append(("text", template[pos : m.start()]))
        tokens.append(("action", m.group(1)))
        pos = m.end()
    if pos < len(template):
        tokens.append(("text", template[pos:]))
    nodes, _ = _parse(tokens, 0, ())
    out: list = []
    _render(nodes, context, out)
    return "".join(out)


def write_template(report: Report, out, template: str = "", **kw) -> None:
    if not template:
        raise TemplateError("--format template requires --template")
    if template.startswith("@"):
        with open(template[1:], "r", encoding="utf-8") as f:
            template = f.read()
    out.write(render(template, report.to_dict()))
