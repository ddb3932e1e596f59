"""Helm chart rendering (ref: pkg/iac/scanners/helm, which shells into the
helm SDK; this is an independent Go-template-subset renderer sufficient for
typical chart manifests).

Supported template language subset: ``{{ .Values.x }}`` traversal (Values/
Chart/Release/Capabilities), ``{{- -}}`` whitespace trimming, pipelines with
the common sprig/helm functions, if/else/else if/end, with, range (lists and
maps, with ``$k, $v :=``), variables (``$x :=``), define/include/template,
comparison and boolean functions, printf and toYaml.

Rendered manifests are handed to the kubernetes check engine.

The port of ``trivy_tpu/misconf/helm/__init__.py``.
"""

from __future__ import annotations

import json
import os.path
import re

import yaml

from trivy_tpu_torch import log

logger = log.logger("misconf:helm")


class TemplateError(ValueError):
    pass


# -- tokenizer ---------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.S)


def _tokenize(src: str):
    """("text", s) / ("action", code) pairs with {{- -}} trimming applied
    (Go text/template: '-' trims ALL adjacent whitespace)."""
    out = []
    pos = 0
    pending_trim = False
    for m in _ACTION_RE.finditer(src):
        text = src[pos : m.start()]
        if pending_trim:
            text = text.lstrip(" \t\r\n")
        if m.group(0).startswith("{{-"):
            text = text.rstrip(" \t\r\n")
        out.append(("text", text))
        out.append(("action", m.group(1)))
        pending_trim = m.group(0).endswith("-}}")
        pos = m.end()
    text = src[pos:]
    if pending_trim:
        text = text.lstrip(" \t\r\n")
    out.append(("text", text))
    return out


# -- AST ---------------------------------------------------------------------

class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Out(_Node):  # {{ expr }}
    def __init__(self, code):
        self.code = code


class _If(_Node):
    def __init__(self):
        self.branches = []  # [(cond_code|None, [nodes])]


class _Range(_Node):
    def __init__(self, code):
        self.code = code  # full range header
        self.body: list[_Node] = []
        self.else_body: list[_Node] = []


class _With(_Node):
    def __init__(self, code):
        self.code = code
        self.body: list[_Node] = []
        self.else_body: list[_Node] = []


class _Define(_Node):
    def __init__(self, name):
        self.name = name
        self.body: list[_Node] = []


def _parse(tokens) -> list[_Node]:
    root: list[_Node] = []
    stack: list = [root]
    modes: list = ["root"]

    def top():
        return stack[-1]

    for kind, val in tokens:
        if kind == "text":
            if val:
                top().append(_Text(val))
            continue
        code = val.strip()
        if not code or code.startswith("/*"):
            continue
        head = code.split(None, 1)[0]
        if head == "if":
            node = _If()
            node.branches.append((code[2:].strip(), []))
            top().append(node)
            stack.append(node.branches[-1][1])
            modes.append("if")
        elif head == "else":
            if modes[-1] not in ("if", "range", "with"):
                raise TemplateError("unexpected else")
            stack.pop()
            parent_list = stack[-1]
            node = parent_list[-1]
            rest = code[4:].strip()
            if isinstance(node, _If):
                if rest.startswith("if "):
                    node.branches.append((rest[3:].strip(), []))
                else:
                    node.branches.append((None, []))
                stack.append(node.branches[-1][1])
            else:
                node.else_body = []
                stack.append(node.else_body)
        elif head == "end":
            if len(stack) <= 1:
                raise TemplateError("unexpected end")
            stack.pop()
            modes.pop()
        elif head == "range":
            node = _Range(code[5:].strip())
            top().append(node)
            stack.append(node.body)
            modes.append("range")
        elif head == "with":
            node = _With(code[4:].strip())
            top().append(node)
            stack.append(node.body)
            modes.append("with")
        elif head == "define":
            name = code[6:].strip().strip('"')
            node = _Define(name)
            top().append(node)
            stack.append(node.body)
            modes.append("if")  # ends with {{ end }}
        else:
            top().append(_Out(code))
    return root


# -- expression evaluation ---------------------------------------------------

_TOKEN_RE = re.compile(
    r'"(?:[^"\\]|\\.)*"|`[^`]*`|\(|\)|\||[^\s()|]+'
)


def _truthy(v) -> bool:
    if v is None:
        return False
    if isinstance(v, (dict, list, str)):
        return len(v) > 0
    if isinstance(v, (int, float, bool)):
        return bool(v)
    return True


def _to_str(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return str(v)


def _to_yaml(v) -> str:
    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


def _indent(n, s):
    pad = " " * int(n)
    return "\n".join(pad + l if l else l for l in _to_str(s).split("\n"))


def _nindent(n, s):
    return "\n" + _indent(n, s)


class Renderer:
    def __init__(self, values: dict, chart_meta: dict, templates: dict[str, str]):
        # helm exposes Chart.yaml keys capitalized (.Chart.Name, .Chart.Version)
        chart_ctx = {
            (k[:1].upper() + k[1:] if isinstance(k, str) else k): v
            for k, v in chart_meta.items()
        }
        self.ctx_root = {
            "Values": values,
            "Chart": chart_ctx,
            "Release": {
                "Name": "release-name",
                "Namespace": "default",
                "Service": "Helm",
                "IsInstall": True,
                "IsUpgrade": False,
            },
            "Capabilities": {
                "KubeVersion": {"Version": "v1.29.0", "Major": "1", "Minor": "29"},
                "APIVersions": [],
            },
            "Template": {"Name": "", "BasePath": "templates"},
        }
        self.defines: dict[str, list[_Node]] = {}
        # preload defines from all templates (incl. _helpers.tpl)
        for name, src in templates.items():
            try:
                nodes = _parse(_tokenize(src))
            except TemplateError as e:
                logger.debug("helm parse failed for %s: %s", name, e)
                continue
            self._collect_defines(nodes)

    def _collect_defines(self, nodes):
        for n in nodes:
            if isinstance(n, _Define):
                self.defines[n.name] = n.body
                self._collect_defines(n.body)
            elif isinstance(n, (_If,)):
                for _, b in n.branches:
                    self._collect_defines(b)
            elif isinstance(n, (_Range, _With)):
                self._collect_defines(n.body)

    # -- public --------------------------------------------------------------

    def render(self, src: str) -> str:
        nodes = _parse(_tokenize(src))
        out: list[str] = []
        self._exec(nodes, self.ctx_root, {"$": self.ctx_root}, out)
        return "".join(out)

    # -- execution -----------------------------------------------------------

    def _exec(self, nodes, dot, vars_, out: list[str]):
        for n in nodes:
            if isinstance(n, _Text):
                out.append(n.s)
            elif isinstance(n, _Out):
                v = self._eval_action(n.code, dot, vars_)
                if v is not None and v is not _NOOP:
                    out.append(_to_str(v))
            elif isinstance(n, _If):
                for cond, body in n.branches:
                    if cond is None or _truthy(self._eval_expr(cond, dot, vars_)):
                        self._exec(body, dot, vars_, out)
                        break
            elif isinstance(n, _With):
                v = self._eval_expr(n.code, dot, vars_)
                if _truthy(v):
                    self._exec(n.body, v, vars_, out)
                else:
                    self._exec(n.else_body, dot, vars_, out)
            elif isinstance(n, _Range):
                self._exec_range(n, dot, vars_, out)
            elif isinstance(n, _Define):
                pass

    def _exec_range(self, n: _Range, dot, vars_, out):
        code = n.code
        kvar = vvar = None
        m = re.match(r"^(\$\w+)\s*(?:,\s*(\$\w+))?\s*:=\s*(.*)$", code)
        if m:
            if m.group(2):
                kvar, vvar, code = m.group(1), m.group(2), m.group(3)
            else:
                vvar, code = m.group(1), m.group(3)
        coll = self._eval_expr(code, dot, vars_)
        items: list = []
        if isinstance(coll, dict):
            items = sorted(coll.items())
        elif isinstance(coll, list):
            items = list(enumerate(coll))
        if not items:
            self._exec(n.else_body, dot, vars_, out)
            return
        for k, v in items:
            nv = dict(vars_)
            if kvar:
                nv[kvar] = k
            if vvar:
                nv[vvar] = v
            self._exec(n.body, v, nv, out)

    # -- actions / expressions ----------------------------------------------

    def _eval_action(self, code, dot, vars_):
        m = re.match(r"^(\$\w+)\s*:=\s*(.*)$", code)
        if m:
            vars_[m.group(1)] = self._eval_expr(m.group(2), dot, vars_)
            return _NOOP
        return self._eval_expr(code, dot, vars_)

    def _eval_expr(self, code, dot, vars_):
        toks = _TOKEN_RE.findall(code)
        if not toks:
            return None
        stages = [[]]
        depth = 0
        for t in toks:
            if t == "(":
                depth += 1
                stages[-1].append(t)
            elif t == ")":
                depth -= 1
                stages[-1].append(t)
            elif t == "|" and depth == 0:
                stages.append([])
            else:
                stages[-1].append(t)
        val = self._eval_stage(stages[0], dot, vars_, piped=_NOPIPE)
        for st in stages[1:]:
            val = self._eval_stage(st, dot, vars_, piped=val)
        return val

    def _eval_stage(self, toks, dot, vars_, piped):
        args, _ = self._eval_terms(toks, 0, dot, vars_)
        if not args:
            return None if piped is _NOPIPE else piped
        head = args[0]
        if isinstance(head, _Func):
            fargs = args[1:]
            if piped is not _NOPIPE:
                fargs = fargs + [piped]  # piped value becomes the last arg
            return head.call(self, fargs, dot, vars_)
        return head

    def _eval_terms(self, toks, i, dot, vars_):
        out = []
        while i < len(toks):
            t = toks[i]
            if t == ")":
                return out, i
            if t == "(":
                sub, j = self._eval_terms(toks, i + 1, dot, vars_)
                # a parenthesized group evaluates like a stage
                if sub and isinstance(sub[0], _Func):
                    out.append(sub[0].call(self, sub[1:], dot, vars_))
                elif sub:
                    out.append(sub[0])
                else:
                    out.append(None)
                i = j + 1
                continue
            out.append(self._term(t, dot, vars_))
            i += 1
        return out, i

    def _term(self, t, dot, vars_):
        if t.startswith('"') and t.endswith('"'):
            try:
                return json.loads(t)
            except Exception:
                return t[1:-1]
        if t.startswith("`") and t.endswith("`"):
            return t[1:-1]
        if t in ("true", "false"):
            return t == "true"
        if t in ("nil", "null"):
            return None
        try:
            return int(t)
        except ValueError:
            pass
        try:
            return float(t)
        except ValueError:
            pass
        if t == ".":
            return dot
        if t.startswith("$"):
            root_name, _, rest = t.partition(".")
            root = vars_.get(root_name)
            return _walk(root, rest) if rest else root
        if t.startswith("."):
            return _walk(dot, t[1:])
        if t in _ALL_FUNCS:
            return _Func(t)
        return None

    def include(self, name, arg):
        body = self.defines.get(name)
        if body is None:
            return ""
        out: list[str] = []
        self._exec(body, arg, {"$": self.ctx_root}, out)
        return "".join(out)


class _Func:
    def __init__(self, name):
        self.name = name

    def call(self, renderer: Renderer, args, dot, vars_):
        fn = _ALL_FUNCS[self.name]
        try:
            if self.name in ("include", "template", "tpl"):
                if self.name == "tpl":
                    src = args[0] if args else ""
                    return renderer.render(src if isinstance(src, str) else "")
                name = args[0] if args else ""
                arg = args[1] if len(args) > 1 else dot
                return renderer.include(name, arg)
            return fn(*args)
        except Exception:
            return None


_NOOP = object()
_NOPIPE = object()


def _walk(v, dotted: str):
    if not dotted:
        return v
    for part in dotted.split("."):
        if isinstance(v, dict):
            v = v.get(part)
        else:
            v = getattr(v, part, None)
        if v is None:
            return None
    return v


def _default(d, v=None):
    # helm: last arg is the value (piped), first the default
    if v is None:
        return d
    return v if _truthy(v) else d


_ALL_FUNCS = {
    "default": _default,
    "quote": lambda *a: '"' + _to_str(a[-1] if a else "") + '"',
    "squote": lambda *a: "'" + _to_str(a[-1] if a else "") + "'",
    "upper": lambda v: _to_str(v).upper(),
    "lower": lambda v: _to_str(v).lower(),
    "title": lambda v: _to_str(v).title(),
    "trim": lambda v: _to_str(v).strip(),
    "trimSuffix": lambda suf, v: _to_str(v)[: -len(suf)] if _to_str(v).endswith(suf) else _to_str(v),
    "trimPrefix": lambda pre, v: _to_str(v)[len(pre):] if _to_str(v).startswith(pre) else _to_str(v),
    "trunc": lambda n, v: _to_str(v)[: int(n)] if int(n) >= 0 else _to_str(v)[int(n):],
    "replace": lambda old, new, v: _to_str(v).replace(old, new),
    "repeat": lambda n, v: _to_str(v) * int(n),
    "printf": lambda fmt, *a: _go_printf(fmt, a),
    "print": lambda *a: "".join(_to_str(x) for x in a),
    "toYaml": _to_yaml,
    "toJson": lambda v: json.dumps(v),
    "fromYaml": lambda s: yaml.safe_load(s) or {},
    "indent": _indent,
    "nindent": _nindent,
    "b64enc": lambda v: __import__("base64").b64encode(_to_str(v).encode()).decode(),
    "b64dec": lambda v: __import__("base64").b64decode(_to_str(v)).decode("utf-8", "replace"),
    "sha256sum": lambda v: __import__("hashlib").sha256(_to_str(v).encode()).hexdigest(),
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "and": lambda *a: a[-1] if all(_truthy(x) for x in a) else next((x for x in a if not _truthy(x)), None),
    "or": lambda *a: next((x for x in a if _truthy(x)), a[-1] if a else None),
    "not": lambda v: not _truthy(v),
    "empty": lambda v: not _truthy(v),
    "required": lambda msg, v: v,
    "fail": lambda msg: None,
    "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
    "ternary": lambda t, f, c: t if _truthy(c) else f,
    "hasKey": lambda d, k: isinstance(d, dict) and k in d,
    "get": lambda d, k: d.get(k) if isinstance(d, dict) else None,
    "keys": lambda d: sorted(d.keys()) if isinstance(d, dict) else [],
    "list": lambda *a: list(a),
    "dict": lambda *a: {a[i]: a[i + 1] for i in range(0, len(a) - 1, 2)},
    "merge": lambda *ds: {k: v for d in reversed([x for x in ds if isinstance(x, dict)]) for k, v in d.items()},
    "len": lambda v: len(v) if isinstance(v, (str, list, dict)) else 0,
    "first": lambda v: v[0] if isinstance(v, list) and v else None,
    "last": lambda v: v[-1] if isinstance(v, list) and v else None,
    "contains": lambda sub, s: _to_str(sub) in _to_str(s),
    "hasPrefix": lambda pre, s: _to_str(s).startswith(_to_str(pre)),
    "hasSuffix": lambda suf, s: _to_str(s).endswith(_to_str(suf)),
    "split": lambda sep, s: {str(i): p for i, p in enumerate(_to_str(s).split(sep))},
    "splitList": lambda sep, s: _to_str(s).split(sep),
    "join": lambda sep, v: _to_str(sep).join(_to_str(x) for x in (v if isinstance(v, list) else [])),
    "add": lambda *a: sum(int(x) for x in a),
    "sub": lambda a, b: int(a) - int(b),
    "mul": lambda *a: __import__("math").prod(int(x) for x in a),
    "div": lambda a, b: int(a) // int(b),
    "mod": lambda a, b: int(a) % int(b),
    "int": lambda v: int(float(v)) if v not in (None, "") else 0,
    "toString": _to_str,
    "kindIs": lambda kind, v: kind == {dict: "map", list: "slice", str: "string", bool: "bool", int: "int", float: "float64", type(None): "invalid"}.get(type(v), "unknown"),
    "typeOf": lambda v: type(v).__name__,
    "include": None,  # handled specially
    "template": None,
    "tpl": None,
    "lookup": lambda *a: {},
    "uuidv4": lambda: "00000000-0000-0000-0000-000000000000",
    "now": lambda: "2006-01-02T15:04:05Z",
    "semverCompare": lambda c, v: True,
}


def _go_printf(fmt, args):
    out = []
    ai = 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        j = i + 1
        while j < len(fmt) and fmt[j] in "-+ 0123456789.":
            j += 1
        if j >= len(fmt):
            break
        verb = fmt[j]
        if verb == "%":
            out.append("%")
        else:
            v = args[ai] if ai < len(args) else ""
            ai += 1
            if verb in ("s", "v"):
                out.append(_to_str(v))
            elif verb == "d":
                out.append(str(int(v)))
            elif verb == "q":
                out.append(json.dumps(_to_str(v)))
            elif verb in ("f", "g"):
                out.append(str(float(v)))
            else:
                out.append(_to_str(v))
        i = j + 1
    return "".join(out)


# -- chart discovery ---------------------------------------------------------

def render_charts(files: dict[str, bytes]) -> dict[str, str]:
    """Find charts among the detected helm files and render their templates.

    Returns {template_path: rendered_manifest_text}.
    """
    charts: dict[str, dict] = {}
    for path in files:
        if os.path.basename(path) == "Chart.yaml":
            root = os.path.dirname(path)
            try:
                meta = yaml.safe_load(files[path].decode("utf-8", "replace")) or {}
            except Exception:
                meta = {}
            charts[root] = meta
    out: dict[str, str] = {}
    for root, meta in charts.items():
        values_path = os.path.join(root, "values.yaml") if root else "values.yaml"
        values = {}
        raw = files.get(values_path)
        if raw is not None:
            try:
                values = yaml.safe_load(raw.decode("utf-8", "replace")) or {}
            except Exception:
                values = {}
        tpl_prefix = os.path.join(root, "templates") if root else "templates"
        templates = {
            p: files[p].decode("utf-8", "replace")
            for p in files
            if p.startswith(tpl_prefix + "/") and p.endswith((".yaml", ".yml", ".tpl"))
        }
        renderer = Renderer(values, meta, templates)
        for p, src in templates.items():
            if os.path.basename(p).startswith("_"):
                continue
            try:
                rendered = renderer.render(src)
            except Exception as e:
                logger.debug("helm render failed for %s: %s", p, e)
                continue
            if rendered.strip():
                out[p] = rendered
        # chart yaml outside templates/ (crds/, chart-adjacent manifests)
        # installs verbatim in helm — flow it through this lane so it is
        # scanned exactly once (the misconf scanner excludes chart dirs
        # from its standalone pass and relies on this for coverage);
        # Chart.yaml/values.yaml are chart config, not manifests
        prefix = root + "/" if root else ""
        for p in files:
            if not p.startswith(prefix) or p.startswith(tpl_prefix + "/"):
                continue
            if os.path.basename(p) in ("Chart.yaml", "values.yaml"):
                continue
            # .json included: k8s manifests ship as JSON too, and the
            # misconf scanner treats them as chart-owned under a root
            if not p.endswith((".yaml", ".yml", ".json")):
                continue
            try:
                rendered = renderer.render(
                    files[p].decode("utf-8", "replace")
                )
            except Exception as e:
                logger.debug("helm render failed for %s: %s", p, e)
                continue
            if rendered.strip():
                out.setdefault(p, rendered)
    return out
