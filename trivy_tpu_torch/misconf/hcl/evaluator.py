"""HCL2 expression evaluator (independent implementation; the reference
evaluates via hashicorp/hcl + zclconf/go-cty inside
pkg/iac/scanners/terraform/parser/evaluator.go).

Unresolvable references evaluate to the UNKNOWN sentinel rather than
erroring — a scanner must keep going on partial configurations.

The port of ``trivy_tpu/misconf/hcl/evaluator.py``.
"""

from __future__ import annotations

from trivy_tpu_torch.misconf.hcl import parser as P
from trivy_tpu_torch.misconf.hcl.functions import (
    FUNCTIONS,
    UNKNOWN,
    EvalError,
    is_unknown,
    to_string,
)

_EXPR_CACHE: dict[str, P.Node] = {}


def _parse_cached(src: str) -> P.Node:
    node = _EXPR_CACHE.get(src)
    if node is None:
        node = P.parse_expression(src)
        _EXPR_CACHE[src] = node
    return node


def truthy(v) -> bool | None:
    """HCL bool conversion; None result means 'unknown'."""
    if v is UNKNOWN:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v == "true":
            return True
        if v == "false":
            return False
        return bool(v)
    if v is None:
        return False
    return bool(v)


class Evaluator:
    """Evaluates expressions against a variable scope.

    ``scope`` maps root names (``var``, ``local``, ``each`` …) to values;
    ``resolver(name)`` is consulted for roots not in scope (the terraform
    layer resolves resource-type roots there). Objects in the tree may
    implement ``hcl_get_attr(name)`` / ``hcl_index(key)`` to customize
    traversal (resource references do).
    """

    def __init__(self, scope: dict | None = None, resolver=None, functions=None):
        self.scope = dict(scope or {})
        self.resolver = resolver
        self.functions = functions if functions is not None else FUNCTIONS

    def child(self, extra: dict) -> "Evaluator":
        ev = Evaluator(self.scope, self.resolver, self.functions)
        ev.scope.update(extra)
        return ev

    # -- public entry points -------------------------------------------------

    def eval(self, node: P.Node):
        try:
            return self._eval(node)
        except EvalError:
            return UNKNOWN
        except (TypeError, KeyError, IndexError, ZeroDivisionError, ValueError):
            return UNKNOWN
        except RecursionError:
            return UNKNOWN

    def eval_src(self, src: str):
        try:
            return self.eval(_parse_cached(src))
        except P.HclSyntaxError:
            return UNKNOWN

    # -- dispatch ------------------------------------------------------------

    def _eval(self, node: P.Node):
        m = getattr(self, "_eval_" + type(node).__name__, None)
        if m is None:
            return UNKNOWN
        return m(node)

    def _eval_Literal(self, n: P.Literal):
        return n.value

    def _eval_Var(self, n: P.Var):
        if n.name in self.scope:
            return self.scope[n.name]
        if self.resolver is not None:
            return self.resolver(n.name)
        return UNKNOWN

    def _eval_GetAttr(self, n: P.GetAttr):
        obj = self._eval(n.obj)
        return self._get_attr(obj, n.name)

    def _get_attr(self, obj, name: str):
        if obj is UNKNOWN or obj is None:
            return UNKNOWN
        hook = getattr(obj, "hcl_get_attr", None)
        if hook is not None:
            return hook(name)
        if isinstance(obj, dict):
            return obj.get(name, UNKNOWN)
        return UNKNOWN

    def _eval_Index(self, n: P.Index):
        obj = self._eval(n.obj)
        key = self._eval(n.key)
        return self._index(obj, key)

    def _index(self, obj, key):
        if obj is UNKNOWN or key is UNKNOWN or obj is None:
            return UNKNOWN
        hook = getattr(obj, "hcl_index", None)
        if hook is not None:
            return hook(key)
        if isinstance(obj, list):
            i = int(key)
            if 0 <= i < len(obj):
                return obj[i]
            return UNKNOWN
        if isinstance(obj, dict):
            if key in obj:
                return obj[key]
            return obj.get(to_string(key), UNKNOWN)
        return UNKNOWN

    def _eval_Splat(self, n: P.Splat):
        obj = self._eval(n.obj)
        if obj is UNKNOWN:
            return UNKNOWN
        if obj is None:
            return []
        items = obj if isinstance(obj, list) else [obj]
        out = []
        for it in items:
            v = it
            for kind, arg in n.rest:
                if kind == "attr":
                    v = self._get_attr(v, arg)
                else:
                    v = self._index(v, self._eval(arg))
            out.append(v)
        return out

    def _eval_Call(self, n: P.Call):
        if n.name == "try":
            for arg in n.args:
                v = self.eval(arg)
                if v is not UNKNOWN:
                    return v
            return UNKNOWN
        if n.name == "can":
            if not n.args:
                return UNKNOWN
            return self.eval(n.args[0]) is not UNKNOWN
        fn = self.functions.get(n.name)
        if fn is None:
            return UNKNOWN
        args = [self._eval(a) for a in n.args]
        if n.expand_last and args:
            last = args.pop()
            if last is UNKNOWN:
                return UNKNOWN
            if isinstance(last, dict):
                last = list(last.values())
            args.extend(last if isinstance(last, list) else [last])
        if n.name not in ("merge", "coalesce", "concat") and any(
            a is UNKNOWN for a in args
        ):
            return UNKNOWN
        return fn(*args)

    def _eval_Unary(self, n: P.Unary):
        v = self._eval(n.operand)
        if v is UNKNOWN:
            return UNKNOWN
        if n.op == "!":
            t = truthy(v)
            return UNKNOWN if t is None else not t
        if n.op == "-":
            return -v
        return UNKNOWN

    def _eval_Binary(self, n: P.Binary):
        op = n.op
        if op in ("&&", "||"):
            lt = truthy(self._eval(n.left))
            if lt is None:
                return UNKNOWN
            if op == "&&" and not lt:
                return False
            if op == "||" and lt:
                return True
            rt = truthy(self._eval(n.right))
            return UNKNOWN if rt is None else rt
        left = self._eval(n.left)
        right = self._eval(n.right)
        if left is UNKNOWN or right is UNKNOWN:
            return UNKNOWN
        if op == "==":
            return self._coerced_eq(left, right)
        if op == "!=":
            return not self._coerced_eq(left, right)
        lnum, rnum = self._nums(left, right)
        if op == "+":
            return lnum + rnum
        if op == "-":
            return lnum - rnum
        if op == "*":
            return lnum * rnum
        if op == "/":
            return lnum / rnum
        if op == "%":
            return lnum % rnum
        if op == "<":
            return lnum < rnum
        if op == ">":
            return lnum > rnum
        if op == "<=":
            return lnum <= rnum
        if op == ">=":
            return lnum >= rnum
        return UNKNOWN

    @staticmethod
    def _coerced_eq(a, b) -> bool:
        if isinstance(a, bool) or isinstance(b, bool):
            ta, tb = truthy(a), truthy(b)
            if isinstance(a, bool) and isinstance(b, str):
                return tb is not None and ta == tb
            if isinstance(b, bool) and isinstance(a, str):
                return ta is not None and ta == tb
        if isinstance(a, (int, float)) and isinstance(b, str):
            try:
                return float(a) == float(b)
            except ValueError:
                return False
        if isinstance(b, (int, float)) and isinstance(a, str):
            try:
                return float(a) == float(b)
            except ValueError:
                return False
        return a == b

    @staticmethod
    def _nums(a, b):
        def conv(v):
            if isinstance(v, bool):
                raise EvalError("arithmetic on bool")
            if isinstance(v, (int, float)):
                return v
            if isinstance(v, str):
                try:
                    return int(v)
                except ValueError:
                    return float(v)
            raise EvalError("arithmetic on non-number")

        return conv(a), conv(b)

    def _eval_Conditional(self, n: P.Conditional):
        c = truthy(self._eval(n.cond))
        if c is None:
            # unknown condition: prefer a resolvable branch so scanning can
            # still see concrete config (matches defsec's lenient stance)
            t = self._eval(n.true)
            return t if t is not UNKNOWN else self._eval(n.false)
        return self._eval(n.true) if c else self._eval(n.false)

    def _eval_TupleExpr(self, n: P.TupleExpr):
        return [self._eval(i) for i in n.items]

    def _eval_ObjectExpr(self, n: P.ObjectExpr):
        out = {}
        for k_node, v_node in n.pairs:
            if isinstance(k_node, P.Literal):
                k = k_node.value
            else:
                k = self._eval(k_node)
            if k is UNKNOWN:
                continue
            out[to_string(k) if not isinstance(k, str) else k] = self._eval(v_node)
        return out

    def _eval_ForExpr(self, n: P.ForExpr):
        coll = self._eval(n.coll)
        if coll is UNKNOWN:
            return UNKNOWN
        if isinstance(coll, dict):
            pairs = list(coll.items())
        elif isinstance(coll, list):
            pairs = list(enumerate(coll))
        elif coll is None:
            pairs = []
        else:
            return UNKNOWN
        tuple_out: list = []
        obj_out: dict = {}
        for k, v in pairs:
            scope = {n.val_var: v}
            if n.key_var:
                scope[n.key_var] = k
            ev = self.child(scope)
            if n.cond is not None:
                c = truthy(ev.eval(n.cond))
                if not c:
                    continue
            if n.key_expr is None:
                tuple_out.append(ev.eval(n.val_expr))
            else:
                kk = ev.eval(n.key_expr)
                if kk is UNKNOWN:
                    continue
                kk = kk if isinstance(kk, str) else to_string(kk)
                vv = ev.eval(n.val_expr)
                if n.group:
                    obj_out.setdefault(kk, []).append(vv)
                else:
                    obj_out[kk] = vv
        return obj_out if n.key_expr is not None else tuple_out

    def _eval_Template(self, n: P.Template):
        parts = self._expand_directives(n.parts)
        if parts is UNKNOWN:
            return UNKNOWN
        # lone interpolation yields the value itself, unconverted
        if len(parts) == 1 and not isinstance(parts[0], str):
            return self.eval_src(parts[0][1])
        out = []
        for p in parts:
            if isinstance(p, str):
                out.append(p)
            else:
                v = self.eval_src(p[1])
                if v is UNKNOWN:
                    return UNKNOWN
                try:
                    out.append(to_string(v))
                except EvalError:
                    return UNKNOWN
        return "".join(out)

    def _expand_directives(self, parts: list):
        """Expand %{if}/%{for} directives into plain parts."""
        if not any(not isinstance(p, str) and p[0] == "directive" for p in parts):
            return parts
        out, i = [], 0
        try:
            out, i = self._expand_seq(parts, 0, None)
        except EvalError:
            return UNKNOWN
        return out

    def _expand_seq(self, parts, i, stop_words):
        """Expand until a directive in stop_words; returns (parts, index_of_stop)."""
        out: list = []
        while i < len(parts):
            p = parts[i]
            if isinstance(p, str) or p[0] != "directive":
                out.append(p)
                i += 1
                continue
            word = p[1].strip().strip("~").strip()
            head = word.split()[0] if word else ""
            if stop_words and head in stop_words:
                return out, i
            if head == "if":
                cond_src = word[len("if"):].strip()
                body, j = self._expand_seq(parts, i + 1, ("else", "endif"))
                else_body: list = []
                jw = parts[j][1].strip().strip("~").strip()
                if jw.startswith("else"):
                    else_body, j = self._expand_seq(parts, j + 1, ("endif",))
                c = truthy(self.eval_src(cond_src))
                if c is None:
                    raise EvalError("unknown template condition")
                out.extend(body if c else else_body)
                i = j + 1
                continue
            if head == "for":
                # %{for x in coll} or %{for k, v in coll}
                m = word[len("for"):].strip()
                var_part, _, coll_src = m.partition(" in ")
                names = [v.strip() for v in var_part.split(",")]
                body, j = self._expand_seq(parts, i + 1, ("endfor",))
                coll = self.eval_src(coll_src.strip())
                if coll is UNKNOWN:
                    raise EvalError("unknown template collection")
                pairs = (
                    list(coll.items()) if isinstance(coll, dict)
                    else list(enumerate(coll if isinstance(coll, list) else []))
                )
                for k, v in pairs:
                    scope = (
                        {names[0]: v} if len(names) == 1
                        else {names[0]: k, names[1]: v}
                    )
                    ev = self.child(scope)
                    for bp in body:
                        if isinstance(bp, str):
                            out.append(bp)
                        else:
                            val = ev.eval_src(bp[1])
                            if val is UNKNOWN:
                                raise EvalError("unknown in template body")
                            out.append(to_string(val))
                i = j + 1
                continue
            raise EvalError(f"unsupported template directive {head!r}")
        if stop_words:
            raise EvalError("unterminated template directive")
        return out, i
