"""The port's HCL engine (``trivy_tpu_torch/misconf/hcl/``) against the JAX
package's, on the CPU: the lexer's tokens, the parser's trees, the
evaluator on the JAX tests' expressions, every function of the standard
library on a table of arguments, and seeded generated expressions. The
engine does no float math of its own, so every comparison is exact: the
values, or the error's type and message.
"""

from __future__ import annotations

import dataclasses
import textwrap

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from trivy_tpu.misconf.hcl import Evaluator as JaxEvaluator
from trivy_tpu.misconf.hcl import functions as jax_functions
from trivy_tpu.misconf.hcl import lexer as jax_lexer
from trivy_tpu.misconf.hcl import parser as jax_parser
from trivy_tpu_torch.misconf.hcl import Evaluator
from trivy_tpu_torch.misconf.hcl import functions, lexer, parser


def norm(obj, _stack=()):
    """A package-free form of an engine value or tree: dataclasses by
    class name and fields, ``UNKNOWN`` as a marker, scalars with their type
    (so ``1``, ``1.0`` and ``True`` stay apart)."""
    if id(obj) in _stack:
        return ("<cycle>", type(obj).__name__)
    stack = _stack + (id(obj),)
    name = type(obj).__name__
    if name == "UnknownType":
        return "<UNKNOWN>"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (name, tuple((f.name, norm(getattr(obj, f.name), stack))
                            for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return ("dict", tuple((norm(k, stack), norm(v, stack)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (name, tuple(norm(x, stack) for x in obj))
    if isinstance(obj, str):
        return (name, str(obj), norm(getattr(obj, "path", ()), stack))
    if obj is None or isinstance(obj, (bool, int, float, bytes)):
        return (name, obj)
    return (name, norm(vars(obj), stack)) if hasattr(obj, "__dict__") else (name, repr(obj))


def outcome(fn, *args):
    """``("ok", value)`` or ``("err", type, message, line)`` of
    ``fn(*args)`` (``line`` for a syntax error, else None)."""
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # the error is part of the contract
        return ("err", type(e).__name__, str(e), getattr(e, "line", None))


def both(src: str, scope=None):
    mine = outcome(lambda: Evaluator(scope=dict(scope or {})).eval_src(src))
    ref = outcome(lambda: JaxEvaluator(scope=dict(scope or {})).eval_src(src))
    return mine, ref


# -- the JAX tests' expressions (tests/test_iac.py::TestHCLEvaluator) --------

SPLAT_SCOPE = {"things": [{"id": 1}, {"id": 2}]}
EXPRESSIONS = [
    ("1 + 2 * 3", None, 7), ("(1 + 2) * 3", None, 9), ("10 % 3", None, 1),
    ("1 < 2 && 2 <= 2", None, True), ("!(1 == 2) || false", None, True),
    ('true ? "a" : "b"', None, "a"), ('"x-${1 + 1}"', None, "x-2"),
    ("[1, 2, 3][1]", None, 2), ('{ a = 1, b = 2 }["b"]', None, 2),
    ("[for x in [1, 2, 3] : x * 2]", None, [2, 4, 6]),
    ("[for x in [1, 2, 3] : x if x > 1]", None, [2, 3]),
    ('{ for k, v in { a = 1 } : upper(k) => v }', None, {"A": 1}),
    ('length("abc")', None, 3), ('join("-", ["a", "b"])', None, "a-b"),
    ('upper("abc")', None, "ABC"), ('contains(["a"], "a")', None, True),
    ("max(1, 5, 2)", None, 5), ('split(",", "a,b")', None, ["a", "b"]),
    ('coalesce(null, "x")', None, "x"), ('lookup({ a = 1 }, "a", 0)', None, 1),
    ('lookup({}, "a", 9)', None, 9), ("things[*].id", SPLAT_SCOPE, [1, 2]),
    # and the corners around them
    ("7 / 2", None, 3.5), ("-3 % 2", None, None), ("1 == 1.0", None, True),
    ('"a" == "a" && !false', None, True), ("null == null", None, True),
    ('{ for k, v in { a = 1, b = 2 } : v => k... }', None, None),
    ("[for i, x in [5, 6] : i + x]", None, [5, 7]),
    ('"%{ if true }yes%{ else }no%{ endif }"', None, None),
    ('"%{ for x in [1, 2] }${x},%{ endfor }"', None, None),
    ("things[0].id", SPLAT_SCOPE, 1), ("things.*.id", SPLAT_SCOPE, None),
    ("missing.attr", None, None), ("[1, 2][5]", None, None),
    ("max([3, 9]...)", None, 9), ('"${"nested ${1}"}"', None, "nested 1"),
    ("1 +", None, None), ('"unterminated', None, None), ("{ a = }", None, None),
    ("<<EOT\nline one\n  two\nEOT\n", None, None),
    ("<<-EOT\n    indented\n      more\n    EOT\n", None, None),
]


@pytest.mark.parametrize("src,scope,want", EXPRESSIONS, ids=[e[0] for e in EXPRESSIONS])
def test_expression_equals_jax(src, scope, want):
    mine, ref = both(src, scope)
    assert mine == ref
    if want is not None:
        assert mine == ("ok", norm(want))


# -- the lexer and the parser ------------------------------------------------

SOURCES = {
    "resource": textwrap.dedent('''
        # a comment
        // another
        /* a block
           comment */
        resource "aws_s3_bucket" "b" {
          bucket = "data-${var.env}"
          tags   = { Name = "x", "Quoted key" = 2 }
          count  = var.on ? 1 : 0
          nested {
            list = [1, 2.5, -3, true, null]
          }
        }
    '''),
    "heredoc": 'x = <<EOT\nhello ${name}\n  world\nEOT\ny = <<-EOT\n    a\n      b\n    EOT\n',
    "dynamic": textwrap.dedent('''
        resource "aws_security_group" "sg" {
          dynamic "ingress" {
            for_each = [22, 80]
            iterator = port
            content {
              from_port = port.value
            }
          }
        }
    '''),
    "for": 'a = [for s in var.list : upper(s) if s != ""]\nb = { for k, v in m : k => v... }\n',
    "splat": 'ids = aws_instance.web[*].id\nfirst = aws_instance.web[0].tags["Name"]\n',
    "templates": 'x = "%{ if a }A%{ else }B%{ endif } $${literal} ${b}"\n',
    "calls": 'x = merge(local.a, { b = 1 }...)\ny = f(1, [2, 3], { c = "d" })\n',
    "oneline": 'locals { a = 1 }\nmodule "m" { source = "./mod" }\n',
    "bad-brace": 'resource "x" "y" {\n  a = 1\n',
    "bad-token": 'a = 1 ~ 2\n',
    "bad-string": 'a = "x\n',
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_lexer_tokens_equal_jax(name):
    assert outcome(lexer.lex, SOURCES[name]) == outcome(jax_lexer.lex, SOURCES[name])


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_parser_trees_equal_jax(name):
    mine = outcome(parser.parse, SOURCES[name])
    assert mine == outcome(jax_parser.parse, SOURCES[name])
    assert mine[0] == ("err" if name.startswith("bad") else "ok")


# -- every function of the standard library ------------------------------------

# name -> argument lists (HCL source); each call is held against JAX, errors
# included
FUNCTION_ARGS = {
    "abs": ["-3", "2.5", '"-4"', "true"],
    "ceil": ["1.2", "-1.2"],
    "floor": ["1.8", "-1.2"],
    "max": ["1, 5, 2", '"3", 1', "true"],
    "min": ["1, 5, 2", "-1.5, 0"],
    "pow": ["2, 10", "2, 0.5"],
    "signum": ["-3", "0", "7"],
    "parseint": ['"ff", 16', '"101", 2', '"zz", 10'],
    "format": ['"%s-%d", "a", 3', '"%05.2f", 3.14159', '"%q %v %%", "x", true', '"%t", false',
               '"%s"', '"%d", "x"'],
    "formatlist": ['"%s=%s", ["a", "b"], ["1", "2"]', '"%s!", "x"'],
    "join": ['"-", ["a", "b"]', '", ", []', '"-", "x"'],
    "split": ['",", "a,b,,c"', '",", ""'],
    "replace": ['"hello", "l", "L"', '"a1b2", "/[0-9]/", "#"'],
    "lower": ['"ABC"'],
    "upper": ['"abc"'],
    "title": ['"hello world-wide"'],
    "trim": ['"?!hello?!", "!?"'],
    "trimspace": ['"  x \\n"'],
    "trimprefix": ['"helloworld", "hello"', '"x", "y"'],
    "trimsuffix": ['"helloworld", "world"', '"x", ""'],
    "substr": ['"hello world", 1, 4', '"hello", -3, -1', '"abc", 5, 1', '"abc", 0, -1'],
    "strrev": ['"abc"'],
    "indent": ['2, "a\\nb"'],
    "startswith": ['"hello", "he"', '"hello", "lo"'],
    "endswith": ['"hello", "lo"'],
    "regex": ['"[a-z]+", "53abc"', '"(\\\\d+)-(\\\\d+)", "12-34"', '"(?P<a>x)", "x"',
              '"q", "abc"'],
    "regexall": ['"[a-z]+", "1a2bb"', '"(x)(y)", "xyxy"'],
    "length": ['"abc"', "[1, 2]", "{a = 1}", "3"],
    "concat": ["[1], [2, 3]", "[]"],
    "contains": ['["a"], "a"', '[1], "1"'],
    "distinct": ['[1, 2, 1, "1"]'],
    "element": ['["a", "b"], 3', "[], 0"],
    "flatten": ["[[1, [2]], 3]"],
    "index": ['["a", "b"], "b"', '["a"], "z"'],
    "keys": ["{b = 1, a = 2}", "[1]"],
    "values": ["{b = 1, a = 2}"],
    "lookup": ['{ a = 1 }, "a", 0', '{}, "a", 9', '{}, "a"'],
    "merge": ["{a = 1}, {b = 2, a = 3}", "{}"],
    "one": ["[]", "[1]", "[1, 2]", '"x"'],
    "range": ["3", "1, 4", "0, 10, 3", "5, 1, -2", "0, 1, 0"],
    "reverse": ["[1, 2, 3]"],
    "setproduct": ['["a", "b"], [1, 2]'],
    "setunion": ["[1, 2], [2, 3]"],
    "setintersection": ["[1, 2, 3], [2, 3, 4]"],
    "setsubtract": ["[1, 2, 3], [2]"],
    "slice": ["[1, 2, 3, 4], 1, 3", "[1], 0, 5"],
    "sort": ['["b", "a", "c"]', "[3, 1]"],
    "sum": ["[1, 2, 3.5]", '["x"]'],
    "zipmap": ['["a", "b"], [1, 2]'],
    "chunklist": ["[1, 2, 3, 4, 5], 2", "[1], 0"],
    "coalesce": ['null, "", "x"', "null, null"],
    "coalescelist": ["[], [1]", "[]"],
    "compact": ['["a", "", null, "b"]'],
    "tostring": ["1", "true", '"x"', "null", "1.5"],
    "tonumber": ['"42"', '"4.5"', '"x"', "7"],
    "tobool": ['"true"', "false", '"maybe"'],
    "tolist": ["[1]", "{a = 1}"],
    "toset": ["[2, 1, 2]"],
    "tomap": ["{a = 1}", "[1]"],
    "sensitive": ['"s"'],
    "nonsensitive": ['"s"'],
    "jsonencode": ["{a = [1, true, null]}", '"x"'],
    "jsondecode": ['"{\\"a\\": [1, 2]}"', '"x"'],
    "yamlencode": ["{a = [1, 2]}"],
    "yamldecode": ['"a: 1\\nb: [x, y]\\n"', '": ["'],
    "base64encode": ['"hello"'],
    "base64decode": ['"aGVsbG8="', '"!!"'],
    "urlencode": ['"a b&c/d"'],
    "textencodebase64": ['"hello", "utf-16le"'],
    "md5": ['"x"'],
    "sha1": ['"x"'],
    "sha256": ['"x"'],
    "sha512": ['"x"'],
    "base64sha256": ['"x"'],
    "uuidv5": ['"6ba7b810-9dad-11d1-80b4-00c04fd430c8", "www.example.com"'],
    "bcrypt": ['"pw"'],
    "uuid": [""],
    "timestamp": [""],
    "cidrhost": ['"10.12.112.0/20", 16', '"10.0.0.0/8", -1', '"x", 1'],
    "cidrsubnet": ['"172.16.0.0/12", 4, 2', '"10.0.0.0/24", 9, 0'],
    "cidrnetmask": ['"172.16.0.0/12"'],
    "cidrsubnets": ['"10.1.0.0/16", 4, 4, 8, 4'],
    "file": ['"x"'],
    "filebase64": ['"x"'],
    "fileexists": ['"x"'],
    "templatefile": ['"x", {}'],
    "pathexpand": ['"~/x"'],
    "abspath": ['"a/b"'],
    "basename": ['"a/b/c.txt"', '"c"'],
    "dirname": ['"a/b/c"', '"c"'],
}


def test_the_function_table_equals_jax():
    assert list(functions.FUNCTIONS) == list(jax_functions.FUNCTIONS)
    assert set(FUNCTION_ARGS) == set(functions.FUNCTIONS)


@pytest.mark.parametrize("name", sorted(FUNCTION_ARGS))
def test_function_equals_jax(name):
    for args in FUNCTION_ARGS[name]:
        mine, ref = both(f"{name}({args})")
        assert mine == ref, (name, args)
        # and called directly, past the evaluator's handling of errors
        vals = [Evaluator().eval_src(a) for a in _split_args(args)]
        jvals = [JaxEvaluator().eval_src(a) for a in _split_args(args)]
        assert (outcome(functions.FUNCTIONS[name], *vals)
                == outcome(jax_functions.FUNCTIONS[name], *jvals)), (name, args)


def _split_args(args: str) -> list[str]:
    """Top-level comma split of an argument list's source."""
    out, depth, cur, quoted = [], 0, "", False
    i = 0
    while i < len(args):
        c = args[i]
        if quoted:
            cur += c
            if c == "\\":
                cur += args[i + 1]
                i += 1
            elif c == '"':
                quoted = False
        elif c == '"':
            quoted = True
            cur += c
        elif c in "([{":
            depth += 1
            cur += c
        elif c in ")]}":
            depth -= 1
            cur += c
        elif c == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += c
        i += 1
    if cur.strip():
        out.append(cur.strip())
    return out


# -- generated expressions -----------------------------------------------------

_ATOMS = st.one_of(
    st.integers(-50, 50).map(str),
    st.sampled_from(["true", "false", "null", '"a"', '"b-1"', '""', "1.5", "0",
                     "var.n", "var.s", "var.l", "var.m", "local.missing"]),
)
SCOPE = {"var": {"n": 3, "s": "txt", "l": [1, 2, 3], "m": {"k": "v", "z": 0}}}


def _compound(children):
    bin_ops = st.sampled_from(["+", "-", "*", "/", "%", "==", "!=", "<", ">", "<=", ">=",
                               "&&", "||"])
    return st.one_of(
        st.tuples(children, bin_ops, children).map(lambda t: f"({t[0]} {t[1]} {t[2]})"),
        st.tuples(st.sampled_from(["-", "!"]), children).map(lambda t: f"{t[0]}({t[1]})"),
        st.tuples(children, children, children).map(lambda t: f"({t[0]} ? {t[1]} : {t[2]})"),
        st.tuples(children, children).map(lambda t: f'"x${{{t[0]}}}-${{{t[1]}}}"'),
        st.tuples(children, st.booleans()).map(
            lambda t: f"[for v in var.l : ({t[0]}) if v > 1]" if t[1]
            else f"{{ for k, v in var.m : k => ({t[0]}) }}"),
        st.lists(children, max_size=3).map(lambda xs: "[" + ", ".join(xs) + "]"),
        st.tuples(st.sampled_from(["length", "tostring", "upper", "abs", "max", "coalesce",
                                   "jsonencode", "contains"]), st.lists(children, min_size=1,
                                                                       max_size=2))
        .map(lambda t: f"{t[0]}({', '.join(t[1])})"),
    )


EXPR = st.recursive(_ATOMS, _compound, max_leaves=12)


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(EXPR)
def test_generated_expressions_equal_jax(src):
    mine, ref = both(src, SCOPE)
    assert mine == ref, src
