"""Terraform-style standard library for the HCL evaluator (independent
implementation of the documented function semantics; ref:
pkg/iac/scanners/terraform/parser/funcs/).

The port of ``trivy_tpu/misconf/hcl/functions.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import re


class UnknownType:
    """Unresolvable value; propagates through most operations."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "UNKNOWN"

    def __bool__(self):
        return False

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


UNKNOWN = UnknownType()


class EvalError(ValueError):
    pass


def is_unknown(v) -> bool:
    if v is UNKNOWN:
        return True
    if isinstance(v, list):
        return any(is_unknown(x) for x in v)
    if isinstance(v, dict):
        return any(is_unknown(x) for x in v.values())
    return False


def _num(v):
    if isinstance(v, bool):
        raise EvalError("expected number")
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                raise EvalError(f"cannot parse {v!r} as number") from None
    raise EvalError("expected number")


def to_string(v) -> str:
    if v is None:
        raise EvalError("cannot convert null to string")
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (int, float, str)):
        return str(v)
    raise EvalError(f"cannot convert {type(v).__name__} to string")


def _iterable(v):
    if isinstance(v, list):
        return v
    if isinstance(v, dict):
        return list(v.values())
    raise EvalError("expected a collection")


def _fmt(spec: str, args: list) -> str:
    """terraform format(): %s/%d/%f/%q/%v/%%, with width/precision passthrough."""
    out = []
    i, n, ai = 0, len(spec), 0

    def take():
        nonlocal ai
        if ai >= len(args):
            raise EvalError("format: not enough arguments")
        v = args[ai]
        ai += 1
        return v

    while i < n:
        c = spec[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        j = i + 1
        while j < n and spec[j] in "-+ 0123456789.":
            j += 1
        if j >= n:
            raise EvalError("format: trailing %")
        verb = spec[j]
        flags = spec[i + 1 : j]
        if verb == "%":
            out.append("%")
        elif verb in ("s", "v"):
            v = take()
            s = to_string(v) if not isinstance(v, (list, dict)) else json.dumps(v)
            out.append(f"%{flags}s" % s if flags else s)
        elif verb == "q":
            out.append(json.dumps(to_string(take())))
        elif verb == "d":
            out.append(f"%{flags}d" % int(_num(take())))
        elif verb in ("f", "g", "e"):
            out.append(f"%{flags}{verb}" % float(_num(take())))
        elif verb == "t":
            out.append("true" if take() else "false")
        else:
            raise EvalError(f"format: unsupported verb %{verb}")
        i = j + 1
    return "".join(out)


def _lookup(m, key, *default):
    if not isinstance(m, dict):
        raise EvalError("lookup: expected a map")
    if key in m:
        return m[key]
    if default:
        return default[0]
    raise EvalError(f"lookup: key {key!r} not found and no default given")


def _element(xs, i):
    xs = _iterable(xs)
    if not xs:
        raise EvalError("element: empty list")
    return xs[int(_num(i)) % len(xs)]


def _flatten(v, out=None):
    if out is None:
        out = []
    for x in v:
        if isinstance(x, list):
            _flatten(x, out)
        else:
            out.append(x)
    return out


def _merge(*maps):
    out: dict = {}
    for m in maps:
        if m is None or m is UNKNOWN:
            continue
        if not isinstance(m, dict):
            raise EvalError("merge: expected maps")
        out.update(m)
    return out


def _distinct(xs):
    out = []
    for x in _iterable(xs):
        if x not in out:
            out.append(x)
    return out


def _sort(xs):
    xs = _iterable(xs)
    return sorted(to_string(x) for x in xs)


def _coalesce(*args):
    for a in args:
        if a is not None and a != "" and a is not UNKNOWN:
            return a
    raise EvalError("coalesce: no non-null arguments")


def _coalescelist(*args):
    for a in args:
        if isinstance(a, list) and a:
            return a
    raise EvalError("coalescelist: no non-empty list")


def _compact(xs):
    return [x for x in _iterable(xs) if isinstance(x, str) and x != ""]


def _range(*args):
    a = [int(_num(x)) for x in args]
    if len(a) == 1:
        return list(range(a[0]))
    if len(a) == 2:
        return list(range(a[0], a[1]))
    return list(range(a[0], a[1], a[2]))


def _slice(xs, s, e):
    xs = _iterable(xs)
    s, e = int(_num(s)), int(_num(e))
    if s < 0 or e > len(xs) or s > e:
        raise EvalError("slice: index out of range")
    return xs[s:e]


def _substr(s, offset, length):
    s = to_string(s)
    offset, length = int(_num(offset)), int(_num(length))
    if offset < 0:
        offset += len(s)
    if length < 0:
        return s[offset:]
    return s[offset : offset + length]


def _zipmap(keys, vals):
    return dict(zip([to_string(k) for k in _iterable(keys)], _iterable(vals)))


def _tobool(v):
    if isinstance(v, bool):
        return v
    if v == "true":
        return True
    if v == "false":
        return False
    if v is None:
        return None
    raise EvalError("tobool: cannot convert")


def _tonumber(v):
    if v is None:
        return None
    return _num(v)


def _tomap(v):
    if isinstance(v, dict):
        return v
    raise EvalError("tomap: expected a map")


def _tolist(v):
    if isinstance(v, list):
        return v
    if isinstance(v, (set, tuple)):
        return list(v)
    raise EvalError("tolist: expected a sequence")


def _toset(v):
    return _distinct(v)


def _split(sep, s):
    s = to_string(s)
    if s == "":
        return []
    return s.split(to_string(sep))


def _regex(pattern, s):
    m = re.search(pattern, to_string(s))
    if not m:
        raise EvalError("regex: no match")
    if m.groupdict():
        return {k: v for k, v in m.groupdict().items()}
    if m.groups():
        return list(m.groups())
    return m.group(0)


def _regexall(pattern, s):
    out = []
    for m in re.finditer(pattern, to_string(s)):
        if m.groups():
            out.append(list(m.groups()))
        else:
            out.append(m.group(0))
    return out


def _replace(s, sub, repl):
    s = to_string(s)
    if len(sub) > 1 and sub.startswith("/") and sub.endswith("/"):
        return re.sub(sub[1:-1], repl, s)
    return s.replace(sub, repl)


def _indent(n, s):
    pad = " " * int(_num(n))
    lines = to_string(s).split("\n")
    return lines[0] + "".join("\n" + (pad + l if l else l) for l in lines[1:])


def _index_fn(xs, v):
    xs = _iterable(xs)
    for i, x in enumerate(xs):
        if x == v:
            return i
    raise EvalError("index: value not found")


def _yamldecode(s):
    import yaml

    return yaml.safe_load(to_string(s))


def _yamlencode(v):
    import yaml

    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False)


def _cidr_parts(cidr: str):
    ip, _, bits = to_string(cidr).partition("/")
    octets = [int(o) for o in ip.split(".")]
    if len(octets) != 4:
        raise EvalError("cidr functions support IPv4 only")
    return sum(o << (8 * (3 - i)) for i, o in enumerate(octets)), int(bits)


def _ip_str(v: int) -> str:
    return ".".join(str((v >> (8 * (3 - i))) & 0xFF) for i in range(4))


def _cidrhost(cidr, hostnum):
    base, bits = _cidr_parts(cidr)
    return _ip_str((base & ~((1 << (32 - bits)) - 1)) + int(_num(hostnum)))


def _cidrsubnet(cidr, newbits, netnum):
    base, bits = _cidr_parts(cidr)
    nb = bits + int(_num(newbits))
    if nb > 32:
        raise EvalError("cidrsubnet: too many bits")
    net = (base & ~((1 << (32 - bits)) - 1)) + (int(_num(netnum)) << (32 - nb))
    return f"{_ip_str(net)}/{nb}"


def _cidrnetmask(cidr):
    _, bits = _cidr_parts(cidr)
    return _ip_str(~((1 << (32 - bits)) - 1) & 0xFFFFFFFF)


def _setproduct(*sets):
    import itertools

    pools = [_iterable(s) for s in sets]
    return [list(t) for t in itertools.product(*pools)]


def _chunklist(xs, size):
    xs = _iterable(xs)
    size = int(_num(size))
    if size <= 0:
        raise EvalError("chunklist: size must be positive")
    return [xs[i : i + size] for i in range(0, len(xs), size)]


FUNCTIONS = {
    # numeric
    "abs": lambda x: abs(_num(x)),
    "ceil": lambda x: math.ceil(_num(x)),
    "floor": lambda x: math.floor(_num(x)),
    "max": lambda *xs: max(_num(x) for x in xs),
    "min": lambda *xs: min(_num(x) for x in xs),
    "pow": lambda a, b: _num(a) ** _num(b),
    "signum": lambda x: (0 if _num(x) == 0 else (1 if _num(x) > 0 else -1)),
    "parseint": lambda s, base: int(to_string(s), int(_num(base))),
    # string
    "format": lambda spec, *a: _fmt(to_string(spec), list(a)),
    "formatlist": lambda spec, *a: [
        _fmt(to_string(spec), [x[i] if isinstance(x, list) else x for x in a])
        for i in range(max((len(x) for x in a if isinstance(x, list)), default=0))
    ] if any(isinstance(x, list) for x in a) else [_fmt(to_string(spec), list(a))],
    "join": lambda sep, xs: to_string(sep).join(to_string(x) for x in _iterable(xs)),
    "split": _split,
    "replace": _replace,
    "lower": lambda s: to_string(s).lower(),
    "upper": lambda s: to_string(s).upper(),
    "title": lambda s: re.sub(r"\b\w", lambda m: m.group(0).upper(), to_string(s)),
    "trim": lambda s, cut: to_string(s).strip(to_string(cut)),
    "trimspace": lambda s: to_string(s).strip(),
    "trimprefix": lambda s, p: to_string(s)[len(p):] if to_string(s).startswith(p) else to_string(s),
    "trimsuffix": lambda s, p: to_string(s)[: -len(p)] if p and to_string(s).endswith(p) else to_string(s),
    "substr": _substr,
    "strrev": lambda s: to_string(s)[::-1],
    "indent": _indent,
    "startswith": lambda s, p: to_string(s).startswith(to_string(p)),
    "endswith": lambda s, p: to_string(s).endswith(to_string(p)),
    "regex": _regex,
    "regexall": _regexall,
    # collection
    "length": lambda v: len(v) if isinstance(v, (str, list, dict)) else (_ for _ in ()).throw(EvalError("length: bad type")),
    "concat": lambda *xs: [y for x in xs for y in _iterable(x)],
    "contains": lambda xs, v: v in _iterable(xs),
    "distinct": _distinct,
    "element": _element,
    "flatten": lambda xs: _flatten(_iterable(xs)),
    "index": _index_fn,
    "keys": lambda m: sorted(m.keys()) if isinstance(m, dict) else (_ for _ in ()).throw(EvalError("keys: expected map")),
    "values": lambda m: [m[k] for k in sorted(m.keys())] if isinstance(m, dict) else (_ for _ in ()).throw(EvalError("values: expected map")),
    "lookup": _lookup,
    "merge": _merge,
    "one": lambda xs: (xs[0] if len(xs) == 1 else None if not xs else (_ for _ in ()).throw(EvalError("one: more than one element"))) if isinstance(xs, list) else xs,
    "range": _range,
    "reverse": lambda xs: list(reversed(_iterable(xs))),
    "setproduct": _setproduct,
    "setunion": lambda *xs: _distinct([y for x in xs for y in _iterable(x)]),
    "setintersection": lambda first, *rest: [x for x in _distinct(first) if all(x in _iterable(r) for r in rest)],
    "setsubtract": lambda a, b: [x for x in _distinct(a) if x not in _iterable(b)],
    "slice": _slice,
    "sort": _sort,
    "sum": lambda xs: sum(_num(x) for x in _iterable(xs)),
    "zipmap": _zipmap,
    "chunklist": _chunklist,
    "coalesce": _coalesce,
    "coalescelist": _coalescelist,
    "compact": _compact,
    # type conversion
    "tostring": to_string,
    "tonumber": _tonumber,
    "tobool": _tobool,
    "tolist": _tolist,
    "toset": _toset,
    "tomap": _tomap,
    "sensitive": lambda v: v,
    "nonsensitive": lambda v: v,
    # encoding
    "jsonencode": lambda v: json.dumps(v, separators=(",", ":")),
    "jsondecode": lambda s: json.loads(to_string(s)),
    "yamlencode": _yamlencode,
    "yamldecode": _yamldecode,
    "base64encode": lambda s: base64.b64encode(to_string(s).encode()).decode(),
    "base64decode": lambda s: base64.b64decode(to_string(s)).decode("utf-8", "replace"),
    "urlencode": lambda s: __import__("urllib.parse", fromlist=["quote_plus"]).quote_plus(to_string(s)),
    "textencodebase64": lambda s, enc: base64.b64encode(to_string(s).encode(enc)).decode(),
    # hash / crypto
    "md5": lambda s: hashlib.md5(to_string(s).encode()).hexdigest(),
    "sha1": lambda s: hashlib.sha1(to_string(s).encode()).hexdigest(),
    "sha256": lambda s: hashlib.sha256(to_string(s).encode()).hexdigest(),
    "sha512": lambda s: hashlib.sha512(to_string(s).encode()).hexdigest(),
    "base64sha256": lambda s: base64.b64encode(hashlib.sha256(to_string(s).encode()).digest()).decode(),
    "uuidv5": lambda ns, name: __import__("uuid").uuid5(__import__("uuid").UUID(ns), to_string(name)).__str__(),
    "bcrypt": lambda s, *cost: UNKNOWN,  # nondeterministic; never load-bearing in checks
    "uuid": lambda: UNKNOWN,  # nondeterministic
    "timestamp": lambda: UNKNOWN,  # nondeterministic
    # network
    "cidrhost": _cidrhost,
    "cidrsubnet": _cidrsubnet,
    "cidrnetmask": _cidrnetmask,
    "cidrsubnets": lambda cidr, *newbits: [  # sequential allocation
        _cidrsubnet(cidr, nb, i) for i, nb in enumerate(int(_num(x)) for x in newbits)
    ],
    # filesystem & env: not evaluable in a scanner sandbox
    "file": lambda *a: UNKNOWN,
    "filebase64": lambda *a: UNKNOWN,
    "fileexists": lambda *a: False,
    "templatefile": lambda *a: UNKNOWN,
    "pathexpand": lambda p: to_string(p),
    "abspath": lambda p: to_string(p),
    "basename": lambda p: to_string(p).rsplit("/", 1)[-1],
    "dirname": lambda p: to_string(p).rsplit("/", 1)[0] if "/" in to_string(p) else ".",
}
