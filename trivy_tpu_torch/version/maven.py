"""Maven version comparison (ref: pkg/detector/library/compare/maven,
masahiro331/go-mvn-version — org.apache.maven ComparableVersion).

Tokens split on '.', '-', and digit/letter transitions; known qualifiers
order: alpha < beta < milestone < rc=cr < snapshot < '' (release) < sp <
other qualifiers (case-insensitive, alphabetical); the single-letter
aliases a/b/m mean alpha/beta/milestone only when immediately followed by
a digit ("1-a1" == "1-alpha-1" but "1-a" uses plain qualifier "a");
null-padding semantics per ComparableVersion ("1" == "1.0" == "1.0.0").
"""

from __future__ import annotations

import re

_QUALIFIERS = ["alpha", "beta", "milestone", "rc", "snapshot", "", "sp"]
_ALIASES = {"cr": "rc", "ga": "", "final": "", "release": ""}
_SPLIT = re.compile(r"([0-9]+|[a-zA-Z]+)")


def _tokenize(v: str):
    """-> list of ('int', n) / ('str', normalized_qualifier) tokens."""
    v = v.strip().lower()
    tokens = []
    i = 0
    while i < len(v):
        c = v[i]
        if c in ".-":
            i += 1
            continue
        m = _SPLIT.match(v, i)
        if not m:
            i += 1
            continue
        run = m.group(0)
        i = m.end()
        if run.isdigit():
            tokens.append(("int", int(run)))
        else:
            q = _ALIASES.get(run, run)
            # a/b/m alias only when the letter run is immediately followed
            # by a digit (no separator in between)
            if run in ("a", "b", "m") and i < len(v) and v[i].isdigit():
                q = {"a": "alpha", "b": "beta", "m": "milestone"}[run]
            tokens.append(("str", q))
    return tokens


def _qualifier_rank(q: str) -> tuple:
    if q in _QUALIFIERS:
        return (0, _QUALIFIERS.index(q), "")
    return (1, len(_QUALIFIERS), q)  # unknown qualifiers after 'sp', alphabetical


def _normalize(tokens):
    """Strip trailing null values (0 and release-equivalent qualifiers)."""
    out = list(tokens)
    while out:
        kind, val = out[-1]
        if (kind == "int" and val == 0) or (kind == "str" and val == ""):
            out.pop()
        else:
            break
    return out


def compare(a: str, b: str) -> int:
    ta = _normalize(_tokenize(a))
    tb = _normalize(_tokenize(b))
    for i in range(max(len(ta), len(tb))):
        xa = ta[i] if i < len(ta) else None
        xb = tb[i] if i < len(tb) else None
        if xa is None or xb is None:
            kind, val = xa if xb is None else xb
            if kind == "int":
                c = 1 if val > 0 else 0
            else:
                rank = _qualifier_rank(val)
                base = _qualifier_rank("")
                c = -1 if rank < base else (1 if rank > base else 0)
            if c:
                return c if xb is None else -c
            continue
        ka, va_ = xa
        kb, vb_ = xb
        if ka == "int" and kb == "int":
            if va_ != vb_:
                return -1 if va_ < vb_ else 1
        elif ka == "int":
            return 1  # numbers beat qualifiers
        elif kb == "int":
            return -1
        else:
            ra, rb = _qualifier_rank(va_), _qualifier_rank(vb_)
            if ra != rb:
                return -1 if ra < rb else 1
    return 0
