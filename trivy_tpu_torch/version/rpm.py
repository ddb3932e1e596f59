"""RPM version comparison (rpmvercmp algorithm).

Semantics per rpm's rpmvercmp (the reference depends on knqyf263/go-rpm-version):
``[epoch:]version-release``; segments of digits or letters compared in
order; digits beat letters; ``~`` sorts before everything; ``^`` sorts
after the base version but before a longer normal suffix.
"""

from __future__ import annotations

import re
from functools import lru_cache

_SEG = re.compile(r"([0-9]+|[a-zA-Z]+|~|\^)")


@lru_cache(maxsize=65536)
def parse(v: str) -> tuple[int, str, str]:
    v = v.strip()
    epoch = 0
    if ":" in v:
        head, _, rest = v.partition(":")
        if head.isdigit():
            epoch = int(head)
            v = rest
    version, _, release = v.partition("-")
    return epoch, version, release


def _rpmvercmp(a: str, b: str) -> int:
    if a == b:
        return 0
    sa = _SEG.findall(a)
    sb = _SEG.findall(b)
    ia = ib = 0
    while ia < len(sa) or ib < len(sb):
        ca = sa[ia] if ia < len(sa) else None
        cb = sb[ib] if ib < len(sb) else None
        # tilde: sorts before everything, including end of string
        if ca == "~" or cb == "~":
            if ca != "~":
                return 1
            if cb != "~":
                return -1
            ia += 1
            ib += 1
            continue
        # caret: newer than base, older than any further normal segment
        if ca == "^" or cb == "^":
            if ca is None:
                return -1  # b has ^ where a ended: a < b
            if cb is None:
                return 1
            if ca != "^":
                return 1  # a has a normal segment vs b's ^: a > b
            if cb != "^":
                return -1
            ia += 1
            ib += 1
            continue
        if ca is None:
            return -1
        if cb is None:
            return 1
        a_num = ca[0].isdigit()
        b_num = cb[0].isdigit()
        if a_num and b_num:
            na, nb = int(ca), int(cb)
            if na != nb:
                return -1 if na < nb else 1
        elif a_num != b_num:
            return 1 if a_num else -1  # numeric segments beat alpha
        else:
            if ca != cb:
                return -1 if ca < cb else 1
        ia += 1
        ib += 1
    return 0


def compare(a: str, b: str) -> int:
    ea, va, ra = parse(a)
    eb, vb, rb = parse(b)
    if ea != eb:
        return -1 if ea < eb else 1
    c = _rpmvercmp(va, vb)
    if c:
        return c
    # releases always compare through rpmvercmp: "" vs "1" -> -1 via the
    # missing-segment rule, and "" vs "~x" -> +1 (tilde sorts before end)
    return _rpmvercmp(ra, rb)
