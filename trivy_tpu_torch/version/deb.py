"""Debian package version comparison (dpkg algorithm).

Semantics per deb-version(7) / dpkg's verrevcmp (the reference depends on
knqyf263/go-deb-version): ``[epoch:]upstream[-revision]``; strings compare
by alternating non-digit/digit parts; in non-digit parts letters sort before
non-letters and ``~`` sorts before everything including end-of-string.
"""

from __future__ import annotations

import re
from functools import lru_cache

_VALID = re.compile(r"^(?:\d+:)?[0-9][A-Za-z0-9.+:~-]*$|^(?:\d+:)?[0-9]$|^[0-9]+$")


@lru_cache(maxsize=65536)
def parse(v: str) -> tuple[int, str, str]:
    """-> (epoch, upstream, revision)."""
    v = v.strip()
    epoch = 0
    if ":" in v:
        head, _, rest = v.partition(":")
        if head.isdigit():
            epoch = int(head)
            v = rest
    upstream, _, revision = v.rpartition("-")
    if not upstream:
        upstream, revision = revision, ""
    return epoch, upstream, revision


def _char_order(c: str) -> int:
    """verrevcmp character order: ~ < end(0) < digits(as part break) <
    letters < other symbols."""
    if c == "~":
        return -1
    if c.isalpha():
        return ord(c)
    return ord(c) + 256


def _verrevcmp(a: str, b: str) -> int:
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        # non-digit run
        while (ia < len(a) and not a[ia].isdigit()) or (
            ib < len(b) and not b[ib].isdigit()
        ):
            ca = _char_order(a[ia]) if ia < len(a) and not a[ia].isdigit() else 0
            cb = _char_order(b[ib]) if ib < len(b) and not b[ib].isdigit() else 0
            if ca != cb:
                return -1 if ca < cb else 1
            if ia < len(a) and not a[ia].isdigit():
                ia += 1
            if ib < len(b) and not b[ib].isdigit():
                ib += 1
        # digit run
        na = nb = 0
        while ia < len(a) and a[ia].isdigit():
            na = na * 10 + int(a[ia])
            ia += 1
        while ib < len(b) and b[ib].isdigit():
            nb = nb * 10 + int(b[ib])
            ib += 1
        if na != nb:
            return -1 if na < nb else 1
    return 0


def compare(a: str, b: str) -> int:
    ea, ua, ra = parse(a)
    eb, ub, rb = parse(b)
    if ea != eb:
        return -1 if ea < eb else 1
    c = _verrevcmp(ua, ub)
    if c:
        return c
    return _verrevcmp(ra, rb)
