"""Semantic versioning compare + node-semver style ranges.

Backs the generic comparer and npm ranges (ref:
pkg/detector/library/compare/compare.go GenericComparer,
compare/npm — masahiro331/go-semver hashicorp-style constraints).
Tolerant parsing: missing minor/patch treated as 0, leading 'v' stripped,
extra numeric components preserved for compare.
"""

from __future__ import annotations

import re
from functools import lru_cache

_NUM = re.compile(r"^\d+$")


@lru_cache(maxsize=65536)
def parse(v: str):
    """-> (nums tuple, prerelease tuple, had_prerelease)."""
    v = v.strip().lstrip("vV")
    build = v.split("+", 1)[0]
    core, _, pre = build.partition("-")
    nums = []
    for part in core.split("."):
        if _NUM.match(part):
            nums.append(int(part))
        else:
            # tolerate junk like "1.0.0a" -> numeric prefix + move rest to pre
            m = re.match(r"^(\d+)(.*)$", part)
            if m:
                nums.append(int(m.group(1)))
                if m.group(2):
                    pre = m.group(2).lstrip(".-") + ("." + pre if pre else "")
            else:
                pre = part + ("." + pre if pre else "")
                break
    while len(nums) < 3:
        nums.append(0)
    pre_ids = tuple(pre.split(".")) if pre else ()
    return tuple(nums), pre_ids


def _cmp_pre(a: tuple, b: tuple) -> int:
    """SemVer rule: no prerelease > any prerelease; ids compare numerically
    when both numeric, else ASCII; shorter list < longer when equal prefix."""
    if not a and not b:
        return 0
    if not a:
        return 1
    if not b:
        return -1
    for xa, xb in zip(a, b):
        na, nb = _NUM.match(xa), _NUM.match(xb)
        if na and nb:
            ia, ib = int(xa), int(xb)
            if ia != ib:
                return -1 if ia < ib else 1
        elif na:
            return -1  # numeric < alphanumeric
        elif nb:
            return 1
        elif xa != xb:
            return -1 if xa < xb else 1
    if len(a) != len(b):
        return -1 if len(a) < len(b) else 1
    return 0


def compare(a: str, b: str) -> int:
    na, pa = parse(a)
    nb, pb = parse(b)
    # compare numeric components pairwise, padding with zeros
    ln = max(len(na), len(nb))
    xa = na + (0,) * (ln - len(na))
    xb = nb + (0,) * (ln - len(nb))
    if xa != xb:
        return -1 if xa < xb else 1
    return _cmp_pre(pa, pb)
