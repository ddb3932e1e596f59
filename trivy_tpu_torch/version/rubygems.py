"""RubyGems version comparison (Gem::Version semantics, ref:
pkg/detector/library/compare/rubygems).

Segments split on '.' with letter/digit transitions; numeric segments
compare numerically, string segments (prerelease markers) sort before
numeric ones and make the version a prerelease of its release.
"""

from __future__ import annotations

import re

_SEG = re.compile(r"[0-9]+|[a-z]+", re.IGNORECASE)


def _segments(v: str):
    v = v.strip()
    segs = []
    for s in _SEG.findall(v.replace("-", ".pre.")):
        segs.append(int(s) if s.isdigit() else s.lower())
    return segs


def compare(a: str, b: str) -> int:
    sa, sb = _segments(a), _segments(b)
    # trim trailing zeros
    while sa and sa[-1] == 0:
        sa.pop()
    while sb and sb[-1] == 0:
        sb.pop()
    for i in range(max(len(sa), len(sb))):
        xa = sa[i] if i < len(sa) else 0
        xb = sb[i] if i < len(sb) else 0
        a_str, b_str = isinstance(xa, str), isinstance(xb, str)
        if a_str and b_str:
            if xa != xb:
                return -1 if xa < xb else 1
        elif a_str != b_str:
            return -1 if a_str else 1  # strings sort before numbers
        else:
            if xa != xb:
                return -1 if xa < xb else 1
    return 0
