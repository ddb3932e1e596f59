"""Alpine apk version comparison.

Semantics per apk-tools' version.c (the reference depends on
knqyf263/go-apk-version): ``digits[.digits...][letter][_suffix[num]][-r#]``
where pre-suffixes (_alpha,_beta,_pre,_rc) sort before the bare version and
post-suffixes (_cvs,_svn,_git,_hg,_p) after.
"""

from __future__ import annotations

import re

_PRE = {"alpha": -4, "beta": -3, "pre": -2, "rc": -1}
_POST = {"cvs": 1, "svn": 2, "git": 3, "hg": 4, "p": 5}

_TOKEN = re.compile(
    r"^(?P<digits>\d+(?:\.\d+)*)"
    r"(?P<letter>[a-z])?"
    r"(?P<suffixes>(?:_(?:alpha|beta|pre|rc|cvs|svn|git|hg|p)\d*)*)"
    r"(?:-r(?P<rev>\d+))?$"
)


def parse(v: str):
    m = _TOKEN.match(v.strip())
    if not m:
        return None
    nums = [int(x) for x in m.group("digits").split(".")]
    letter = m.group("letter") or ""
    suffixes = []
    for s in re.findall(r"_([a-z]+)(\d*)", m.group("suffixes") or ""):
        name, num = s
        rank = _PRE.get(name) if name in _PRE else _POST.get(name)
        suffixes.append((rank, int(num) if num else 0))
    rev = int(m.group("rev")) if m.group("rev") else 0
    return nums, letter, suffixes, rev


def compare(a: str, b: str) -> int:
    pa, pb = parse(a), parse(b)
    if pa is None or pb is None:
        # invalid versions: fall back to string compare (stable, arbitrary)
        return -1 if a < b else (0 if a == b else 1)
    na, la, sa, ra = pa
    nb, lb, sb, rb = pb
    # numeric components: first component numeric, later components compare
    # numerically when both lack leading zeros; apk actually compares
    # component-wise numerically
    for xa, xb in zip(na, nb):
        if xa != xb:
            return -1 if xa < xb else 1
    if len(na) != len(nb):
        return -1 if len(na) < len(nb) else 1
    if la != lb:
        return -1 if la < lb else 1
    # suffix lists: compare pairwise; missing suffix = 0 (bare) which sorts
    # after pre-suffixes and before post-suffixes
    for i in range(max(len(sa), len(sb))):
        ta = sa[i] if i < len(sa) else (0, 0)
        tb = sb[i] if i < len(sb) else (0, 0)
        if ta != tb:
            return -1 if ta < tb else 1
    if ra != rb:
        return -1 if ra < rb else 1
    return 0
