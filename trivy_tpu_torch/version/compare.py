"""Scheme dispatch and constraint evaluation.

Advisory version ranges follow trivy-db conventions (ref:
pkg/detector/library/driver.go:115-142 + compare/): an expression is an
OR (``||``) of AND-groups (comma-separated) of ``<op><version>`` terms;
bare versions mean equality; ``^``/``~``/``~>`` expand per npm/gem rules.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from trivy_tpu_torch.version import apk, deb, maven, pep440, rpm, rubygems, semver

_COMPARERS = {
    "deb": deb.compare,
    "rpm": rpm.compare,
    "apk": apk.compare,
    "semver": semver.compare,
    "npm": semver.compare,
    "pep440": pep440.compare,
    "maven": maven.compare,
    "gem": rubygems.compare,
    "rubygems": rubygems.compare,
}


def compare(scheme: str, a: str, b: str) -> int:
    return _COMPARERS.get(scheme, semver.compare)(a, b)


@dataclass(frozen=True)
class Constraint:
    op: str  # one of < <= > >= = !=
    version: str

    def check(self, scheme: str, version: str) -> bool:
        c = compare(scheme, version, self.version)
        return {
            "<": c < 0,
            "<=": c <= 0,
            ">": c > 0,
            ">=": c >= 0,
            "=": c == 0,
            "!=": c != 0,
        }[self.op]


_TERM = re.compile(r"^\s*(>=|<=|==|!=|>|<|=|\^|~>|~)?\s*v?([^\s,]+)\s*$")


def _expand_term(op: str, ver: str) -> list[Constraint]:
    """^/~/~> expand to >=/< pairs (npm caret/tilde, gem pessimistic)."""
    if op in ("", None, "=", "=="):
        return [Constraint("=", ver)]
    if op in (">", ">=", "<", "<=", "!="):
        return [Constraint(op, ver)]
    nums, _pre = semver.parse(ver)
    if op == "^":
        # bump the leftmost nonzero component
        upper = list(nums[:3])
        for i, n in enumerate(upper):
            if n != 0 or i == 2:
                upper[i] += 1
                upper[i + 1 :] = [0] * (len(upper) - i - 1)
                break
        return [Constraint(">=", ver), Constraint("<", ".".join(map(str, upper)))]
    if op in ("~", "~>"):
        parts = ver.split("-")[0].split(".")
        if op == "~>" and len(parts) >= 2:
            upper = parts[:-1]
            upper[-1] = str(int(re.sub(r"\D.*$", "", upper[-1]) or 0) + 1)
        elif len(parts) >= 2:
            upper = parts[:2]
            upper[-1] = str(int(re.sub(r"\D.*$", "", upper[-1]) or 0) + 1)
        else:
            upper = [str(int(re.sub(r"\D.*$", "", parts[0]) or 0) + 1)]
        return [Constraint(">=", ver), Constraint("<", ".".join(upper))]
    return [Constraint("=", ver)]


def parse_constraints(expr: str) -> list[list[Constraint]]:
    """expr -> OR-list of AND-groups. Empty/'*' matches anything."""
    groups = []
    for or_part in expr.split("||"):
        terms: list[Constraint] = []
        ok = True
        for raw in or_part.split(","):
            raw = raw.strip()
            if not raw or raw in ("*", "ANY"):
                continue
            m = _TERM.match(raw)
            if not m:
                ok = False
                break
            terms.extend(_expand_term(m.group(1) or "", m.group(2)))
        if ok:
            groups.append(terms)
    return groups


def satisfies(scheme: str, version: str, expr: str) -> bool:
    """Does ``version`` fall inside ``expr``? Unparseable groups are
    skipped (advisory-side data errors must not crash a scan)."""
    groups = parse_constraints(expr)
    if not groups:
        return False
    for group in groups:
        if all(c.check(scheme, version) for c in group):
            return True
    return False
