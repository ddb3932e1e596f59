"""Table report writer (ref: pkg/report/table), byte for byte the JAX
package's ``report/table.py``: per target a grid of its vulnerabilities,
each secret finding with its censored code context, the failed checks of a
configuration file, a grid of the licenses found, and
the packages of a result that has no finding; with ``dependency_tree`` the
reversed dependency-origin tree of each vulnerable package; with
``show_suppressed`` a grid of the findings the filter suppressed.
"""

from __future__ import annotations

from collections import Counter

from trivy_tpu_torch.types import Report, Result

SEV_ORDER = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]


def _rule(width: int) -> str:
    return "─" * width


def _severity_summary(counter: Counter) -> str:
    parts = [f"{s}: {counter.get(s, 0)}" for s in SEV_ORDER if counter.get(s, 0)]
    return ", ".join(parts) if parts else "none"


def write_table(report: Report, out, show_suppressed: bool = False,
                dependency_tree: bool = False, **_kw) -> None:
    visible = any(not r.is_empty for r in report.results)
    n_suppressed = sum(len(r.modified_findings) for r in report.results)
    if not visible:
        out.write(f"\n{report.artifact_name} ({report.artifact_type})\n")
        out.write("No issues detected.\n")
        if n_suppressed and not show_suppressed:
            out.write(f"({n_suppressed} suppressed finding{'s' if n_suppressed != 1 else ''}; "
                      "--show-suppressed lists them)\n")
    for result in report.results:
        _write_result(result, out)
        if dependency_tree and result.vulnerabilities and result.packages:
            _write_dependency_tree(result, out)
        if show_suppressed and result.modified_findings:
            _write_suppressed(result, out)


def _write_dependency_tree(result: Result, out) -> None:
    """Reversed dependency-origin tree for vulnerable packages (ref: the
    table writer's --dependency-tree rendering over
    pkg/dependency/relationship.go graphs): each vulnerable package is a
    root; its children are the packages that depend on it, walking up to
    the direct dependencies a user can actually bump."""
    by_id = {p.id or f"{p.name}@{p.version}": p for p in result.packages}
    reverse: dict[str, list[str]] = {}
    for p in result.packages:
        pid = p.id or f"{p.name}@{p.version}"
        for dep in p.depends_on:
            reverse.setdefault(dep, []).append(pid)
    if not reverse:
        return
    vuln_counts: dict[str, Counter] = {}
    for v in result.vulnerabilities:
        pid = v.pkg_id or f"{v.pkg_name}@{v.installed_version}"
        vuln_counts.setdefault(pid, Counter())[v.severity] += 1
    out.write("\nDependency Origin Tree (Reversed)\n")
    out.write(_rule(40) + "\n")
    out.write(f"{result.target}\n")
    roots = sorted(vuln_counts)
    for ri, pid in enumerate(roots):
        last_root = ri == len(roots) - 1
        summary = ", ".join(f"{s}: {c}" for s, c in sorted(vuln_counts[pid].items()))
        out.write(f"{'└── ' if last_root else '├── '}{pid}, ({summary})\n")
        prefix = "    " if last_root else "│   "
        # BFS up the reverse edges (cycle-guarded) to show who pulls it in
        seen = {pid}
        level = [pid]
        depth = 0
        while level and depth < 8:
            parents = sorted({par for node in level for par in reverse.get(node, [])
                              if par not in seen})
            if not parents:
                break
            seen.update(parents)
            for pi, par in enumerate(parents):
                last = pi == len(parents) - 1
                pk = by_id.get(par)
                rel = (f" ({pk.relationship})"
                       if pk is not None and pk.relationship in ("direct", "root", "workspace")
                       else "")
                out.write(prefix + "    " * depth + ("└── " if last else "├── ") + par + rel
                          + "\n")
            level = parents
            depth += 1


def _write_suppressed(result: Result, out) -> None:
    """Suppressed-findings table (ref: pkg/report/table --show-suppressed)."""
    _header(out, f"{result.target} (suppressed)", f"— {len(result.modified_findings)} findings")
    _grid(out, ["ID", "Type", "Status", "Statement", "Source"],
          [[m.finding.get("VulnerabilityID") or m.finding.get("ID")
            or m.finding.get("RuleID") or m.finding.get("Name", ""),
            m.type, m.status, (m.statement or "")[:50], m.source]
           for m in result.modified_findings])


def _header(out, title: str, extra: str = "") -> None:
    out.write(f"\n{title}{(' ' + extra) if extra else ''}\n")
    out.write(_rule(max(20, len(title) + len(extra) + 1)) + "\n")


def _write_result(result: Result, out) -> None:
    if result.vulnerabilities:
        counter = Counter(v.severity for v in result.vulnerabilities)
        _header(
            out,
            f"{result.target} ({result.type})",
            f"— {len(result.vulnerabilities)} vulnerabilities ({_severity_summary(counter)})",
        )
        _grid(out, ["Library", "Vulnerability", "Severity", "Installed", "Fixed", "Title"],
              [[v.pkg_name, v.vulnerability_id, v.severity, v.installed_version,
                v.fixed_version or "—", (v.title or "")[:60]] for v in result.vulnerabilities])
    if result.secrets:
        counter = Counter(s.severity for s in result.secrets)
        _header(out, result.target,
                f"— {len(result.secrets)} secrets ({_severity_summary(counter)})")
        for s in result.secrets:
            out.write(f"\n{s.severity}: {s.title} ({s.rule_id})\n")
            loc = (
                f"line {s.start_line}"
                if s.start_line == s.end_line
                else f"lines {s.start_line}-{s.end_line}"
            )
            out.write(f"{_rule(40)}\n{result.target}:{loc}\n")
            for line in s.code.lines:
                marker = ">" if line.is_cause else " "
                out.write(f"{line.number:>4} {marker} {line.content}\n")
            out.write(_rule(40) + "\n")
    if result.misconfigurations:
        fails = [m for m in result.misconfigurations if m.status == "FAIL"]
        counter = Counter(m.severity for m in fails)
        _header(out, f"{result.target} ({result.type})",
                f"— {len(fails)} failures ({_severity_summary(counter)})")
        for m in fails:
            out.write(f"\n{m.severity}: {m.id} — {m.title}\n")
            if m.message:
                out.write(f"  {m.message}\n")
            if m.start_line:
                out.write(f"  at {result.target}:{m.start_line}\n")
    if result.licenses:
        counter = Counter(lic.severity for lic in result.licenses)
        _header(
            out,
            f"{result.target} (license)",
            f"— {len(result.licenses)} findings ({_severity_summary(counter)})",
        )
        _grid(out, ["Package/File", "License", "Category", "Severity"],
              [[lic.pkg_name or lic.file_path, lic.name, lic.category, lic.severity]
               for lic in result.licenses])
    if result.packages and not (result.vulnerabilities or result.secrets or result.licenses):
        _header(out, f"{result.target} ({result.type})", f"— {len(result.packages)} packages")
        _grid(out, ["Package", "Version"], [[p.name, p.version] for p in result.packages])


def _grid(out, cols: list[str], rows: list[list[str]]) -> None:
    widths = [len(c) for c in cols]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))

    def fmt(cells):
        return "│".join(f" {str(c):<{widths[i]}} " for i, c in enumerate(cells))

    out.write(fmt(cols) + "\n")
    out.write("┼".join(_rule(w + 2) for w in widths) + "\n")
    for row in rows:
        out.write(fmt(row) + "\n")
