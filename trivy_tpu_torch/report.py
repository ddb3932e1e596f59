"""Report writers for the secret, license and vulnerability scans (ref:
pkg/report/writer.go).

``json``: the reference's JSON schema (SchemaVersion, ArtifactName,
Results[].Target/Class/Vulnerabilities/Secrets/Licenses...), byte for byte
the JAX package's ``report/json_.py``. ``table``: the vulnerability, secret
and license sections of the JAX package's ``report/table.py`` — a grid of
each target's vulnerabilities; a header per file, then each secret finding
with its censored code context; a grid of the licenses found; with
``--show-suppressed``, a grid of the findings the filter suppressed.
"""

from __future__ import annotations

import json
from collections import Counter

from trivy_tpu_torch.types import Report, Result

SEV_ORDER = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]


def write_json(report: Report, out, **_kw) -> None:
    json.dump(report.to_dict(), out, indent=2, ensure_ascii=False)
    out.write("\n")


def _rule(width: int) -> str:
    return "─" * width


def _severity_summary(counter: Counter) -> str:
    parts = [f"{s}: {counter.get(s, 0)}" for s in SEV_ORDER if counter.get(s, 0)]
    return ", ".join(parts) if parts else "none"


def _header(out, title: str, extra: str = "") -> None:
    out.write(f"\n{title}{(' ' + extra) if extra else ''}\n")
    out.write(_rule(max(20, len(title) + len(extra) + 1)) + "\n")


def _write_vulnerabilities(result: Result, out) -> None:
    counter = Counter(v.severity for v in result.vulnerabilities)
    _header(
        out,
        f"{result.target} ({result.type})",
        f"— {len(result.vulnerabilities)} vulnerabilities ({_severity_summary(counter)})",
    )
    _grid(out, ["Library", "Vulnerability", "Severity", "Installed", "Fixed", "Title"],
          [[v.pkg_name, v.vulnerability_id, v.severity, v.installed_version,
            v.fixed_version or "—", (v.title or "")[:60]] for v in result.vulnerabilities])


def _write_secrets(result: Result, out) -> None:
    counter = Counter(s.severity for s in result.secrets)
    _header(
        out,
        result.target,
        f"— {len(result.secrets)} secrets ({_severity_summary(counter)})",
    )
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


def _write_licenses(result: Result, out) -> None:
    counter = Counter(lic.severity for lic in result.licenses)
    _header(
        out,
        f"{result.target} (license)",
        f"— {len(result.licenses)} findings ({_severity_summary(counter)})",
    )
    _grid(out, ["Package/File", "License", "Category", "Severity"],
          [[lic.pkg_name or lic.file_path, lic.name, lic.category, lic.severity]
           for lic in result.licenses])


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


def _write_suppressed(result: Result, out) -> None:
    """Suppressed-findings table (ref: pkg/report/table --show-suppressed)."""
    _header(out, f"{result.target} (suppressed)", f"— {len(result.modified_findings)} findings")
    _grid(out, ["ID", "Type", "Status", "Statement", "Source"],
          [[m.finding.get("VulnerabilityID") or m.finding.get("ID")
            or m.finding.get("RuleID") or m.finding.get("Name", ""),
            m.type, m.status, (m.statement or "")[:50], m.source]
           for m in result.modified_findings])


def write_table(report: Report, out, show_suppressed: bool = False) -> None:
    n_suppressed = sum(len(r.modified_findings) for r in report.results)
    if not any(r.vulnerabilities or r.secrets or r.licenses for r in report.results):
        out.write(f"\n{report.artifact_name} ({report.artifact_type})\n")
        out.write("No issues detected.\n")
        if n_suppressed and not show_suppressed:
            out.write(f"({n_suppressed} suppressed finding{'s' if n_suppressed != 1 else ''}; "
                      "--show-suppressed lists them)\n")
    for result in report.results:
        if result.vulnerabilities:
            _write_vulnerabilities(result, out)
        if result.secrets:
            _write_secrets(result, out)
        if result.licenses:
            _write_licenses(result, out)
        if show_suppressed and result.modified_findings:
            _write_suppressed(result, out)


WRITERS = {"json": write_json, "table": write_table}
