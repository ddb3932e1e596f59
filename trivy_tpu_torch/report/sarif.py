"""SARIF 2.1.0 writer (ref: pkg/report/sarif.go), the port's copy of
``trivy_tpu/report/sarif.py``.

One run with one rule per distinct finding ID (vulnerability, secret rule,
misconfiguration check); results reference rules by index and carry
physical locations with line regions, matching the reference's shape so
SARIF consumers (e.g. code-scanning UIs) ingest both identically.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.types import Report

SARIF_VERSION = "2.1.0"
SCHEMA = "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json"

# severity -> SARIF level (ref: sarif.go toSarifErrorLevel)
_LEVELS = {
    "CRITICAL": "error",
    "HIGH": "error",
    "MEDIUM": "warning",
    "LOW": "note",
    "UNKNOWN": "note",
}
# severity -> security-severity property (ref: sarif.go toSarifRuleName scores)
_SCORES = {
    "CRITICAL": "9.5",
    "HIGH": "8.0",
    "MEDIUM": "5.5",
    "LOW": "2.0",
    "UNKNOWN": "0.0",
}


def _region(start: int, end: int) -> dict:
    start = max(1, start or 1)
    return {
        "startLine": start,
        "startColumn": 1,
        "endLine": max(start, end or start),
        "endColumn": 1,
    }


def write_sarif(report: Report, out, **kw) -> None:
    rules: list[dict] = []
    rule_index: dict[str, int] = {}
    results: list[dict] = []

    def rule_for(rid: str, name: str, severity: str, help_text: str,
                 help_uri: str = "") -> int:
        if rid in rule_index:
            return rule_index[rid]
        rule = {
            "id": rid,
            "name": name,
            "shortDescription": {"text": rid},
            "fullDescription": {"text": help_text or rid},
            "defaultConfiguration": {
                "level": _LEVELS.get(severity, "note"),
            },
            "properties": {
                "tags": ["security", severity],
                "precision": "very-high",
                "security-severity": _SCORES.get(severity, "0.0"),
            },
        }
        if help_uri:
            rule["helpUri"] = help_uri
        rule_index[rid] = len(rules)
        rules.append(rule)
        return rule_index[rid]

    def add_result(rid: str, idx: int, message: str, uri: str,
                   start: int = 1, end: int = 1) -> None:
        results.append(
            {
                "ruleId": rid,
                "ruleIndex": idx,
                "level": rules[idx]["defaultConfiguration"]["level"],
                "message": {"text": message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": uri,
                                "uriBaseId": "ROOTPATH",
                            },
                            "region": _region(start, end),
                        }
                    }
                ],
            }
        )

    for result in report.results:
        uri = result.target.lstrip("/") or result.target
        for v in result.vulnerabilities:
            idx = rule_for(
                v.vulnerability_id,
                f"{v.pkg_name}: {v.title}" if v.title else v.vulnerability_id,
                v.severity,
                v.description,
                v.primary_url,
            )
            msg = (
                f"Package: {v.pkg_name}\nInstalled Version: {v.installed_version}\n"
                f"Vulnerability {v.vulnerability_id}\nSeverity: {v.severity}\n"
                f"Fixed Version: {v.fixed_version or ''}"
            )
            add_result(v.vulnerability_id, idx, msg, uri)
        for s in result.secrets:
            idx = rule_for(s.rule_id, s.title, s.severity, s.title)
            add_result(
                s.rule_id, idx,
                f"Artifact: {result.target}\nType: secret\nSecret {s.title}\n"
                f"Severity: {s.severity}\nMatch: {s.match}",
                uri, s.start_line, s.end_line,
            )
        for m in result.misconfigurations:
            if m.status != "FAIL":
                continue
            idx = rule_for(m.id, m.title, m.severity, m.description, m.primary_url)
            add_result(
                m.id, idx,
                f"Artifact: {result.target}\nType: {result.type}\n"
                f"Vulnerability {m.id}\nSeverity: {m.severity}\n"
                f"Message: {m.message}",
                uri, m.start_line, m.end_line,
            )

    doc = {
        "$schema": SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "trivy-tpu",
                        "informationUri": "https://github.com/aquasecurity/trivy",
                        "fullName": "trivy-tpu security scanner",
                        "rules": rules,
                    }
                },
                "results": results,
                "columnKind": "utf16CodeUnits",
                "originalUriBaseIds": {
                    "ROOTPATH": {"uri": "file:///"},
                },
            }
        ],
    }
    json.dump(doc, out, indent=2)
    out.write("\n")
