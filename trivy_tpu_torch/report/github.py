"""GitHub dependency snapshot writer (ref: pkg/report/github/github.go), the
port's copy of ``trivy_tpu/report/github.py``.

Emits the dependency-submission API shape: one manifest per result with
resolved packages keyed by purl.
"""

from __future__ import annotations

import json

from trivy_tpu_torch import purl as purl_mod
from trivy_tpu_torch.types import OS, Report


def write_github(report: Report, out, **kw) -> None:
    os_d = report.metadata.get("OS")
    os_info = OS.from_dict(os_d) if os_d else None
    manifests = {}
    for result in report.results:
        if not result.packages:
            continue
        resolved = {}
        for pkg in result.packages:
            p = purl_mod.from_package(
                pkg, result.type or "", os_info if result.cls == "os-pkgs" else None
            )
            if p is None:
                continue
            resolved[pkg.name] = {
                "package_url": p.to_string(),
                "relationship": "direct" if pkg.relationship in ("direct", "root")
                else "indirect",
                "scope": "runtime",
                "dependencies": [],
            }
        if not resolved:
            continue
        manifests[result.target] = {
            "name": result.target,
            "file": {"source_location": result.target},
            "resolved": resolved,
        }
    doc = {
        "version": 0,
        "detector": {
            "name": "trivy-tpu",
            "version": "0.1.0",
            "url": "https://github.com/aquasecurity/trivy",
        },
        "scanned": report.created_at,
        "manifests": manifests,
    }
    json.dump(doc, out, indent=2)
    out.write("\n")
