"""JSON report writer (ref: pkg/report/writer.go JSON branch).

Field names and nesting match the reference's JSON schema (SchemaVersion,
ArtifactName, Results[].Target/Class/Secrets/Vulnerabilities/...), byte for
byte the JAX package's ``report/json_.py``.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.types import Report


def write_json(report: Report, out, **_kw) -> None:
    json.dump(report.to_dict(), out, indent=2, ensure_ascii=False)
    out.write("\n")
