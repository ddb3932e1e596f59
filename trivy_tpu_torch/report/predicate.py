"""Cosign vulnerability-attestation predicate writer
(ref: pkg/report/predicate/vuln.go CosignVulnPredicate — the Cosign
Vulnerability Scan Record shape: invocation, scanner{uri,version,db,
result}, metadata{scanStartedOn,scanFinishedOn}), the port's copy of
``trivy_tpu/report/predicate.py`` with the port's own ``VERSION``.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone

from trivy_tpu_torch import VERSION
from trivy_tpu_torch.types import Report


def write_cosign_vuln(report: Report, out, **_kw) -> None:
    now = datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")
    version = VERSION
    predicate = {
        "invocation": {
            "parameters": None,
            "uri": "",
            "event_id": "",
            "builder.id": "",
        },
        "scanner": {
            "uri": f"pkg:github/trivy-tpu/trivy-tpu@{version}",
            "version": version,
            "db": {"uri": "", "version": ""},
            "result": report.to_dict(),
        },
        "metadata": {
            "scanStartedOn": now,
            "scanFinishedOn": now,
        },
    }
    json.dump(predicate, out, indent=2)
    out.write("\n")
