"""Report writers (ref: pkg/report/writer.go:45-99 format switch), the
port's copy of ``trivy_tpu/report/``: ``json``, ``table``, ``sarif``, the
SBOM formats ``cyclonedx``, ``spdx`` and ``spdx-json`` (``sbom/io.py``),
``github``, ``template`` and ``cosign-vuln``. Each writes the bytes the JAX
package's writer writes for the same report."""

from __future__ import annotations

import sys

from trivy_tpu_torch.types import Report

FORMATS = ["table", "json", "sarif", "cyclonedx", "spdx", "spdx-json", "github", "template",
           "cosign-vuln"]


def write(report: Report, fmt: str = "table", output=None, **kw) -> None:
    out = output or sys.stdout
    if fmt == "json":
        from trivy_tpu_torch.report.json_ import write_json

        write_json(report, out, **kw)
    elif fmt == "table":
        from trivy_tpu_torch.report.table import write_table

        write_table(report, out, **kw)
    elif fmt == "sarif":
        from trivy_tpu_torch.report.sarif import write_sarif

        write_sarif(report, out, **kw)
    elif fmt in ("cyclonedx", "spdx", "spdx-json"):
        from trivy_tpu_torch.sbom.io import encode_report

        encode_report(report, fmt, out, **kw)
    elif fmt == "github":
        from trivy_tpu_torch.report.github import write_github

        write_github(report, out, **kw)
    elif fmt == "template":
        from trivy_tpu_torch.report.template import write_template

        write_template(report, out, **kw)
    elif fmt == "cosign-vuln":
        from trivy_tpu_torch.report.predicate import write_cosign_vuln

        write_cosign_vuln(report, out, **kw)
    else:
        raise ValueError(f"unknown format: {fmt}")
