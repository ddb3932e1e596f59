"""Scan options and the report's metadata (ref: pkg/scanner/scan.go:134-204),
the port of ``trivy_tpu/scanner/__init__.py``."""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

from trivy_tpu_torch.types import OS, Report, Result


@dataclass
class ScanOptions:
    """What to scan (ref: pkg/types ScanOptions)."""

    scanners: list[str] = field(default_factory=lambda: ["secret"])
    list_all_pkgs: bool = False


def build_report(name: str, artifact_type: str, results: list[Result],
                 os_info: OS | None) -> Report:
    """The report of one artifact: its non-empty results and the metadata
    of ``Scanner.scan_artifact`` for an artifact with no image, with the OS
    when the analyzers found one (ref: scan.go:164-204)."""
    metadata = {"ImageID": "", "DiffIDs": []}
    if os_info is not None:
        metadata["OS"] = os_info.to_dict()
    return Report(
        created_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        artifact_name=name,
        artifact_type=artifact_type,
        metadata=metadata,
        results=[r for r in results if not r.is_empty],
    )
