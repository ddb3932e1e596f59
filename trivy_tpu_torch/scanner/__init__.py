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
                 os_info: OS | None, image_metadata: dict | None = None,
                 skipped_files: int = 0, health: dict | None = None) -> Report:
    """The report of one artifact: its non-empty results and the metadata
    of ``Scanner.scan_artifact`` (ref: scan.go:164-204): the image's ID,
    diff IDs and config when ``image_metadata`` holds them (an image's
    ``ArtifactReference.image_metadata``), the OS when the analyzers found
    one, and ``SkippedFiles`` when files an analyzer wanted could not be
    read. ``health`` is the scan's share of the trace context's health
    counts (the JAX ``scan_artifact``'s before/after delta): a
    ``scan.degraded`` there sets the report's ``Degraded``."""
    image = image_metadata or {}
    metadata = {"ImageID": image.get("id", ""), "DiffIDs": image.get("diff_ids", [])}
    if os_info is not None:
        metadata["OS"] = os_info.to_dict()
    if image.get("config"):
        metadata["ImageConfig"] = image["config"]
    if skipped_files > 0:
        metadata["SkippedFiles"] = skipped_files
    return Report(
        created_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        artifact_name=name,
        artifact_type=artifact_type,
        metadata=metadata,
        results=[r for r in results if not r.is_empty],
        degraded=(health or {}).get("scan.degraded", 0) > 0,
    )
