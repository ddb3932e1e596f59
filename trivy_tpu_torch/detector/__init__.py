"""Vulnerability detection layer (ref: pkg/detector)."""

from __future__ import annotations

from collections import Counter

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.types import ArtifactDetail, Result, ResultClass


def detect_all(db, target: str, detail: ArtifactDetail, device=DEFAULT_DEVICE,
               stats: Counter | None = None, list_all_pkgs: bool = False,
               host_fallback: bool = True) -> list[Result]:
    """OS packages + every application (ref: pkg/scanner/local/scan.go:153-247,
    pkg/scanner/langpkg/scan.go:36), as the JAX package's ``detect_all``
    with both package types. The applications' constraint checks run on
    ``device``; ``stats`` gathers the join's counters. ``list_all_pkgs``
    (``--list-all-pkgs``) keeps every package in its section and the
    applications without findings. ``host_fallback`` lets a failed join
    finish on the host comparator."""
    from trivy_tpu_torch.detector import library, ospkg
    from trivy_tpu_torch.vulnerability import fill_infos

    results: list[Result] = []
    if detail.os and detail.packages:
        vulns = ospkg.detect(db, detail.os, detail.packages)
        fill_infos(db, vulns)
        results.append(
            Result(
                target=f"{target} ({detail.os.family} {detail.os.name})",
                cls=ResultClass.OS_PKGS.value,
                type=detail.os.family,
                vulnerabilities=vulns,
                packages=detail.packages if list_all_pkgs else [],
            )
        )
    apps = sorted(detail.applications, key=lambda a: (a.file_path, a.type))
    # whole-SBOM one-pass join: every app's packages hash-join and
    # dispatch together against the card-resident global bound matrix
    for app, vulns in zip(apps, library.detect_batch(db, apps, device, stats, host_fallback)):
        fill_infos(db, vulns)
        if not vulns and not list_all_pkgs:
            continue
        results.append(
            Result(
                target=app.file_path or app.type,
                cls=ResultClass.LANG_PKGS.value,
                type=app.type,
                vulnerabilities=vulns,
                packages=app.packages if list_all_pkgs else [],
            )
        )
    return results
