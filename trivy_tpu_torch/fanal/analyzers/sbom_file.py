"""SBOM-files-inside-the-scan-target analyzer.

Images sometimes ship their own SBOMs (Bitnami images carry SPDX files
under /opt/bitnami; ref: pkg/fanal/analyzer/sbom/sbom.go) — decoding them
yields package inventories for software no lockfile or package DB
describes. Matches common SBOM filename shapes and decodes through the
same CycloneDX/SPDX decoder the sbom command uses.
"""

from __future__ import annotations

import os.path

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)

logger = log.logger("analyzer:sbom")

MAX_SBOM_BYTES = 16 << 20

# JSON and SPDX tag-value shapes only — the decoder has no XML support,
# so advertising *.xml would just burn I/O on guaranteed failures
_SUFFIXES = (
    ".cdx", ".cdx.json",
    ".spdx", ".spdx.json",
    "bom.json", "sbom.json",
)


def _looks_like_sbom(path: str) -> bool:
    # covers the Bitnami layout too (/opt/bitnami/<app>/.spdx-<app>.spdx)
    return os.path.basename(path).lower().endswith(_SUFFIXES)


class SbomFileAnalyzer(Analyzer):
    type = AnalyzerType.SBOM
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return info.size <= MAX_SBOM_BYTES and _looks_like_sbom(file_path)

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        from trivy_tpu_torch.sbom.decode import decode

        try:
            blob = decode(inp.content)
        except Exception as e:
            logger.debug("cannot decode SBOM %s: %s", inp.file_path, e)
            return None
        apps = list(blob.applications)
        for app in apps:
            # findings should point at the SBOM file that declared them
            app.file_path = app.file_path or inp.file_path
        if not apps and not blob.package_infos:
            return None
        # blob.os rides along: an image whose only OS evidence is a shipped
        # SBOM (deb/rpm purl distro qualifiers) must still reach the OS-pkg
        # detectors
        return AnalysisResult(
            applications=apps,
            package_infos=list(blob.package_infos),
            os=blob.os,
        )


register_analyzer(SbomFileAnalyzer)
