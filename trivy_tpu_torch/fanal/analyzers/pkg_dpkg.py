"""Debian dpkg database analyzers
(ref: pkg/fanal/analyzer/pkg/dpkg — /var/lib/dpkg/status, status.d/*,
per-package info/*.list file lists).

Status stanzas parse Package/Version/Source (with optional bracketed
source version)/Architecture/Status; only installed packages count.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import Package, PackageInfo

_SOURCE_RE = re.compile(r"^(?P<name>\S+)(?:\s+\((?P<ver>[^)]+)\))?$")


def _parse_epoch(version: str) -> tuple[int, str]:
    if ":" in version:
        head, _, rest = version.partition(":")
        if head.isdigit():
            return int(head), rest
    return 0, version


class DpkgAnalyzer(Analyzer):
    type = AnalyzerType.DPKG
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        if file_path == "var/lib/dpkg/status":
            return True
        if file_path.startswith("var/lib/dpkg/status.d/") and not file_path.endswith(".md5sums"):
            return True
        if file_path.startswith("var/lib/dpkg/info/") and file_path.endswith(".list"):
            return True
        return False

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        if inp.file_path.endswith(".list"):
            files = [
                l.strip()
                for l in inp.content.decode("utf-8", "replace").splitlines()
                if l.strip() and l.strip() != "/."
            ]
            return AnalysisResult(system_files=[f.lstrip("/") for f in files])
        pkgs: list[Package] = []
        for stanza in inp.content.decode("utf-8", "replace").split("\n\n"):
            fields: dict[str, str] = {}
            key = None
            for line in stanza.splitlines():
                if line.startswith((" ", "\t")):
                    continue  # continuation lines (descriptions) ignored
                if ":" in line:
                    key, _, val = line.partition(":")
                    fields[key.strip()] = val.strip()
            name = fields.get("Package")
            version = fields.get("Version")
            if not name or not version:
                continue
            status = fields.get("Status", "install ok installed")
            if "installed" not in status.split() or "not-installed" in status:
                continue
            epoch, ver = _parse_epoch(version)
            upstream, _, revision = ver.rpartition("-")
            if not upstream:
                upstream, revision = revision, ""
            src_name, src_full = name, version
            if "Source" in fields:
                m = _SOURCE_RE.match(fields["Source"])
                if m:
                    src_name = m.group("name")
                    if m.group("ver"):
                        src_full = m.group("ver")
            src_epoch, src_ver = _parse_epoch(src_full)
            src_up, _, src_rev = src_ver.rpartition("-")
            if not src_up:
                src_up, src_rev = src_rev, ""
            pkg = Package(
                name=name,
                version=upstream,
                release=revision,
                epoch=epoch,
                arch=fields.get("Architecture", ""),
                src_name=src_name,
                src_version=src_up,
                src_release=src_rev,
                src_epoch=src_epoch,
            )
            pkg.id = f"{name}@{version}"
            pkgs.append(pkg)
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=inp.file_path, packages=pkgs)]
        )


register_analyzer(DpkgAnalyzer)
