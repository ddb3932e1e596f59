"""Alpine apk installed-database analyzer
(ref: pkg/fanal/analyzer/pkg/apk — parses /lib/apk/db/installed).

Record format: blank-line separated blocks of single-letter keys:
P=name V=version A=arch L=license o=origin(src) m=maintainer
D/r=depends F/R=files."""

from __future__ import annotations

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import Package, PackageInfo, PkgIdentifier


class ApkAnalyzer(Analyzer):
    type = AnalyzerType.APK
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path == "lib/apk/db/installed"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs: list[Package] = []
        system_files: list[str] = []
        cur: dict[str, str] = {}
        files: list[str] = []
        cur_dir = ""

        def flush():
            if not cur.get("P"):
                return
            full = cur.get("V", "")
            version, _, release = full.partition("-r")
            pkg = Package(
                name=cur["P"],
                version=full,  # apk advisories compare the full 1.2.3-r0 form
                arch=cur.get("A", ""),
                src_name=cur.get("o", cur["P"]),
                src_version=full,
                licenses=_split_license(cur.get("L", "")),
                identifier=PkgIdentifier(),
            )
            pkg.id = f"{pkg.name}@{pkg.version}"
            pkgs.append(pkg)

        for line in inp.content.decode("utf-8", "replace").splitlines():
            if not line.strip():
                flush()
                cur = {}
                continue
            if len(line) < 2 or line[1] != ":":
                continue
            key, value = line[0], line[2:]
            if key == "F":
                cur_dir = value
            elif key == "R":
                path = f"{cur_dir}/{value}" if cur_dir else value
                files.append(path)
                system_files.append(path)
            else:
                cur[key] = value
        flush()
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=inp.file_path, packages=pkgs)],
            system_files=system_files,
        )


def _split_license(s: str) -> list[str]:
    out = []
    for part in s.replace(" AND ", " ").replace(" OR ", " ").split():
        if part not in ("AND", "OR"):
            out.append(part)
    return out


register_analyzer(ApkAnalyzer)
