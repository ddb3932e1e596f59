"""Analyzer registry and the per-file analysis group (ref:
pkg/fanal/analyzer/analyzer.go), the port of ``trivy_tpu/fanal/analyzer.py``.

Per-file analyzers keep the reference's contract: a ``required(path,
info)`` prefilter on the walker's :class:`FileInfo`, then ``analyze(input)
-> AnalysisResult``. They are built sorted by type value and their results
merge into one :class:`AnalysisResult`, sorted deterministically before it
becomes the scan's blob (ref: analyzer.go:188-301), so the report's order of
applications and packages is that of the JAX package.

The secret, license and config analyzers are batched (collect during the
walk, finalize once) and live beside the group in ``fanal/secret.py``,
``fanal/license.py`` and ``fanal/config.py``; their findings merge into
the same result.
"""

from __future__ import annotations

import enum
from collections.abc import Callable
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal.walker import FileInfo
from trivy_tpu_torch.types import (
    Application,
    BlobInfo,
    LicenseFile,
    Misconfiguration,
    OS,
    PackageInfo,
    Secret,
)

logger = log.logger("analyzer")


class AnalyzerType(str, enum.Enum):
    """Analyzer type constants (subset of ref: pkg/fanal/analyzer/const.go)."""

    # OS
    OS_RELEASE = "os-release"
    ALPINE = "alpine"
    DEBIAN = "debian"
    UBUNTU = "ubuntu"
    REDHAT = "redhat"
    AMAZON = "amazon"
    # OS packages
    APK = "apk"
    DPKG = "dpkg"
    RPM = "rpm"
    # language ecosystems
    BUNDLER = "bundler"
    CARGO = "cargo"
    RUST_BINARY = "rustbinary"
    COMPOSER = "composer"
    GO_MOD = "gomod"
    GO_BINARY = "gobinary"
    GRADLE_LOCK = "gradle-lockfile"
    JAR = "jar"
    POM = "pom"
    NPM_PKG_LOCK = "npm"
    NODE_PKG = "node-pkg"
    PNPM = "pnpm"
    YARN = "yarn"
    PIP = "pip"
    PIPENV = "pipenv"
    POETRY = "poetry"
    UV = "uv"
    CONAN = "conan-lock"
    NUGET = "nuget"
    DOTNET_DEPS = "dotnet-core"
    PUB_SPEC = "pubspec-lock"
    MIX_LOCK = "mix-lock"
    SWIFT = "swift"
    COCOAPODS = "cocoapods"
    CONDA_PKG = "conda-pkg"
    PYTHON_PKG = "python-pkg"
    GEMSPEC = "gemspec"
    JULIA = "julia"
    PACKAGES_PROPS = "packages-props"
    CONDA_ENV = "conda-environment"
    SBT_LOCK = "sbt-lockfile"
    WORDPRESS = "wordpress"
    # others
    SECRET = "secret"
    RED_HAT_CONTENT_MANIFEST = "redhat-content-manifest"
    RED_HAT_DOCKERFILE = "redhat-dockerfile"
    APK_REPO = "apk-repo"
    EXECUTABLE = "executable"
    LICENSE_FILE = "license-file"
    LICENSE_HEADER = "license-header"
    CONFIG = "config"
    SBOM = "sbom"


# the analyzers whose output reaches the report's Metadata.OS: they run
# under every scanner set (an SBOM file may carry the OS in its purls)
OS_IDENTITY = frozenset({
    AnalyzerType.OS_RELEASE, AnalyzerType.ALPINE, AnalyzerType.DEBIAN,
    AnalyzerType.REDHAT, AnalyzerType.SBOM,
})


@dataclass
class AnalysisInput:
    """Per-file input (ref: analyzer.go AnalysisInput)."""

    dir: str  # scan root
    file_path: str  # posix path relative to root
    info: FileInfo
    content: bytes


@dataclass
class AnalysisResult:
    """Accumulation of everything analyzers produce (ref:
    analyzer.go:251-301)."""

    os: OS | None = None
    repository: dict | None = None
    build_info: dict | None = None
    digests: dict = field(default_factory=dict)
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    misconfigurations: list[Misconfiguration] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)
    system_files: list[str] = field(default_factory=list)  # for the sysfile filter

    def merge(self, other: "AnalysisResult | None") -> None:
        if other is None:
            return
        if other.os is not None:
            self.os = self.os.merge(other.os) if self.os else other.os
        if other.repository is not None:
            self.repository = other.repository
        if other.build_info is not None:
            # merge content-sets with nvr/arch coming from sibling files
            merged = dict(self.build_info or {})
            merged.update(other.build_info)
            self.build_info = merged
        if other.digests:
            self.digests.update(other.digests)
        self.package_infos.extend(other.package_infos)
        self.applications.extend(other.applications)
        self.misconfigurations.extend(other.misconfigurations)
        self.secrets.extend(other.secrets)
        self.licenses.extend(other.licenses)
        self.system_files.extend(other.system_files)

    def sort(self) -> None:
        """Deterministic ordering (ref: analyzer.go:188-249)."""
        self.package_infos.sort(key=lambda p: p.file_path)
        for pi in self.package_infos:
            pi.packages.sort(key=lambda p: (p.name, p.version, p.file_path))
        self.applications.sort(key=lambda a: (a.file_path, a.type))
        for app in self.applications:
            app.packages.sort(key=lambda p: (p.name, p.version, p.file_path))
        self.misconfigurations.sort(key=lambda m: m.file_path)
        self.secrets.sort(key=lambda s: s.file_path)
        self.licenses.sort(key=lambda l: (l.file_path, l.pkg_name))

    def to_blob_info(self) -> BlobInfo:
        self.sort()
        return BlobInfo(
            os=self.os,
            repository=self.repository,
            build_info=self.build_info,
            digests=self.digests,
            package_infos=self.package_infos,
            applications=self.applications,
            misconfigurations=self.misconfigurations,
            secrets=self.secrets,
            licenses=self.licenses,
        )


class Analyzer:
    """Per-file analyzer contract (ref: analyzer.go:72-84)."""

    type: AnalyzerType
    version: int = 1

    def required(self, file_path: str, info: FileInfo) -> bool:
        raise NotImplementedError

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        raise NotImplementedError


_analyzers: dict[AnalyzerType, Callable[..., Analyzer]] = {}


def register_analyzer(factory) -> None:
    """Global registry (ref: analyzer.go:26-27 RegisterAnalyzer)."""
    t = factory.type
    if t in _analyzers:
        raise ValueError(f"analyzer {t} registered twice")
    _analyzers[t] = factory


@dataclass
class AnalyzerOptions:
    """Group construction options (ref: analyzer.go AnalyzerOptions):
    ``enabled`` keeps only those types when given; ``extra`` carries
    per-analyzer settings (``java_db_path``, ``executable_digests``)."""

    enabled: frozenset | None = None
    extra: dict = field(default_factory=dict)


class AnalyzerGroup:
    """The per-file analyzers of one scan (ref: analyzer.go:321-377)."""

    def __init__(self, options: AnalyzerOptions | None = None):
        import trivy_tpu_torch.fanal.analyzers  # noqa: F401  (registers built-ins)

        opts = options or AnalyzerOptions()
        self.analyzers: list[Analyzer] = [
            factory(opts)
            for t, factory in sorted(_analyzers.items(), key=lambda kv: kv[0].value)
            if opts.enabled is None or t in opts.enabled
        ]

    def versions(self) -> dict[str, int]:
        """type -> version map, part of every layer's cache key (ref:
        pkg/fanal/artifact/local/fs.go:183)."""
        return dict(sorted((a.type.value, a.version) for a in self.analyzers))

    def required(self, file_path: str, info: FileInfo) -> list[Analyzer]:
        return [a for a in self.analyzers if a.required(file_path, info)]

    def analyze_file(self, result: AnalysisResult, takers: list[Analyzer], dir: str,
                     file_path: str, info: FileInfo, content: bytes) -> None:
        """Run ``takers`` (the analyzers that required the file) on its
        content, merging into ``result``. An analyzer's failure is logged and
        costs only its own output for this file, as in the reference."""
        for a in takers:
            try:
                result.merge(a.analyze(
                    AnalysisInput(dir=dir, file_path=file_path, info=info, content=content)))
            except Exception as e:
                logger.warning("analyzer %s failed on %s: %s", a.type.value, file_path, e)
