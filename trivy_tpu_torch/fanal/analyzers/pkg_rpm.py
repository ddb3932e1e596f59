"""RPM package database analyzer
(ref: pkg/fanal/analyzer/pkg/rpm/rpm.go; db decoding in
``trivy_tpu_torch.fanal.rpmdb`` replaces the external go-rpmdb).

Feeds the RedHat-family OS detectors (redhat/centos/fedora/oracle/alma/
rocky/suse/amazon/photon): packages carry the epoch/version/release triple,
the source-package triple parsed from SOURCERPM, and vendor/modularity
metadata the drivers use for advisory matching. Installed file lists are
reported for vendor-provided packages only, so the sysfile post-handler can
drop language packages that rpm itself installed (ref: rpm.go:140-151).
"""

from __future__ import annotations

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal import rpmdb
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import Package, PackageInfo

logger = log.logger("analyzer:rpm")

_DB_PATHS = frozenset(
    base + name
    for base in ("var/lib/rpm/", "usr/lib/sysimage/rpm/")
    for name in ("Packages", "Packages.db", "rpmdb.sqlite")
)

# vendors whose packages are considered OS-provided (ref: rpm.go osVendors);
# matching is substring so "Red Hat, Inc." and "CentOS" both hit
_OS_VENDOR_WORDS = (
    "Amazon",
    "CentOS",
    "Fedora Project",
    "Oracle America",
    "Red Hat",
    "AlmaLinux",
    "CloudLinux",
    "VMware",
    "SUSE",
    "openSUSE",
    "Microsoft Corporation",
    "Rocky",
)


def split_source_rpm(filename: str) -> tuple[str, str, str]:
    """``bash-5.1.8-6.el9.src.rpm`` → (name, version, release).

    Source epoch never appears in SOURCERPM; callers reuse the binary epoch
    (ref: rpm.go:173 note).
    """
    if filename.endswith(".rpm"):
        filename = filename[: -len(".rpm")]
    rest, _, _arch = filename.rpartition(".")
    if not rest:
        raise ValueError(f"unexpected source rpm name: {filename!r}")
    nv, _, rel = rest.rpartition("-")
    n, _, ver = nv.rpartition("-")
    if not n or not ver or not rel:
        raise ValueError(f"unexpected source rpm name: {filename!r}")
    return n, ver, rel


def _vendor_provided(vendor: str) -> bool:
    return any(w in vendor for w in _OS_VENDOR_WORDS)


class RpmAnalyzer(Analyzer):
    type = AnalyzerType.RPM
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path in _DB_PATHS

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            headers = rpmdb.read_headers(inp.content)
        except rpmdb.RpmDBError as e:
            logger.warning("failed to parse rpmdb %s: %s", inp.file_path, e)
            return None
        pkgs: list[Package] = []
        system_files: list[str] = []
        provides: dict[str, str] = {}
        requires: list[list[str]] = []
        for h in headers:
            name = h.str_(rpmdb.TAG_NAME)
            version = h.str_(rpmdb.TAG_VERSION)
            if not name or not version:
                continue
            release = h.str_(rpmdb.TAG_RELEASE)
            arch = h.str_(rpmdb.TAG_ARCH) or "None"
            src_name = src_ver = src_rel = ""
            source_rpm = h.str_(rpmdb.TAG_SOURCERPM)
            if source_rpm and source_rpm != "(none)":
                try:
                    src_name, src_ver, src_rel = split_source_rpm(source_rpm)
                except ValueError:
                    logger.debug("invalid source rpm: %s", source_rpm)
            epoch = h.int_(rpmdb.TAG_EPOCH)
            vendor = h.str_(rpmdb.TAG_VENDOR)
            files: list[str] = []
            if _vendor_provided(vendor):
                basenames = h.list_(rpmdb.TAG_BASENAMES)
                dirnames = h.list_(rpmdb.TAG_DIRNAMES)
                dirindexes = h.list_(rpmdb.TAG_DIRINDEXES)
                for i, base in enumerate(basenames):
                    if i < len(dirindexes) and dirindexes[i] < len(dirnames):
                        files.append(dirnames[dirindexes[i]] + base)
            sigmd5 = h.tags.get(rpmdb.TAG_SIGMD5)
            lic = h.str_(rpmdb.TAG_LICENSE)
            pkg = Package(
                name=name,
                version=version,
                release=release,
                epoch=epoch,
                arch=h.str_(rpmdb.TAG_ARCH) or "None",
                src_name=src_name,
                src_version=src_ver,
                src_release=src_rel,
                src_epoch=epoch,
                licenses=[lic] if lic else [],
                maintainer=vendor,
                modularitylabel=h.str_(rpmdb.TAG_MODULARITYLABEL),
                digest=f"md5:{bytes(sigmd5).hex()}" if isinstance(sigmd5, (bytes, bytearray)) and sigmd5 else "",
            )
            pkg.id = f"{name}@{version}-{release}.{arch}"
            pkgs.append(pkg)
            system_files.extend(f.lstrip("/") for f in files)
            for p in h.list_(rpmdb.TAG_PROVIDENAME):
                provides[p] = pkg.id
            requires.append(h.list_(rpmdb.TAG_REQUIRENAME))
        # requires → providing package IDs (ref: rpm.go consolidateDependencies)
        for pkg, reqs in zip(pkgs, requires):
            deps = {provides[r] for r in reqs if r in provides and provides[r] != pkg.id}
            pkg.depends_on = sorted(deps)
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=inp.file_path, packages=pkgs)],
            system_files=system_files,
        )


register_analyzer(RpmAnalyzer)
