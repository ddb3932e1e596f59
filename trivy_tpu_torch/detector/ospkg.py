"""OS package vulnerability detection (ref: pkg/detector/ospkg/detect.go).

Driver map per OS family: advisory bucket naming, version-comparison
scheme, and EOL handling. Advisory semantics: a package is vulnerable when
``installed < FixedVersion`` (fixed advisory) or unconditionally for
unfixed advisories (empty FixedVersion → status 'affected').
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import date

from trivy_tpu_torch import log
from trivy_tpu_torch.types import DetectedVulnerability, OS, Package
from trivy_tpu_torch.version import compare

logger = log.logger("detector:ospkg")


@dataclass(frozen=True)
class Driver:
    family: str
    scheme: str  # deb | rpm | apk
    bucket_family: str = ""  # bucket name override
    use_major_version: bool = False  # bucket keyed by major ("redhat 8")
    use_major_minor: bool = False  # bucket keyed by major.minor ("alpine 3.18")
    rolling: bool = False  # rolling distro: versionless bucket ("wolfi")

    def bucket(self, os_name: str) -> str:
        fam = self.bucket_family or self.family
        if self.rolling:
            return fam
        name = os_name
        if self.use_major_version:
            name = os_name.split(".")[0]
        elif self.use_major_minor:
            name = ".".join(os_name.split(".")[:2])
        return f"{fam} {name}".strip()


DRIVERS: dict[str, Driver] = {
    # alpine advisories are bucketed by major.minor (ref: alpine detector
    # trims to osver.Minor) — os-release VERSION_ID is the full "3.18.4"
    "alpine": Driver("alpine", "apk", use_major_minor=True),
    "debian": Driver("debian", "deb", use_major_version=True),
    "ubuntu": Driver("ubuntu", "deb"),
    "redhat": Driver("redhat", "rpm", use_major_version=True),
    "centos": Driver("centos", "rpm", bucket_family="redhat", use_major_version=True),
    "rocky": Driver("rocky", "rpm", use_major_version=True),
    "alma": Driver("alma", "rpm", use_major_version=True),
    "oracle": Driver("oracle", "rpm", bucket_family="Oracle Linux", use_major_version=True),
    "amazon": Driver("amazon", "rpm", bucket_family="amazon linux"),
    "fedora": Driver("fedora", "rpm"),
    "photon": Driver("photon", "rpm"),
    "azurelinux": Driver("azurelinux", "rpm", bucket_family="Azure Linux"),
    "cbl-mariner": Driver("cbl-mariner", "rpm", bucket_family="CBL-Mariner"),
    # rolling distros: trivy-db buckets carry no version component
    "wolfi": Driver("wolfi", "apk", bucket_family="wolfi", rolling=True),
    "chainguard": Driver("chainguard", "apk", bucket_family="chainguard", rolling=True),
    "opensuse-leap": Driver("opensuse-leap", "rpm", bucket_family="openSUSE Leap"),
    "sles": Driver("sles", "rpm", bucket_family="SUSE Linux Enterprise"),
}

# minimal EOL table for the supported-version warning
# (ref: each ospkg driver's eolDates map; kept to majors that matter)
EOL: dict[str, dict[str, date]] = {
    "alpine": {"3.10": date(2021, 5, 1), "3.16": date(2024, 5, 23),
               "3.17": date(2024, 11, 22), "3.18": date(2025, 5, 9),
               "3.19": date(2025, 11, 1), "3.20": date(2026, 4, 1),
               "3.21": date(2026, 11, 1)},
    "debian": {"10": date(2024, 6, 30), "11": date(2026, 8, 31),
               "12": date(2028, 6, 30)},
    "ubuntu": {"18.04": date(2023, 5, 31), "20.04": date(2025, 5, 31),
               "22.04": date(2027, 6, 1), "24.04": date(2029, 5, 31)},
    # (ref: pkg/detector/ospkg/redhat/redhat.go eolDates and siblings)
    "redhat": {"6": date(2020, 11, 30), "7": date(2024, 6, 30),
               "8": date(2029, 5, 31), "9": date(2032, 5, 31)},
    "centos": {"6": date(2020, 11, 30), "7": date(2024, 6, 30),
               "8": date(2021, 12, 31)},
    "alma": {"8": date(2029, 3, 1), "9": date(2032, 5, 31)},
    "rocky": {"8": date(2029, 5, 31), "9": date(2032, 5, 31)},
    "oracle": {"6": date(2021, 3, 1), "7": date(2024, 12, 1),
               "8": date(2029, 7, 1), "9": date(2032, 6, 1)},
    "amazon": {"1": date(2023, 12, 31), "2": date(2026, 6, 30),
               "2022": date(2026, 11, 15), "2023": date(2028, 3, 15)},
    "fedora": {"38": date(2024, 5, 21), "39": date(2024, 11, 26),
               "40": date(2025, 5, 28), "41": date(2025, 11, 26)},
}


def is_supported_version(family: str, os_name: str, today: date | None = None) -> bool:
    table = EOL.get(family)
    if not table:
        return True
    key = os_name if os_name in table else ".".join(os_name.split(".")[:2])
    eol = table.get(key)
    if eol is None:
        key = os_name.split(".")[0]
        eol = table.get(key)
    if eol is None:
        return True
    return (today or date.today()) <= eol


def detect(db, os_info: OS, packages: list[Package]) -> list[DetectedVulnerability]:
    driver = DRIVERS.get(os_info.family)
    if driver is None:
        logger.warning("unsupported OS family: %s", os_info.family)
        return []
    if not is_supported_version(os_info.family, os_info.name):
        logger.warning(
            "%s %s reached end-of-support; vulnerabilities may be undetected",
            os_info.family,
            os_info.name,
        )
    bucket = driver.bucket(os_info.name)
    vulns: list[DetectedVulnerability] = []
    for pkg in packages:
        names = [pkg.name]
        if pkg.src_name and pkg.src_name != pkg.name:
            names.append(pkg.src_name)
        if driver.scheme == "rpm" and pkg.modularitylabel:
            # modular packages are advisory-keyed by "name:stream::pkg"
            # (ref: pkg/detector/ospkg/redhat/redhat.go module handling)
            parts = pkg.modularitylabel.split(":")
            if len(parts) >= 2:
                module = ":".join(parts[:2])
                names = [f"{module}::{n}" for n in names]
        installed = _installed_version(pkg, driver.scheme)
        seen: set[str] = set()
        for name in names:
            for adv in db.get_advisories(bucket, name):
                if adv.vulnerability_id in seen:
                    continue
                if (
                    adv.arches
                    and pkg.arch
                    and pkg.arch != "noarch"  # noarch installs everywhere
                    and pkg.arch not in adv.arches
                ):
                    continue
                if adv.fixed_version:
                    if compare(driver.scheme, installed, adv.fixed_version) >= 0:
                        continue
                    status = "fixed"
                else:
                    status = adv.status or "affected"
                seen.add(adv.vulnerability_id)
                vulns.append(
                    DetectedVulnerability(
                        vulnerability_id=adv.vulnerability_id,
                        pkg_id=pkg.id,
                        pkg_name=pkg.name,
                        pkg_identifier=pkg.identifier,
                        installed_version=installed,
                        fixed_version=adv.fixed_version,
                        status=status,
                        severity=adv.severity or "UNKNOWN",
                        data_source=adv.data_source,
                        layer=pkg.layer,
                    )
                )
    vulns.sort(key=lambda v: (v.pkg_name, v.vulnerability_id, v.pkg_path))
    return vulns


def _installed_version(pkg: Package, scheme: str) -> str:
    v = pkg.version
    if scheme in ("deb", "rpm") and pkg.epoch:
        v = f"{pkg.epoch}:{v}"
    if pkg.release:  # rpm release, deb revision, apk -rN all join with '-'
        v = f"{v}-{pkg.release}"
    return v
