"""OS identity analyzers (ref: pkg/fanal/analyzer/os/*).

Release-file parsing for every supported family: os-release (the generic
path covering ubuntu/debian/fedora/rhel-likes/suse/wolfi/chainguard...),
alpine-release, debian_version, redhat-release and friends. Later layers
merge via OS.merge (never blanking earlier values)."""

from __future__ import annotations

import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import OS

# ID (+ ID_LIKE) values in os-release -> internal family names
_OS_RELEASE_IDS = {
    "alpine": "alpine",
    "debian": "debian",
    "ubuntu": "ubuntu",
    "fedora": "fedora",
    "rhel": "redhat",
    "centos": "centos",
    "rocky": "rocky",
    "almalinux": "alma",
    "ol": "oracle",
    "amzn": "amazon",
    "photon": "photon",
    "wolfi": "wolfi",
    "chainguard": "chainguard",
    "opensuse-leap": "opensuse-leap",
    "opensuse-tumbleweed": "opensuse-tumbleweed",
    "sles": "sles",
    "azurelinux": "azurelinux",
    "mariner": "cbl-mariner",
}


def _parse_os_release(text: str) -> dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip().strip('"').strip("'")
    return out


class OSReleaseAnalyzer(Analyzer):
    type = AnalyzerType.OS_RELEASE
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path in ("etc/os-release", "usr/lib/os-release", "os-release")

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        fields = _parse_os_release(inp.content.decode("utf-8", "replace"))
        id_ = fields.get("ID", "")
        family = _OS_RELEASE_IDS.get(id_)
        if family is None:
            for like in fields.get("ID_LIKE", "").split():
                if like in _OS_RELEASE_IDS:
                    family = _OS_RELEASE_IDS[like]
                    break
        if family is None:
            return None
        name = fields.get("VERSION_ID", "")
        if not name and family in ("wolfi", "chainguard", "opensuse-tumbleweed"):
            name = fields.get("VERSION_ID", "")
        if family == "amazon":
            # amazon linux buckets use "2" / "2023"
            name = name.split(".")[0] if name.startswith("201") else name
        if not name:
            return None
        return AnalysisResult(os=OS(family=family, name=name))


class AlpineReleaseAnalyzer(Analyzer):
    type = AnalyzerType.ALPINE
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path == "etc/alpine-release"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        ver = inp.content.decode("utf-8", "replace").strip()
        if not ver:
            return None
        # bucket key is major.minor (ref: analyzer/os/alpine)
        name = ".".join(ver.split(".")[:2])
        return AnalysisResult(os=OS(family="alpine", name=name))


class DebianVersionAnalyzer(Analyzer):
    type = AnalyzerType.DEBIAN
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path == "etc/debian_version"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        ver = inp.content.decode("utf-8", "replace").strip()
        if not ver or "/" in ver:  # "trixie/sid" etc: unstable, no release
            return None
        return AnalysisResult(os=OS(family="debian", name=ver))


_REDHAT_RE = re.compile(
    r"^(?P<name>.+?) (?:Linux )?(?:Server )?release (?P<ver>[\d.]+)", re.IGNORECASE
)
_REDHAT_FAMILIES = [
    ("centos", "centos"),
    ("rocky", "rocky"),
    ("alma", "alma"),
    ("oracle", "oracle"),
    ("fedora", "fedora"),
    ("red hat", "redhat"),
]


class RedHatReleaseAnalyzer(Analyzer):
    type = AnalyzerType.REDHAT
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path in (
            "etc/redhat-release",
            "etc/centos-release",
            "etc/rocky-release",
            "etc/almalinux-release",
            "etc/oracle-release",
            "etc/fedora-release",
            "etc/system-release",
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", "replace").strip()
        m = _REDHAT_RE.match(text)
        if not m:
            return None
        low = m.group("name").lower()
        family = "redhat"
        for needle, fam in _REDHAT_FAMILIES:
            if needle in low:
                family = fam
                break
        return AnalysisResult(os=OS(family=family, name=m.group("ver")))


register_analyzer(OSReleaseAnalyzer)
register_analyzer(AlpineReleaseAnalyzer)
register_analyzer(DebianVersionAnalyzer)
register_analyzer(RedHatReleaseAnalyzer)
