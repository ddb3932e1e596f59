"""Build-metadata analyzers: Red Hat content manifests and buildinfo
Dockerfiles, apk repository detection, and executable digests
(ref: pkg/fanal/analyzer/buildinfo/{content_manifest,dockerfile}.go,
pkg/fanal/analyzer/repo/apk/apk.go, pkg/fanal/analyzer/executable/).
"""

from __future__ import annotations

import hashlib
import json
import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)


class ContentManifestAnalyzer(Analyzer):
    """``root/buildinfo/content_manifests/*.json`` -> BuildInfo content
    sets (Red Hat advisory repository filtering)."""

    type = AnalyzerType.RED_HAT_CONTENT_MANIFEST
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return (
            file_path.startswith("root/buildinfo/content_manifests/")
            and file_path.count("/", len("root/buildinfo/content_manifests/")) == 0
            and file_path.endswith(".json")
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except json.JSONDecodeError:
            return None
        sets = (doc or {}).get("content_sets") or []
        if not sets:
            return None
        return AnalysisResult(
            build_info={"ContentSets": [str(s) for s in sets]}
        )


_LABEL_RE = re.compile(
    r"^\s*LABEL\s+(?P<body>.+)$", re.IGNORECASE | re.MULTILINE
)
_KV_RE = re.compile(
    r"""(?P<k>[\w.\-]+|"[^"]+")\s*=\s*(?P<v>"(?:[^"\\]|\\.)*"|\S+)"""
)


class BuildinfoDockerfileAnalyzer(Analyzer):
    """``root/buildinfo/Dockerfile-*`` -> BuildInfo NVR + arch from the
    com.redhat.component / architecture labels; the NVR release comes from
    the file name, matching the reference's parseVersion."""

    type = AnalyzerType.RED_HAT_DOCKERFILE
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        if not file_path.startswith("root/buildinfo/"):
            return False
        name = file_path[len("root/buildinfo/") :]
        return "/" not in name and name.startswith("Dockerfile")

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", "replace")
        text = text.replace("\\\n", " ")  # join continuations
        env: dict[str, str] = {}
        component = arch = ""
        for m in re.finditer(
            r"^\s*(ENV|ARG)\s+(.+)$", text, re.IGNORECASE | re.MULTILINE
        ):
            for kv in _KV_RE.finditer(m.group(2)):
                env[kv.group("k").strip('"')] = kv.group("v").strip('"')
        for m in _LABEL_RE.finditer(text):
            for kv in _KV_RE.finditer(m.group("body")):
                key = kv.group("k").strip('"').lower()
                val = _expand(kv.group("v").strip('"'), env)
                if key in ("com.redhat.component", "bzcomponent"):
                    component = val
                elif key == "architecture":
                    arch = val
        if not component or not arch:
            return None
        return AnalysisResult(
            build_info={
                "Nvr": f"{component}-{_parse_version(inp.file_path)}",
                "Arch": arch,
            }
        )


def _expand(value: str, env: dict[str, str]) -> str:
    def sub(m):
        return env.get(m.group(1) or m.group(2), "")

    return re.sub(r"\$(?:\{([\w.\-]+)\}|([\w.\-]+))", sub, value)


def _parse_version(nvr: str) -> str:
    """version-release suffix of the Dockerfile name (dockerfile.go
    parseVersion): last two dash-separated fields."""
    release_i = nvr.rfind("-")
    if release_i < 0:
        return ""
    version_i = nvr[:release_i].rfind("-")
    return nvr[version_i + 1 :]


_APK_REPO_RE = re.compile(
    r"(?:https?|ftp)://[0-9A-Za-z.-]+/([A-Za-z]+)/v?([0-9A-Za-z_.-]+)/"
)


class ApkRepoAnalyzer(Analyzer):
    """``etc/apk/repositories`` -> OS repository family + newest release
    (drives alpine edge/branch advisory selection)."""

    type = AnalyzerType.APK_REPO
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path == "etc/apk/repositories"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        family = ""
        release = ""
        for line in inp.content.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if line.startswith("#"):  # a commented-out edge repo must not
                continue              # flip the advisory stream
            m = _APK_REPO_RE.search(line)
            if not m:
                continue
            new_family, new_ver = m.group(1), m.group(2)
            if family and family != new_family:
                return None  # mixed distributions: unusable signal
            family = new_family
            if not release:
                release = new_ver
            elif release == "edge" or new_ver == "edge":
                release = "edge"
            else:
                release = max(release, new_ver, key=_ver_key)
        if not family or not release:
            return None
        return AnalysisResult(
            repository={"Family": family, "Release": release}
        )


def _ver_key(v: str):
    parts = []
    for p in re.split(r"[._-]", v):
        parts.append((0, int(p)) if p.isdigit() else (1, p))
    return parts


_ELF_MAGIC = b"\x7fELF"
_MACHO_MAGICS = (b"\xfe\xed\xfa\xce", b"\xfe\xed\xfa\xcf",
                 b"\xcf\xfa\xed\xfe", b"\xce\xfa\xed\xfe")


class ExecutableAnalyzer(Analyzer):
    """sha256 digests of executable binaries (the reference feeds these to
    rekor/signature lookups — that consumer is env-blocked here, the
    collection is not).

    Opt-in (``analyzer_extra["executable_digests"]``): hashing every
    executable reads each one in full, which is pure cost until a digest
    consumer (rekor) is reachable."""

    type = AnalyzerType.EXECUTABLE
    version = 1

    def __init__(self, options):
        self._enabled = bool(
            getattr(options, "extra", {}).get("executable_digests")
        )

    def required(self, file_path: str, info) -> bool:
        return self._enabled and bool(getattr(info, "mode", 0) & 0o111)

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        head = inp.content[:4]
        if not (head == _ELF_MAGIC or head in _MACHO_MAGICS
                or head[:2] == b"MZ"):
            return None
        digest = hashlib.sha256(inp.content).hexdigest()
        return AnalysisResult(
            digests={inp.file_path: f"sha256:{digest}"}
        )


register_analyzer(ContentManifestAnalyzer)
register_analyzer(BuildinfoDockerfileAnalyzer)
register_analyzer(ApkRepoAnalyzer)
register_analyzer(ExecutableAnalyzer)
