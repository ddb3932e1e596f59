"""Report types of the secret and license scans.

The subset of ``trivy_tpu.types`` that those scans produce: secret findings
and the per-file ``Secret``; license findings, the per-file ``LicenseFile``
and the report's ``DetectedLicense``; the per-target ``Result`` and the
top-level ``Report``. Their ``to_dict`` forms use the same JSON field names
and order as the JAX package (and the reference's JSON schema), so the two
packages' reports compare byte for byte.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any

SCHEMA_VERSION = 2  # report schema version (ref: pkg/fanal/types/const.go)


class ResultClass(str, enum.Enum):
    """Result classes in a report (ref: pkg/types/report.go)."""

    OS_PKGS = "os-pkgs"
    LANG_PKGS = "lang-pkgs"
    CONFIG = "config"
    SECRET = "secret"
    LICENSE = "license"
    LICENSE_FILE = "license-file"
    CUSTOM = "custom"


class Severity(str, enum.Enum):
    """Finding severity (ref: pkg/fanal/types/severity.go ordering)."""

    UNKNOWN = "UNKNOWN"
    LOW = "LOW"
    MEDIUM = "MEDIUM"
    HIGH = "HIGH"
    CRITICAL = "CRITICAL"

    @classmethod
    def parse(cls, s: str) -> "Severity":
        try:
            return cls(s.upper())
        except ValueError:
            return cls.UNKNOWN


@dataclass
class Line:
    """One rendered source line in a finding's context window: ``is_cause``
    marks lines that contain the match, ``truncated`` lines cut to the
    display budget, ``highlighted`` the censored display form."""

    number: int
    content: str
    is_cause: bool = False
    truncated: bool = False
    highlighted: str = ""
    first_cause: bool = False
    last_cause: bool = False
    annotation: str = ""

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class Code:
    lines: list[Line] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {"lines": [l.to_dict() for l in self.lines]}


@dataclass
class SecretFinding:
    """A single secret detection (ref: pkg/fanal/types/secret.go SecretFinding)."""

    rule_id: str
    category: str
    severity: str
    title: str
    start_line: int
    end_line: int
    match: str  # censored line containing the secret
    code: Code = field(default_factory=Code)
    offset: int = 0  # byte offset of the secret within the file (not serialized)
    layer: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "RuleID": self.rule_id,
            "Category": self.category,
            "Severity": self.severity,
            "Title": self.title,
            "StartLine": self.start_line,
            "EndLine": self.end_line,
            "Match": self.match,
            "Code": self.code.to_dict(),
            "Layer": self.layer,
        }


@dataclass
class Secret:
    """All findings within one file (ref: pkg/fanal/types/secret.go Secret)."""

    file_path: str
    findings: list[SecretFinding] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "FilePath": self.file_path,
            "Findings": [f.to_dict() for f in self.findings],
        }


@dataclass
class LicenseFinding:
    """One license the classifier found in a file (ref: types.LicenseFinding)."""

    name: str
    confidence: float = 1.0
    link: str = ""
    category: str = ""
    severity: str = "UNKNOWN"

    def to_dict(self) -> dict[str, Any]:
        return {
            "Name": self.name,
            "Confidence": self.confidence,
            "Link": self.link,
            "Category": self.category,
            "Severity": self.severity,
        }


@dataclass
class LicenseFile:
    """Licenses classified from one file (ref: types.LicenseFile)."""

    type: str  # "header" | "license-file"
    file_path: str = ""
    pkg_name: str = ""
    findings: list[LicenseFinding] = field(default_factory=list)
    layer: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "Type": self.type,
            "FilePath": self.file_path,
            "PkgName": self.pkg_name,
            "Findings": [f.to_dict() for f in self.findings],
            "Layer": self.layer,
        }


@dataclass
class DetectedLicense:
    """One license in a report's license section (ref: types.DetectedLicense)."""

    severity: str = "UNKNOWN"
    category: str = ""
    pkg_name: str = ""
    file_path: str = ""
    name: str = ""
    text: str = ""
    confidence: float = 1.0
    link: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "Severity": self.severity,
            "Category": self.category,
            "PkgName": self.pkg_name,
            "FilePath": self.file_path,
            "Name": self.name,
            "Text": self.text,
            "Confidence": self.confidence,
            "Link": self.link,
        }


@dataclass
class Result:
    """One report section: the secret findings of one target file, or a
    license section."""

    target: str
    cls: str = ResultClass.SECRET.value
    type: str = ""
    secrets: list[SecretFinding] = field(default_factory=list)
    licenses: list[DetectedLicense] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"Target": self.target, "Class": self.cls, "Type": self.type}
        if self.secrets:
            d["Secrets"] = [s.to_dict() for s in self.secrets]
        if self.licenses:
            d["Licenses"] = [l.to_dict() for l in self.licenses]
        return d


@dataclass
class Report:
    """Top-level scan report (ref: pkg/types/report.go Report)."""

    schema_version: int = SCHEMA_VERSION
    created_at: str = ""
    artifact_name: str = ""
    artifact_type: str = ""
    metadata: dict[str, Any] = field(default_factory=dict)
    results: list[Result] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "SchemaVersion": self.schema_version,
            "CreatedAt": self.created_at,
            "ArtifactName": self.artifact_name,
            "ArtifactType": self.artifact_type,
            "Metadata": dict(self.metadata),
            "Results": [r.to_dict() for r in self.results],
        }
