"""Report types of the secret, license, vulnerability and misconfiguration
scans.

The subset of ``trivy_tpu.types`` that those scans produce: secret findings
and the per-file ``Secret``; license findings, the per-file ``LicenseFile``
and the report's ``DetectedLicense``; packages, applications, the OS, the
per-file ``Misconfiguration`` with its ``MisconfResult`` checks, the
``BlobInfo`` and its merged ``ArtifactDetail``, and the
``DetectedVulnerability``; the per-target ``Result`` and the top-level
``Report``. Their ``to_dict`` forms use the same JSON field names
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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Line":
        return cls(**d)


@dataclass
class Code:
    lines: list[Line] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {"lines": [l.to_dict() for l in self.lines]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Code":
        return cls(lines=[Line.from_dict(x) for x in d.get("lines", [])])


@dataclass
class MisconfResult:
    """One policy evaluation result (ref: types.MisconfResult)."""

    id: str
    avd_id: str = ""
    type: str = ""
    title: str = ""
    description: str = ""
    message: str = ""
    namespace: str = ""
    query: str = ""
    resolution: str = ""
    severity: str = "UNKNOWN"
    primary_url: str = ""
    references: list[str] = field(default_factory=list)
    status: str = "FAIL"  # PASS | FAIL | EXCEPTION
    start_line: int = 0
    end_line: int = 0
    resource: str = ""
    provider: str = ""
    service: str = ""
    code: Code = field(default_factory=Code)

    def to_dict(self) -> dict[str, Any]:
        return {
            "ID": self.id,
            "AVDID": self.avd_id,
            "Type": self.type,
            "Title": self.title,
            "Description": self.description,
            "Message": self.message,
            "Namespace": self.namespace,
            "Query": self.query,
            "Resolution": self.resolution,
            "Severity": self.severity,
            "PrimaryURL": self.primary_url,
            "References": list(self.references),
            "Status": self.status,
            "CauseMetadata": {
                "StartLine": self.start_line,
                "EndLine": self.end_line,
                "Resource": self.resource,
                "Provider": self.provider,
                "Service": self.service,
                "Code": self.code.to_dict(),
            },
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MisconfResult":
        cm = d.get("CauseMetadata", {}) or {}
        return cls(
            id=d.get("ID", ""),
            avd_id=d.get("AVDID", ""),
            type=d.get("Type", ""),
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            message=d.get("Message", ""),
            namespace=d.get("Namespace", ""),
            query=d.get("Query", ""),
            resolution=d.get("Resolution", ""),
            severity=d.get("Severity", "UNKNOWN"),
            primary_url=d.get("PrimaryURL", ""),
            references=list(d.get("References", []) or []),
            status=d.get("Status", "FAIL"),
            start_line=cm.get("StartLine", 0),
            end_line=cm.get("EndLine", 0),
            resource=cm.get("Resource", ""),
            provider=cm.get("Provider", ""),
            service=cm.get("Service", ""),
            code=Code.from_dict(cm.get("Code", {}) or {}),
        )


@dataclass
class Misconfiguration:
    """The check results of one configuration file (ref:
    pkg/fanal/types/misconf.go Misconfiguration)."""

    file_type: str = ""
    file_path: str = ""
    successes: list[MisconfResult] = field(default_factory=list)
    failures: list[MisconfResult] = field(default_factory=list)
    layer: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "FileType": self.file_type,
            "FilePath": self.file_path,
            "Successes": [r.to_dict() for r in self.successes],
            "Failures": [r.to_dict() for r in self.failures],
            "Layer": self.layer,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Misconfiguration":
        return cls(
            file_type=d.get("FileType", ""),
            file_path=d.get("FilePath", ""),
            successes=[MisconfResult.from_dict(x) for x in d.get("Successes", [])],
            failures=[MisconfResult.from_dict(x) for x in d.get("Failures", [])],
            layer=d.get("Layer", ""),
        )


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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SecretFinding":
        return cls(
            rule_id=d["RuleID"],
            category=d.get("Category", ""),
            severity=d.get("Severity", "UNKNOWN"),
            title=d.get("Title", ""),
            start_line=d.get("StartLine", 0),
            end_line=d.get("EndLine", 0),
            match=d.get("Match", ""),
            code=Code.from_dict(d.get("Code", {})),
            layer=d.get("Layer", ""),
        )


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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Secret":
        return cls(
            file_path=d["FilePath"],
            findings=[SecretFinding.from_dict(x) for x in d.get("Findings", [])],
        )


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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LicenseFinding":
        return cls(
            name=d.get("Name", ""),
            confidence=d.get("Confidence", 1.0),
            link=d.get("Link", ""),
            category=d.get("Category", ""),
            severity=d.get("Severity", "UNKNOWN"),
        )


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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LicenseFile":
        return cls(
            type=d.get("Type", ""),
            file_path=d.get("FilePath", ""),
            pkg_name=d.get("PkgName", ""),
            findings=[LicenseFinding.from_dict(x) for x in d.get("Findings", [])],
            layer=d.get("Layer", ""),
        )


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

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DetectedLicense":
        return cls(
            severity=d.get("Severity", "UNKNOWN"),
            category=d.get("Category", ""),
            pkg_name=d.get("PkgName", ""),
            file_path=d.get("FilePath", ""),
            name=d.get("Name", ""),
            text=d.get("Text", ""),
            confidence=d.get("Confidence", 1.0),
            link=d.get("Link", ""),
        )


@dataclass
class PkgIdentifier:
    purl: str = ""
    uid: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {"PURL": self.purl, "UID": self.uid}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PkgIdentifier":
        return cls(purl=d.get("PURL", ""), uid=d.get("UID", ""))


@dataclass
class Package:
    """A software package (OS or language ecosystem).

    Subset of the reference's ``types.Package`` (ref: pkg/fanal/types/artifact.go)
    sufficient for detection: identity, version triple (epoch/version/release
    for rpm-style), source package for OS advisories, relationships and
    dependency edges for SBOM graphs.
    """

    name: str
    version: str
    id: str = ""
    release: str = ""
    epoch: int = 0
    arch: str = ""
    src_name: str = ""
    src_version: str = ""
    src_release: str = ""
    src_epoch: int = 0
    licenses: list[str] = field(default_factory=list)
    file_path: str = ""
    dev: bool = False
    indirect: bool = False
    relationship: str = ""  # root|workspace|direct|indirect
    depends_on: list[str] = field(default_factory=list)
    identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    layer: str = ""
    locations: list[dict[str, int]] = field(default_factory=list)  # [{"StartLine":..,"EndLine":..}]
    maintainer: str = ""  # vendor for rpm packages
    modularitylabel: str = ""  # RedHat module stream, e.g. nodejs:10:...
    digest: str = ""  # e.g. md5:<sigmd5> for rpm

    def to_dict(self) -> dict[str, Any]:
        return {
            "ID": self.id,
            "Name": self.name,
            "Version": self.version,
            "Release": self.release,
            "Epoch": self.epoch,
            "Arch": self.arch,
            "SrcName": self.src_name,
            "SrcVersion": self.src_version,
            "SrcRelease": self.src_release,
            "SrcEpoch": self.src_epoch,
            "Licenses": list(self.licenses),
            "FilePath": self.file_path,
            "Dev": self.dev,
            "Indirect": self.indirect,
            "Relationship": self.relationship,
            "DependsOn": list(self.depends_on),
            "Identifier": self.identifier.to_dict(),
            "Layer": self.layer,
            "Locations": list(self.locations),
            "Maintainer": self.maintainer,
            "Modularitylabel": self.modularitylabel,
            "Digest": self.digest,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Package":
        return cls(
            id=d.get("ID", ""),
            name=d.get("Name", ""),
            version=d.get("Version", ""),
            release=d.get("Release", ""),
            epoch=d.get("Epoch", 0),
            arch=d.get("Arch", ""),
            src_name=d.get("SrcName", ""),
            src_version=d.get("SrcVersion", ""),
            src_release=d.get("SrcRelease", ""),
            src_epoch=d.get("SrcEpoch", 0),
            licenses=list(d.get("Licenses", []) or []),
            file_path=d.get("FilePath", ""),
            dev=d.get("Dev", False),
            indirect=d.get("Indirect", False),
            relationship=d.get("Relationship", ""),
            depends_on=list(d.get("DependsOn", []) or []),
            identifier=PkgIdentifier.from_dict(d.get("Identifier", {}) or {}),
            layer=d.get("Layer", ""),
            locations=list(d.get("Locations", []) or []),
            maintainer=d.get("Maintainer", ""),
            modularitylabel=d.get("Modularitylabel", ""),
            digest=d.get("Digest", ""),
        )


@dataclass
class PackageInfo:
    """OS packages found under one path (e.g. var/lib/dpkg/status)."""

    file_path: str = ""
    packages: list[Package] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {"FilePath": self.file_path, "Packages": [p.to_dict() for p in self.packages]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PackageInfo":
        return cls(
            file_path=d.get("FilePath", ""),
            packages=[Package.from_dict(x) for x in d.get("Packages", [])],
        )


@dataclass
class Application:
    """Language-ecosystem packages from one lockfile/binary (ref: types.Application)."""

    type: str  # ecosystem type, e.g. "npm", "pip", "gomod"
    file_path: str = ""
    packages: list[Package] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "Type": self.type,
            "FilePath": self.file_path,
            "Packages": [p.to_dict() for p in self.packages],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Application":
        return cls(
            type=d.get("Type", ""),
            file_path=d.get("FilePath", ""),
            packages=[Package.from_dict(x) for x in d.get("Packages", [])],
        )


@dataclass
class OS:
    family: str = ""
    name: str = ""
    eosl: bool = False
    extended: bool = False  # e.g. ubuntu ESM

    def to_dict(self) -> dict[str, Any]:
        return {"Family": self.family, "Name": self.name, "Eosl": self.eosl, "Extended": self.extended}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "OS":
        return cls(
            family=d.get("Family", ""),
            name=d.get("Name", ""),
            eosl=d.get("Eosl", False),
            extended=d.get("Extended", False),
        )

    def merge(self, other: "OS") -> "OS":
        """Later layers win, but never blank out earlier values (applier semantics)."""
        return OS(
            family=other.family or self.family,
            name=other.name or self.name,
            eosl=other.eosl or self.eosl,
            extended=other.extended or self.extended,
        )


@dataclass
class BlobInfo:
    """The analysis result of one blob (ref: pkg/fanal/types BlobInfo): the
    fields a filesystem scan, an image layer or an SBOM fills. ``diff_id``
    is the layer its findings carry; whiteouts and opaque dirs delete what
    lower layers put at those paths. An image layer's blob is cached in its
    ``to_dict`` form, the JAX package's without the custom-resource list."""

    os: OS | None = None
    repository: dict[str, str] | None = None  # {"Family":..., "Release":...}
    # Red Hat build metadata: {"ContentSets": [...]} or {"Nvr":..., "Arch":...}
    build_info: dict | None = None
    digests: dict[str, str] = field(default_factory=dict)  # executable sha256s
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    misconfigurations: list[Misconfiguration] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)
    diff_id: str = ""
    created_by: str = ""
    opaque_dirs: list[str] = field(default_factory=list)
    whiteout_files: list[str] = field(default_factory=list)
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> dict[str, Any]:
        return {
            "SchemaVersion": self.schema_version,
            "OS": self.os.to_dict() if self.os else None,
            "Repository": self.repository,
            "BuildInfo": self.build_info,
            "Digests": dict(self.digests) or None,
            "PackageInfos": [p.to_dict() for p in self.package_infos],
            "Applications": [a.to_dict() for a in self.applications],
            "Misconfigurations": [m.to_dict() for m in self.misconfigurations],
            "Secrets": [s.to_dict() for s in self.secrets],
            "Licenses": [l.to_dict() for l in self.licenses],
            "DiffID": self.diff_id,
            "CreatedBy": self.created_by,
            "OpaqueDirs": list(self.opaque_dirs),
            "WhiteoutFiles": list(self.whiteout_files),
        }

    def to_wire_dict(self) -> dict[str, Any]:
        """:meth:`to_dict` with the JAX blob's one section the port has no
        analyzer for (custom resources), always empty: the blob a JAX client
        or replica sends, whose content key is the JAX key."""
        return {**self.to_dict(), "CustomResources": []}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BlobInfo":
        return cls(
            schema_version=d.get("SchemaVersion", SCHEMA_VERSION),
            os=OS.from_dict(d["OS"]) if d.get("OS") else None,
            repository=d.get("Repository"),
            build_info=d.get("BuildInfo"),
            digests=dict(d.get("Digests") or {}),
            package_infos=[PackageInfo.from_dict(x) for x in d.get("PackageInfos", []) or []],
            applications=[Application.from_dict(x) for x in d.get("Applications", []) or []],
            misconfigurations=[Misconfiguration.from_dict(x)
                               for x in d.get("Misconfigurations", []) or []],
            secrets=[Secret.from_dict(x) for x in d.get("Secrets", []) or []],
            licenses=[LicenseFile.from_dict(x) for x in d.get("Licenses", []) or []],
            diff_id=d.get("DiffID", ""),
            created_by=d.get("CreatedBy", ""),
            opaque_dirs=list(d.get("OpaqueDirs", []) or []),
            whiteout_files=list(d.get("WhiteoutFiles", []) or []),
        )


@dataclass
class ArtifactDetail:
    """Merged view of the blobs (ref: pkg/fanal/types ArtifactDetail)."""

    os: OS | None = None
    repository: dict[str, str] | None = None
    build_info: dict | None = None
    digests: dict[str, str] = field(default_factory=dict)
    packages: list[Package] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    misconfigurations: list[Misconfiguration] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list[LicenseFile] = field(default_factory=list)


@dataclass
class DetectedVulnerability:
    """A matched advisory against an installed package (ref: types.DetectedVulnerability)."""

    vulnerability_id: str
    pkg_name: str
    installed_version: str
    fixed_version: str = ""
    status: str = ""  # fixed | affected | will_not_fix | end_of_life ...
    pkg_id: str = ""
    pkg_path: str = ""
    pkg_identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    severity: str = "UNKNOWN"
    severity_source: str = ""
    title: str = ""
    description: str = ""
    references: list[str] = field(default_factory=list)
    cvss: dict[str, Any] = field(default_factory=dict)
    cwe_ids: list[str] = field(default_factory=list)
    primary_url: str = ""
    data_source: dict[str, str] = field(default_factory=dict)
    layer: str = ""
    published_date: str = ""
    last_modified_date: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "VulnerabilityID": self.vulnerability_id,
            "PkgID": self.pkg_id,
            "PkgName": self.pkg_name,
            "PkgPath": self.pkg_path,
            "PkgIdentifier": self.pkg_identifier.to_dict(),
            "InstalledVersion": self.installed_version,
            "FixedVersion": self.fixed_version,
            "Status": self.status,
            "Severity": self.severity,
            "SeveritySource": self.severity_source,
            "Title": self.title,
            "Description": self.description,
            "References": list(self.references),
            "CVSS": dict(self.cvss),
            "CweIDs": list(self.cwe_ids),
            "PrimaryURL": self.primary_url,
            "DataSource": dict(self.data_source),
            "Layer": self.layer,
            "PublishedDate": self.published_date,
            "LastModifiedDate": self.last_modified_date,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DetectedVulnerability":
        return cls(
            vulnerability_id=d.get("VulnerabilityID", ""),
            pkg_id=d.get("PkgID", ""),
            pkg_name=d.get("PkgName", ""),
            pkg_path=d.get("PkgPath", ""),
            pkg_identifier=PkgIdentifier.from_dict(d.get("PkgIdentifier", {}) or {}),
            installed_version=d.get("InstalledVersion", ""),
            fixed_version=d.get("FixedVersion", ""),
            status=d.get("Status", ""),
            severity=d.get("Severity", "UNKNOWN"),
            severity_source=d.get("SeveritySource", ""),
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            references=list(d.get("References", []) or []),
            cvss=dict(d.get("CVSS", {}) or {}),
            cwe_ids=list(d.get("CweIDs", []) or []),
            primary_url=d.get("PrimaryURL", ""),
            data_source=dict(d.get("DataSource", {}) or {}),
            layer=d.get("Layer", ""),
            published_date=d.get("PublishedDate", ""),
            last_modified_date=d.get("LastModifiedDate", ""),
        )


@dataclass
class ModifiedFinding:
    """A finding suppressed after the scan by an ignore file or an ignore
    policy (ref: pkg/types/finding.go ModifiedFinding)."""

    type: str = "vulnerability"
    status: str = ""  # ignored
    statement: str = ""
    source: str = ""
    finding: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "Type": self.type,
            "Status": self.status,
            "Statement": self.statement,
            "Source": self.source,
            "Finding": dict(self.finding),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModifiedFinding":
        return cls(
            type=d.get("Type", "vulnerability"),
            status=d.get("Status", ""),
            statement=d.get("Statement", ""),
            source=d.get("Source", ""),
            finding=d.get("Finding", {}) or {},
        )


@dataclass
class Result:
    """One report section: the secret findings of one target file, the
    checks of one configuration file, a license section, or the
    vulnerabilities (and, with ``--list-all-pkgs``, the packages) of the OS
    packages or of one application."""

    target: str
    cls: str = ResultClass.SECRET.value
    type: str = ""
    packages: list[Package] = field(default_factory=list)
    vulnerabilities: list[DetectedVulnerability] = field(default_factory=list)
    misconfigurations: list[MisconfResult] = field(default_factory=list)
    secrets: list[SecretFinding] = field(default_factory=list)
    licenses: list[DetectedLicense] = field(default_factory=list)
    modified_findings: list[ModifiedFinding] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"Target": self.target, "Class": self.cls, "Type": self.type}
        if self.packages:
            d["Packages"] = [p.to_dict() for p in self.packages]
        if self.vulnerabilities:
            d["Vulnerabilities"] = [v.to_dict() for v in self.vulnerabilities]
        if self.misconfigurations:
            d["Misconfigurations"] = [m.to_dict() for m in self.misconfigurations]
        if self.secrets:
            d["Secrets"] = [s.to_dict() for s in self.secrets]
        if self.licenses:
            d["Licenses"] = [l.to_dict() for l in self.licenses]
        if self.modified_findings:
            d["ExperimentalModifiedFindings"] = [m.to_dict() for m in self.modified_findings]
        return d

    @classmethod
    def from_dict(cls_, d: dict[str, Any]) -> "Result":
        return cls_(
            target=d.get("Target", ""),
            cls=d.get("Class", ""),
            type=d.get("Type", ""),
            packages=[Package.from_dict(x) for x in d.get("Packages", []) or []],
            vulnerabilities=[
                DetectedVulnerability.from_dict(x) for x in d.get("Vulnerabilities", []) or []
            ],
            misconfigurations=[
                MisconfResult.from_dict(x) for x in d.get("Misconfigurations", []) or []
            ],
            secrets=[SecretFinding.from_dict(x) for x in d.get("Secrets", []) or []],
            licenses=[DetectedLicense.from_dict(x) for x in d.get("Licenses", []) or []],
            modified_findings=[
                ModifiedFinding.from_dict(x)
                for x in d.get("ExperimentalModifiedFindings", []) or []
            ],
        )

    @property
    def is_empty(self) -> bool:
        return not (self.packages or self.vulnerabilities or self.misconfigurations
                    or self.secrets or self.licenses)


@dataclass
class Report:
    """Top-level scan report (ref: pkg/types/report.go Report). ``degraded``
    is never set by the port's scans; it carries the flag of a JAX report
    that ``convert`` re-renders."""

    schema_version: int = SCHEMA_VERSION
    created_at: str = ""
    artifact_name: str = ""
    artifact_type: str = ""
    metadata: dict[str, Any] = field(default_factory=dict)
    results: list[Result] = field(default_factory=list)
    degraded: bool = False

    def to_dict(self) -> dict[str, Any]:
        out = {
            "SchemaVersion": self.schema_version,
            "CreatedAt": self.created_at,
            "ArtifactName": self.artifact_name,
            "ArtifactType": self.artifact_type,
            "Metadata": dict(self.metadata),
            "Results": [r.to_dict() for r in self.results],
        }
        if self.degraded:
            out["Degraded"] = True
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Report":
        return cls(
            schema_version=d.get("SchemaVersion", SCHEMA_VERSION),
            created_at=d.get("CreatedAt", ""),
            artifact_name=d.get("ArtifactName", ""),
            artifact_type=d.get("ArtifactType", ""),
            metadata=dict(d.get("Metadata", {}) or {}),
            results=[Result.from_dict(x) for x in d.get("Results", []) or []],
            degraded=bool(d.get("Degraded", False)),
        )
