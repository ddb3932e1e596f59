"""SBOM encoding (ref: pkg/sbom/io/encode.go, pkg/sbom/cyclonedx, pkg/sbom/spdx),
the port's copy of ``trivy_tpu/sbom/io.py``.

Encodes a scan Report into CycloneDX 1.5 JSON, SPDX 2.3 JSON, or SPDX
tag-value. Component purls are generated with the same mapping the decoder
uses, so CycloneDX output re-ingests losslessly through
``trivy_tpu_torch.sbom.decode`` (round-trip property, tested).

Serial numbers / document namespaces are derived from a content hash rather
than a random UUID so output is deterministic (the golden-test property the
reference gets from uuid.SetFakeUUID, ref: pkg/uuid/uuid.go:23-32).
"""

from __future__ import annotations

import hashlib
import json

from trivy_tpu_torch import purl as purl_mod
from trivy_tpu_torch.types import OS, Package, Report

CDX_VERSION = "1.5"
SPDX_VERSION = "SPDX-2.3"
TOOL_NAME = "trivy-tpu"


def _content_uuid(report: Report) -> str:
    h = hashlib.sha256(
        (report.artifact_name + report.artifact_type + report.created_at).encode()
    ).hexdigest()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


def _os_info(report: Report) -> OS | None:
    os_d = report.metadata.get("OS")
    return OS.from_dict(os_d) if os_d else None


def _iter_packages(report: Report):
    """(app_type, package) pairs across all results."""
    for result in report.results:
        app_type = result.type or ""
        for pkg in result.packages:
            yield result, app_type, pkg


def encode_report(report: Report, fmt: str, out, **kw) -> None:
    if fmt == "cyclonedx":
        json.dump(encode_cyclonedx(report), out, indent=2)
        out.write("\n")
    elif fmt == "spdx-json":
        json.dump(encode_spdx(report), out, indent=2)
        out.write("\n")
    elif fmt == "spdx":
        out.write(encode_spdx_tv(report))
    else:
        raise ValueError(f"unknown SBOM format: {fmt}")


# -- CycloneDX ---------------------------------------------------------------

def encode_cyclonedx(report: Report) -> dict:
    os_info = _os_info(report)
    components = []
    vulns: dict[str, dict] = {}
    if os_info is not None:
        components.append(
            {
                "bom-ref": f"os:{os_info.family}:{os_info.name}",
                "type": "operating-system",
                "name": os_info.family,
                "version": os_info.name,
            }
        )
    seen: set[str] = set()
    # package-ID -> bom-ref, for dependsOn edge resolution (the lockfile
    # edges use "name@version" IDs; ref: pkg/sbom/io/encode.go dependency
    # graph encoding)
    ref_by_id: dict[str, str] = {}
    edges_by_ref: dict[str, list[str]] = {}
    pending_edges: list[tuple[str, list[str]]] = []
    for result, app_type, pkg in _iter_packages(report):
        p = purl_mod.from_package(
            pkg, app_type, os_info if result.cls == "os-pkgs" else None
        )
        purl_str = p.to_string() if p else ""
        ref = purl_str or f"pkg:{app_type}/{pkg.name}@{pkg.version}"
        ref_by_id[pkg.id or f"{pkg.name}@{pkg.version}"] = ref
        if pkg.depends_on:
            pending_edges.append((ref, list(pkg.depends_on)))
        if ref in seen:
            continue
        seen.add(ref)
        comp = {
            "bom-ref": ref,
            "type": "library",
            "name": pkg.name,
            # full distro version string (incl. release) — matches the purl
            "version": p.version if p else pkg.version,
        }
        if purl_str:
            comp["purl"] = purl_str
        if pkg.licenses:
            comp["licenses"] = [{"license": {"name": l}} for l in pkg.licenses]
        components.append(comp)
    for ref, dep_ids in pending_edges:
        resolved = sorted(
            {ref_by_id[d] for d in dep_ids if d in ref_by_id}
        )
        if resolved:
            edges_by_ref[ref] = sorted(
                set(edges_by_ref.get(ref, [])) | set(resolved)
            )
    for result in report.results:
        for v in result.vulnerabilities:
            entry = vulns.setdefault(
                v.vulnerability_id,
                {
                    "id": v.vulnerability_id,
                    "source": {"name": v.data_source.get("Name", "")}
                    if v.data_source
                    else {},
                    "ratings": [
                        {"severity": (v.severity or "unknown").lower()}
                    ],
                    "description": v.title or "",
                    "affects": [],
                },
            )
            p = purl_mod.from_package(
                v_pkg(v),
                result.type or "",
                _os_info(report) if result.cls == "os-pkgs" else None,
            )
            entry["affects"].append(
                {"ref": p.to_string() if p else v.pkg_name}
            )
    doc = {
        "$schema": "http://cyclonedx.org/schema/bom-1.5.schema.json",
        "bomFormat": "CycloneDX",
        "specVersion": CDX_VERSION,
        "serialNumber": f"urn:uuid:{_content_uuid(report)}",
        "version": 1,
        "metadata": {
            "timestamp": report.created_at,
            "tools": {"components": [{"type": "application", "name": TOOL_NAME}]},
            "component": {
                "bom-ref": report.artifact_name,
                "type": "container" if report.artifact_type == "container_image"
                else "application",
                "name": report.artifact_name,
            },
        },
        "components": components,
    }
    if edges_by_ref:
        doc["dependencies"] = [
            {"ref": ref, "dependsOn": deps}
            for ref, deps in sorted(edges_by_ref.items())
        ]
    if vulns:
        doc["vulnerabilities"] = [vulns[k] for k in sorted(vulns)]
    return doc


def v_pkg(v):
    """Minimal package view of a DetectedVulnerability for purl building."""
    return Package(
        name=v.pkg_name,
        version=v.installed_version,
        identifier=v.pkg_identifier,
    )


# -- SPDX --------------------------------------------------------------------

def _spdx_id(name: str, version: str, i: int) -> str:
    safe = "".join(c if c.isalnum() or c in ".-" else "-" for c in f"{name}-{version}")
    return f"SPDXRef-Package-{i}-{safe}"


def _spdx_packages(report: Report):
    os_info = _os_info(report)
    out = []
    seen: set[str] = set()
    i = 0
    for result, app_type, pkg in _iter_packages(report):
        p = purl_mod.from_package(
            pkg, app_type, os_info if result.cls == "os-pkgs" else None
        )
        purl_str = p.to_string() if p else ""
        key = purl_str or f"{app_type}/{pkg.name}@{pkg.version}"
        if key in seen:
            continue
        seen.add(key)
        lic = pkg.licenses[0] if pkg.licenses else "NOASSERTION"
        entry = {
            "SPDXID": _spdx_id(pkg.name, pkg.version, i),
            "name": pkg.name,
            "versionInfo": pkg.version,
            "downloadLocation": "NOASSERTION",
            "licenseConcluded": lic,
            "licenseDeclared": lic,
        }
        if purl_str:
            entry["externalRefs"] = [
                {
                    "referenceCategory": "PACKAGE-MANAGER",
                    "referenceType": "purl",
                    "referenceLocator": purl_str,
                }
            ]
        out.append(entry)
        i += 1
    return out


def encode_spdx(report: Report) -> dict:
    packages = _spdx_packages(report)
    return {
        "spdxVersion": SPDX_VERSION,
        "dataLicense": "CC0-1.0",
        "SPDXID": "SPDXRef-DOCUMENT",
        "name": report.artifact_name,
        "documentNamespace": (
            f"https://trivy-tpu/{report.artifact_type}/{_content_uuid(report)}"
        ),
        "creationInfo": {
            "created": report.created_at,
            "creators": [f"Tool: {TOOL_NAME}"],
        },
        "packages": packages,
        "documentDescribes": [p["SPDXID"] for p in packages],
    }


def encode_spdx_tv(report: Report) -> str:
    doc = encode_spdx(report)
    lines = [
        f"SPDXVersion: {doc['spdxVersion']}",
        f"DataLicense: {doc['dataLicense']}",
        f"SPDXID: {doc['SPDXID']}",
        f"DocumentName: {doc['name']}",
        f"DocumentNamespace: {doc['documentNamespace']}",
        f"Creator: {doc['creationInfo']['creators'][0]}",
        f"Created: {doc['creationInfo']['created']}",
        "",
    ]
    for p in doc["packages"]:
        lines.append(f"PackageName: {p['name']}")
        lines.append(f"SPDXID: {p['SPDXID']}")
        lines.append(f"PackageVersion: {p['versionInfo']}")
        lines.append(f"PackageDownloadLocation: {p['downloadLocation']}")
        lines.append(f"PackageLicenseConcluded: {p['licenseConcluded']}")
        for ref in p.get("externalRefs", []):
            lines.append(
                "ExternalRef: PACKAGE-MANAGER purl " + ref["referenceLocator"]
            )
        lines.append("")
    return "\n".join(lines)
