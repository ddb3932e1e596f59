"""SBOM decoding into BlobInfo (ref: pkg/sbom/io/decode.go).

CycloneDX JSON and SPDX (JSON + tag-value) documents decode into the same
normalized BlobInfo the analyzers produce, so the scan side is format-
agnostic (ref: pkg/fanal/artifact/sbom/sbom.go:40-96).
"""

from __future__ import annotations

import json

from trivy_tpu_torch import purl as purl_mod
from trivy_tpu_torch.sbom import detect_format
from trivy_tpu_torch.types import Application, BlobInfo, OS, Package, PkgIdentifier


def decode(data: bytes) -> BlobInfo:
    fmt = detect_format(data)
    if fmt == "cyclonedx":
        return decode_cyclonedx(json.loads(data))
    if fmt == "attest-cyclonedx":
        doc = json.loads(data)
        return decode_cyclonedx(doc.get("predicate", {}))
    if fmt == "spdx-json":
        return decode_spdx(json.loads(data))
    if fmt == "spdx-tv":
        return decode_spdx_tv(data.decode("utf-8", "replace"))
    raise ValueError("unrecognized SBOM format")


def _purl_to_pkg(purl_str: str, version: str = "", name: str = "") -> tuple[str, Package] | None:
    """-> (app_type, Package) or None for OS/unsupported purls."""
    try:
        p = purl_mod.PackageURL.parse(purl_str)
    except ValueError:
        return None
    app_type = purl_mod.PURL_TO_APP.get(p.type)
    if p.type in ("apk", "deb", "rpm"):
        # OS purls: namespace is the distro family, not part of the name
        pkg = Package(
            name=name or p.name,
            version=version or p.version,
            identifier=PkgIdentifier(purl=purl_str),
        )
        pkg.arch = p.qualifiers.get("arch", "")
        pkg.epoch = int(p.qualifiers.get("epoch", 0) or 0)
        pkg.src_name = p.qualifiers.get("upstream", "")
        return ("__os__:" + p.qualifiers.get("distro", ""), pkg)
    if app_type is None:
        return None
    pkg = Package(
        name=name or purl_mod.to_package_name(p),
        version=version or p.version,
        identifier=PkgIdentifier(purl=purl_str),
    )
    return (app_type, pkg)


def decode_cyclonedx(doc: dict) -> BlobInfo:
    blob = BlobInfo()
    apps: dict[str, Application] = {}
    os_pkgs: list[Package] = []
    distro = ""
    pkg_by_ref: dict[str, Package] = {}
    for comp in doc.get("components", []) or []:
        ctype = comp.get("type", "")
        if ctype == "operating-system":
            blob.os = OS(family=comp.get("name", ""), name=comp.get("version", ""))
            continue
        if ctype not in ("library", "application", "framework", ""):
            continue
        purl_str = comp.get("purl", "")
        if not purl_str:
            continue
        decoded = _purl_to_pkg(purl_str, comp.get("version", ""))
        if decoded is None:
            continue
        app_type, pkg = decoded
        pkg.licenses = [
            l.get("license", {}).get("id") or l.get("license", {}).get("name", "")
            for l in comp.get("licenses", []) or []
            if isinstance(l, dict)
        ]
        pkg.licenses = [x for x in pkg.licenses if x]
        pkg_by_ref[comp.get("bom-ref", "") or purl_str] = pkg
        if app_type.startswith("__os__:"):
            distro = distro or app_type.split(":", 1)[1]
            os_pkgs.append(pkg)
        else:
            apps.setdefault(app_type, Application(type=app_type)).packages.append(pkg)
    # dependency graph round-trip: dependsOn refs -> package "name@version"
    # IDs (ref: pkg/sbom/io/decode.go)
    for dep in doc.get("dependencies", []) or []:
        src = pkg_by_ref.get(dep.get("ref", ""))
        if src is None:
            continue
        src.depends_on = sorted(
            {
                f"{t.name}@{t.version}"
                for r in dep.get("dependsOn", []) or []
                if (t := pkg_by_ref.get(r)) is not None
            }
        )
    if os_pkgs:
        from trivy_tpu_torch.types import PackageInfo

        blob.package_infos = [PackageInfo(packages=os_pkgs)]
        if blob.os is None and distro and "-" in distro:
            family, _, name = distro.partition("-")
            blob.os = OS(family=family, name=name)
    blob.applications = [apps[k] for k in sorted(apps)]
    return blob


def decode_spdx(doc: dict) -> BlobInfo:
    blob = BlobInfo()
    apps: dict[str, Application] = {}
    os_pkgs: list[Package] = []
    distro = ""
    for sp in doc.get("packages", []) or []:
        purl_str = ""
        for ref in sp.get("externalRefs", []) or []:
            if ref.get("referenceType") == "purl":
                purl_str = ref.get("referenceLocator", "")
                break
        if not purl_str:
            continue
        decoded = _purl_to_pkg(purl_str, sp.get("versionInfo", ""))
        if decoded is None:
            continue
        app_type, pkg = decoded
        lic = sp.get("licenseConcluded") or sp.get("licenseDeclared") or ""
        if lic and lic not in ("NOASSERTION", "NONE"):
            pkg.licenses = [lic]
        if app_type.startswith("__os__:"):
            distro = distro or app_type.split(":", 1)[1]
            os_pkgs.append(pkg)
        else:
            apps.setdefault(app_type, Application(type=app_type)).packages.append(pkg)
    if os_pkgs:
        from trivy_tpu_torch.types import PackageInfo

        blob.package_infos = [PackageInfo(packages=os_pkgs)]
        # SPDX has no operating-system component; recover the OS identity
        # from the purl distro qualifier so OS detection still runs
        if blob.os is None and distro and "-" in distro:
            family, _, name = distro.partition("-")
            blob.os = OS(family=family, name=name)
    blob.applications = [apps[k] for k in sorted(apps)]
    return blob


def decode_spdx_tv(text: str) -> BlobInfo:
    """Minimal SPDX tag-value decoding: PackageName/PackageVersion/
    ExternalRef purl triplets."""
    blob = BlobInfo()
    apps: dict[str, Application] = {}
    name = version = ""
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("PackageName:"):
            name = line.split(":", 1)[1].strip()
            version = ""
        elif line.startswith("PackageVersion:"):
            version = line.split(":", 1)[1].strip()
        elif line.startswith("ExternalRef:") and "purl" in line:
            purl_str = line.split()[-1]
            decoded = _purl_to_pkg(purl_str, version, name)
            if decoded:
                app_type, pkg = decoded
                if not app_type.startswith("__os__:"):
                    apps.setdefault(app_type, Application(type=app_type)).packages.append(pkg)
    blob.applications = [apps[k] for k in sorted(apps)]
    return blob
