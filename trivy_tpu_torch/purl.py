"""package-url (purl) mapping (ref: pkg/purl/purl.go:49-185).

``pkg:<type>/<namespace>/<name>@<version>?<qualifiers>`` ↔ internal
Package/Application types, including distro/epoch qualifiers for OS
packages and the purl-type ↔ application-type mapping both ways.
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass, field


@dataclass
class PackageURL:
    type: str
    name: str
    namespace: str = ""
    version: str = ""
    qualifiers: dict[str, str] = field(default_factory=dict)
    subpath: str = ""

    def to_string(self) -> str:
        parts = ["pkg:", self.type, "/"]
        if self.namespace:
            parts.append(
                "/".join(urllib.parse.quote(p, safe="") for p in self.namespace.split("/"))
                + "/"
            )
        parts.append(urllib.parse.quote(self.name, safe=""))
        if self.version:
            parts.append("@" + urllib.parse.quote(self.version, safe=""))
        if self.qualifiers:
            q = "&".join(
                f"{k}={urllib.parse.quote(str(v), safe='')}"
                for k, v in sorted(self.qualifiers.items())
            )
            parts.append("?" + q)
        if self.subpath:
            parts.append("#" + self.subpath)
        return "".join(parts)

    @classmethod
    def parse(cls, s: str) -> "PackageURL":
        if not s.startswith("pkg:"):
            raise ValueError(f"not a purl: {s}")
        rest = s[4:].lstrip("/")
        subpath = ""
        if "#" in rest:
            rest, subpath = rest.rsplit("#", 1)
        qualifiers: dict[str, str] = {}
        if "?" in rest:
            rest, q = rest.rsplit("?", 1)
            for kv in q.split("&"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    qualifiers[k] = urllib.parse.unquote(v)
        version = ""
        if "@" in rest:
            rest, version = rest.rsplit("@", 1)
            version = urllib.parse.unquote(version)
        segs = rest.split("/")
        type_ = segs[0]
        name = urllib.parse.unquote(segs[-1])
        namespace = "/".join(urllib.parse.unquote(p) for p in segs[1:-1])
        return cls(
            type=type_,
            namespace=namespace,
            name=name,
            version=version,
            qualifiers=qualifiers,
            subpath=subpath,
        )


# purl type -> internal application type (ref: purl.go LangType mapping)
PURL_TO_APP = {
    "npm": "node-pkg",
    "pypi": "python-pkg",
    "gem": "gemspec",
    "maven": "jar",
    "golang": "gobinary",
    "cargo": "rust-binary",
    "composer": "composer-vendor",
    "nuget": "nuget",
    "conan": "conan-lock",
    "hex": "mix-lock",
    "pub": "pubspec-lock",
    "swift": "swift",
    "cocoapods": "cocoapods",
    "bitnami": "bitnami",
    "k8s": "k8s",
}
APP_TO_PURL = {
    "npm": "npm", "yarn": "npm", "pnpm": "npm", "node-pkg": "npm", "bun": "npm",
    "jar": "maven", "pom": "maven", "gradle-lockfile": "maven", "sbt-lockfile": "maven",
    "pip": "pypi", "pipenv": "pypi", "poetry": "pypi", "uv": "pypi", "python-pkg": "pypi",
    "bundler": "gem", "gemspec": "gem",
    "cargo": "cargo", "rust-binary": "cargo",
    "composer": "composer", "composer-vendor": "composer",
    "gomod": "golang", "gobinary": "golang",
    "conan-lock": "conan", "mix-lock": "hex", "pubspec-lock": "pub",
    "swift": "swift", "cocoapods": "cocoapods", "nuget": "nuget",
    "dotnet-core": "nuget", "bitnami": "bitnami", "k8s": "k8s",
}

_OS_TYPES = {"apk", "deb", "rpm"}


def from_package(pkg, app_type: str = "", os_info=None) -> PackageURL | None:
    """Internal Package -> purl (ref: purl.go New)."""
    if os_info is not None:
        family = os_info.family
        ptype = {"alpine": "apk", "debian": "deb", "ubuntu": "deb"}.get(family, "rpm")
        qualifiers = {}
        if pkg.arch:
            qualifiers["arch"] = pkg.arch
        if pkg.epoch:
            qualifiers["epoch"] = str(pkg.epoch)
        qualifiers["distro"] = f"{family}-{os_info.name}"
        # purl version carries the full distro version string incl. release
        # (ref: purl.go utilVersion: "<version>-<release>", epoch qualifier)
        version = pkg.version
        if pkg.release:
            version = f"{version}-{pkg.release}"
        return PackageURL(
            type=ptype,
            namespace=family,
            name=pkg.name,
            version=version,
            qualifiers=qualifiers,
        )
    ptype = APP_TO_PURL.get(app_type)
    if ptype is None:
        return None
    namespace, name = "", pkg.name
    if ptype == "maven" and ":" in name:
        namespace, name = name.split(":", 1)
    elif ptype in ("npm", "golang", "composer") and "/" in name:
        namespace, name = name.rsplit("/", 1)
    return PackageURL(type=ptype, namespace=namespace, name=name, version=pkg.version)


def to_package_name(purl: PackageURL) -> str:
    if purl.type == "maven" and purl.namespace:
        return f"{purl.namespace}:{purl.name}"
    if purl.namespace:
        return f"{purl.namespace}/{purl.name}"
    return purl.name
