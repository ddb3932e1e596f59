"""Maven pom.xml resolution.

Covers the offline-resolvable core of the reference's ~2,500-LoC pom
parser (ref: pkg/dependency/parser/java/pom/parse.go): parent-chain
loading via relativePath, property interpolation (incl. project.* builtins
and transitive properties), dependencyManagement version/scope inheritance,
and dependency merging across the parent chain (every scope except test
reports as a regular package; test marks dev). Remote-repository
resolution needs egress and is out of scope — unresolved versions are
dropped rather than guessed.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.types import Package, PkgIdentifier

logger = log.logger("dependency:pom")

_PROP = re.compile(r"\$\{([^}]+)\}")
MAX_PARENT_DEPTH = 16


def _strip_ns(tag: str) -> str:
    return tag.split("}")[-1]


def _to_dict(el) -> dict:
    out: dict = {}
    for child in el:
        tag = _strip_ns(child.tag)
        if len(child):
            val = _to_dict(child)
        else:
            val = (child.text or "").strip()
        if tag in out:
            prev = out[tag]
            if not isinstance(prev, list):
                out[tag] = [prev]
            out[tag].append(val)
        else:
            out[tag] = val
    return out


@dataclass
class Pom:
    group: str = ""
    artifact: str = ""
    version: str = ""
    packaging: str = "jar"
    properties: dict = field(default_factory=dict)
    dep_management: list = field(default_factory=list)  # dicts
    dependencies: list = field(default_factory=list)  # dicts
    parent_gav: tuple | None = None
    parent_relative: str = ""


def parse_pom_xml(content: bytes) -> Pom | None:
    try:
        root = ET.fromstring(content)
    except ET.ParseError:
        return None
    doc = _to_dict(root)
    pom = Pom()
    parent = doc.get("parent") or {}
    if isinstance(parent, dict) and parent.get("artifactId"):
        pom.parent_gav = (
            parent.get("groupId", ""),
            parent.get("artifactId", ""),
            parent.get("version", ""),
        )
        pom.parent_relative = parent.get("relativePath") or "../pom.xml"
    pom.group = doc.get("groupId") or (pom.parent_gav[0] if pom.parent_gav else "")
    pom.artifact = doc.get("artifactId", "")
    pom.version = doc.get("version") or (pom.parent_gav[2] if pom.parent_gav else "")
    pom.packaging = doc.get("packaging", "jar") or "jar"
    props = doc.get("properties") or {}
    if isinstance(props, dict):
        pom.properties = {
            k: v for k, v in props.items() if isinstance(v, str)
        }

    def dep_list(node) -> list:
        if not isinstance(node, dict):
            return []
        deps = node.get("dependency")
        if deps is None:
            return []
        return deps if isinstance(deps, list) else [deps]

    dm = doc.get("dependencyManagement") or {}
    pom.dep_management = dep_list(dm.get("dependencies") if isinstance(dm, dict) else None)
    pom.dependencies = dep_list(doc.get("dependencies"))
    return pom


class Resolver:
    """Resolves one pom with its on-disk parent chain.

    ``loader(path)`` returns pom bytes for a filesystem path or None —
    the analyzer binds it to the scan tree so image scans work too.
    """

    def __init__(self, loader):
        self.loader = loader

    def resolve(self, content: bytes, pom_path: str) -> list[Package]:
        chain = self._parent_chain(content, pom_path)
        if not chain:
            return []
        props: dict = {}
        dep_mgmt: dict[tuple, dict] = {}
        # parents first so the child wins on conflicts
        for pom in reversed(chain):
            props.update(pom.properties)
        child = chain[0]
        props.setdefault("project.groupId", child.group)
        props.setdefault("project.version", child.version)
        props.setdefault("project.artifactId", child.artifact)
        props.setdefault("pom.groupId", child.group)
        props.setdefault("pom.version", child.version)

        def interp(v: str, depth: int = 0) -> str:
            if not v or depth > 8:
                return v or ""
            return _PROP.sub(lambda m: interp(props.get(m.group(1), ""), depth + 1), v)

        for pom in reversed(chain):
            for d in pom.dep_management:
                self._add_mgmt(dep_mgmt, d, interp, pom_path)
        pkgs: dict[tuple, Package] = {}
        for pom in reversed(chain):
            for d in pom.dependencies:
                if not isinstance(d, dict):
                    continue
                g = interp(d.get("groupId", ""))
                a = interp(d.get("artifactId", ""))
                if not g or not a:
                    continue
                v = interp(d.get("version", ""))
                scope = interp(d.get("scope", ""))
                managed = dep_mgmt.get((g, a), {})
                if not v:
                    v = managed.get("version", "")
                if not scope:
                    scope = managed.get("scope", "")
                # provided/system deps still ship in practice often enough
                # that dropping their CVEs silently is the worse error —
                # they are reported like compile deps
                if not v:
                    logger.debug("%s: unresolved version for %s:%s", pom_path, g, a)
                    continue
                name = f"{g}:{a}"
                pkgs[(g, a)] = Package(
                    name=name,
                    version=v,
                    dev=scope == "test",
                    identifier=PkgIdentifier(purl=f"pkg:maven/{g}/{a}@{v}"),
                )
        out = sorted(pkgs.values(), key=lambda p: (p.name, p.version))
        for p in out:
            p.id = p.id or f"{p.name}@{p.version}"
            p.relationship = "direct"
        # root node: the pom's own GAV with edges to every resolved direct
        # dependency (the offline-derivable slice of the reference's module
        # graph, pkg/dependency/parser/java/pom + relationship.go)
        g = interp(child.group) or props.get("project.groupId", "")
        a = child.artifact
        v = interp(child.version)
        if a and out:
            root = Package(
                name=f"{g}:{a}" if g else a,
                version=v,
                relationship="root",
                identifier=PkgIdentifier(
                    purl=f"pkg:maven/{g}/{a}@{v}" if g and v else ""
                ),
            )
            root.id = f"{root.name}@{v}" if v else root.name
            root.depends_on = sorted(p.id for p in out)
            out.insert(0, root)
        return out

    def _add_mgmt(self, dep_mgmt: dict, d: dict, interp, pom_path: str) -> None:
        if not isinstance(d, dict):
            return
        g = interp(d.get("groupId", ""))
        a = interp(d.get("artifactId", ""))
        scope = interp(d.get("scope", ""))
        if scope == "import":
            # import-scope BOMs resolve by GAV from a remote repository,
            # which needs egress — skipped, like every other remote lookup
            logger.debug(
                "%s: import-scope BOM %s:%s not resolvable offline",
                pom_path, g, a,
            )
            return
        if g and a:
            dep_mgmt[(g, a)] = {
                "version": interp(d.get("version", "")),
                "scope": scope,
            }

    def _parent_chain(self, content: bytes, pom_path: str) -> list[Pom]:
        chain: list[Pom] = []
        cur_content, cur_path = content, pom_path
        for _ in range(MAX_PARENT_DEPTH):
            pom = parse_pom_xml(cur_content)
            if pom is None:
                break
            chain.append(pom)
            if pom.parent_gav is None:
                break
            rel = pom.parent_relative
            cand = os.path.normpath(os.path.join(os.path.dirname(cur_path), rel))
            if os.path.basename(cand) != "pom.xml" and not cand.endswith(".xml"):
                cand = os.path.join(cand, "pom.xml")
            raw = self.loader(cand)
            if raw is None:
                break
            # guard: the named parent must match the file we found
            parent = parse_pom_xml(raw)
            if parent is None or parent.artifact != pom.parent_gav[1]:
                break
            cur_content, cur_path = raw, cand
        return chain


def fs_loader(path: str):
    """Default loader over the real filesystem."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None
