"""VEX (Vulnerability Exploitability eXchange) filtering.

Suppresses detected vulnerabilities whose VEX status is ``not_affected`` or
``fixed`` (ref: pkg/vex/vex.go:65-200 Filter/NotAffected). Three document
formats are auto-detected, matching the reference's format sniffing
(ref: pkg/vex/document.go):

- OpenVEX (``@context`` openvex.dev): statements with vulnerability name,
  product identifiers (purl), status, justification
  (ref: pkg/vex/openvex.go).
- CycloneDX VEX: a BOM whose ``vulnerabilities[].analysis.state`` carries
  the status and ``affects[].ref`` points at bom-refs / purls
  (ref: pkg/vex/cyclonedx.go).
- CSAF VEX: ``product_tree`` branches with purl helpers +
  ``vulnerabilities[].product_status`` (ref: pkg/vex/csaf.go — the subset
  driven by known_not_affected/fixed).

Product matching is purl-based: a VEX purl matches a detected package when
type/namespace/name agree, the VEX version (if given) equals the package
version, and VEX qualifiers (if given) are a subset of the package's —
the openvex matching semantics. The reference additionally walks the SBOM
component graph for subcomponent statements; this build's reports are
flat, so products match the affected package directly.

Suppressed findings are recorded in ``Result.modified_findings`` and
surface as ``ExperimentalModifiedFindings`` in JSON output, like the
reference's ``--show-suppressed`` data.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.types import ModifiedFinding, Report

logger = log.logger("vex")

_SUPPRESS_STATUSES = ("not_affected", "fixed")

# status vocabulary normalization per format
_CDX_STATES = {
    "not_affected": "not_affected",
    "resolved": "fixed",
    "resolved_with_pedigree": "fixed",
    "exploitable": "affected",
    "in_triage": "under_investigation",
    "false_positive": "not_affected",
}


@dataclass
class Statement:
    vuln_id: str
    purls: list[str]
    status: str  # not_affected | fixed | affected | under_investigation
    justification: str = ""
    source: str = ""
    # True only when the document genuinely declared no products (OpenVEX
    # product-less statements apply globally). Statements whose declared
    # products failed to resolve to purls must NOT match everything.
    match_all: bool = False


# ---------------------------------------------------------------------------
# purl matching
# ---------------------------------------------------------------------------


def _parse_purl(purl: str):
    """Split ``pkg:type/ns/name@version?q=v`` → (type, namespace, name,
    version, qualifiers) — enough structure for matching."""
    if not purl.startswith("pkg:"):
        return None
    body = purl[4:]
    qualifiers: dict[str, str] = {}
    if "?" in body:
        body, q = body.split("?", 1)
        for pair in q.split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                qualifiers[k] = v
    version = ""
    if "@" in body:
        body, version = body.rsplit("@", 1)
    parts = [p for p in body.split("/") if p]
    if not parts:
        return None
    ptype = parts[0]
    name = parts[-1] if len(parts) > 1 else ""
    namespace = "/".join(parts[1:-1])
    return (ptype.lower(), namespace, name, version, qualifiers)


def purl_matches(vex_purl: str, pkg_purl: str) -> bool:
    """openvex-style matching: the VEX purl's specified fields must agree."""
    a = _parse_purl(vex_purl)
    b = _parse_purl(pkg_purl)
    if a is None or b is None:
        return False
    at, ans, an, av, aq = a
    bt, bns, bn, bv, bq = b
    if at != bt or an != bn:
        return False
    if ans and ans != bns:
        return False
    if av and av != bv:
        return False
    for k, v in aq.items():
        if bq.get(k) != v:
            return False
    return True


# ---------------------------------------------------------------------------
# document loading
# ---------------------------------------------------------------------------


class VexDocument:
    def __init__(self, statements: list[Statement], source: str):
        self.statements = statements
        self.source = source

    def not_affected(self, vuln_id: str, purl: str) -> ModifiedFinding | None:
        """Last matching statement wins (OpenVEX override semantics,
        ref: pkg/vex/openvex.go NotAffected)."""
        matched = [
            s
            for s in self.statements
            if s.vuln_id == vuln_id
            and (s.match_all or any(purl_matches(p, purl) for p in s.purls))
        ]
        if not matched:
            return None
        stmt = matched[-1]
        if stmt.status in _SUPPRESS_STATUSES:
            return ModifiedFinding(
                type="vulnerability",
                status=stmt.status,
                statement=stmt.justification,
                source=self.source,
            )
        return None


def load(path: str) -> VexDocument:
    """Load a VEX file, sniffing its format."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    source = os.path.basename(path)
    if "@context" in doc and "openvex" in str(doc.get("@context", "")):
        return VexDocument(_load_openvex(doc), source)
    if doc.get("bomFormat") == "CycloneDX" or "vulnerabilities" in doc and "components" in doc:
        return VexDocument(_load_cyclonedx(doc), source)
    if "document" in doc and "product_tree" in doc:
        return VexDocument(_load_csaf(doc), source)
    raise ValueError(f"unrecognized VEX format in {path}")


def _load_openvex(doc: dict) -> list[Statement]:
    out = []
    for stmt in doc.get("statements", []) or []:
        vuln = stmt.get("vulnerability") or {}
        vuln_id = vuln.get("name", "") if isinstance(vuln, dict) else str(vuln)
        purls = []
        products = stmt.get("products", []) or []
        for product in products:
            if isinstance(product, dict):
                pid = product.get("@id", "")
                if pid.startswith("pkg:"):
                    purls.append(pid)
                for ident in (product.get("identifiers") or {}).values():
                    if str(ident).startswith("pkg:"):
                        purls.append(str(ident))
            elif str(product).startswith("pkg:"):
                purls.append(str(product))
        out.append(
            Statement(
                vuln_id=vuln_id,
                purls=purls,
                status=stmt.get("status", ""),
                justification=stmt.get("justification", "")
                or stmt.get("impact_statement", ""),
                source="OpenVEX",
                match_all=not products,
            )
        )
    return out


def _load_cyclonedx(doc: dict) -> list[Statement]:
    # bom-ref → purl for affects[].ref resolution
    ref_purl: dict[str, str] = {}
    meta_comp = (doc.get("metadata") or {}).get("component") or {}
    for comp in list(doc.get("components", []) or []) + [meta_comp]:
        if comp.get("bom-ref") and comp.get("purl"):
            ref_purl[comp["bom-ref"]] = comp["purl"]
    out = []
    for vuln in doc.get("vulnerabilities", []) or []:
        analysis = vuln.get("analysis") or {}
        status = _CDX_STATES.get(analysis.get("state", ""), "")
        purls = []
        affects = vuln.get("affects", []) or []
        for affect in affects:
            ref = affect.get("ref", "")
            purl = ref_purl.get(ref, ref if ref.startswith("pkg:") else "")
            if purl:
                purls.append(purl)
        if not purls:
            # affects were declared but none resolved to a purl (or none were
            # declared at all) — suppressing everything would silently hide
            # real vulnerabilities; CDX VEX matching is product-based only.
            continue
        out.append(
            Statement(
                vuln_id=vuln.get("id", ""),
                purls=purls,
                status=status,
                justification=analysis.get("detail", "")
                or analysis.get("justification", ""),
                source="CycloneDX VEX",
            )
        )
    return out


def _csaf_purls(branches: list, out: dict) -> None:
    """product id → purl from the (recursive) CSAF product tree."""
    for br in branches or []:
        prod = br.get("product") or {}
        pid = prod.get("product_id", "")
        helper = (prod.get("product_identification_helper") or {}).get("purl", "")
        if pid and helper:
            out[pid] = helper
        _csaf_purls(br.get("branches"), out)


def _load_csaf(doc: dict) -> list[Statement]:
    purls: dict[str, str] = {}
    _csaf_purls((doc.get("product_tree") or {}).get("branches"), purls)
    # relationships: composed products inherit the component purl
    for rel in (doc.get("product_tree") or {}).get("relationships", []) or []:
        child = (rel.get("full_product_name") or {}).get("product_id", "")
        parent = rel.get("product_reference", "")
        if child and parent in purls:
            purls[child] = purls[parent]
    out = []
    for vuln in doc.get("vulnerabilities", []) or []:
        status_map = vuln.get("product_status") or {}
        for key, status in (
            ("known_not_affected", "not_affected"),
            ("fixed", "fixed"),
        ):
            ids = status_map.get(key) or []
            stmt_purls = [purls[i] for i in ids if i in purls]
            if not stmt_purls:
                # no product ids, or ids that resolved to no purls — do
                # not let this statement match every package
                continue
            out.append(
                Statement(
                    vuln_id=vuln.get("cve", "") or (vuln.get("ids") or [{}])[0].get("text", ""),
                    purls=stmt_purls,
                    status=status,
                    justification=(vuln.get("threats") or [{}])[0].get("details", ""),
                    source="CSAF VEX",
                )
            )
    return out


# ---------------------------------------------------------------------------
# report filtering
# ---------------------------------------------------------------------------


class RepositorySet:
    """VEX repositories (ref: pkg/vex/repo/: manifest ``vex-repository.json``,
    index at ``<repo>/0.1/index.json``, documents resolved relative to the
    index). The ``--vex repo`` source reads the repository config
    (``repository.yaml``, a ``repositories: [{name, url, enabled}]`` list),
    then looks up each vulnerability's package by its version-less purl in
    every enabled repository's index, in config order — first repository
    holding the package wins (ref: pkg/vex/repo.go:90-113).

    Zero-egress build: repositories must already be present in the cache
    (``<cache>/vex/repositories/<name>/``); downloading is the env-blocked
    seam, resolution/matching is complete.
    """

    SCHEMA_VERSION = "0.1"

    def __init__(self, cache_dir: str, config_path: str = ""):
        import yaml

        self.indexes: list[tuple[str, str, dict, str]] = []
        self._doc_cache: dict[str, VexDocument | None] = {}
        config_path = config_path or os.path.join(
            cache_dir, "vex", "repository.yaml"
        )
        if not os.path.exists(config_path):
            alt = os.path.expanduser("~/.trivy/vex/repository.yaml")
            config_path = alt if os.path.exists(alt) else config_path
        try:
            with open(config_path, encoding="utf-8") as f:
                conf = yaml.safe_load(f) or {}
        except (OSError, yaml.YAMLError) as e:
            logger.warning(
                "no usable VEX repository config at %s (%s); `--vex repo` "
                "has nothing to consult", config_path, e,
            )
            return
        for r in conf.get("repositories") or []:
            if not (r or {}).get("enabled", True):
                continue
            name = str(r.get("name", ""))
            repo_dir = os.path.join(cache_dir, "vex", "repositories", name)
            index_path = os.path.join(
                repo_dir, self.SCHEMA_VERSION, "index.json"
            )
            if not os.path.exists(index_path):
                logger.warning(
                    "VEX repository %s not found locally (%s), skipping",
                    name, index_path,
                )
                continue
            try:
                with open(index_path, encoding="utf-8") as f:
                    raw = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("VEX repository %s: bad index: %s", name, e)
                continue
            pkgs = {}
            for entry in raw.get("packages") or raw.get("Packages") or []:
                pid = entry.get("id") or entry.get("ID") or ""
                if pid:
                    pkgs[pid] = {
                        "location": entry.get("location")
                        or entry.get("Location") or "",
                        "format": entry.get("format")
                        or entry.get("Format") or "",
                    }
            self.indexes.append(
                (name, str(r.get("url", "")), pkgs,
                 os.path.dirname(index_path))
            )

    @staticmethod
    def package_id(purl: str) -> str:
        """Version/qualifier/subpath-less purl — the index key (vex-repo
        spec §3.2; OCI keeps its repository_url qualifier)."""
        from trivy_tpu_torch.purl import PackageURL

        try:
            p = PackageURL.parse(purl)
        except ValueError:
            return ""
        keep_q = {}
        if p.type == "oci" and "repository_url" in p.qualifiers:
            keep_q = {"repository_url": p.qualifiers["repository_url"]}
        p.version = ""
        p.qualifiers = keep_q
        p.subpath = ""
        return p.to_string()

    def not_affected(self, vuln_id: str, purl: str) -> ModifiedFinding | None:
        pkg_id = self.package_id(purl)
        if not pkg_id:
            return None
        for name, url, pkgs, base_dir in self.indexes:
            entry = pkgs.get(pkg_id)
            if entry is None:
                continue
            loc = os.path.join(base_dir, entry["location"])
            if loc not in self._doc_cache:
                try:
                    self._doc_cache[loc] = load(loc)
                except (OSError, ValueError, json.JSONDecodeError) as e:
                    logger.warning(
                        "VEX repository %s: cannot load %s: %s", name, loc, e
                    )
                    self._doc_cache[loc] = None
            doc = self._doc_cache[loc]
            if doc is not None:
                m = doc.not_affected(vuln_id, purl)
                if m is not None:
                    m.source = f"VEX Repository: {name} ({url})"
                    return m
            # higher-precedence repository holds the package: stop here
            return None
        return None


def filter_report(
    report: Report, sources: list[str], cache_dir: str = ""
) -> None:
    """Drop vulnerabilities a VEX document marks not_affected/fixed;
    record them as modified findings (ref: vex.go filterVulnerabilities).
    A source of ``repo`` consults the local VEX repositories."""
    docs = []
    for src in sources:
        if src == "repo":
            if not cache_dir:
                from trivy_tpu_torch.cache.fs import default_cache_dir

                cache_dir = default_cache_dir()
            docs.append(RepositorySet(cache_dir))
            continue
        try:
            docs.append(load(src))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            logger.warning("cannot load VEX source %s: %s", src, e)
    if not docs:
        return
    for result in report.results:
        if not result.vulnerabilities:
            continue
        kept = []
        for vuln in result.vulnerabilities:
            purl = vuln.pkg_identifier.purl
            modified = None
            for doc in docs:
                modified = doc.not_affected(vuln.vulnerability_id, purl)
                if modified is not None:
                    break
            if modified is None:
                kept.append(vuln)
            else:
                modified.finding = vuln.to_dict()
                result.modified_findings.append(modified)
        result.vulnerabilities = kept
