"""Lockfile/manifest parsers for the priority ecosystems
(ref: pkg/dependency/parser/*; formats parsed from their public specs).
"""

from __future__ import annotations

import json
import re

from trivy_tpu_torch.types import Package


def _pkg(name: str, version: str, **kw) -> Package:
    p = Package(name=name, version=version, **kw)
    p.id = f"{name}@{version}"
    return p


# --- go.mod (ref: parser/golang/mod) ---------------------------------------

_GOMOD_REQ = re.compile(r"^\s*(?P<mod>\S+)\s+(?P<ver>v\S+?)(?:\s*//\s*(?P<c>.*))?$")
_GOMOD_MODULE = re.compile(r"^\s*module\s+(\S+)")


def parse_gomod(content: bytes, path: str = "") -> list[Package]:
    """go.mod requires with direct/indirect split and a root module node.

    go.mod carries no inter-module edges (the build list is flattened since
    Go 1.17), so the graph the reference renders is root -> direct requires
    (ref: parser/golang/mod marks the main module Relationship root); the
    indirect set stays flat, exactly as much as the file encodes.
    """
    pkgs: list[Package] = []
    module = ""
    in_require = False
    for raw in content.decode("utf-8", "replace").splitlines():
        line = raw.split("//", 1)[0].rstrip() if "// indirect" not in raw else raw.rstrip()
        s = line.strip()
        mm = _GOMOD_MODULE.match(s)
        if mm and not module:
            module = mm.group(1)
            continue
        if s.startswith("require ("):
            in_require = True
            continue
        if in_require and s == ")":
            in_require = False
            continue
        m = None
        if in_require:
            m = _GOMOD_REQ.match(raw)
        elif s.startswith("require "):
            m = _GOMOD_REQ.match(raw.replace("require ", "", 1))
        if m and m.group("mod") != "(":
            indirect = "indirect" in (m.group("c") or "")
            pkgs.append(
                _pkg(
                    m.group("mod"),
                    m.group("ver").lstrip("v"),
                    indirect=indirect,
                    relationship="indirect" if indirect else "direct",
                )
            )
    if module and pkgs:
        root = Package(name=module, version="", relationship="root")
        root.id = module
        root.depends_on = sorted(
            p.id for p in pkgs if p.relationship == "direct"
        )
        pkgs.insert(0, root)
    return pkgs


# --- npm package-lock.json (v1/v2/v3, ref: parser/nodejs/npm) ---------------


def parse_npm_lock(content: bytes, path: str = "") -> list[Package]:
    """package-lock.json with full dependency edges: the lockfile's
    node_modules layout encodes npm's resolution algorithm, so each
    entry's dependencies resolve by walking up the nesting chain
    (ref: pkg/dependency/parser/nodejs/npm resolution + relationship.go
    direct/indirect split from the root entry's declared deps)."""
    doc = json.loads(content)
    out: dict[tuple[str, str], Package] = {}
    if "packages" in doc:  # lockfile v2/v3
        locs = doc["packages"]

        def name_of(loc: str, meta: dict) -> str:
            return meta.get("name") or loc.split("node_modules/")[-1]

        def resolve(loc: str, dep: str) -> str | None:
            """Nearest node_modules/<dep> walking up from ``loc``."""
            base = loc
            while True:
                cand = (base + "/" if base else "") + f"node_modules/{dep}"
                meta = locs.get(cand)
                if meta is not None and meta.get("version"):
                    return f"{dep}@{meta['version']}"
                if not base:
                    return None
                if "/node_modules/" in base:
                    base = base.rsplit("/node_modules/", 1)[0]
                else:
                    # top-level node_modules/x OR a workspace dir
                    # (packages/a): both resolve against the root scope next
                    base = ""

        root = locs.get("", {}) or {}
        root_deps = set(root.get("dependencies", {}) or {}) | set(
            root.get("devDependencies", {}) or {}
        ) | set(root.get("optionalDependencies", {}) or {})
        for loc, meta in locs.items():
            if not loc:  # "" is the root project
                continue
            name = name_of(loc, meta)
            version = meta.get("version", "")
            if not version:
                continue
            key = (name, version)
            if key not in out:
                # direct = declared by the root project; nesting depth alone
                # misclassifies hoisted transitive deps as direct
                direct = loc == f"node_modules/{name}" and name in root_deps
                p = _pkg(
                    name, version,
                    dev=bool(meta.get("dev")),
                    indirect=not direct,
                )
                p.relationship = "direct" if direct else "indirect"
                deps = set(meta.get("dependencies", {}) or {}) | set(
                    meta.get("optionalDependencies", {}) or {}
                )
                p.depends_on = sorted(
                    d for d in (resolve(loc, dep) for dep in deps) if d
                )
                out[key] = p
    else:  # lockfile v1: nested dependencies
        def walk(deps: dict, depth: int, chain: list[dict]):
            for name, meta in (deps or {}).items():
                version = meta.get("version", "")
                if version:
                    key = (name, version)
                    if key not in out:
                        p = _pkg(
                            name, version, dev=bool(meta.get("dev")),
                            indirect=depth > 0,
                        )
                        p.relationship = "direct" if depth == 0 else "indirect"
                        edges = []
                        for dep in meta.get("requires", {}) or {}:
                            # nearest enclosing resolution, v1 style
                            for scope in [meta.get("dependencies", {})] + [
                                c for c in reversed(chain)
                            ] + [deps]:
                                m2 = (scope or {}).get(dep)
                                if m2 and m2.get("version"):
                                    edges.append(f"{dep}@{m2['version']}")
                                    break
                        p.depends_on = sorted(set(edges))
                        out[key] = p
                walk(meta.get("dependencies", {}), depth + 1,
                     chain + [meta.get("dependencies", {})])

        top = doc.get("dependencies", {})
        walk(top, 0, [top])
    return [out[k] for k in sorted(out)]


# --- yarn.lock (classic v1 format, ref: parser/nodejs/yarn) -----------------

_YARN_HEADER = re.compile(r'^"?(?P<name>(?:@[^@/"]+/)?[^@/"]+)@(?P<range>[^",]*)')
_YARN_VERSION = re.compile(r'^\s{2}version:?\s+"?(?P<v>[^"\s]+)"?')
_YARN_DEP = re.compile(
    r'^\s{4}"?(?P<name>(?:@[^@/"\s]+/)?[^@/":\s]+)"?:?\s+'
    r'(?:"(?P<qrange>[^"]+)"|(?P<range>\S+))'
)


def _yarn_range(r: str) -> str:
    """Normalize a selector range: berry prefixes ranges with a protocol
    (npm:^1.0.0); classic has the bare range."""
    return r[4:] if r.startswith("npm:") else r


def parse_yarn_lock(content: bytes, path: str = "") -> list[Package]:
    """yarn.lock (classic v1 and berry v2+) with dependency edges: each
    entry's ``dependencies:`` ranges resolve through the lockfile's own
    (name, range) -> version map (ref: pkg/dependency/parser/nodejs/yarn).
    Berry's ``name@npm:range`` selectors normalize to bare ranges."""
    # pass 1: entries with their selector sets and declared deps
    entries: list[dict] = []
    cur: dict | None = None
    in_deps = False
    for line in content.decode("utf-8", "replace").splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if not line.startswith(" "):
            selectors = []
            for sel in line.strip().rstrip(":").split(","):
                m = _YARN_HEADER.match(sel.strip())
                if m:
                    selectors.append((m.group("name"), _yarn_range(m.group("range"))))
            cur = {"selectors": selectors, "version": "", "deps": []}
            entries.append(cur)
            in_deps = False
            continue
        if cur is None:
            continue
        if line.startswith("  ") and not line.startswith("   "):
            in_deps = line.strip() in ("dependencies:", "optionalDependencies:")
            m = _YARN_VERSION.match(line)
            if m:
                cur["version"] = m.group("v")
            continue
        if in_deps:
            m = _YARN_DEP.match(line)
            if m:
                rng = m.group("qrange") or m.group("range") or ""
                cur["deps"].append((m.group("name"), _yarn_range(rng)))
    # (name, range) -> version, plus name -> versions fallback
    by_selector: dict[tuple[str, str], str] = {}
    by_name: dict[str, set[str]] = {}
    for e in entries:
        if not e["version"]:
            continue
        for sel in e["selectors"]:
            by_selector[sel] = e["version"]
            by_name.setdefault(sel[0], set()).add(e["version"])

    out: dict[tuple[str, str], Package] = {}
    for e in entries:
        if not e["selectors"] or not e["version"]:
            continue
        if any(r.startswith(("workspace:", "patch:")) for _n, r in e["selectors"]):
            continue  # berry local workspaces/patches are not packages
        name = e["selectors"][0][0]
        key = (name, e["version"])
        if key in out:
            continue
        edges = []
        for dep_name, dep_range in e["deps"]:
            v = by_selector.get((dep_name, dep_range))
            if v is None:
                versions = by_name.get(dep_name, set())
                v = next(iter(versions)) if len(versions) == 1 else None
            if v is not None:
                edges.append(f"{dep_name}@{v}")
        p = _pkg(name, e["version"])
        p.depends_on = sorted(set(edges))
        out[key] = p
    return [out[k] for k in sorted(out)]


# --- pnpm-lock.yaml (v6/v9 key styles, ref: parser/nodejs/pnpm) -------------


def _pnpm_key_to_nv(key: str) -> tuple[str, str]:
    key = key.strip().split("(", 1)[0]  # drop peer-dep suffix: name@ver(peer@x)
    if key.startswith("/"):  # v5/v6: /name@version or /name/version
        body = key[1:]
        if "@" in body[1:]:
            name, _, version = body.rpartition("@")
        else:
            name, _, version = body.rpartition("/")
    else:  # v9: name@version
        name, _, version = key.rpartition("@")
    return name, version.split("(", 1)[0]


def parse_pnpm_lock(content: bytes, path: str = "") -> list[Package]:
    """pnpm-lock.yaml with dependency edges: v5-v6 carry per-package
    ``dependencies`` maps inline; v9 moves them into ``snapshots``
    (ref: pkg/dependency/parser/nodejs/pnpm)."""
    import yaml

    doc = yaml.safe_load(content) or {}
    packages = doc.get("packages") or {}
    snapshots = doc.get("snapshots") or {}
    out: dict[tuple[str, str], Package] = {}

    def edges_of(meta) -> list[str]:
        if not isinstance(meta, dict):
            return []
        deps = dict(meta.get("dependencies") or {})
        deps.update(meta.get("optionalDependencies") or {})
        edges = []
        for dname, dver in deps.items():
            v = str(dver).split("(", 1)[0]
            if v.startswith("/"):  # aliased: /real-name@version
                dname, v = _pnpm_key_to_nv(v)
            if v:
                edges.append(f"{dname}@{v}")
        return sorted(set(edges))

    snap_edges = {
        _pnpm_key_to_nv(k): edges_of(meta) for k, meta in snapshots.items()
    }
    for key, meta in packages.items():
        name, version = _pnpm_key_to_nv(key)
        if name and version:
            p = _pkg(name, version)
            p.depends_on = snap_edges.get((name, version)) or edges_of(meta)
            out.setdefault((name, version), p)
    return [out[k] for k in sorted(out)]


# --- pip requirements.txt (ref: parser/python/pip) --------------------------

_REQ_LINE = re.compile(r"^(?P<name>[A-Za-z0-9][A-Za-z0-9._-]*)\s*==\s*(?P<ver>[^\s;#]+)")


def parse_requirements(content: bytes, path: str = "") -> list[Package]:
    pkgs = []
    for line in content.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "-")):
            continue
        m = _REQ_LINE.match(line)
        if m:
            pkgs.append(_pkg(m.group("name"), m.group("ver")))
    return pkgs


# --- Pipfile.lock (ref: parser/python/pipenv) -------------------------------


def parse_pipfile_lock(content: bytes, path: str = "") -> list[Package]:
    doc = json.loads(content)
    pkgs = []
    for section, dev in (("default", False), ("develop", True)):
        for name, meta in (doc.get(section) or {}).items():
            ver = (meta or {}).get("version", "")
            if ver.startswith("=="):
                pkgs.append(_pkg(name, ver[2:], dev=dev))
    return pkgs


# --- poetry.lock / uv.lock / Cargo.lock (TOML [[package]]) ------------------


def _tomllib():
    """stdlib tomllib (3.11+) with fallbacks for 3.10 hosts: the
    standalone tomli package first, pip's vendored copy as a last
    resort (pip-less slim interpreters won't have the latter)."""
    try:
        import tomllib
    except ImportError:
        try:
            import tomli as tomllib
        except ImportError:
            from pip._vendor import tomli as tomllib
    return tomllib


def _parse_toml_packages(content: bytes, dev_groups: bool = False) -> list[Package]:
    """Lockfiles of [[package]] entries (poetry/uv/cargo), with dependency
    edges resolved by name against the lock's own entries (versions are
    pinned, so name -> version is unambiguous except for multi-version
    cargo graphs, where an exact "name version" spec disambiguates)."""
    tomllib = _tomllib()

    doc = tomllib.loads(content.decode("utf-8", "replace"))
    entries = doc.get("package", []) or []
    by_name: dict[str, list[str]] = {}
    for entry in entries:
        if entry.get("name") and entry.get("version"):
            by_name.setdefault(entry["name"], []).append(entry["version"])
    pkgs = []
    for entry in entries:
        name, version = entry.get("name"), entry.get("version")
        if not (name and version):
            continue
        dev = entry.get("category") == "dev" if dev_groups else False
        p = _pkg(name, version, dev=dev)
        edges = []
        deps = entry.get("dependencies")
        if isinstance(deps, dict):  # poetry: {name: spec}
            for dname in deps:
                vs = by_name.get(dname, [])
                if len(vs) == 1:
                    edges.append(f"{dname}@{vs[0]}")
        elif isinstance(deps, list):  # cargo/uv: "name" or "name version" or {name=...}
            for d in deps:
                if isinstance(d, dict):
                    dname, dver = d.get("name"), d.get("version", "")
                else:
                    dname, _, dver = str(d).partition(" ")
                    dver = dver.split(" ", 1)[0]
                if not dname:
                    continue
                if dver:
                    edges.append(f"{dname}@{dver}")
                else:
                    vs = by_name.get(dname, [])
                    if len(vs) == 1:
                        edges.append(f"{dname}@{vs[0]}")
        p.depends_on = sorted(set(edges))
        pkgs.append(p)
    return pkgs


def parse_poetry_lock(content: bytes, path: str = "") -> list[Package]:
    return _parse_toml_packages(content, dev_groups=True)


def parse_uv_lock(content: bytes, path: str = "") -> list[Package]:
    return _parse_toml_packages(content)


def parse_cargo_lock(content: bytes, path: str = "") -> list[Package]:
    return _parse_toml_packages(content)


# --- Gemfile.lock (ref: parser/ruby/bundler) --------------------------------

_GEM_SPEC = re.compile(r"^    (?P<name>\S+) \((?P<ver>[^)]+)\)$")


def parse_gemfile_lock(content: bytes, path: str = "") -> list[Package]:
    pkgs = []
    in_gem = False
    for line in content.decode("utf-8", "replace").splitlines():
        if line.rstrip() in ("GEM", "GIT", "PATH"):
            in_gem = True
            continue
        if line.strip() == "" or not line.startswith(" "):
            in_gem = line.rstrip() in ("GEM",)
            continue
        if in_gem:
            m = _GEM_SPEC.match(line)
            if m:
                pkgs.append(_pkg(m.group("name"), m.group("ver")))
    return pkgs


# --- composer.lock (ref: parser/php/composer) -------------------------------


def parse_composer_lock(content: bytes, path: str = "") -> list[Package]:
    doc = json.loads(content)
    versions: dict[str, str] = {}
    for section in ("packages", "packages-dev"):
        for meta in doc.get(section, []) or []:
            if meta.get("name") and meta.get("version"):
                versions[meta["name"]] = str(meta["version"]).lstrip("v")
    pkgs = []
    for section, dev in (("packages", False), ("packages-dev", True)):
        for meta in doc.get(section, []) or []:
            name, ver = meta.get("name"), str(meta.get("version", "")).lstrip("v")
            if name and ver:
                lic = meta.get("license") or []
                p = _pkg(
                    name, ver, dev=dev,
                    licenses=lic if isinstance(lic, list) else [lic],
                )
                # edges: require entries that resolve to locked packages
                # (php/ext-* platform requirements have no lock entry)
                p.depends_on = sorted(
                    f"{d}@{versions[d]}"
                    for d in (meta.get("require") or {})
                    if d in versions
                )
                pkgs.append(p)
    return pkgs


# --- gradle.lockfile (ref: parser/java/gradle) ------------------------------


def parse_gradle_lock(content: bytes, path: str = "") -> list[Package]:
    # gradle.lockfile records `group:artifact:version=configurations` lines
    # only — no inter-dependency edges exist in the format (the reference's
    # parser/gradle/lockfile is likewise flat), so no graph is synthesized
    pkgs = []
    for line in content.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        coord = line.split("=", 1)[0]
        parts = coord.split(":")
        if len(parts) == 3:
            pkgs.append(_pkg(f"{parts[0]}:{parts[1]}", parts[2]))
    return pkgs


# --- NuGet packages.lock.json (ref: parser/nuget/lock) ----------------------


def parse_nuget_lock(content: bytes, path: str = "") -> list[Package]:
    """packages.lock.json incl. the per-package dependency edges it records
    (each entry's ``dependencies`` maps name -> requested range; resolved
    versions come from the entries themselves — ref: parser/nuget/lock)."""
    doc = json.loads(content)
    out: dict[tuple[str, str], Package] = {}
    for _fw, deps in (doc.get("dependencies") or {}).items():
        # resolution is per target framework: edges must bind to the
        # version THIS framework resolved, not first-framework-wins
        resolved: dict[str, str] = {}  # name(lower) -> id
        raw_deps: dict[tuple[str, str], list[str]] = {}
        for name, meta in (deps or {}).items():
            ver = (meta or {}).get("resolved", "")
            if not ver:
                continue
            out.setdefault(
                (name, ver),
                _pkg(name, ver, indirect=(meta.get("type") == "Transitive")),
            )
            resolved[name.lower()] = f"{name}@{ver}"
            names = sorted((meta.get("dependencies") or {}).keys())
            if names:
                raw_deps[(name, ver)] = names
        for key, names in raw_deps.items():
            # NuGet ids are case-insensitive: edges use the entry's spelling
            edges = [resolved[n.lower()] for n in names if n.lower() in resolved]
            if edges:
                out[key].depends_on = sorted(
                    set(out[key].depends_on) | set(edges)
                )
    return [out[k] for k in sorted(out)]


# --- Maven pom.xml: see trivy_tpu_torch.dependency.pom (parent-chain resolver) ---


# --- jar/war/ear filename heuristic (ref: parser/java/jar without javadb) ---

_JAR_NAME = re.compile(r"^(?P<name>.+?)-(?P<ver>\d[\w.+-]*?)(?:[-.](?:sources|javadoc|tests))?\.[jwe]ar$")


def parse_jar_name(file_path: str) -> list[Package]:
    import os.path

    base = os.path.basename(file_path)
    m = _JAR_NAME.match(base)
    if not m:
        return []
    return [_pkg(m.group("name"), m.group("ver"), file_path=file_path)]


# --- Conan lock (ref: parser/c/conan) ---------------------------------------


def parse_conan_lock(content: bytes, path: str = "") -> list[Package]:
    doc = json.loads(content)
    pkgs = []
    reqs = doc.get("requires") or []
    if isinstance(reqs, list):  # v2 lockfile (flat: no graph recorded)
        for r in reqs:
            ref = r.split("#", 1)[0]
            if "/" in ref:
                name, _, ver = ref.partition("/")
                pkgs.append(_pkg(name, ver.split("@", 1)[0]))
    # v1 lockfile: graph_lock carries real edges (node "requires" lists)
    nodes = (doc.get("graph_lock") or {}).get("nodes") or {}
    by_nid: dict[str, Package] = {}
    for nid, node in nodes.items():
        ref = ((node or {}).get("ref") or "").split("#", 1)[0]
        if "/" in ref:
            name, _, ver = ref.partition("/")
            p = _pkg(name, ver.split("@", 1)[0])
            by_nid[nid] = p
            pkgs.append(p)
    for nid, node in nodes.items():
        if nid not in by_nid:
            continue
        edges = [
            by_nid[r].id
            for r in (node or {}).get("requires") or []
            if r in by_nid
        ]
        if edges:
            by_nid[nid].depends_on = sorted(set(edges))
    return pkgs


# --- mix.lock (ref: parser/hex/mix) -----------------------------------------

_MIX_RE = re.compile(
    r'"(?P<name>[^"]+)":\s*\{:hex,\s*:(?P<pkg>\w+),\s*"(?P<ver>[^"]+)"'
    r'(?P<rest>[^\n]*)'
)
_MIX_DEP_RE = re.compile(r"\{:(?P<dep>\w+),")


def parse_mix_lock(content: bytes, path: str = "") -> list[Package]:
    """mix.lock entries incl. edges: each hex tuple's 6th element lists the
    package's own deps as `{:name, requirement, [hex: :name, ...]}` tuples
    (one entry per line in mix's output format — ref: parser/hex/mix)."""
    text = content.decode("utf-8", "replace")
    entries = []
    for m in _MIX_RE.finditer(text):
        entries.append((m.group("name"), m.group("ver"), m.group("rest")))
    by_name = {name: f"{name}@{ver}" for name, ver, _ in entries}
    pkgs = []
    for name, ver, rest in entries:
        p = _pkg(name, ver)
        edges = {
            by_name[d.group("dep")]
            for d in _MIX_DEP_RE.finditer(rest)
            if d.group("dep") in by_name and d.group("dep") != name
        }
        if edges:
            p.depends_on = sorted(edges)
        pkgs.append(p)
    return pkgs


# --- pubspec.lock (dart, ref: parser/dart/pub) ------------------------------


def parse_pubspec_lock(content: bytes, path: str = "") -> list[Package]:
    import yaml

    doc = yaml.safe_load(content) or {}
    pkgs = []
    for name, meta in (doc.get("packages") or {}).items():
        ver = (meta or {}).get("version", "")
        if ver:
            dep_kind = (meta or {}).get("dependency", "")
            indirect = "transitive" in dep_kind
            pkgs.append(_pkg(
                name, ver, indirect=indirect,
                relationship="indirect" if indirect else "direct",
                dev=dep_kind == "direct dev",
            ))
    return pkgs


# --- Podfile.lock (cocoapods, ref: parser/swift/cocoapods) ------------------


def parse_podfile_lock(content: bytes, path: str = "") -> list[Package]:
    """Podfile.lock PODS entries incl. the dependency edges each pod lists
    as its nested items (`- Pod (1.0):\\n  - Dep (~> 2.0)` — ref:
    parser/swift/cocoapods), with subspecs collapsed onto the base pod."""
    import yaml

    doc = yaml.safe_load(content) or {}
    versions: dict[str, str] = {}  # base pod name -> version
    raw_edges: dict[str, set] = {}

    def pod_name(s: str) -> tuple[str, str]:
        m = re.match(r"^(\S+)(?: \(([^)]+)\))?$", str(s))
        return (m.group(1).split("/")[0], m.group(2) or "") if m else ("", "")

    for entry in doc.get("PODS") or []:
        deps: list[str] = []
        if isinstance(entry, dict):
            entry, deps = next(iter(entry.items()))
        name, ver = pod_name(entry)
        if not name or not ver:
            continue
        versions.setdefault(name, ver)
        for d in deps or []:
            dep_base, _ = pod_name(d)
            if dep_base and dep_base != name:
                raw_edges.setdefault(name, set()).add(dep_base)
    pkgs = []
    for name in sorted(versions):
        p = _pkg(name, versions[name])
        p.depends_on = sorted(
            f"{d}@{versions[d]}" for d in raw_edges.get(name, ()) if d in versions
        )
        pkgs.append(p)
    return pkgs


# --- Package.resolved (swift, ref: parser/swift/swift) ----------------------


def parse_swift_resolved(content: bytes, path: str = "") -> list[Package]:
    doc = json.loads(content)
    pkgs = []
    pins = doc.get("pins") or (doc.get("object") or {}).get("pins") or []
    for pin in pins:
        name = pin.get("location") or pin.get("repositoryURL") or pin.get("identity", "")
        ver = (pin.get("state") or {}).get("version", "")
        if name and ver:
            pkgs.append(_pkg(name.removesuffix(".git"), ver))
    return pkgs


# --- dotnet *.deps.json (ref: parser/dotnet/core_deps/parse.go) -------------


def parse_dotnet_deps(content: bytes, path: str = "") -> list[Package]:
    """.NET runtime dependency file: ``libraries`` entries of type
    "package" are the restored NuGet packages."""
    doc = json.loads(content)
    pkgs = []
    for key, meta in (doc.get("libraries") or {}).items():
        if (meta or {}).get("type") != "package":
            continue
        name, _, version = key.partition("/")
        if name and version:
            pkgs.append(_pkg(name, version))
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs


# --- julia Manifest.toml (ref: parser/julia/manifest/parse.go) --------------


def parse_julia_manifest(content: bytes, path: str = "") -> list[Package]:
    """Julia package manifest: [[deps.Name]] entries with uuid/version and
    name-resolved dependency edges (stdlib entries carry no version)."""
    tomllib = _tomllib()

    doc = tomllib.loads(content.decode("utf-8", "replace"))
    deps_tbl = doc.get("deps", doc)  # format 2 nests under [deps]; 1 is flat
    if not isinstance(deps_tbl, dict):
        return []
    versions: dict[str, str] = {}
    for name, entries in deps_tbl.items():
        if isinstance(entries, list) and entries:
            v = entries[0].get("version")
            if v:
                versions[name] = v
    pkgs = []
    for name, entries in sorted(deps_tbl.items()):
        if not (isinstance(entries, list) and entries):
            continue
        entry = entries[0]
        version = entry.get("version")
        if not version:
            continue  # stdlib / path deps
        p = _pkg(name, version)
        p.depends_on = sorted(
            f"{d}@{versions[d]}"
            for d in (entry.get("deps") or [])
            if d in versions
        )
        pkgs.append(p)
    return pkgs


# --- sbt build.sbt.lock (ref: parser/sbt/lockfile/parse.go) -----------------


def parse_sbt_lock(content: bytes, path: str = "") -> list[Package]:
    doc = json.loads(content)
    pkgs = []
    seen = set()
    for dep in doc.get("dependencies", []) or []:
        org, name, version = dep.get("org"), dep.get("name"), dep.get("version")
        if not (org and name and version):
            continue
        full = f"{org}:{name}"
        if (full, version) in seen:
            continue
        seen.add((full, version))
        pkgs.append(_pkg(full, version))
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs


# --- conda environment.yml (ref: parser/conda/environment/parse.go) ---------

_CONDA_SPEC = re.compile(
    r"^(?P<name>[A-Za-z0-9_.-]+)\s*(?:=+\s*(?P<ver>[0-9][^=\s]*))?"
)


def parse_conda_environment(content: bytes, path: str = "") -> list[Package]:
    """conda environment.yml: plain specs plus the nested pip list."""
    import yaml

    doc = yaml.safe_load(content) or {}
    pkgs = []
    for dep in doc.get("dependencies", []) or []:
        if isinstance(dep, str):
            m = _CONDA_SPEC.match(dep.strip())
            if m and m.group("name"):
                pkgs.append(_pkg(m.group("name"), m.group("ver") or ""))
        elif isinstance(dep, dict):
            for pip_spec in dep.get("pip", []) or []:
                m = _REQ_LINE.match(str(pip_spec))
                if m:
                    pkgs.append(_pkg(m.group("name"), m.group("ver")))
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs


# --- nuget Directory.Packages.props (ref: parser/nuget/config) --------------


def parse_packages_props(content: bytes, path: str = "") -> list[Package]:
    """Central package management props: <PackageVersion Include=... />."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(content.decode("utf-8-sig", "replace"))
    except ET.ParseError:
        return []
    pkgs = []
    for el in root.iter():
        if el.tag.rsplit("}", 1)[-1] not in ("PackageVersion", "PackageReference"):
            continue
        name = el.get("Include") or el.get("Update")
        version = el.get("Version") or (el.findtext("Version") or "")
        if name and version and "$(" not in version and "$(" not in name:
            pkgs.append(_pkg(name, version))
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs


# --- WordPress core version (ref: parser/frameworks/wordpress) --------------

_WP_VERSION_RE = re.compile(r"^\$wp_version\s*=\s*['\"]([^'\"]+)['\"]\s*;")


def parse_wordpress_version(content: bytes, path: str = "") -> list[Package]:
    """wp-includes/version.php's ``$wp_version = '6.4.2';`` assignment,
    with // and /* */ comments stripped the way the reference does."""
    in_comment = False
    for raw in content.decode("utf-8", "replace").splitlines():
        line = raw.split("//", 1)[0].strip()
        if line.startswith("/*"):
            in_comment = True
        if in_comment:
            if line.endswith("*/"):
                in_comment = False
            continue
        m = _WP_VERSION_RE.match(line)
        if m:
            return [_pkg("wordpress", m.group(1))]
    return []
