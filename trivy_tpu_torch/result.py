"""Result filtering (ref: pkg/result/filter.go), the port of
``trivy_tpu/result.py``.

Severity filter, VEX documents (``vex.py``), ``.trivyignore`` / YAML
ignore files with expiry, Python or Rego ignore-policy files (``rego.py``),
and deterministic dedup+sort — applied after scanning, before reporting
(ref: filter.go:37-120).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field

from trivy_tpu_torch import log
from trivy_tpu_torch.types import ModifiedFinding, Report

logger = log.logger("result")


@dataclass
class IgnoreEntry:
    id: str
    paths: list[str] = field(default_factory=list)
    expired_at: datetime.date | None = None
    statement: str = ""

    def active(self, today: datetime.date) -> bool:
        return self.expired_at is None or today <= self.expired_at


@dataclass
class IgnoreConfig:
    vulnerabilities: list[IgnoreEntry] = field(default_factory=list)
    misconfigurations: list[IgnoreEntry] = field(default_factory=list)
    secrets: list[IgnoreEntry] = field(default_factory=list)
    licenses: list[IgnoreEntry] = field(default_factory=list)

    @classmethod
    def load(cls, path: str | None) -> "IgnoreConfig":
        cfg = cls()
        if not path or not os.path.exists(path):
            return cfg
        if path.endswith((".yml", ".yaml")):
            import yaml

            with open(path) as f:
                data = yaml.safe_load(f) or {}

            def entries(key):
                out = []
                for e in data.get(key, []) or []:
                    exp = e.get("expired_at")
                    if isinstance(exp, str):
                        exp = datetime.date.fromisoformat(exp)
                    out.append(
                        IgnoreEntry(
                            id=e.get("id", ""),
                            paths=list(e.get("paths", []) or []),
                            expired_at=exp,
                            statement=e.get("statement", ""),
                        )
                    )
                return out

            cfg.vulnerabilities = entries("vulnerabilities")
            cfg.misconfigurations = entries("misconfigurations")
            cfg.secrets = entries("secrets")
            cfg.licenses = entries("licenses")
            return cfg
        # plain .trivyignore: one ID per line, '#' comments (ref:
        # result/filter.go parseIgnoreFile)
        ids = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    ids.append(IgnoreEntry(id=line))
        cfg.vulnerabilities = ids
        cfg.secrets = list(ids)
        cfg.misconfigurations = list(ids)
        cfg.licenses = list(ids)
        return cfg

    def match(
        self, entries: list[IgnoreEntry], id_: str, path: str = ""
    ) -> IgnoreEntry | None:
        import fnmatch

        today = datetime.date.today()
        for e in entries:
            if not e.active(today):
                continue
            if e.id and e.id != id_:
                continue
            if e.paths and not any(fnmatch.fnmatch(path, p) for p in e.paths):
                continue
            return e
        return None


@dataclass
class FilterOptions:
    severities: list[str] = field(default_factory=list)
    ignore_file: str | None = None
    vex_sources: list[str] = field(default_factory=list)
    policy_file: str | None = None  # --ignore-policy
    show_suppressed: bool = False  # keep suppressed-only results in output
    cache_dir: str = ""  # VEX repositories live under <cache>/vex/


class PolicyError(ValueError):
    pass


class IgnorePolicy:
    """``--ignore-policy`` predicate file — the rego ignore-policy stand-in
    (ref: pkg/result/filter.go:37-120 applyPolicy; the reference evaluates
    ``package trivy; ignore`` OPA rules over each finding). A ``.rego`` file
    runs through the rego-subset interpreter of ``rego.py``.

    The policy is a Python file defining any of::

        def ignore_vulnerability(v: dict) -> bool: ...
        def ignore_misconfiguration(m: dict) -> bool: ...
        def ignore_secret(s: dict) -> bool: ...
        def ignore_license(l: dict) -> bool: ...
        def ignore(finding: dict, kind: str) -> bool: ...   # fallback

    Each predicate receives the finding's report-JSON dict; returning True
    suppresses the finding (recorded as a modified finding, status
    ``ignored``).
    """

    _KINDS = ("vulnerability", "misconfiguration", "secret", "license")

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".rego"):
            # the reference's native policy format runs unmodified through
            # the rego-subset interpreter: query data.trivy.ignore over each
            # finding, exactly pkg/result/filter.go applyPolicy
            from trivy_tpu_torch import rego

            try:
                with open(path, encoding="utf-8") as f:
                    self._rego_mod = rego.parse_module(f.read())
            except (OSError, rego.RegoError) as e:
                raise PolicyError(
                    f"ignore policy {path} failed to load: {e}"
                ) from e
            names = self._rego_mod.rule_names()
            if "ignore" not in names:
                raise PolicyError(
                    f"ignore policy {path} defines no 'ignore' rule "
                    f"(rules found: {', '.join(names) or 'none'})"
                )
            self._fns = dict.fromkeys(self._KINDS)
            self._generic = None
            return
        self._rego_mod = None
        ns: dict = {"__file__": path, "__name__": "trivy_ignore_policy"}
        try:
            with open(path, encoding="utf-8") as f:
                code = compile(f.read(), path, "exec")
            exec(code, ns)  # noqa: S102 — explicit user-supplied policy file
        except Exception as e:
            raise PolicyError(f"ignore policy {path} failed to load: {e}") from e
        self._fns = {k: ns.get(f"ignore_{k}") for k in self._KINDS}
        self._generic = ns.get("ignore")
        if not self._generic and not any(self._fns.values()):
            raise PolicyError(
                f"ignore policy {path} defines no ignore_* or ignore() predicate"
            )

    def has_predicate(self, kind: str) -> bool:
        if self._rego_mod is not None:
            return True  # rego policies see every finding kind
        return self._fns.get(kind) is not None or self._generic is not None

    def ignores(self, kind: str, finding_dict: dict) -> bool:
        if self._rego_mod is not None:
            from trivy_tpu_torch import rego

            try:
                return bool(self._rego_mod.eval_rule("ignore", finding_dict))
            except rego.RegoError as e:
                raise PolicyError(
                    f"ignore policy {self.path}: {e}"
                ) from e
        fn = self._fns.get(kind)
        try:
            if fn is not None:
                return bool(fn(finding_dict))
            if self._generic is not None:
                return bool(self._generic(finding_dict, kind))
        except Exception as e:
            raise PolicyError(f"ignore policy {self.path} raised: {e}") from e
        return False


def filter_report(report: Report, options: FilterOptions) -> Report:
    """In-place severity/ignore filtering + dedup (ref: filter.go:37)."""
    if options.vex_sources:
        from trivy_tpu_torch import vex

        vex.filter_report(report, options.vex_sources, options.cache_dir)
    ignores = IgnoreConfig.load(options.ignore_file)
    policy = IgnorePolicy(options.policy_file) if options.policy_file else None
    sevs = set(options.severities)

    for result in report.results:
        if sevs:
            result.vulnerabilities = [
                v for v in result.vulnerabilities if v.severity in sevs
            ]
            result.secrets = [s for s in result.secrets if s.severity in sevs]
            result.misconfigurations = [
                m for m in result.misconfigurations if m.severity in sevs
            ]
            result.licenses = [l for l in result.licenses if l.severity in sevs]

        def keep_unignored(items, entries, kind, id_of, path_of):
            """Drop ignore-file matches, recording each as a modified finding
            (status ``ignored``) so --show-suppressed lists them like the
            reference does."""
            kept = []
            for item in items:
                entry = ignores.match(entries, id_of(item), path_of(item))
                if entry is None:
                    kept.append(item)
                else:
                    result.modified_findings.append(
                        ModifiedFinding(
                            type=kind,
                            status="ignored",
                            statement=entry.statement or "ignored by ignore file",
                            source=options.ignore_file or "",
                            finding=item.to_dict(),
                        )
                    )
            return kept

        result.vulnerabilities = keep_unignored(
            result.vulnerabilities, ignores.vulnerabilities, "vulnerability",
            lambda v: v.vulnerability_id, lambda v: v.pkg_path or v.pkg_name,
        )
        result.secrets = keep_unignored(
            result.secrets, ignores.secrets, "secret",
            lambda s: s.rule_id, lambda s: result.target,
        )
        result.misconfigurations = keep_unignored(
            result.misconfigurations, ignores.misconfigurations, "misconfiguration",
            lambda m: m.id, lambda m: result.target,
        )
        result.licenses = keep_unignored(
            result.licenses, ignores.licenses, "license",
            lambda l: l.name, lambda l: l.file_path or l.pkg_name,
        )
        if policy is not None:
            _apply_policy(result, policy)
        # dedup + deterministic order (ref: filter.go:77-120)
        seen = set()
        uniq = []
        for v in sorted(
            result.vulnerabilities,
            key=lambda v: (v.pkg_name, v.vulnerability_id, v.pkg_path, v.fixed_version),
        ):
            key = (v.vulnerability_id, v.pkg_name, v.pkg_path, v.installed_version)
            if key not in seen:
                seen.add(key)
                uniq.append(v)
        result.vulnerabilities = uniq
    report.results = [
        r
        for r in report.results
        if not r.is_empty or (options.show_suppressed and r.modified_findings)
    ]
    return report


def _apply_policy(result, policy: IgnorePolicy) -> None:
    """Run the ignore policy over every finding class; suppressed findings
    are recorded with status ``ignored`` (ref: filter.go applyPolicy)."""

    def keep(items, kind):
        if not policy.has_predicate(kind):
            return items
        kept = []
        for item in items:
            d = item.to_dict()
            if policy.ignores(kind, d):
                result.modified_findings.append(
                    ModifiedFinding(
                        type=kind,
                        status="ignored",
                        statement="ignored by policy",
                        source=policy.path,
                        finding=d,
                    )
                )
            else:
                kept.append(item)
        return kept

    result.vulnerabilities = keep(result.vulnerabilities, "vulnerability")
    result.misconfigurations = keep(result.misconfigurations, "misconfiguration")
    result.secrets = keep(result.secrets, "secret")
    result.licenses = keep(result.licenses, "license")
