"""Secret scan engine: rule evaluation, censoring, finding construction.

Behavioral contract modeled on the reference scan loop (ref:
pkg/fanal/secret/scanner.go:377-463): per file — global path allowlist, then
for each rule: path match, per-rule path allowlist, keyword prefilter, regex
location finding, exclude-block suppression, per-rule allow-regex
suppression; matched bytes are censored (ref: scanner.go:465-473) and each
location becomes a finding with 1-based line numbers, a censored match line
truncated to a display budget, and ±2 lines of code context (ref:
scanner.go:495-558). Findings are sorted deterministically so output is
stable under any execution order — the property that lets the device batch path
produce byte-identical results.

Content is handled as latin-1 text: a 1:1 byte<->char mapping, so regex spans
ARE byte offsets and censoring is byte-exact regardless of encoding.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

from trivy_tpu_torch import obs
from trivy_tpu_torch.secret.rules import (
    SECRET_GROUP,
    AllowRule,
    Rule,
    ascii_lower,
    builtin_allow_rules,
    builtin_rules,
)
from trivy_tpu_torch.types import Code, Line, Secret, SecretFinding, Severity

# Display budget for a rendered line (ref: scanner.go findLocation 100-char cap).
MAX_LINE_LENGTH = 100
# Context lines around the cause block (ref: scanner.go:495-558 ±2 lines).
CONTEXT_LINES = 2


@dataclass(frozen=True)
class Location:
    start: int
    end: int


@dataclass
class ScannerConfig:
    """User configuration (ref: pkg/fanal/secret/scanner.go:277-307).

    Loaded from a ``trivy-secret.yaml``-shaped mapping: custom rules, custom
    allow rules, rule disabling, builtin-rule restriction, global exclude
    blocks.
    """

    custom_rules: list[Rule] = field(default_factory=list)
    custom_allow_rules: list[AllowRule] = field(default_factory=list)
    enable_builtin_rule_ids: list[str] | None = None
    disable_rule_ids: list[str] = field(default_factory=list)
    disable_allow_rule_ids: list[str] = field(default_factory=list)
    exclude_block_regexes: list[str] = field(default_factory=list)
    # sha256 of the source --secret-config file bytes ("" when built
    # programmatically): folded into the persistent dedup namespace
    source_digest: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ScannerConfig":
        def to_rule(rd: dict) -> Rule:
            eb = rd.get("exclude-block")
            if isinstance(eb, dict):
                exclude_blocks = list(eb.get("regexes", []) or [])
            elif isinstance(eb, str):
                exclude_blocks = [eb]
            else:
                exclude_blocks = []
            return Rule(
                id=rd["id"],
                category=rd.get("category", "Custom"),
                title=rd.get("title", rd["id"]),
                severity=Severity.parse(rd.get("severity", "UNKNOWN")),
                regex=rd["regex"],
                keywords=list(rd.get("keywords", []) or []),
                path=rd.get("path"),
                secret_group_name=rd.get("secret-group-name") or rd.get("secret_group_name"),
                allow_rules=[to_allow(a) for a in rd.get("allow-rules", []) or []],
                exclude_blocks=exclude_blocks,
            )

        def to_allow(ad: dict) -> AllowRule:
            return AllowRule(
                id=ad["id"],
                description=ad.get("description", ""),
                path=ad.get("path"),
                regex=ad.get("regex"),
            )

        return cls(
            custom_rules=[to_rule(r) for r in d.get("rules", []) or []],
            custom_allow_rules=[to_allow(a) for a in d.get("allow-rules", []) or []],
            enable_builtin_rule_ids=d.get("enable-builtin-rules"),
            disable_rule_ids=list(d.get("disable-rules", []) or []),
            disable_allow_rule_ids=list(d.get("disable-allow-rules", []) or []),
            exclude_block_regexes=list(
                (d.get("exclude-block", {}) or {}).get("regexes", []) or []
            ),
        )

    @classmethod
    def from_yaml_file(cls, path: str) -> "ScannerConfig":
        import hashlib

        import yaml

        with open(path, "rb") as f:
            raw = f.read()
        cfg = cls.from_dict(yaml.safe_load(raw.decode("utf-8")) or {})
        # content digest of the config FILE: the persistent dedup store
        # folds it into its namespace keys, so editing the rule file
        # invalidates every persisted entry even when the parsed rule set
        # hashes the same way (allow rules, exclude blocks and disables
        # don't change hit vectors but DO change findings)
        cfg.source_digest = hashlib.sha256(raw).hexdigest()
        return cfg


class SecretScanner:
    """Evaluates the effective ruleset over file contents.

    This is the exact-semantics engine. It is used directly as the CPU
    backend, and as the confirmation stage of the CUDA scanner (which uses the
    device prefilter to decide *which* (file, rule) pairs ever reach it).
    """

    def __init__(self, config: ScannerConfig | None = None):
        cfg = config or ScannerConfig()
        rules = builtin_rules()
        if cfg.enable_builtin_rule_ids is not None:
            enabled = set(cfg.enable_builtin_rule_ids)
            unknown = enabled - {r.id for r in rules}
            if unknown:
                raise ValueError(f"unknown builtin rule ids: {sorted(unknown)}")
            rules = [r for r in rules if r.id in enabled]
        disabled = set(cfg.disable_rule_ids)
        rules = [r for r in rules if r.id not in disabled]
        for r in cfg.custom_rules:
            if r.id in disabled:
                continue
            rules.append(r)
        self.rules: list[Rule] = rules

        allow = builtin_allow_rules() + list(cfg.custom_allow_rules)
        disabled_allow = set(cfg.disable_allow_rule_ids)
        self.allow_rules: list[AllowRule] = [a for a in allow if a.id not in disabled_allow]

        self.global_exclude_blocks: list[re.Pattern] = [
            re.compile(p) for p in cfg.exclude_block_regexes
        ]

    # -- path-level filters -------------------------------------------------

    def allow_path(self, path: str) -> bool:
        """Global path allowlist: file skipped entirely (ref: scanner.go:388-392)."""
        return any(a.path_re and a.path_re.search(path) for a in self.allow_rules)

    def rules_for_path(self, path: str) -> list[Rule]:
        """Rules applicable to this path after path match + per-rule path allow."""
        return [
            r for r in self.rules if r.match_path(path) and not r.allow_path(path)
        ]

    # -- location finding (shared by CPU and device-confirm paths) ----------

    def global_block_spans(self, content: str) -> list[tuple[int, int]]:
        """Spans of user-configured global exclude blocks, computed once per file
        (the reference builds its block index lazily per content,
        ref: scanner.go:237-275)."""
        spans: list[tuple[int, int]] = []
        for pat in self.global_exclude_blocks:
            spans.extend(m.span() for m in pat.finditer(content))
        return spans

    def find_rule_locations(
        self,
        rule: Rule,
        content: str,
        lower: str,
        global_blocks: list[tuple[int, int]] | None = None,
    ) -> list[Location]:
        """All surviving match locations of one rule in ``content``.

        ``content`` must be latin-1-decoded bytes so spans are byte offsets.
        """
        if not rule.match_keywords(lower):
            return []
        locs: list[Location] = []
        for m in rule.regex_re.finditer(content):
            if rule.secret_group_name and rule.secret_group_name in rule.regex_re.groupindex:
                start, end = m.span(rule.secret_group_name)
            else:
                start, end = m.span()
            if start == end or start < 0:
                continue
            locs.append(Location(start, end))
        return self._filter_locations(rule, content, locs, global_blocks)

    def _filter_locations(
        self,
        rule: Rule,
        content: str,
        locs: list[Location],
        global_blocks: list[tuple[int, int]] | None,
    ) -> list[Location]:
        """Exclude-block and allow-regex suppression shared by every
        location-finding strategy."""
        if not locs:
            return []
        # exclude-block suppression: a location is dropped only when a block
        # fully contains it (ref: scanner.go Location.Match containment).
        blocks: list[tuple[int, int]] = list(
            global_blocks if global_blocks is not None else self.global_block_spans(content)
        )
        for pat in rule.exclude_block_res:
            blocks.extend(m.span() for m in pat.finditer(content))
        if blocks:
            locs = [
                l
                for l in locs
                if not any(bs <= l.start and l.end <= be for bs, be in blocks)
            ]
        # allow regexes (per-rule + global) are tested against the extracted
        # secret text itself (ref: scanner.go AllowLocation).
        allow_res = [a.regex_re for a in rule.allow_rules if a.regex_re is not None]
        allow_res += [a.regex_re for a in self.allow_rules if a.regex_re is not None]
        if allow_res:
            locs = [
                l
                for l in locs
                if not any(p.search(content[l.start : l.end]) for p in allow_res)
            ]
        return locs

    def find_rule_locations_fullscan(
        self,
        rule: Rule,
        content: str,
        lower: str,
        global_blocks: list[tuple[int, int]] | None = None,
    ) -> list[Location]:
        """:meth:`find_rule_locations` semantics, but unbounded-width rules
        locate candidate match starts with the bounded start-detector and
        take the true extent via ``match()`` — avoiding the regex engine's
        whole-content rescan. Used by the device confirm path for
        keyword-lane rules, where flagged chunks bound the *keyword*
        position, not the match start, so no window restriction is sound.
        """
        det = None
        if not rule.has_lookaround:
            wmax = rule.max_match_width
            if wmax is None or wmax > 8192:
                det = rule.start_detector
        if det is None:
            return self.find_rule_locations(rule, content, lower, global_blocks)
        if not rule.match_keywords(lower):
            return []
        locs: list[Location] = []
        n = len(content)
        pos = 0
        while pos < n:
            dm = det[0].search(content, pos)
            if dm is None:
                break
            m = rule.regex_re.match(content, dm.start())
            if m is None:
                pos = dm.start() + 1
                continue
            if rule.secret_group_name and rule.secret_group_name in rule.regex_re.groupindex:
                start, end = m.span(rule.secret_group_name)
            else:
                start, end = m.span()
            pos = m.end() if m.end() > dm.start() else dm.start() + 1
            if start == end or start < 0:
                continue
            locs.append(Location(start, end))
        return self._filter_locations(rule, content, locs, global_blocks)

    def find_rule_locations_in_windows(
        self,
        rule: Rule,
        content: str,
        lower: str,
        windows: list[tuple[int, int]],
        global_blocks: list[tuple[int, int]] | None = None,
    ) -> list[Location]:
        """Same results as :meth:`find_rule_locations` restricted to matches
        whose *start* lies inside the given windows.

        SOUND ONLY when the device guarantees flagged chunks contain the
        match start: the anchored device lane (anchor literal at fixed
        offset from the match start), or the keyword lane for bounded-width
        rules whose keyword provably sits inside every match
        (``Rule.keyword_in_match`` — the keyword occurrence then bounds the
        start within ``max_match_width``). Keyword-lane rules without that
        proof must use :meth:`find_rule_locations_fullscan` instead — the
        caller (TorchSecretScanner._confirm_inner) enforces this split.

        Bounded-width rules use ``search(pos, endpos)`` over windows padded
        by the match width so ``^``/lookbehind/word-prefix see real context;
        unbounded-width rules locate candidate starts with the bounded
        start-detector prefix and take the true extent via ``match()``.
        Lookaround rules fall back to a full scan (their context is
        unbounded by getwidth()).
        """
        if not rule.match_keywords(lower):  # keywords are a whole-file test
            return []
        wmax = rule.max_match_width
        if rule.has_lookaround:
            # lookarounds examine context beyond getwidth()'s bound, so the
            # fixed padding below cannot guarantee parity — full scan instead
            return self.find_rule_locations(rule, content, lower, global_blocks)
        detector = None
        if wmax is None or wmax > 8192:
            # unbounded match width: locate candidate starts with the bounded
            # start-detector prefix, then take the true (unbounded) extent
            # via match() at each candidate — no full-file rescans
            detector = rule.start_detector
            if detector is None:
                return self.find_rule_locations(rule, content, lower, global_blocks)
        n = len(content)
        # slack beyond the match width for anchor/word-prefix context
        pad = (detector[1] if detector else wmax) + 256
        ivs = sorted((max(0, s - pad), min(n, e + pad)) for s, e in windows)
        merged: list[list[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        verify_edges = rule.has_end_anchor
        locs: list[Location] = []
        pos = 0  # carried across windows: preserves finditer's global
        # non-overlapping consumption order when a match spans a gap
        for s, e in merged:
            pos = max(pos, s)
            while pos <= e:
                if detector is not None:
                    dm = detector[0].search(content, pos, min(n, e + detector[1]))
                    if dm is None or dm.start() > e:
                        break
                    m = rule.regex_re.match(content, dm.start())
                    if m is None:
                        pos = dm.start() + 1
                        continue
                else:
                    m = rule.regex_re.search(content, pos, e)
                    if m is None:
                        break
                    if verify_edges and e < n and m.end() >= e - 1:
                        # finditer's endpos acts as end-of-string, so a
                        # terminal $/\Z (incl. the before-trailing-\n form)
                        # may have fired mid-content; re-match at the same
                        # start against the real string end — the
                        # authoritative span the full scan sees
                        m2 = rule.regex_re.match(content, m.start())
                        if m2 is None:
                            pos = m.start() + 1
                            continue
                        m = m2
                if (
                    rule.secret_group_name
                    and rule.secret_group_name in rule.regex_re.groupindex
                ):
                    start, end = m.span(rule.secret_group_name)
                else:
                    start, end = m.span()
                # non-overlapping consumption order, as finditer would do
                pos = m.end() if m.end() > pos else pos + 1
                if start == end or start < 0:
                    continue
                locs.append(Location(start, end))
        # exclude blocks and allow regexes replicate find_rule_locations over
        # the full content (a block straddling a window must still suppress)
        return self._filter_locations(rule, content, locs, global_blocks)

    # -- full scan ----------------------------------------------------------

    def scan_bytes(self, file_path: str, data: bytes) -> Secret:
        """Scan one file's bytes; returns a :class:`Secret` (possibly empty)."""
        if self.allow_path(file_path):
            return Secret(file_path=file_path)
        content = data.decode("latin-1")
        return self.scan_content(file_path, content)

    def scan_content(self, file_path: str, content: str) -> Secret:
        # per-rule cost profile on the active trace context; one enabled
        # check per file when tracing is off
        ctx = obs.current()
        prof = ctx.profile() if ctx.enabled else None
        # ASCII-only fold, matching Rule.lower_keywords and the device
        # prefilter (bytes A-Z, no locale) — see rules.ascii_lower
        lower = ascii_lower(content)
        global_blocks = self.global_block_spans(content)
        hits: list[tuple[Rule, Location]] = []
        for rule in self.rules_for_path(file_path):
            t0 = time.perf_counter() if prof is not None else 0.0
            locs = self.find_rule_locations(rule, content, lower, global_blocks)
            if prof is not None:
                prof.confirm(rule.id, time.perf_counter() - t0, len(locs))
            for loc in locs:
                hits.append((rule, loc))
        return self.build_findings(file_path, content, hits)

    def build_findings(
        self, file_path: str, content: str, hits: list[tuple[Rule, Location]]
    ) -> Secret:
        """Censor all hit spans jointly, then render findings deterministically."""
        if not hits:
            return Secret(file_path=file_path)
        # de-duplicate identical (rule, span) pairs — the device path may confirm
        # the same location from two overlapping chunks.
        seen: set[tuple[str, int, int]] = set()
        uniq: list[tuple[Rule, Location]] = []
        for rule, loc in hits:
            key = (rule.id, loc.start, loc.end)
            if key not in seen:
                seen.add(key)
                uniq.append((rule, loc))
        censored = _censor(content, [l for _, l in uniq])
        lines = _LineIndex(content, censored)
        findings = [
            _render_finding(rule, loc, lines) for rule, loc in uniq
        ]
        findings.sort(key=lambda f: (f.start_line, f.rule_id, f.offset, f.end_line))
        return Secret(file_path=file_path, findings=findings)


def _censor(content: str, locations: list[Location]) -> str:
    """Replace every secret span with '*' bytes (ref: scanner.go:465-473)."""
    buf = list(content)
    for loc in locations:
        for i in range(loc.start, min(loc.end, len(buf))):
            if buf[i] != "\n":
                buf[i] = "*"
    return "".join(buf)


class _LineIndex:
    """Byte-offset -> line mapping over raw and censored content."""

    def __init__(self, content: str, censored: str):
        self.raw_lines = content.split("\n")
        self.censored_lines = censored.split("\n")
        # starts[i] = offset of first char of line i (0-based line index)
        self.starts: list[int] = [0]
        pos = 0
        for ln in self.raw_lines[:-1]:
            pos += len(ln) + 1
            self.starts.append(pos)

    def line_of(self, offset: int) -> int:
        """0-based line index containing byte ``offset`` (bisect on starts)."""
        import bisect

        return bisect.bisect_right(self.starts, offset) - 1


def _render_finding(rule: Rule, loc: Location, lines: _LineIndex) -> SecretFinding:
    start_li = lines.line_of(loc.start)
    end_li = lines.line_of(max(loc.start, loc.end - 1))
    start_line = start_li + 1
    end_line = end_li + 1

    def render_line(li: int) -> tuple[str, bool]:
        raw = lines.censored_lines[li]
        if len(raw) <= MAX_LINE_LENGTH:
            return raw, False
        # Long line: show a fixed window anchored just before the secret so
        # the cause stays visible (display-budget semantics, ref:
        # scanner.go:495-558).
        local = max(0, loc.start - lines.starts[li]) if li == start_li else 0
        begin = max(0, min(local - 20, len(raw) - MAX_LINE_LENGTH))
        return raw[begin : begin + MAX_LINE_LENGTH], True

    match_text, _ = render_line(start_li)

    code_lines: list[Line] = []
    first = max(0, start_li - CONTEXT_LINES)
    last = min(len(lines.censored_lines) - 1, end_li + CONTEXT_LINES)
    for li in range(first, last + 1):
        content_text, truncated = render_line(li)
        is_cause = start_li <= li <= end_li
        code_lines.append(
            Line(
                number=li + 1,
                content=content_text,
                is_cause=is_cause,
                truncated=truncated,
                highlighted=content_text,
                first_cause=is_cause and li == start_li,
                last_cause=is_cause and li == end_li,
            )
        )

    return SecretFinding(
        rule_id=rule.id,
        category=rule.category,
        severity=rule.severity.value if isinstance(rule.severity, Severity) else str(rule.severity),
        title=rule.title,
        start_line=start_line,
        end_line=end_line,
        match=match_text,
        code=Code(lines=code_lines),
        offset=loc.start,
    )
